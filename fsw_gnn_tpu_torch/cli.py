"""Command-line interface of the port: full-graph training of an FSW-GNN.

  python -m fsw_gnn_tpu_torch.cli train --dataset cora --hidden 64 64
  python -m fsw_gnn_tpu_torch.cli train --dataset cora --device cpu

Counterpart of the `train` subcommand of `fsw_gnn_tpu/cli.py`, on one
device (the card unless --device says otherwise).  A dataset whose npz file
is absent (FSW_DATA_DIR, else `data/`) runs on its size-matched synthetic
stand-in.  Neighbor-sampled minibatch training (item 11 in ROADMAP.md) and
more than one device (item 14) are not ported and raise; `bench`,
`autotune` and `export` are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys


def _add_train_args(p):
    p.add_argument('--dataset', default='cora')
    p.add_argument('--hidden', type=int, nargs='+', default=[64])
    p.add_argument('--embed-dim', type=int, default=None,
                   help='FSW embedding dim per layer (default: '
                        '2*max(in, out), huge for wide features)')
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--lr', type=float, default=1e-2)
    p.add_argument('--weight-decay', type=float, default=0.0)
    p.add_argument('--mlp-layers', type=int, default=1)
    p.add_argument('--dropout', type=float, default=0.0)
    p.add_argument('--eval-every', type=int, default=5)
    p.add_argument('--patience', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--num-devices', type=int, default=None,
                   help='more than 1 is not ported yet (raises)')
    p.add_argument('--slice-chunk', type=int, default=None,
                   help='serialize the slice axis in chunks (memory cap)')
    p.add_argument('--eval-node-chunk', type=int, default=None,
                   help='layer-wise evaluation; not ported yet (raises)')
    p.add_argument('--minimize-slice-coherence', action='store_true',
                   help='coherence-minimize projection frames at init '
                        '(not ported yet: raises)')
    p.add_argument('--checkpoint-dir', default=None)
    p.add_argument('--no-auto-resume', action='store_true',
                   help='do not restore the latest checkpoint in '
                        '--checkpoint-dir before training')
    p.add_argument('--metrics-path', default=None,
                   help='append per-epoch metrics to this JSONL file')
    p.add_argument('--trace-dir', default=None,
                   help='write a torch.profiler trace here')
    p.add_argument('--minibatch', action='store_true',
                   help='neighbor-sampled minibatch training; not ported '
                        'yet (raises)')
    p.add_argument('--device', default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument('--verbose', action='store_true')


def cmd_train(args) -> int:
    from .data.datasets import load
    from .train import TrainConfig, Trainer

    if args.minibatch:
        raise NotImplementedError(
            'minibatch training (train/minibatch.py, data/sampler.py, item '
            '11 in ROADMAP.md) is not ported yet')
    data = load(args.dataset)
    cfg = TrainConfig(
        hidden_dims=tuple(args.hidden), embed_dim=args.embed_dim,
        learning_rate=args.lr, weight_decay=args.weight_decay,
        epochs=args.epochs, eval_every=args.eval_every,
        patience=args.patience,
        minimize_slice_coherence=args.minimize_slice_coherence,
        mlp_layers=args.mlp_layers, dropout=args.dropout, seed=args.seed,
        num_devices=args.num_devices, slice_chunk=args.slice_chunk,
        eval_node_chunk=args.eval_node_chunk,
        checkpoint_dir=args.checkpoint_dir,
        auto_resume=not args.no_auto_resume,
        metrics_path=args.metrics_path, trace_dir=args.trace_dir)
    tr = Trainer(data, cfg, device=args.device)
    out = tr.fit(verbose=args.verbose)
    print(json.dumps({'dataset': data.name, 'device': str(tr.device),
                      **out['final'], 'seconds': round(out['seconds'], 2),
                      'epochs_run': out['epochs_run']}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='fsw_gnn_tpu_torch')
    sub = parser.add_subparsers(dest='cmd', required=True)
    p_train = sub.add_parser('train', help='full-graph node classification')
    _add_train_args(p_train)
    p_train.set_defaults(fn=cmd_train)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
