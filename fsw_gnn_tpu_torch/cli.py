"""Command-line interface of the port: training of an FSW-GNN (full-graph,
or on neighbor-sampled minibatches), the export of a trained checkpoint,
and the autotune of the routing rules on the card.

  python -m fsw_gnn_tpu_torch.cli train --dataset cora --hidden 64 64 \
      --checkpoint-dir ckpt
  python -m fsw_gnn_tpu_torch.cli export --dataset cora --hidden 64 64 \
      --checkpoint-dir ckpt --out cora.pt2
  python -m fsw_gnn_tpu_torch.cli train --dataset ogbn-arxiv --minibatch \
      --batch-size 1024 --fanouts 10,10 --eval-node-chunk 16384
  python -m fsw_gnn_tpu_torch.cli train --dataset cora --device cpu
  torchrun --nproc-per-node 4 -m fsw_gnn_tpu_torch.cli train \
      --dataset cora --num-devices 4 --exchange all_to_all
  python -m fsw_gnn_tpu_torch.cli autotune [--dry-run]
  python -m fsw_gnn_tpu_torch.cli bench [--device cpu]

Counterpart of the `train`, `export`, `autotune` and `bench` subcommands
of `fsw_gnn_tpu/cli.py`, on the card unless --device says otherwise (for
`export`, --device is where the artifact runs, as the JAX command's
--platform).  A dataset whose npz file is absent (FSW_DATA_DIR, else
`data/`) runs on its size-matched synthetic stand-in.  `--num-devices P`
trains over P processes, one per device, started by torchrun or by
`python -m fsw_gnn_tpu_torch.parallel.launch --nproc P -- train ...`
(edge-partitioned, or data-parallel with --minibatch); only rank 0 prints
the JSON line.  `autotune` measures the rank-vs-sort and K1 crossovers on
the card (`utils/autotune.py`) and caches them under its kind (not with
--dry-run); it prints {"rules": ..., "cache": path or null}.  `bench`
runs the headline benchmark (`fsw_gnn_tpu_torch.bench`) and prints its
JSON line.
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
                   help='train over this many processes, one per device '
                        '(launch them with torchrun or parallel.launch)')
    p.add_argument('--slice-chunk', type=int, default=None,
                   help='serialize the slice axis in chunks (memory cap)')
    p.add_argument('--eval-node-chunk', type=int, default=None,
                   help='exact layer-wise evaluation in recipient chunks '
                        'of this size (memory cap for huge graphs)')
    p.add_argument('--exchange', default='all_gather',
                   choices=['all_gather', 'all_to_all', 'overlap'],
                   help='boundary feature exchange for distributed runs')
    p.add_argument('--minimize-slice-coherence', action='store_true',
                   help='coherence-minimize projection frames at init '
                        '(slower init)')
    p.add_argument('--checkpoint-dir', default=None)
    p.add_argument('--no-auto-resume', action='store_true',
                   help='do not restore the latest checkpoint in '
                        '--checkpoint-dir before training')
    p.add_argument('--metrics-path', default=None,
                   help='append per-epoch metrics to this JSONL file')
    p.add_argument('--trace-dir', default=None,
                   help='write a torch.profiler trace here')
    p.add_argument('--compilation-cache', default=None, metavar='DIR',
                   help='build and keep the kernels\' libraries in DIR '
                        '(default: the package\'s _build/)')
    p.add_argument('--minibatch', action='store_true',
                   help='neighbor-sampled minibatch training')
    p.add_argument('--batch-size', type=int, default=512)
    p.add_argument('--fanouts', default='10,10')
    p.add_argument('--device', default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument('--verbose', action='store_true')


def cmd_train(args) -> int:
    from .data.datasets import load
    from .parallel import ensure_distributed
    from .train import MinibatchTrainer, TrainConfig, Trainer

    if args.num_devices is not None:
        # one process per device: start the group torchrun (or the
        # launcher) describes in the environment
        ensure_distributed(device=args.device)
    data = load(args.dataset)
    cfg = TrainConfig(
        hidden_dims=tuple(args.hidden), embed_dim=args.embed_dim,
        learning_rate=args.lr, weight_decay=args.weight_decay,
        epochs=args.epochs, eval_every=args.eval_every,
        patience=args.patience,
        minimize_slice_coherence=args.minimize_slice_coherence,
        mlp_layers=args.mlp_layers, dropout=args.dropout, seed=args.seed,
        num_devices=args.num_devices, exchange=args.exchange,
        slice_chunk=args.slice_chunk,
        eval_node_chunk=args.eval_node_chunk,
        checkpoint_dir=args.checkpoint_dir,
        auto_resume=not args.no_auto_resume,
        metrics_path=args.metrics_path, trace_dir=args.trace_dir,
        compilation_cache=args.compilation_cache)
    if args.minibatch:
        fanouts = tuple(int(x) for x in args.fanouts.split(','))
        tr = MinibatchTrainer(data, cfg, batch_size=args.batch_size,
                              fanouts=fanouts, device=args.device)
    else:
        tr = Trainer(data, cfg, device=args.device)
    out = tr.fit(verbose=args.verbose)
    if tr.is_main:
        world = tr.mesh.size if tr.mesh is not None else 1
        print(json.dumps({'dataset': data.name, 'device': tr.device.type,
                          'processes': world, **out['final'],
                          'seconds': round(out['seconds'], 2),
                          'epochs_run': out['epochs_run']}), flush=True)
    return 0


def cmd_autotune(args) -> int:
    """One-shot measurement of the routing rules on this card, cached by
    its kind so that aggregate='auto' can use the rank kernels on a card
    without a measured rules table.  Unlike the JAX command it moves no
    build cache: the kernels' builds persist already."""
    from .utils.autotune import autotune_rank_rules, cache_path
    rules = autotune_rank_rules(write_cache=not args.dry_run,
                                device=args.device)
    print(json.dumps({'rules': rules,
                      'cache': None if args.dry_run else cache_path()}),
          flush=True)
    return 0


def cmd_bench(args) -> int:
    """The headline benchmark, `fsw_gnn_tpu_torch.bench.main`."""
    from .bench import main as bench_main
    bench_main(['--device', args.device])
    return 0


def cmd_export(args) -> int:
    """The latest checkpoint in --checkpoint-dir -> a torch.export
    artifact of the model's forward on the dataset's graph."""
    from .data.datasets import load
    from .serving import export_forward, save_artifact
    from .train import TrainConfig, Trainer

    data = load(args.dataset)
    cfg = TrainConfig(hidden_dims=tuple(args.hidden),
                      embed_dim=args.embed_dim, mlp_layers=args.mlp_layers,
                      seed=args.seed, checkpoint_dir=args.checkpoint_dir,
                      slice_chunk=args.slice_chunk)
    tr = Trainer(data, cfg, device=args.device)
    step = tr.restore_checkpoint()
    blob = export_forward(tr.model, tr.X, tr.compute_graph,
                          device=args.device)
    save_artifact(args.out, blob)
    print(json.dumps({'artifact': args.out, 'bytes': len(blob),
                      'checkpoint_step': step}))
    return 0


def _add_export_args(p):
    p.add_argument('--dataset', default='cora')
    p.add_argument('--hidden', type=int, nargs='+', default=[64])
    p.add_argument('--embed-dim', type=int, default=None)
    p.add_argument('--mlp-layers', type=int, default=1)
    p.add_argument('--slice-chunk', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--checkpoint-dir', required=True)
    p.add_argument('--device', default=None,
                   help="where the artifact runs: 'cuda' (the default) or "
                        "'cpu'")
    p.add_argument('--out', required=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='fsw_gnn_tpu_torch')
    sub = parser.add_subparsers(dest='cmd', required=True)
    p_train = sub.add_parser('train', help='node classification (full-graph '
                                             'or --minibatch)')
    _add_train_args(p_train)
    p_train.set_defaults(fn=cmd_train)
    p_export = sub.add_parser('export', help='checkpoint -> torch.export '
                                             'artifact')
    _add_export_args(p_export)
    p_export.set_defaults(fn=cmd_export)
    p_auto = sub.add_parser('autotune', help='measure + cache the routing '
                                             'rules for this card')
    p_auto.add_argument('--dry-run', action='store_true',
                        help='measure and print, do not write the cache')
    p_auto.add_argument('--device', default=None,
                        help="'cuda' (the default) or 'cpu'")
    p_auto.set_defaults(fn=cmd_autotune)
    p_bench = sub.add_parser('bench', help='run the headline benchmark')
    p_bench.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                         help="'cuda' (the default) or 'cpu'")
    p_bench.set_defaults(fn=cmd_bench)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
