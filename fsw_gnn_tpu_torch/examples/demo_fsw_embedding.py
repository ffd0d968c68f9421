"""Embed a batch of weighted point clouds with the FSW embedding.

Counterpart of examples/demo_fsw_embedding.py: batch dimensions (3, 2, 5)
of multisets of n = 100 points in d = 20 dimensions (normal), weights a
softmax of normal values, embedded into 1000 dimensions by `FSWEmbedding`
(random slices and frequencies, seed 0).  On the card 'auto' takes the
rank kernel K2f at this width.

    python -m fsw_gnn_tpu_torch.examples.demo_fsw_embedding [--device cpu]
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..embedding import FSWConfig
from ..modules import FSWEmbedding
from ._args import parser

BATCH_DIMS = (3, 2, 5)
D, N, EMBED_DIM = 20, 100, 1000


def main(argv=None, batch_dims=BATCH_DIMS, n=N, d=D, embed_dim=EMBED_DIM):
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    cfg = FSWConfig(d_in=d, d_out=embed_dim)
    emb = FSWEmbedding(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(batch_dims + (n, d), generator=gen).to(dev)
    W = torch.softmax(torch.randn(batch_dims + (n,), generator=gen),
                      dim=-1).to(dev)
    with torch.no_grad():
        X_emb = emb(X, W)
    print(f'Feature dimension: {d}  Size of each multiset: {n}  '
          f'Embedding dimension: {embed_dim}  Batch dimensions: '
          f'{batch_dims}  Device: {dev}')
    print('Size of X:    ', tuple(X.shape))
    print('Size of E(X): ', tuple(X_emb.shape))
    if not bool(torch.isfinite(X_emb).all()):
        raise RuntimeError('the embedding is not finite')
    return X_emb


if __name__ == '__main__':
    main()
