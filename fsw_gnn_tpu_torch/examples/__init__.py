"""The port's counterparts of the repository's `examples/` demos, each run
as

    python -m fsw_gnn_tpu_torch.examples.<name> [--device cpu]

on the card unless given `--device cpu`:

  demo_fsw_embedding  batched weighted point clouds through FSWEmbedding
  demo_conv           one FSWConv layer on a random graph's CSR Graph
  demo_serving        a Trainer fit, a torch.export artifact saved and
                      loaded, and a GraphServer stream over both routes
  demo_dsmetric       the doubly-stochastic graph metric (`--n`, `--steps`)
  demo_distributed    the edge-partitioned step over P processes
                      (`--nproc`), the three boundary exchanges agreeing
"""
