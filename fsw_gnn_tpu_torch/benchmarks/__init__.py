"""The port's counterpart of the repository's `benchmarks/` folder: the JAX
scripts' file names, each run as

    python -m fsw_gnn_tpu_torch.benchmarks.<name> [--device cpu]

on the card unless given `--device cpu` (then the kernels' plain versions,
which the first line says), with the JAX script's environment knobs and
defaults, one JSON line a case, each with the card's name and power limit.

Ported so far: `_timing` (the protocol), `attic.fsw_table` (kernel A1),
`bench_fused_table`, `probe_kernel_matmul` (P1), `probe_select_ceiling`
(P6), `probe_emit_pipeline` (P4), `bench_rank_proj`, `bench_rank_kernel`,
and K3's: `probe_segscan_variants` (P5), `probe_fill_floor` (P2),
`probe_segcumsum_fill` (P3) and `bench_segcumsum`.  The probe and attic
kernels are CUDA sources in `csrc/` (fsw_table_sort.cu, probe_matmul.cu,
probe_select.cu, probe_stage.cu, probe_segscan.cu for P5 and P2, and K3's
packed form in segcumsum.cu for P3), built at first use as the package's
other kernels; no route of the package reaches them.
"""
