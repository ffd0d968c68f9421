"""The port's counterpart of the repository's `benchmarks/` folder: the JAX
scripts' file names, each run as

    python -m fsw_gnn_tpu_torch.benchmarks.<name> [--device cpu]

on the card unless given `--device cpu` (then the kernels' plain versions,
which the first line says), with the JAX script's environment knobs and
defaults, one JSON line a case, each with the card's name and power limit.

Ported: every script of `benchmarks/`, with `_timing` (the protocol) and
`attic.fsw_table` (kernel A1); `bench_repspread` times the port's headline
benchmark, `fsw_gnn_tpu_torch.bench` (bench.py's counterpart).  The probe and
attic kernels are CUDA sources in `csrc/` (fsw_table_sort.cu for A1,
probe_matmul.cu for P1 with its `wgmma` routine in tf32x3_wgmma.cuh,
probe_select.cu for P6, probe_stage.cu for P4,
probe_segscan.cu for P5 and P2, and K3's packed form in segcumsum.cu for
P3), built at first use as the package's other kernels; no route of the
package reaches them.  The others drive the package's public API and its
kernels K1-K4: `bench_fused_table`, `bench_rank_proj`, `bench_rank_kernel`
and `bench_segcumsum`; serving (`bench_serving`, `bench_serving_aba`,
`probe_serving_budget`, `probe_serving_fresh`); the CSR path against the
tables and both by stages (`bench_csr_vs_table`, `bench_breakdown`,
`bench_table_breakdown`); `bench_arxiv_scale`; `bench_multiset`; cartesian
mode (`bench_cart_kernel`, `bench_cart_dw`, `bench_cart_waste`,
`probe_cart_dw_frontier`); and `bench_scaling` (the edge-partitioned step
over processes started by `parallel.launch`).  Each script's `setup`
builds the JAX script's inputs from the same seed.
"""
