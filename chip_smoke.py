#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. the card's name, and its name and power limit from nvidia-smi;
  2. build every CUDA kernel of the package from its sources (nvcc,
     sm_90a, all sources at once), with the seconds it took and ptxas'
     resource report; K1's shared memory a block and blocks an SM, and the
     backward entry kernel's (K1b, K2b, K4b) block shape, shared memory,
     blocks and warps an SM at B = 8 .. 128 with and without with_dw, and
     K2f's and K4f's (at F = 8) registers, shared memory, blocks and warps
     an SM at B = 8 .. 128, and K3's (each type, ids or mask, direction;
     its tile) (from that report: the `occupancy:` line);
  3. K1f (`fsw_rank_fwdp`) against its plain PyTorch version on the card,
     at every degree-class shape of the served envelope, and both timed;
  4. serving: the bench FSWConv (in = out = 64 channels, 127 slices,
     3-layer MLP head, float32, random weights from seed 0) behind a
     GraphServer with a degree-class envelope sized from an 8192-node,
     average-degree-16 simple random graph, serving requests of 4096 to
     8192 nodes through `predict` and `predict_many`; every output is
     checked finite, one full-size request against the same model on the
     CPU, and K1f's launches against the path's classes;
  5. K1b (`fsw_rank_bwdp`) against its plain PyTorch version on the card,
     every output (dZ, df, dV, and dwn, dpad with with_dw), at every
     degree-class table of the bench graph, on the arguments the rank
     route passes in one forward (captured, not rebuilt), in four variants
     (the training path's: uniform_w on, with_dw off; uniform_w off; ties
     with an f = 0 slice; with_dw on with random weights);
  6. the bench training step (bench.py): the same FSWConv on the 8192-node
     graph in the `multi` layout, SGD(1e-3), 61 steps; the first step's
     gradients against the same step on the CPU, the loss finite and
     falling, K1f and K1b each launched (classes x steps) times; then the
     step, its forward, backward and optimizer, and K1f and K1b at every
     class, timed, and the step's device-busy time read from a
     torch.profiler trace of 10 steps.  The loss is sum(out**2) / N, bench.py's sum(out**2)
     per node: on the plain sum, SGD(1e-3) diverges from this model's
     initial weights within three steps (in the JAX package too), and the
     steps after that would be timed on NaNs.  The work of a step is the
     same;
  7. the Trainer: `load('cora')` (its synthetic stand-in when data/cora.npz
     is absent: 2708 nodes, 1433 features, 7 classes) with
     TrainConfig(hidden_dims=(64, 64), epochs=30, eval_every=10).  Before
     `fit`, the rank route's arguments of one forward are captured and
     the kernels held against their plain versions on every (layer,
     degree class) table at its full size (layer 0: D = 1433, S = 2865,
     2712 and 8 rows; the route sends the 2712-row class to K2 and the
     rest to K1): K1f and K2f on the arguments as passed, K1b on the
     dyadic grid and K2b with with_dw off (the path's) and on.  Then
     `fit`: the initial loss against a CPU forward of the same model, the
     loss falling, the final train accuracy above 0.9, each kernel
     launched (its tables x passes) times; then one epoch's parts timed,
     and each rank kernel on every table beside its bound;
  8. multisets: the reference demo's FSWEmbedding (d = 20, n = 100, 1000
     slices, random frequencies, seed 0) on 8 x 16 x 16 = 2048 multisets
     (X normal, W a softmax of normal values), so K2 sees P of 819 MB.
     K2f (`fsw_rank_fwd`) and K2b (`fsw_rank_bwd`) against their plain
     versions on the arguments the route passes (captured) in five
     variants: W given (with_dw on), W=None with w_mode 'unit' and
     'uniform' (uniform_w on, with_dw off), a batch of total mass 0.5
     below the threshold (a phantom mass), ties with an f = 0 slice; each
     also with with_dw on and random weights.  Then forward and backward
     through `'auto'` (which must take K2) for the gradients of X and W,
     K2f and K2b launched once each; the first 128 multisets through the
     same module on the CPU; K2f, K2b, their plain versions, the sort
     route and the whole forward and backward timed, and K2 and the sort
     route forward and backward with weight gradients also at n = 128,
     the widest multiset `'auto'` sends to K2;
  9. K2 on the table path: the bench FSWConv on the bench graph with
     slice_chunk = 64 = d_in, so the fused route does not apply; K2 held
     against its plain version on every captured (class, chunk) call in
     four variants; forward and backward, K2f and K2b launched (classes x
     chunks) times each; output and gradients against the CPU; K2f and K2b
     timed on every captured call beside their bounds;
 10. the width repair: FSWConv(64, 64, mlp_layers=3) on a 2000-node graph
     whose node 0 has 1024 in-edges (`hub_graph`): no rank call wider than
     128 (the classes up to 1024 wide take the sort route), K1f and K1b
     launched once per narrow class, output and gradients against the
     CPU;
 11. K3 (`segcumsum`) alone on 2^24 normal values, against its plain
     version with the ids and with the mask, at average segments of 32
     and 4096, singletons, and 32 in float64; each timed beside its bound
     and torch.cumsum's unsegmented floor on the same array, and the
     reverse scan (the backward's) with the mask;
 12. the CSR path: the bench FSWConv on the bench graph as a CSR Graph
     (130925 edges padded to 130944): K3 once a forward, the row form
     (`segcumsum_rows`) on 127 rows of 130944 over the graph's one mask,
     held against its plain version on the captured call and timed beside
     its bound and torch.cumsum along the rows; forward and forward +
     backward timed beside the `multi` layout of the same graph; output
     and gradients (the edge weights' too) against the CPU on an
     8192-node graph whose in-degrees are all 16;
 13. K3's backward: one gradient of the bench graph's edge weights on the
     card, K3's backward (one reverse launch on the cotangent) held
     against autograd through its plain version on the captured
     cotangent; the reverse call and the forward + backward with the edge
     weights' gradient timed, and a trace of the latter, whose kernels
     must hold no flip and two K3 launches (the `CSR conv:` line); then
     the scatter-free adjoints: the gradients of X, the slice vectors,
     the frequencies and the edge weights from two calls must be the same
     bits, and a trace of one backward alone must hold no scatter-add
     kernel or op (`SCATTER_KERNELS`, `SCATTER_OPS`; its kernels printed
     as `csr_bwd_kernels`);
 14. FSWGraphClassifier(64, (64, 64), 2, mlp_layers=3) on 256 graphs of
     64 nodes (in-degrees 4 or 8 by class), the convs on the CSR Graph and
     the readout on `readout_graph`: logits against the CPU, the first
     step's gradients against the CPU in float64, 5 Adam steps with the
     loss falling, K3 three times a forward;
 15. a 16384-node graph whose node 0 has 8192 in-edges: `auto_layout`
     keeps the CSR Graph; FSWConv forward and backward against the CPU;
 16. the server's CSR route: a GraphServer without classes serves 20
     requests of 4096-8192 nodes; a classes server takes a hub request
     (`fallbacks`) and a duplicate-edge request under assume_uniform_w
     (`uniform_w_fallbacks`) through CSR; outputs against the CPU;
 17. K4f (`fsw_rank_cart_fwd`) and K4b (`fsw_rank_cart_bwd`) alone at the
     JAX package's cartesian benchmark shape (`benchmarks/bench_cart_dw.py`:
     R = 8192 rows, B = 32, S = 128 slices, F = 8 frequencies, P ~ N(0, 1)
     of 134 MB, a fifth of the weights zero, frequencies |N(0, 1)| + 0.1
     as an (S, F) matrix whose rows differ) against their plain versions
     in five variants: with_dw on and off, uniform_w, ties with an f = 0
     column, a phantom mass; each timed beside its bound, its plain
     version and the sort route (`bucket_quadrature(..., 'sort')`),
     forward and forward + backward with every input taking a gradient;
     then the same with weight gradients at B = 128, the widest 'auto'
     sends to K4;
 18. the cartesian MultiTable: FSWEmbedding(FSWConfig(d_in=64,
     n_slices=128, n_freqs=8, collapse_freqs=True), learnable slices and
     frequencies) on the bench graph (`multi` layout): 'auto' takes K4 on
     every degree class (the captured calls; K4 held against its plain
     version on each, in four variants as phase 9's K2); forward and
     backward with weights_grad False and True (the table weights taking
     a gradient), one K4f and one K4b launch a class each; output and
     every gradient against the CPU; forward and forward + backward timed
     beside the sort route, and a kernel trace of the forward + backward;
 19. cartesian multisets: FSWEmbedding(FSWConfig(d_in=20, n_slices=128,
     n_freqs=8)) on phase 8's 2048 multisets of n = 100 (P 105 MB), W
     given and W = None, through 'auto' (K4, held against its plain
     version on the captured calls); forward and backward, one K4f and
     one K4b launch each; the first 128 multisets against the CPU;
     forward and forward + backward timed beside the sort route, and a
     kernel trace of the forward + backward;
 20. Citeseer (`citeseer_phase`): the Trainer on the Citeseer stand-in
     (3327 nodes, 3703 features), hidden (64, 64), 10 epochs at learning
     rate 1e-3: the initial loss against a CPU forward, the loss finite
     and falling, every rank call of one forward held against its plain
     version; then FSWConv(3703, 64) forward and backward on a 1024-node
     graph (classes 8 and 16 wide, one routed to K1 at D = 3703, one to
     K2), output and every gradient against the CPU;
 21. the K1 crossover (`routing_phase`): the fused route (K1) against the
     unfused route (X @ V, the gather, K2) through `fsw_embed_table` with
     the route forced, forward and forward + backward, in turns, on every
     class of the bench graph at D = 64 .. 1024 and of Cora's layer 0;
     a `routing:` line with the rule's pick beside each measurement;
 22. where K1's time goes (`k1_ab_phase`) on a served request, a bench
     step and Cora's layer 0: K1f's projection alone, K1b's step 1 alone
     and torch.matmul of the same product;
 23. the coherence minimizer (`coherence_phase`) on the card at Cora's
     layer-0 frame, 2865 x 1433 in float64 from seed 0: the stages kept,
     the iterations of each stage, the total time and the time an
     iteration beside its bound (two products of 2 n^2 d operations at
     the 67 TFLOP/s of float64 on the tensor cores), the coherence before
     and after (it must fall), the rows unit within 1e-12; the card's
     result against the CPU's at 127 x 64, within 1e-9;
 24. models with their default arguments (`defaults_phase`), whose
     constructors run the minimizer on the card: FSWConv(64, 64) served
     on the bench envelope (K1f), a request against a CPU copy; the
     Trainer's FSWGNN on the Cora stand-in with minimize_slice_coherence
     on, built (timed) and trained 5 steps at learning rate 1e-3, the
     loss falling (K1f, K1b, K2f, K2b); FSWConv(64, 64, mlp_layers=0) (concat_self: the
     coherence-minimized dim_reduct) forward on the bench graph against
     its CPU copy;
 25. K3 in CUDA graphs (`k3_graph_phase`): two graphs captured on one
     stream (one K3 workspace), the flat scan on 2^24 values and the row
     form at the CSR call's shape, replayed in turns on two inputs each,
     every replay the eager call's bits, no launch counted at capture;
     eager call and replay timed (`K3 graphs:` line);
 26. the headline server through its graphs (`graph_server_phase`): the
     bench FSWConv behind a graph server and an eager one
     (cuda_graphs=False), with phase 4's envelope and without classes
     (the CSR route); each route's warm-up and capture under sync debug
     mode 'error'; `warmup` 2 (1), its eager warm-up's K1f and K3
     launches counted; 50 requests of 4096-8192 nodes (20 on the CSR
     server) leave `num_compiles()` as it was and launch nothing from
     Python; then both servers take the requests in turns: outputs
     against the eager server's (bit for bit, or the largest difference),
     p50 and p90 eager against graph; the full-size request's forward,
     device and host-enqueue time and a kernel trace, eager against one
     replay, and the smallest request's replay (`graph server:` line);
 27. the other layouts (`dtype_server_phase`): a bfloat16 server at the
     headline envelope beside a float32 one (the largest difference
     relative to the float32 scale, wire bytes a request); at Cora's
     envelope (2708 nodes, 10556 edges) uint16 indices against int32 ones
     bit for bit, and bfloat16 with uint16 (`dtype servers:` line);
 28. export on the card (`export_phase`): the bench FSWConv closed over
     the bench graph in the `multi` layout and as a CSR Graph, saved,
     loaded and called (K1f or K3 through their ops), against the eager
     module and timed beside it (`export:` line);
 29. minibatch training at ogbn-arxiv's published scale
     (`minibatch_phase`): a graph of 169343 nodes, 1166243 directed edges,
     128 features, 40 planted classes and OGB's split sizes, built in O(E)
     (`arxiv_data`); the MinibatchTrainer with FSWGNN hidden (64,) at the
     CLI's defaults, batch 1024, fanouts (10, 10) (max_nodes 113664,
     max_edges 112640), one epoch of 89 steps: the first step's loss
     against the same step on the CPU, the loss finite and falling, every
     batch one shape, K3 two launches a step and no rank kernel (the
     batches take the CSR route), K3 held against its plain version on one
     step's captured calls; the epoch's seconds, a step's host parts
     (sampling, the CSR build, the copy in, all of `_build_batch`) beside
     its device ms and the idle share, a trace of a step (its
     segment-reduce kernels, where the padding segment is summed), the
     sorted segment-sum timed with the padding as built and spread over
     the empty recipients (`padding_segment_ms`) and the peak memory
     (`minibatch:` line);
 30. layer-wise inference (`layerwise_phase`): the trained model through
     `layerwise_predict(node_chunk=16384)` and the full-graph predict (the
     `multi` layout), both timed with their peak memory, within 1e-4 of
     the logits' scale of each other; K1f and K2f held against their plain
     versions on every call of the full forward, K3 on one chunk's calls
     (`layer-wise:` line);
 31. the normal entry point (`cli_minibatch_phase`): `python -m
     fsw_gnn_tpu_torch.cli train --dataset ogbn-arxiv --minibatch
     --batch-size 1024 --fanouts 10,10 --epochs 2 --eval-node-chunk 4096`
     on the loader's stand-in exits 0 and reports device cuda (`cli:`
     line);
 32. dsmetric (`dsmetric_phase`): the demo's pair (n = 12, d = 4), a batch
     of 64 pairs at n = 64 in float64 and float32 against the CPU in
     float64, the ms a solve and a trace of one (`dsmetric:` line);
 33. the edge-partitioned trainer at world size 1 (`dist_phase`) on a
     one-rank NCCL group the smoke starts on a file store
     (`ensure_distributed`): the Trainer's FSWGNN on the Cora stand-in,
     hidden (64, 64), defaults, partitioned with P = 1; for each exchange
     (all_gather, all_to_all, overlap with 4 chunks) the logits against
     the single-device forward on the card with the same parameters, one
     train step's loss and every gradient against the single-device
     step, K1 and K2 held against their plain versions on the forward's
     calls, the launches of one forward and one step (the overlap: K2f
     and K2b and no K1; the others K1f and K1b), the step's ms and its
     exchange's (every exchange call of a step, forward and backward),
     K1 and K2 timed on the captured calls, a trace's top kernels; then
     arxiv's full graph (`arxiv_data`), FSWGNN hidden (64,), all_to_all:
     a step's ms and its peak memory (`distributed:` line);
 34. one data-parallel step at world size 1 (`dp_phase`,
     `make_dp_train_step`) on one batch of phase 29's sampler against
     the single-device minibatch step on the same batch and parameters:
     the loss and every gradient, K3 one launch a layer; both timed in
     turns (`dp:` line);
 35. `python -m fsw_gnn_tpu_torch.parallel.launch --nproc 1 -- train
     --dataset cora --hidden 64 64 --epochs 2 --num-devices 1 --exchange
     all_to_all` (`cli_dist_phase`): exit 0, one JSON line, device cuda,
     one process (`cli dist:` line);
 36. the autotune (`autotune_phase`): `python -m fsw_gnn_tpu_torch.cli
     autotune` in a process of its own, its cache in a temporary
     directory (FSW_AUTOTUNE_CACHE): exit 0, one JSON line, the cache
     written under the card's kind; the one-sided contract against the
     H100 table (K2's decisive wins, B = 32 with weight gradients and 32
     and 64 without, measured as wins; wins beyond the table's cap
     listed), the K1 ladder's decisive points that K1_RHO0 / K1_D0 decide
     otherwise listed (forward + backward and forward only),
     `_rank_rules` of the card still the table with that cache in place;
     then the autotune's cells in this process at AT_REDUCED, which
     launch K1f, K1b, K2f, K2b, K4f and K4b, each held against its plain
     version on the calls they made (`autotune:` line: every margin and
     cell, the fits beside the constants, the seconds);
 37. the utilities (`utils_phase`): `validate_edge_index` and
     `validate_graph` on the bench graph on the card (corrupted copies
     raise); `checkify_embed` around the headline FSWConv forward on the
     `multi` layout (K1f) and the CSR Graph (K3): the unwrapped bits, one
     inf feature raising and naming an op, its time beside the unwrapped
     forward's; `trace()` around a served request and a CSR forward,
     whose Chrome trace holds K1f's and K3's kernels and the fsw_project
     and fsw_segcumsum ranges; a SectionTimer summary (`utils:` line);
 38. the benchmark folder's kernels (`bench_folder_phase`): A1
     (`fsw_table_sort`, the sorting-network table forward in registers,
     its P entry and its gathered entry `fsw_table_forward`), P1
     (`probe_matmul`, K1's contractions on two tile routines: 'wgmma' and
     K1's own 'k1'), P4 (`probe_stage`, K2f with staged loads) and P6
     (`probe_select`, the rank loop's and the trig tails' op mixes)
     against their plain versions at their scripts' shapes, timed beside
     their bounds; A1's two entries bit for bit each other and against
     the port's sort route on bench_fused_table's graph and at B = 16 ..
     1024; P1's five contractions on both routines at the probe's, the
     headline's and Cora's shapes against float64 and the plain version,
     the same bits on two calls, the headline's and Cora's timed beside
     `torch.matmul` in float32 and TF32; P4 bit for bit against K2f;
     then, every counter at 0, the four scripts' `main` on the card
     (`python -m fsw_gnn_tpu_torch.benchmarks.<name>`, their JSON lines
     printed), which must launch each kernel (`bench folder:` line);
 39. K3's probes (`k3_probes_phase`): P5 (`probe_segscan`'s three
     inner-loop variants), P2 (its six stage ablations) and K3's packed
     form (P3) against their plain versions at their scripts' default
     shapes, and against K3 in float64; the packed form bit for bit K3's
     mask form; each timed beside its plain version, K3 and
     `torch.cumsum`; then, every counter at 0, the four scripts' `main`
     on the card (`probe_segscan_variants`, `probe_fill_floor`,
     `probe_segcumsum_fill`, `bench_segcumsum`), which must launch each
     kernel (`K3 probes:` line);
 40. the ported benchmark scripts (`ported_scripts_phase`): the
     fourteen scripts of `fsw_gnn_tpu_torch/benchmarks/` that drive the
     model's kernels (serving, serving layouts in turns, the serving budget
     and fresh-request probes, CSR against tables, the CSR and table
     breakdowns, arxiv's scale, multisets ('auto' and 'rank'), the four
     cartesian scripts, scaling at one NCCL rank), each `main([])` from
     every counter at 0 at its defaults; each must pass its own check and
     launch its kernels (`ported scripts:` line);
 41. the five demos (`ported_demos_phase`): `fsw_gnn_tpu_torch/examples/`
     with their defaults, each from every counter at 0, each launching its
     kernels (`ported demos:` line);
 42. the headline benchmark (`bench_phase`): `python -m
     fsw_gnn_tpu_torch.bench` (the bench FSWConv's forward, backward and
     SGD step on the bench graph, replayed as one CUDA graph, beside the
     eager step) at its defaults, in bfloat16, on the CSR Graph and on one
     NeighborTable (2 reps each), and `bench_repspread` at 4 reps, each
     from every counter at 0: every probe finite, the captured step's
     parameters after 60 steps those of the eager step, K1f and K1b one
     launch a class in every eager step (the capture's warm-up included)
     and none in a replay, K3 on the CSR Graph; then bench.py's own loss,
     sum(out**2), for four eager steps, printed as a record (`bench:`
     line);
 43. one JSON line listing the fifteen kernels with their launches,
     errors, times and bounds (the launches of the seven of the model's
     paths are those of the main-path runs 4, 6, 7, 8, 9, 10, 12-16, 18,
     19, 20, 24, 26-30, 33, 34, 36, 37 and 42 together, the five of the
     benchmark folder (A1's two entries apart) those of phase 38's
     scripts, the three of K3's
     probes those of phase 39's; K2's times and bounds at phase 8's
     shape, K3's at phase 12's, K4's at phase 17's with B = 32, K4b's with
     with_dw, A1's at bench_fused_table's graph, P1's at K1's headline
     forward on the 'wgmma' routine (the 'k1' routine's beside it), P4's at the probe's shape, P6's of its 'rank' body, P5's of
     its 'fma' loop, P2's of its 'full' stage, P3's packed form at its
     probe's shape);
 44. the last line: {"ok": true, "device": {...}}.

Tolerances:
  * K1f against its plain version, both on the card in float32:
    |kernel - plain| <= 2e-5 * max|plain| + 1e-5 * |plain|.  The weighted
    ranks agree to the bit wherever the projections do; the projections
    differ by rounding (3xTF32 on the tensor cores, within about 1e-7 of
    sum |z v|, against cuBLAS in float32) and the trig by sincospi against
    the plain version's libm-style sin/cos.
  * K1b against its plain version, each output on its own scale:
    |kernel - plain| <= 1e-4 * max|plain| + 1e-4 * |plain|.  The backward
    jumps where two projections swap order, so Z and V are first rounded
    to a dyadic grid on which every projection is exact in float32 in any
    summation order (`dyadic`): both sides then rank alike, and what
    differs is the trig and the summation order of dZ (over S), dV (over
    the R * B entries) and df (over R).
  * served output against the CPU: |gpu - cpu| <= 1e-4 * max|cpu|.  The
    CPU runs the plain versions (MKL products, another summation order);
    three Linear layers follow the embedding.
  * the bench step's first gradients against the CPU, per parameter:
    |gpu - cpu| <= 1e-4 * max|cpu| + 1e-4 * |cpu|, with the features and
    the slice vectors on the dyadic grid (so both rank alike).
  * the Trainer's first loss against the CPU: relative 1e-4.  A forward
    is continuous in every input, so float32 rounding (about 1e-6 of each
    layer's scale) is all that differs, through three layers.
  * K2f and K2b against their plain versions: as K1f and K1b.  P is given,
    so no dyadic rounding is needed for both sides to rank alike.  K2f and
    K4f skip the padding: on every captured call each gives its own bits
    again with NaN at every zero-weight entry's projection, and on a
    second call.
  * K4f and K4b against their plain versions: as K2f and K2b, each output
    on its own scale; K4b sums dp, dc and dwn over the F frequencies in
    another rounding (fused multiply-adds) and df over the rows in
    another order.
  * multisets, table K2, hub graph and the cartesian phases 18 and 19
    against the CPU, output and every gradient: |gpu - cpu| <= 1e-4 *
    max|cpu| + 1e-4 * |cpu|, with the features and the slice vectors on
    the dyadic grid, and the multisets' weights on multiples of 2^-20
    (see `multiset_setup`).
  * K3 against its plain version, per element: |kernel - plain| <=
    8 eps * (the segment's prefix of |v|) (its suffix of |g| for the
    backward).  Both restart at every segment; each sums a prefix in a few
    roundings of partial sums no larger than it.
  * the CSR phases against the CPU, outputs and gradients: as above, on
    graphs whose in-degrees are powers of two (every normalized weight and
    every cumulative weight exact in any summation order: with the
    'spread' frequencies up to 253 one ulp of c moves an output by about
    1e-4 of its scale), features and slice vectors dyadic where the first
    layer's projections decide the sort.  The classifier's later layers
    project features computed in another order on each side; their
    float32 projections differ by ulps, which swaps near-ties and jumps
    the gradient, so its gradients are compared in float64.
  * the coherence minimizer, card against CPU in float64: 1e-9
    elementwise.  Both run the same state machine; cuBLAS and the CPU
    round the products in another order (about 1e-14 after the schedule
    on the CPU against JAX), and every step decision falls alike.
  * phase 24's outputs against the CPU: as the served output above.
  * phase 29's first loss against the CPU: relative 1e-4, as the
    Trainer's (unit weights: every cumulative weight is exact in either
    order).  Phase 30: layer-wise against the full predict within 1e-4 of
    the logits' scale (the chunks' scans and the `multi` layout's rank
    kernels sum in other orders: the JAX package's own test holds them at
    rtol 5e-5, atol 2e-5).  Phase 32: float64 on the card against the CPU
    within 1e-9 of each value (the same steps; cuBLAS and the CPU round
    the products in another order), float32 within 1e-2 of float64 on the
    unrelated pairs and 1e-2 of the largest value on all.
  * phases 33 and 34 against the single-device path on the card: the
    logits within 1e-4 of their scale, the loss relative 1e-4, every
    gradient within 1e-4 of its largest entry (as the bench step's).  At
    world size 1 the all-gather and the all-to-all run the single
    device's routes (the same bits); the overlap aggregates every class
    through K2 on cuBLAS projections where the single device takes K1's
    3xTF32 ones, which rounds apart by about 1e-6 of each scale.
  * phases 25-28: K3's replays and the uint16 server against their eager
    or int32 twins bit for bit; the graph server and the artifact against
    the eager server and module within 1e-4 of the output's scale (the
    same kernels and products on the same inputs: bit for bit is
    expected, and printed); the bfloat16 servers' difference from float32
    is printed, not bounded (bfloat16 features and weights, about 3
    significant digits, through phases up to f = 253).

Bounds (`fsw_gnn_tpu_torch/utils/bounds.py`, which the headline
benchmark's floor sums too): the least time the card could take for a
kernel's work, the
largest of (bytes that must move) / 3.35 TB/s, (float32 operations
outside the tensor cores) / 67 TFLOP/s and, for K1's projections,
(their operations) / (495 / 3) TFLOP/s: the H100 SXM's published peaks
at 700 W, TF32 on the tensor cores taken three times a float32 product
(the 3xTF32 split K1 runs; the pipes overlap, so the largest time
bounds).  Bytes: every input tensor read once and every output written
once, except that the forward kernels K2f and K4f read only the real
entries' columns of P (they skip the padding while they stage a row), so
their P counts 4 S sum_r d_r bytes, not 4 R B S: this lowers their bound
and makes no number look better (the backward kernels still write a full
dP, and their bytes stay as they are).  Operations: the least that this
run's data needs.  Zero-weight (padding) entries and rows contribute
exactly 0, and ranking d entries of one slice needs no more than a
stable sort and a cumsum, d log2 d + d operations (the kernels' d x d
rank loop runs about 2.5 d^2 instructions instead), so a row with d real
entries needs
  K1f: S * (d (2 D + 20) + d log2 d + d) operations: 2 D an entry for the
       projection (on the tensor cores), about 20 for the trig of one
       entry-slice;
  K1b: S * (d (6 D + 45) + d log2 d + d) operations: 2 D each for the
       recomputed projection, dZ and dV (on the tensor cores), about 45
       for the two sincospi, the dp, phi_f and df terms of one
       entry-slice (with with_dw, which the training path does not use, a
       reverse cumsum adds d more);
  K2f: S * (20 d + d log2 d + d) operations: K1f's without the projection;
  K2b: S * (45 d + d log2 d + d) operations, plus d with with_dw: K1b's
       without the three products;
  K4f: S * (20 F d + d log2 d + d) operations: one ranking serves the F
       frequencies, whose trig is K2f's each;
  K4b: S * (45 F d + d log2 d + d) operations, plus d with with_dw.
At the multiset shape K2's operations take less time than its bytes; at
phase 17's shape K4's bytes take less time than its operations.  The
bound of the padded shapes (every table entry counted) is printed beside
K1f's.
A1 (phase 38) runs its bitonic network whatever the data: B log2 B
(log2 B + 1) / 4 compare-exchanges a row and slice, counted as 4
operations each (a min, a max and two selects of the weights), and the
scan and the trig of each real entry, 26 operations (`table_sort_bound_ms`);
the P entry's bytes are P, wn, pad and freqs read once and the output
written, the gathered entry's Xp, idx, wn, pad and freqs (its operations
decide it).  P1: its 2 M N K products at the 3xTF32 rate against its
operands' and output's bytes.  P4: K2f's bound.  P6: each body's modeled operations
(the TPU probe's table) at 67 TFLOP/s against P, wn and the output.
K3 needs one add an element and moves 12 bytes an element in float32
with ids (values and ids read, output written), 9 with the mask: its
bound is the bytes'.  So are those of K3's probes (phase 39): P5 12 bytes
an element (values and ids read, output written), P2 9 (values and the
mask), K3's packed form 8 (one stream of values read, the output
written); their operations (an add an element for the function, P5's
loops seven passes of a few each) take less than a tenth of that time.  The row form's rows share one mask of m bytes, read
once for all of them: 8 bytes an element plus m (`k3_bytes`), which is
lower than the flat form's 9 and makes no time look better.

Device times are medians over 5 windows of back-to-back calls between
two CUDA events, a sleep kernel queued first so the card never waits for
the host (`device_ms`); host times are the median of back-to-back calls
on the host clock, from a synchronised start.  Latency is reported as the
median and the 90th percentile of the `predict` requests (100 samples).
"""
import copy
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the H100's bound model, shared with the package's headline benchmark
from fsw_gnn_tpu_torch.utils.bounds import (PEAK_BYTES, rank2_bound_ms,
                                            rank_bound_ms, rank_bwd_bound_ms)
from fsw_gnn_tpu_torch.utils.bounds import bound as _bound

ROOT = os.path.dirname(os.path.abspath(__file__))

N_NODES, AVG_DEG, D_IN, D_OUT = 8192, 16, 64, 64
MAX_EDGES = N_NODES * AVG_DEG
MIN_NODES = 4096
N_PREDICT, N_MANY, WINDOW = 100, 32, 8
KERNEL_RTOL, KERNEL_ATOL_REL = 1e-5, 2e-5
BWD_RTOL, BWD_ATOL_REL = 1e-4, 1e-4
SERVE_ATOL_REL = 1e-4
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
N_STEPS, STEP_LR = 60, 1e-3
TRAIN_EPOCHS, TRAIN_EVAL_EVERY, TRAIN_ACC_MIN = 30, 10, 0.9
LOSS0_RTOL = 1e-4
MMA_THREADS = 128  # a block of K1's products (csrc/fsw_rank_common.cuh)
FWD_THREADS = 64   # a block of K2f or K4f (TS in csrc/fsw_rank_common.cuh)
BWD_NAMES = ('dZ', 'dwn', 'dpad', 'df', 'dV')
BWD2_NAMES = ('dP', 'dwn', 'dpad', 'df')
HUB_NODES, HUB_IN = 2000, 1024
MS_LEAD, MS_N, MS_D, MS_S, MS_CPU_SETS = (8, 16, 16), 100, 20, 1000, 128
TABLE_CHUNK = 64
KERNEL_NAMES = ('fsw_rank_fwdp', 'fsw_rank_bwdp', 'fsw_rank_fwd',
                'fsw_rank_bwd', 'segcumsum', 'fsw_rank_cart_fwd',
                'fsw_rank_cart_bwd')
CART_R, CART_B, CART_S, CART_F, CART_ZERO = 8192, 32, 128, 8, 0.2
K3_N, K3_ULPS, K3_ITEMS = 1 << 24, 8, 16
K3_CASES = (('avg 32', 32, 'float32'), ('avg 4096', 4096, 'float32'),
            ('singletons', 1, 'float32'), ('avg 32, float64', 32, 'float64'))
CSR_CHECK_DEG = 16
CLS_GRAPHS, CLS_NODES, CLS_DEGS, CLS_STEPS, CLS_LR = 256, 64, (4, 8), 5, 1e-4
CSR_HUB_NODES, CSR_HUB_IN, CSR_HUB_DEG = 16384, 8192, 4
CSR_REQUESTS, CSR_SERVE_HUB_IN, CSR_CLASSES_NODES = 20, 256, 2048
CITESEER_EPOCHS, CITESEER_LR = 10, 1e-3
CITESEER_SUB_NODES, CITESEER_SUB_HUBS = 1024, 8
ROUTE_DS, ROUTE_BENCH_S = (64, 128, 256, 512, 1024), 127
CORA_D, CORA_S = 1433, 2865
PEAK_F64_TC_OPS = 67e12
COH_CHECK, COH_CPU_TOL, COH_UNIT_TOL = (127, 64), 1e-9, 1e-12
DEFAULTS_REQUESTS, DEFAULTS_EPOCHS, DEFAULTS_LR = 8, 5, 1e-3
K3G_REPLAYS = 3
GRAPH_REQUESTS, GRAPH_CSR_REQUESTS, BF16_REQUESTS = 50, 20, 10
CORA_NODES, CORA_EDGES = 2708, 10556     # Cora's published graph
SCATTER_KERNELS = ('indexing_backward', 'indexFunc', 'index_add',
                   'scatter_add', 'ReduceAdd')
SCATTER_OPS = ('aten::index_add', 'aten::index_add_', 'aten::scatter_add',
               'aten::scatter_add_', 'aten::_index_put_impl_')
ARXIV_NODES, ARXIV_EDGES = 169343, 1166243      # ogbn-arxiv's published
ARXIV_FEATURES, ARXIV_CLASSES = 128, 40          # counts, and OGB's split
ARXIV_SPLIT = (90941, 29799, 48603)
ARXIV_SAME_CLASS, ARXIV_MEAN_SCALE = 0.8, 0.5
MB_BATCH, MB_FANOUTS, MB_HIDDEN = 1024, (10, 10), (64,)
MB_CAPS = (MB_BATCH * 111, MB_BATCH * 110)       # b (1 + 10 + 100), b 110
LW_NODE_CHUNK, LW_ATOL_REL = 16384, 1e-4
CLI_EPOCHS, CLI_NODE_CHUNK, CLI_TIMEOUT = 2, 4096, 600
DS_DEMO_N, DS_DEMO_D, DS_TRACE_OUTER = 12, 4, 50
DS_PAIRS, DS_N, DS_D, DS_CPU_PAIRS = 64, 64, 4, 8
DS_F64_RTOL, DS_F32_RTOL, DS_ISO_SHARE = 1e-9, 1e-2, 1e-2
DIST_HIDDEN, DIST_CHUNKS = (64, 64), 4
AUTOTUNE_TIMEOUT = 300
# the in-process run of the autotune's cells that counts their launches
AT_REDUCED = dict(buckets=(32,), cart_buckets=(32,), k1_ds=(64, CORA_D),
                  k1_rhos=(0.2, 2.0), steps=1, calls=1)
K1F_KERNEL, K3_KERNEL = 'fsw_rank_fwdp_kernel', 'scan_kernel'
UTILS_REPS = 5


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def simple_graph(seed, n, deg=AVG_DEG):
    """A simple random directed graph (no self-loops, no duplicate edges)
    with about n * deg edges, as bench.py builds it."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, n * deg)
    dst = rng.integers(0, n, n * deg)
    keep = src != dst
    pairs = np.unique(src[keep].astype(np.int64) * n + dst[keep])
    return np.stack([pairs // n, pairs % n]), rng


def hub_graph(seed, n=HUB_NODES, hub_in=HUB_IN, deg=4):
    """A simple random directed graph of about n * deg edges among nodes
    1 .. n-1, and node 0 receiving `hub_in` edges, from nodes 1 .. hub_in:
    one degree class wider than the rank kernels take.  At hub_in = 1024
    the hub's normalized unit weights are 2^-10, so the sort route's
    cumsum is exact in any order (a parallel scan on the card, a
    sequential sum on the CPU)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n, n * deg)
    dst = rng.integers(1, n, n * deg)
    src = np.concatenate([src, np.arange(1, hub_in + 1)])
    dst = np.concatenate([dst, np.zeros(hub_in, np.int64)])
    keep = src != dst
    pairs = np.unique(src[keep].astype(np.int64) * n + dst[keep])
    return np.stack([pairs // n, pairs % n]), rng


def regular_graph(seed, n, deg, offset=0):
    """Edges into every node v of n (ids offset by `offset`) from `deg`
    distinct other nodes among the n, chosen at random: every in-degree is
    `deg`, so at a power of two every normalized weight and every prefix
    of them is exact in any summation order."""
    rng = np.random.default_rng(seed)
    off = np.empty((n, deg), np.int64)
    for v in range(n):
        row = np.unique(rng.integers(1, n, 4 * deg))
        while row.shape[0] < deg:
            row = np.unique(np.concatenate([row, rng.integers(1, n, deg)]))
        off[v] = rng.permutation(row)[:deg]
    dst = np.repeat(np.arange(n), deg)
    src = (dst + off.reshape(-1)) % n
    return np.stack([src, dst]) + offset


def dyadic(Z, V):
    """Z (..., D) and V (D, S) rounded to dyadic grids 2^-p and 2^-q, the
    finest for which every partial sum of Z V is an integer multiple of
    2^-(p+q) below 2^24 of them: every projection is then exact in float32
    in any summation order, so a kernel and its plain version rank the
    entries identically (the backward jumps where two projections swap
    order)."""
    import torch

    def bound(z, v):
        return float((z.abs().reshape(-1, z.shape[-1]).double()
                      @ v.abs().double()).max())
    bits = int(np.floor(np.log2(2.0 ** 23 / bound(Z, V))))
    p = bits // 2
    q = bits - p
    Zq = torch.round(Z * 2.0 ** p) / 2.0 ** p
    Vq = torch.round(V * 2.0 ** q) / 2.0 ** q
    if not bound(Zq, Vq) * 2.0 ** (p + q) < 2.0 ** 24:
        raise ValueError('dyadic rounding left a projection inexact')
    return Zq, Vq


def device_ms(torch, fn, n, reps=5):
    """(device ms per call, host ms per call) of `fn`.  The host time is
    the median of `n` back-to-back calls on the host clock, from a
    synchronised start: the Python cost of a call, and any wait inside it.
    The device time is the median over `reps` of the mean over `n`
    back-to-back calls between two CUDA events; a sleep kernel queued
    first keeps the card busy while the host enqueues the calls, so the
    host's cost does not leave the card idle inside the timed region."""
    fn()
    torch.cuda.synchronize()
    hosts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        hosts.append(time.perf_counter() - t0)
    host = float(np.median(hosts))
    torch.cuda.synchronize()
    cycles = int(2e9 * max(2e-3, 3 * sum(hosts)))  # >= 2 GHz SM clock
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times)), 1e3 * host


def ptxas_kernels(log):
    """{kernel: (registers, static shared bytes)} of every entry function
    in nvcc's `-Xptxas -v` report `log`, each named by the last component
    of its mangled name and its float, double, integer or bool template
    arguments (`rank_bwd_entry_kernel<8,1>` for <8, true>,
    `scan_kernel<float,0,1>` for <float, false, true>)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym, i, parts = m.group(1), 3 if m.group(1)[2:3] == 'N' else 2, []
            while (d := re.match(r'\d+', sym[i:])):
                n = int(d.group())
                parts.append(sym[i + d.end():i + d.end() + n])
                i += d.end() + n
            targs = re.match(r'I((?:[fd]|L[ib]\d+E)+)E', sym[i:])
            name = (parts[-1] if parts else sym) + (
                '<' + ','.join(
                    {'f': 'float', 'd': 'double'}.get(t, v) for t, v in
                    re.findall(r'([fd])|L[ib](\d+)E', targs.group(1)))
                + '>' if targs else '')
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and name is not None:
            sm = re.search(r'(\d+) bytes smem', line)
            out[name] = (int(m.group(1)), int(sm.group(1)) if sm else 0)
            name = None
    return out


def blocks_per_sm(regs, smem, threads):
    """Blocks of `threads` threads, `regs` registers a thread and `smem`
    bytes of shared memory that one H100 SM holds at once: the least of
    its limits on registers (65536, allocated 256 a warp), shared memory
    (233472, 1024 of it reserved a block), threads (2048) and blocks
    (32)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    return min(65536 // (per_warp * warps), 233472 // (smem + 1024),
               2048 // threads, 32)


def time_k2_calls(torch, calls, gen, n=3):
    """Device ms of K2f and K2b (the path's with_dw) on captured K2 calls,
    with their bounds, summed, and per call with the real-entry share of
    its table (the share of nonzero weights, which K2f stages and ranks).
    Launches made here are not counted as the path's."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    keys = {'fwd': 'k2f_ms', 'bwd': 'k2b_ms', 'fwd_bound': 'k2f_bound_ms',
            'bwd_bound': 'k2b_bound_ms'}
    tot = dict.fromkeys(keys, 0.0)
    rows = []
    with torch.no_grad():
        for args, unif, dw in calls:
            P, wn = args[0], args[1]
            S = P.shape[2]
            G = torch.randn(P.shape[::2], generator=gen, device=P.device)
            row = {'shape': list(P.shape),
                   'real_entry_share': float((wn != 0).float().mean()),
                   'k2f_ms': device_ms(torch, lambda: R.fsw_rank_aggregate(
                       *args, uniform_w=unif, with_dw=dw), n)[0],
                   'k2b_ms': device_ms(torch, lambda: (
                       R.fsw_rank_aggregate_bwd(*args, G, uniform_w=unif,
                                                with_dw=dw)), n)[0],
                   'k2f_bound_ms': rank2_bound_ms(wn, S)[0],
                   'k2b_bound_ms': rank2_bound_ms(wn, S, bwd=True,
                                                  with_dw=dw)[0]}
            for k, key in keys.items():
                tot[k] += row[key]
            rows.append(row)
    return tot, rows


def capture_rank_calls(run, name='fsw_rank_aggregate_proj'):
    """Run `run()` with one of the rank route's entry points (`name` in
    fsw_gnn_tpu_torch.embedding: the fused K1 `fsw_rank_aggregate_proj`,
    the unfused K2 `fsw_rank_aggregate` or the cartesian K4
    `fsw_rank_aggregate_cart`) wrapped, and return the
    arguments of every call it made, in order: a list of (args, uniform_w,
    with_dw), the args detached copies.  The checks and timings replay
    exactly what the path passes.  Launches made here count as usual:
    callers reset the counts after."""
    from fsw_gnn_tpu_torch import embedding
    real = getattr(embedding, name)
    calls = []

    def spy(*args, uniform_w=False, with_dw=True):
        calls.append((tuple(t.detach().clone() for t in args),
                      bool(uniform_w), bool(with_dw)))
        return real(*args, uniform_w=uniform_w, with_dw=with_dw)
    setattr(embedding, name, spy)
    try:
        run()
    finally:
        setattr(embedding, name, real)
    return calls


def rank_fns(kind):
    """(forward label, backward label, kernel, plain, backward kernel,
    backward plain, backward output names) of K1, K2 or K4 (`kind`)."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    if kind == 'K2':
        return ('K2f', 'K2b', R.fsw_rank_aggregate, R.fsw_rank_aggregate_plain,
                R.fsw_rank_aggregate_bwd, R.fsw_rank_aggregate_bwd_plain,
                BWD2_NAMES)
    if kind == 'K4':
        return ('K4f', 'K4b', R.fsw_rank_aggregate_cart,
                R.fsw_rank_aggregate_cart_plain, R.fsw_rank_aggregate_cart_bwd,
                R.fsw_rank_aggregate_cart_bwd_plain, BWD2_NAMES)
    return ('K1f', 'K1b', R.fsw_rank_aggregate_proj,
            R.fsw_rank_aggregate_proj_plain, R.fsw_rank_aggregate_proj_bwd,
            R.fsw_rank_aggregate_proj_bwd_plain, BWD_NAMES)


def tables_of(graph):
    return graph.tables if hasattr(graph, 'tables') else [graph]


def check_fwd(torch, label, args, unif, kind='K1'):
    """K1f (or K2f, K4f) against its plain version on one input; returns
    the largest absolute error and the largest error relative to the
    output's scale."""
    name, _, kernel, plain, _, _, _ = rank_fns(kind)
    # with_dw=False: the wrapper passes uniform_w to the kernel only then
    got = kernel(*args, uniform_w=unif, with_dw=False)
    torch.cuda.synchronize()
    want = plain(*args, uniform_w=unif)
    err = (got - want).abs()
    scale = want.abs().max().item()
    ok = bool(torch.all(err <= KERNEL_ATOL_REL * scale
                        + KERNEL_RTOL * want.abs()))
    if not (ok and torch.isfinite(got).all()):
        fail(f'{name} disagrees ({label}): max abs err '
             f'{err.max().item():.3e}, scale {scale:.3e}')
    return err.max().item(), err.max().item() / max(scale, 1e-30)


def check_fwd_padding(torch, label, args, unif, kind):
    """K2f or K4f skips the padding: on P with NaN at every zero-weight
    entry it gives the bits it gives on P, and a second call the same
    bits."""
    name, _, kernel, _, _, _, _ = rank_fns(kind)
    P, wn = args[0], args[1]
    got = kernel(*args, uniform_w=unif, with_dw=False)
    again = kernel(*args, uniform_w=unif, with_dw=False)
    Pn = P.masked_fill((wn == 0)[:, :, None], float('nan'))
    nan_pad = kernel(Pn, *args[1:], uniform_w=unif, with_dw=False)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f'{name}: two calls differ ({label})')
    if not torch.equal(got, nan_pad):
        fail(f'{name}: a padded entry changed the output ({label})')


def check_bwd(torch, label, args, G, unif, with_dw, kind='K1'):
    """K1b (or K2b, K4b) against its plain version on one input; returns
    the largest absolute error and the largest error relative to its
    output's scale."""
    _, name, _, _, kernel, plain, names = rank_fns(kind)
    got = kernel(*args, G, uniform_w=unif, with_dw=with_dw)
    torch.cuda.synchronize()
    want = plain(*args, G, uniform_w=unif, with_dw=with_dw)
    max_err = worst_rel = 0.0
    for out, g, w in zip(names, got, want):
        if w is None:
            if g is not None:
                fail(f'{name} returned {out} without with_dw ({label})')
            continue
        err = (g - w).abs()
        scale = w.abs().max().item()
        ok = bool(torch.all(err <= BWD_ATOL_REL * scale
                            + BWD_RTOL * w.abs()))
        if not (ok and torch.isfinite(g).all()):
            fail(f'{name} {out} disagrees ({label}): max abs err '
                 f'{err.max().item():.3e}, scale {scale:.3e}')
        max_err = max(max_err, err.max().item())
        worst_rel = max(worst_rel, err.max().item() / max(scale, 1e-30))
    dead = args[1] == 0
    if not torch.all(got[0][dead] == 0):
        fail(f'{name} gave padded entries a non-zero {names[0]} ({label})')
    del got, want
    return max_err, worst_rel


def time_rank_kernels(torch, calls, gen, n=10, plain_reps=0):
    """Device ms of K1f and K1b on the captured rank calls of one pass,
    summed, with the plain versions when plain_reps > 0, and the bound ms
    of K1b.  Launches made here are not counted as the path's."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_bwd,
        fsw_rank_aggregate_proj_bwd_plain, fsw_rank_aggregate_proj_plain)
    tot = dict(fwd=0.0, bwd=0.0, fwd_plain=0.0, bwd_plain=0.0, bwd_bound=0.0)
    bound_by = set()
    rows = []
    with torch.no_grad():
        for args, unif, dw in calls:
            Z, wn, _, _, V = args
            R, B, D = Z.shape
            S = V.shape[1]
            G = torch.randn((R, S), generator=gen, device=Z.device)
            f_ms, _ = device_ms(torch, lambda: fsw_rank_aggregate_proj(
                *args, uniform_w=unif, with_dw=dw), n)
            b_ms, _ = device_ms(torch, lambda: fsw_rank_aggregate_proj_bwd(
                *args, G, uniform_w=unif, with_dw=dw), n)
            bm, by = rank_bwd_bound_ms(wn, D, S)
            bound_by.add(by)
            row = dict(B=B, R=R, D=D, S=S, k1f_ms=f_ms,
                       k1b_ms=b_ms, k1b_bound_ms=bm, k1b_bound_by=by)
            if plain_reps:
                row['k1f_plain_ms'], _ = device_ms(
                    torch, lambda: fsw_rank_aggregate_proj_plain(
                        *args, uniform_w=unif), 3, plain_reps)
                row['k1b_plain_ms'], _ = device_ms(
                    torch, lambda: fsw_rank_aggregate_proj_bwd_plain(
                        *args, G, uniform_w=unif, with_dw=dw), 3,
                    plain_reps)
                tot['fwd_plain'] += row['k1f_plain_ms']
                tot['bwd_plain'] += row['k1b_plain_ms']
            tot['fwd'] += f_ms
            tot['bwd'] += b_ms
            tot['bwd_bound'] += bm
            rows.append(row)
    tot['bwd_bound_by'] = ('operations' if 'operations' in bound_by
                           else 'bytes')
    return tot, rows


def traced_busy_ms(torch, fn, n):
    """Device-busy ms per call of `fn` from a torch.profiler trace of n
    calls: the summed durations of the kernels and copies it records on
    the card (one stream, so they do not overlap).  None where the trace
    holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / n if busy_us else None


def traced_top_kernels(torch, fn, n, top=8):
    """(device-busy ms per call, [[name, ms per call, calls per call]] of
    the `top` costliest kernels and copies on the card) from a
    torch.profiler trace of n calls of `fn`, names cut to 90 characters."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, calls = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name[:90]] += e.time_range.elapsed_us()
            calls[e.name[:90]] += 1
    rows = sorted(us.items(), key=lambda kv: -kv[1])[:top]
    return (sum(us.values()) / 1e3 / n,
            [[k, v / 1e3 / n, calls[k] / n] for k, v in rows])


def step_parts_ms(torch, forward, loss_of, opt):
    """Device and host ms of one training step and of its forward,
    backward and optimizer parts, each timed on its own (the backward
    repeated on one retained graph)."""
    def step():
        opt.zero_grad(set_to_none=True)
        loss_of(forward()).backward()
        opt.step()
    parts = {}
    parts['step_device_ms'], parts['step_host_ms'] = device_ms(
        torch, step, 3)
    parts['forward_device_ms'], parts['forward_host_ms'] = device_ms(
        torch, forward, 3)
    loss = loss_of(forward())
    parts['backward_device_ms'], parts['backward_host_ms'] = device_ms(
        torch, lambda: loss.backward(retain_graph=True), 3)
    parts['optimizer_device_ms'], parts['optimizer_host_ms'] = device_ms(
        torch, opt.step, 5)
    del loss
    opt.zero_grad(set_to_none=True)
    return parts


def serve_and_check_k1f(torch, T, dev, model, counts, errs):
    """Phases 3 and 4.  Returns the rank calls of one request and K1f's
    entry for the kernels line."""
    from fsw_gnn_tpu_torch.embedding import table_weights
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_plain)
    cfg = model.embed_cfg
    ref_ei, _ = simple_graph(0, N_NODES)
    classes, class_rows = T.multi_envelope(
        T.from_edge_index(ref_ei, N_NODES), N_NODES)
    print(f'envelope: classes {classes} rows {class_rows}; slices '
          f'{cfg.nSlices}, feature width {cfg.proj_dim}')
    # eager (cuda_graphs=False): this phase counts each request's launches
    # and captures the rank calls, which a graph's replay does not pass
    # through; phase 26 serves the same model through the graphs
    server = T.GraphServer(model, N_NODES, MAX_EDGES, classes=classes,
                           class_rows=class_rows, assume_uniform_w=True,
                           cuda_graphs=False, device=dev)

    def request(seed, n):
        ei, rng = simple_graph(seed, n)
        return ei, rng.standard_normal((n, D_IN)).astype(np.float32)

    # ---- 3. K1f at every served class, on what one request passes it -------
    server.warmup(D_IN)
    calls = capture_rank_calls(lambda: server.predict(*request(1, N_NODES)))
    if len(calls) != len(classes):
        fail(f'one request made {len(calls)} rank calls for '
             f'{len(classes)} classes')
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err, worst_rel = 0.0, 0.0
    k_ms = p_ms = b_ms = bp_ms = 0.0
    bound_by = set()
    with torch.inference_mode():
        for (Z, wn, pad, freqs, V), unif, _ in calls:
            R, B, D = Z.shape
            f_zero = freqs.clone()
            f_zero[0] = 0.0
            # ties: every odd entry repeats the even one before it
            Zt = Z.clone()
            Zt[:, 1::2] = Zt[:, 0::2]
            w = torch.rand((R, B), generator=gen, device=dev) * (wn > 0)
            _, wn_r, pad_r = table_weights(w, cfg)
            variants = [
                ('served', Z, wn, pad, freqs, unif),
                ('served, uniform_w off', Z, wn, pad, freqs, False),
                ('ties, f=0', Zt, wn, pad, f_zero, unif),
                ('ties, f=0, random weights', Zt, wn_r.contiguous(),
                 pad_r.contiguous(), f_zero, False)]
            for label, z, a, p, f, u in variants:
                e, r = check_fwd(torch, f'B={B} R={R}, {label}',
                                 (z, a, p, f, V), u)
                max_err, worst_rel = max(max_err, e), max(worst_rel, r)
            km, kh = device_ms(torch, lambda: fsw_rank_aggregate_proj(
                Z, wn, pad, freqs, V, uniform_w=unif, with_dw=False), 20)
            pm, _ = device_ms(torch, lambda: fsw_rank_aggregate_proj_plain(
                Z, wn, pad, freqs, V, uniform_w=unif), 3)
            bm, by, bpm = rank_bound_ms(wn, D, V.shape[1])
            bound_by.add(by)
            k_ms, p_ms = k_ms + km, p_ms + pm
            b_ms, bp_ms = b_ms + bm, bp_ms + bpm
            print(f'  class B={B:3d} R={R:5d} ({int((wn > 0).sum())}'
                  f' real entries): kernel {km:.4f} ms (host {kh:.4f} ms a '
                  f'call), plain {pm:.4f} ms, bound {bm:.5f} ms ({by}), '
                  f'padded-shape bound {bpm:.5f} ms')
    errs['fsw_rank_fwdp'] = max(errs['fsw_rank_fwdp'], max_err)
    print(f'K1f check: ok, max abs err {max_err:.3e} (max '
          f'{worst_rel:.3e} of the output scale); per request: kernel '
          f'{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms, '
          f'padded-shape bound {bp_ms:.5f} ms', flush=True)

    # ---- 4. serving ----------------------------------------------------------
    sizes = np.random.default_rng(2).integers(MIN_NODES, N_NODES + 1,
                                              N_PREDICT + N_MANY)
    sizes[0] = N_NODES               # the request checked against the CPU
    reqs = [request(10 + i, int(n)) for i, n in enumerate(sizes)]
    seq, many = reqs[:N_PREDICT], reqs[N_PREDICT:]
    fsw_rank_aggregate_proj.launches = 0
    latencies, outs = [], []
    for ei, X in seq:
        t0 = time.perf_counter()
        outs.append(server.predict(ei, X))
        latencies.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    outs += server.predict_many(many, window=WINDOW)
    t_many = time.perf_counter() - t0
    launches = fsw_rank_aggregate_proj.launches
    n_req = len(reqs)
    if launches != len(classes) * n_req:
        fail(f'K1f launched {launches} times for {n_req} requests '
             f'of {len(classes)} classes')
    counts['fsw_rank_fwdp'] += launches
    for (ei, X), out in zip(reqs, outs):
        if out.shape != (X.shape[0], D_OUT) or not np.isfinite(out).all():
            fail(f'bad output for a {X.shape[0]}-node request')
    if server.fallbacks or server.uniform_w_fallbacks:
        fail('a request left the envelope')

    cpu_server = T.GraphServer(copy.deepcopy(model), N_NODES, MAX_EDGES,
                               classes=classes, class_rows=class_rows,
                               assume_uniform_w=True, device='cpu')
    want = cpu_server.predict(*seq[0])
    serve_err = float(np.abs(outs[0] - want).max())
    serve_scale = float(np.abs(want).max())
    if not serve_err <= SERVE_ATOL_REL * serve_scale:
        fail(f'served output differs from the CPU: max abs err '
             f'{serve_err:.3e}, scale {serve_scale:.3e}')
    edges_many = sum(ei.shape[1] for ei, _ in many)

    # where one full-size request's time goes: host build, copy, forward
    with torch.inference_mode():
        t0 = time.perf_counter()
        for _ in range(5):
            g = T.from_edge_index(seq[0][0], N_NODES, pad_to=MAX_EDGES)
            mt = T.to_multi_table(g, classes=classes, class_rows=class_rows)
            Xp = np.zeros((N_NODES, D_IN), np.float32)
            Xp[:] = seq[0][1]
            host, = server._pack(mt, Xp)
        host_ms = 1e3 * (time.perf_counter() - t0) / 5
        h2d_ms, _ = device_ms(
            torch, lambda: host.to(dev, non_blocking=True), 10)
        buf = host.to(dev)
        Xd = server._unpack_x(buf, server._li, server._lf)
        mtd = server._unpack(*server._split(buf, server._li, server._lf))
        fwd_ms, fwd_host_ms = device_ms(torch, lambda: model(Xd, mtd), 10)
    p50_ms = 1e3 * float(np.median(latencies))
    main = {
        'requests': n_req, 'launches': launches,
        'predict_samples': len(latencies),
        'p50_latency_ms': p50_ms,
        'p90_latency_ms': 1e3 * float(np.percentile(latencies, 90)),
        'predict_edges_per_s': (sum(ei.shape[1] for ei, _ in seq)
                                / sum(latencies)),
        'predict_many_requests_per_s': len(many) / t_many,
        'predict_many_edges_per_s': edges_many / t_many,
        'served_vs_cpu_max_abs_err': serve_err,
        'served_output_scale': serve_scale,
        'device_idle_share': 1.0 - fwd_ms / p50_ms,
        'breakdown_ms': {'host_build_and_pack': host_ms, 'h2d_copy': h2d_ms,
                         'forward_host_enqueue': fwd_host_ms,
                         'forward_device': fwd_ms,
                         'rank_kernels_device': k_ms},
    }
    print('serving: ' + json.dumps(main), flush=True)
    return calls, {'name': 'fsw_rank_fwdp', 'route': 'cuda',
            'source': 'fsw_gnn_tpu_torch/csrc/fsw_rank_fwdp.cu',
            'replaces': 'fsw_gnn_tpu/ops/fsw_rank_pallas.py:588',
            'ms': k_ms, 'plain_ms': p_ms,
            'bound_ms': b_ms,
            'bound_by': ('operations' if 'operations' in bound_by
                         else 'bytes'),
            'library_ms': None}


def close_to_cpu(torch, label, got, want, rtol, atol_rel):
    """Fail unless |got - want| <= atol_rel * max|want| + rtol * |want|;
    returns the largest error relative to max|want|."""
    got = got.detach().cpu()
    want = want.detach()
    err = (got - want).abs()
    scale = want.abs().max().item()
    if not (bool(torch.isfinite(got).all()) and bool(
            torch.all(err <= atol_rel * scale + rtol * want.abs()))):
        fail(f'{label} differs from the CPU: max abs err '
             f'{err.max().item():.3e}, scale {scale:.3e}')
    return err.max().item() / max(scale, 1e-30)


def bench_setup(torch, T, csr=False):
    """bench.py's graph, features and model: the 8192-node simple graph in
    the `multi` layout (with `csr`, the padded CSR Graph: 130925 edges
    padded to 130944), X ~ N(0, 1) from the same generator, FSWConv(64,
    64, mlp_layers=3) from seed 0; X and the slice vectors put on the
    dyadic grid (so the CPU ranks as the card does)."""
    ei, rng = simple_graph(0, N_NODES)
    X = torch.from_numpy(rng.standard_normal((N_NODES, D_IN))
                         .astype(np.float32))
    model = T.FSWConv(D_IN, D_OUT, mlp_layers=3,
                      minimize_slice_coherence=False, dtype=torch.float32,
                      device='cpu', generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        X, Vq = dyadic(X, model.fsw_embed.proj_vecs.t())
        model.fsw_embed.proj_vecs.copy_(Vq.t())
    graph = T.from_edge_index(ei, N_NODES)
    return model, X, graph if csr else T.to_multi_table(graph)


def check_rank_calls(torch, dev, calls, cfg, where, errs, all_variants):
    """K1f and K1b against their plain versions on captured rank calls, at
    the shapes the path gave them.  K1f on the arguments as passed; K1b on
    Z and V rounded to the dyadic grid (so both sides rank alike), in the
    path's variant and with with_dw on and random weights, and with
    `all_variants` also with uniform_w off and with ties and an f = 0
    slice."""
    from fsw_gnn_tpu_torch.embedding import table_weights
    gen = torch.Generator(device=dev).manual_seed(1)
    fwd = [0.0, 0.0]
    bwd = [0.0, 0.0]
    with torch.no_grad():
        for args, unif, dw in calls:
            R, B, D = args[0].shape
            S = args[4].shape[1]
            shape = f'{where}, B={B} R={R} D={D} S={S}'
            e = check_fwd(torch, f'{shape}, path', args, unif)
            fwd = [max(a, b) for a, b in zip(fwd, e)]
            Z, wn, pad, freqs, V = args
            Z, V = dyadic(Z, V)
            w = torch.rand((R, B), generator=gen, device=dev) * (wn > 0)
            _, wn_r, pad_r = table_weights(w, cfg)
            variants = [
                ('path', Z, wn, pad, freqs, unif, dw),
                ('with_dw, random weights', Z, wn_r.contiguous(),
                 pad_r.contiguous(), freqs, False, True)]
            if all_variants:
                f_zero = freqs.clone()
                f_zero[1] = 0.0
                Zt = Z.clone()
                Zt[:, 1::2] = Zt[:, 0::2]
                variants += [
                    ('uniform_w off', Z, wn, pad, freqs, False, dw),
                    ('ties, f=0', Zt, wn, pad, f_zero, unif, dw)]
            G = torch.randn((R, S), generator=gen, device=dev)
            for label, z, a, p, f, u, d in variants:
                e = check_bwd(torch, f'{shape}, {label}', (z, a, p, f, V), G,
                              u, d)
                bwd = [max(a, b) for a, b in zip(bwd, e)]
    errs['fsw_rank_fwdp'] = max(errs['fsw_rank_fwdp'], fwd[0])
    errs['fsw_rank_bwdp'] = max(errs['fsw_rank_bwdp'], bwd[0])
    print(f'{where}: K1f and K1b checked on {len(calls)} tables: ok; K1f max '
          f'abs err {fwd[0]:.3e} ({fwd[1]:.3e} of the output scale), K1b '
          f'{bwd[0]:.3e} ({bwd[1]:.3e} of an output\'s scale), '
          f'{len(variants)} variants', flush=True)


def bench_step(torch, T, dev, counts, errs):
    """Phases 5 and 6.  Returns the rank calls of one forward and the K1b
    entry's timing fields, and prints the step's numbers."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (fsw_rank_aggregate_proj,
                                                fsw_rank_aggregate_proj_bwd)
    cpu_model, X, graph = bench_setup(torch, T)
    model = copy.deepcopy(cpu_model).to(dev)
    Xd, gd = X.to(dev), graph.to(dev)
    with torch.no_grad():
        calls = capture_rank_calls(lambda: model(Xd, gd))
    check_rank_calls(torch, dev, calls, model.embed_cfg, 'bench graph', errs,
                     all_variants=True)
    n_classes = len(graph.tables)
    e_real = int(graph.num_edges)
    opt = torch.optim.SGD(model.parameters(), lr=STEP_LR)

    def loss_of(out):
        return (out * out).sum() / N_NODES

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model(Xd, gd))
        loss.backward()
        return loss.detach()

    fsw_rank_aggregate_proj.launches = 0
    fsw_rank_aggregate_proj_bwd.launches = 0
    losses = [step()]
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    opt.step()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(N_STEPS):
        losses.append(step())
        opt.step()
    b.record()
    b.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / N_STEPS
    event_ms = a.elapsed_time(b) / N_STEPS
    n_f, n_b = (fsw_rank_aggregate_proj.launches,
                fsw_rank_aggregate_proj_bwd.launches)
    want = n_classes * (N_STEPS + 1)
    if (n_f, n_b) != (want, want):
        fail(f'bench step: K1f launched {n_f}, K1b {n_b} times; expected '
             f'{want} each ({n_classes} classes x {N_STEPS + 1} steps)')
    counts['fsw_rank_fwdp'] += n_f
    counts['fsw_rank_bwdp'] += n_b
    losses = torch.stack(losses).cpu().numpy()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f'bench step: loss not finite and falling: {losses[0]} -> '
             f'{losses[-1]}')

    # the first step on the CPU, from the same parameters
    loss_of(cpu_model(X, graph)).backward()
    grad_err = {k: close_to_cpu(torch, f'bench step: gradient of {k}',
                                grads[k], p.grad, GRAD_RTOL, GRAD_ATOL_REL)
                for k, p in cpu_model.named_parameters()}

    parts = step_parts_ms(torch, lambda: model(Xd, gd), loss_of, opt)

    def full_step():
        step()
        opt.step()
    busy = traced_busy_ms(torch, full_step, 10)
    gen = torch.Generator(device=dev).manual_seed(2)
    kern, rows = time_rank_kernels(torch, calls, gen, plain_reps=3)
    res = {
        'steps': N_STEPS + 1, 'edges': e_real, 'classes': n_classes,
        'launches_k1f': n_f, 'launches_k1b': n_b,
        'loss_first': float(losses[0]), 'loss_last': float(losses[-1]),
        'step_ms_events': event_ms, 'step_ms_host_clock': wall_ms,
        'fwd_bwd_edges_per_s': e_real / (wall_ms * 1e-3),
        **parts,
        'device_idle_share': 1.0 - parts['step_device_ms'] / wall_ms,
        'step_device_busy_ms_trace': busy,
        'device_idle_share_trace': (None if busy is None
                                    else 1.0 - busy / wall_ms),
        'k1f_ms_per_step': kern['fwd'], 'k1b_ms_per_step': kern['bwd'],
        'k1f_plain_ms_per_step': kern['fwd_plain'],
        'k1b_plain_ms_per_step': kern['bwd_plain'],
        'k1b_bound_ms_per_step': kern['bwd_bound'],
        'first_step_grad_max_rel_err': max(grad_err.values()),
        'per_class': rows,
    }
    print('bench step: ' + json.dumps(res), flush=True)
    return calls, kern


def trainer_phase(torch, T, dev, counts, errs):
    """Phase 7: check the rank kernels on every table of the Trainer's
    path, fit the Trainer on the card, and print its numbers."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.data import load
    from fsw_gnn_tpu_torch.train import masked_softmax_cross_entropy
    data = load('cora')
    tr = T.Trainer(data, T.TrainConfig(
        hidden_dims=(64, 64), epochs=TRAIN_EPOCHS,
        eval_every=TRAIN_EVAL_EVERY), device=dev)
    # the initial loss of the same model on the CPU, in train mode
    cpu_model = copy.deepcopy(tr.model).to('cpu').train()
    with torch.no_grad():
        logits = cpu_model(torch.from_numpy(data.features),
                           T.auto_layout(tr.graph))
        s, c = masked_softmax_cross_entropy(
            logits, torch.from_numpy(data.labels).long(),
            torch.from_numpy(data.train_mask.astype(np.float32)))
        loss0_cpu = (s / max(c.item(), 1.0)).item()
    del cpu_model, logits

    n_layers = len(tr.model.convs)
    n_classes = len(tables_of(tr.compute_graph))
    # the rank kernels on every (layer, class) table, as one forward passes
    # it: K1 where the route takes the fused kernels, K2 where it takes the
    # unfused ones (layer 0's 2712-row class, D = 1433)
    tr.model.eval()
    run = lambda: tr.model(tr.X, tr.compute_graph)  # noqa: E731
    with torch.no_grad():
        calls = capture_rank_calls(run)
        calls2 = capture_rank_calls(run, 'fsw_rank_aggregate')
    if len(calls) + len(calls2) != n_layers * n_classes:
        fail(f'trainer: one forward made {len(calls)} K1 and {len(calls2)} '
             f'K2 calls for {n_layers} layers x {n_classes} classes')
    print(f'trainer: rank route per (layer, class): K1 on '
          f'{[tuple(a[0].shape) for a, _, _ in calls]}, K2 on '
          f'{[tuple(a[0].shape) for a, _, _ in calls2]}')
    check_rank_calls(torch, dev, calls, tr.model.convs[0].embed_cfg,
                     'trainer', errs, all_variants=False)
    check_rank2_calls(torch, dev, calls2, tr.model.convs[0].embed_cfg,
                      'trainer', errs, extra=False)

    names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_bwd',
             'fsw_rank_aggregate', 'fsw_rank_aggregate_bwd')
    for name in names:
        getattr(R, name).launches = 0
    out = tr.fit()
    torch.cuda.synchronize()
    n_f, n_b, n_f2, n_b2 = (getattr(R, name).launches for name in names)
    n_evals = TRAIN_EPOCHS // TRAIN_EVAL_EVERY + 1     # and the final one
    want = [len(c) * k for c in (calls, calls2)
            for k in (TRAIN_EPOCHS + n_evals, TRAIN_EPOCHS)]
    if [n_f, n_b, n_f2, n_b2] != want:
        fail(f'trainer: K1f, K1b, K2f, K2b launched {n_f}, {n_b}, {n_f2}, '
             f'{n_b2} times; expected {want}')
    counts['fsw_rank_fwdp'] += n_f
    counts['fsw_rank_bwdp'] += n_b
    counts['fsw_rank_fwd'] += n_f2
    counts['fsw_rank_bwd'] += n_b2
    losses = [h['loss'] for h in tr.history]
    if not abs(losses[0] - loss0_cpu) <= LOSS0_RTOL * abs(loss0_cpu):
        fail(f'trainer: initial loss {losses[0]} differs from the CPU '
             f'forward {loss0_cpu}')
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f'trainer: loss not finite and falling: {losses}')
    final = out['final']
    if not final['train_acc'] > TRAIN_ACC_MIN:
        fail(f'trainer: train accuracy {final["train_acc"]} <= '
             f'{TRAIN_ACC_MIN}')

    # one epoch's parts, and the rank kernels of every layer and class
    t0 = time.perf_counter()
    for _ in range(5):
        tr.train_epoch()
    epoch_ms = 1e3 * (time.perf_counter() - t0) / 5
    model, X, g = tr.model, tr.X, tr.compute_graph

    def loss_of(logits):
        s, c = masked_softmax_cross_entropy(logits, tr.labels, tr.train_mask)
        return s / torch.clamp(c, min=1.0)
    parts = step_parts_ms(torch, lambda: model(X, g, generator=tr.generator),
                          loss_of, tr.opt)
    gen = torch.Generator(device=dev).manual_seed(3)
    kern, rows = time_rank_kernels(torch, calls, gen, n=3)
    k2_ms, k2_rows = time_k2_calls(torch, calls2, gen)
    res = {
        'dataset': data.name, 'nodes': data.num_nodes,
        'features': int(data.features.shape[1]),
        'classes': data.num_classes, 'edges': int(tr.graph.num_edges),
        'layers': n_layers, 'degree_classes': n_classes,
        'launches_k1f': n_f, 'launches_k1b': n_b,
        'launches_k2f': n_f2, 'launches_k2b': n_b2,
        'epochs': out['epochs_run'],
        'seconds_per_epoch_fit': out['seconds'] / out['epochs_run'],
        'epoch_ms_train_only': epoch_ms,
        'loss_first': losses[0], 'loss_first_cpu': loss0_cpu,
        'loss_last': losses[-1], **{k: v for k, v in final.items()},
        **parts,
        'device_idle_share': 1.0 - parts['step_device_ms'] / epoch_ms,
        'k1f_ms_per_epoch': kern['fwd'], 'k1b_ms_per_epoch': kern['bwd'],
        'k2f_ms_per_epoch': k2_ms['fwd'], 'k2b_ms_per_epoch': k2_ms['bwd'],
        'k1b_bound_ms_per_epoch': kern['bwd_bound'],
        'k2f_bound_ms_per_epoch': k2_ms['fwd_bound'],
        'k2b_bound_ms_per_epoch': k2_ms['bwd_bound'],
        'k2_classes': k2_rows,
        'per_layer_class': rows,
    }
    print('trainer: ' + json.dumps(res), flush=True)


def check_rank2_calls(torch, dev, calls, cfg, where, errs, extra=True,
                      kind='K2'):
    """K2f and K2b (or with kind='K4' K4f and K4b) against their plain
    versions on captured calls, at the shapes the path gave them: the
    forward on the arguments as passed, the backward in the path's variant
    and with with_dw on and random weights, and with `extra` also with
    uniform_w off and with ties and an f = 0 slice (K4: an f = 0 column)."""
    from fsw_gnn_tpu_torch.embedding import table_weights
    names = {'K2': ('fsw_rank_fwd', 'fsw_rank_bwd'),
             'K4': ('fsw_rank_cart_fwd', 'fsw_rank_cart_bwd')}[kind]
    gen = torch.Generator(device=dev).manual_seed(5)
    fwd = [0.0, 0.0]
    bwd = [0.0, 0.0]
    with torch.no_grad():
        for args, unif, dw in calls:
            P, wn, pad, freqs = args
            R, B, S = P.shape
            shape = f'{where}, B={B} R={R} S={S}'
            e = check_fwd(torch, f'{shape}, path', args, unif, kind)
            fwd = [max(a, b) for a, b in zip(fwd, e)]
            check_fwd_padding(torch, f'{shape}, path', args, unif, kind)
            w = torch.rand((R, B), generator=gen, device=dev) * (wn > 0)
            _, wn_r, pad_r = table_weights(w, cfg)
            variants = [('path', P, wn, pad, freqs, unif, dw),
                        ('with_dw, random weights', P, wn_r.contiguous(),
                         pad_r.contiguous(), freqs, False, True)]
            if extra:
                f_zero = freqs.clone()
                if kind == 'K4':
                    f_zero[:, 1 % freqs.shape[1]] = 0.0
                else:
                    f_zero[1 % S] = 0.0
                Pt = P.clone()
                Pt[:, 1::2] = Pt[:, 0:B - 1:2]
                variants += [('uniform_w off', P, wn, pad, freqs, False, dw),
                             ('ties, f=0', Pt, wn, pad, f_zero, unif, dw)]
            G = torch.randn((R,) + tuple(freqs.shape), generator=gen,
                            device=dev)
            for label, p_, a, pd, f, u, d in variants:
                if label == 'ties, f=0':
                    e = check_fwd(torch, f'{shape}, {label}', (p_, a, pd, f),
                                  u, kind)
                    fwd = [max(x, y) for x, y in zip(fwd, e)]
                e = check_bwd(torch, f'{shape}, {label}', (p_, a, pd, f), G,
                              u, d, kind)
                bwd = [max(x, y) for x, y in zip(bwd, e)]
            del variants
    errs[names[0]] = max(errs[names[0]], fwd[0])
    errs[names[1]] = max(errs[names[1]], bwd[0])
    print(f'{where}: {kind}f and {kind}b checked on {len(calls)} calls: ok; '
          f'{kind}f max abs err {fwd[0]:.3e} ({fwd[1]:.3e} of the output '
          f'scale), the same bits with NaN at the padding and on a second '
          f'call; {kind}b {bwd[0]:.3e} ({bwd[1]:.3e} of an output\'s '
          f'scale)', flush=True)


def multiset_setup(torch, T, dev, cfg=None):
    """The reference demo's FSWEmbedding (d = 20, n = 100, 1000 slices,
    random frequencies; `examples/demo_fsw_embedding.py`; or `cfg`) from
    seed 0 on a batch of 8 x 16 x 16 = 2048 multisets: X ~ N(0, 1), W a
    softmax of N(0, 1) values, a N(0, 1) cotangent.  X and the slice
    vectors are put on the dyadic grid (so the CPU ranks as the card does)
    and W on multiples of 2^-20 (so both sum it exactly: the random
    frequencies reach about 2400, and the phase pi f (2c - w) turns one
    ulp of c into about 1e-3 of the output's scale)."""
    cfg = cfg or T.FSWConfig(d_in=MS_D, d_out=MS_S)
    model = T.FSWEmbedding(cfg, device='cpu',
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal(MS_LEAD + (MS_N, MS_D))
                         .astype(np.float32))
    W = torch.softmax(torch.from_numpy(rng.standard_normal(
        MS_LEAD + (MS_N,)).astype(np.float32)), dim=-1)
    # multiples of 2^-20 below 1: every partial sum of a multiset's weights
    # is exact in float32, so the card and the CPU normalize alike
    W = torch.round(W * 2.0 ** 20) / 2.0 ** 20
    out_shape = ((cfg.nSlices, cfg.nFreqs)
                 if cfg.cartesian_mode and not cfg.collapse_freqs
                 else (cfg.out_dim,))
    G = torch.from_numpy(rng.standard_normal(MS_LEAD + out_shape)
                         .astype(np.float32))
    with torch.no_grad():
        X, Vq = dyadic(X.to(dev), model.proj_vecs.t().to(dev))
        model.proj_vecs.copy_(Vq.t().cpu())
    return model, X.cpu(), W, G


def multiset_phase(torch, T, dev, counts, errs):
    """Phase 8: FSWEmbedding on dense multisets at the demo's widths.
    Returns the K2 entries' timing fields."""
    from fsw_gnn_tpu_torch.embedding import (
        RANK_AGGREGATE_MAX_BUCKET_NO_DW, _resolve_aggregate, bucket_quadrature)
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    cpu_model, X, W, G = multiset_setup(torch, T, dev)
    model = copy.deepcopy(cpu_model).to(dev)
    cfg = model.cfg
    if _resolve_aggregate('auto', cfg, MS_N) != 'rank':
        fail(f"multisets: 'auto' does not take K2 at n = {MS_N}")
    Xd, Wd, Gd = X.to(dev), W.to(dev), G.to(dev)
    n_sets = int(np.prod(MS_LEAD))

    # K2f and K2b on the arguments the route passes, in four variants
    gen = torch.Generator(device=dev).manual_seed(6)
    checked = {}
    for label, run in (
            ('W given (the path)', lambda: model(Xd, Wd)),
            ("W=None, w_mode='unit'", lambda: model(Xd, w_mode='unit')),
            ("W=None, w_mode='uniform'", lambda: model(Xd,
                                                       w_mode='uniform')),
            ('mass 0.5 < threshold', lambda: model(Xd, 0.5 * Wd))):
        with torch.no_grad():
            calls = capture_rank_calls(run, 'fsw_rank_aggregate')
        if len(calls) != 1:
            fail(f'multisets ({label}): {len(calls)} K2 calls, expected 1')
        (args, unif, dw), = calls
        if args[0].shape != (n_sets, MS_N, MS_S):
            fail(f'multisets ({label}): K2 saw {tuple(args[0].shape)}')
        if label.startswith('mass') and not bool((args[2] > 0).all()):
            fail('multisets: the light batch has no phantom mass')
        check_rank2_calls(torch, dev, calls, cfg, f'multisets, {label}', errs,
                          extra=label.startswith('W given'))
        checked[label] = (unif, dw)
        if label.startswith('W given'):
            path_args, path_unif, path_dw = args, unif, dw
        del calls, args
    if checked["W=None, w_mode='unit'"] != (True, False):
        fail('multisets: W=None did not run K2 with uniform_w, without dw')

    # the main path: forward and backward through the module, counted
    Xg = Xd.clone().requires_grad_(True)
    Wg = Wd.clone().requires_grad_(True)
    R.fsw_rank_aggregate.launches = 0
    R.fsw_rank_aggregate_bwd.launches = 0
    out = model(Xg, Wg)
    (out * Gd).sum().backward()
    torch.cuda.synchronize()
    n_f, n_b = R.fsw_rank_aggregate.launches, R.fsw_rank_aggregate_bwd.launches
    if (n_f, n_b) != (1, 1):
        fail(f'multisets: K2f launched {n_f}, K2b {n_b} times; expected 1 '
             f'each')
    counts['fsw_rank_fwd'] += n_f
    counts['fsw_rank_bwd'] += n_b
    if out.shape != MS_LEAD + (MS_S,):
        fail(f'multisets: output shape {tuple(out.shape)}')

    # the first 128 multisets through the same module on the CPU
    k = MS_CPU_SETS
    Xc = X.reshape(-1, MS_N, MS_D)[:k].clone().requires_grad_(True)
    Wc = W.reshape(-1, MS_N)[:k].clone().requires_grad_(True)
    out_c = cpu_model(Xc, Wc)
    (out_c * G.reshape(-1, MS_S)[:k]).sum().backward()
    cpu_err = {
        'out': close_to_cpu(torch, 'multisets: output',
                            out.reshape(-1, MS_S)[:k], out_c, GRAD_RTOL,
                            SERVE_ATOL_REL),
        'grad_X': close_to_cpu(torch, 'multisets: gradient of X',
                               Xg.grad.reshape(-1, MS_N, MS_D)[:k], Xc.grad,
                               GRAD_RTOL, GRAD_ATOL_REL),
        'grad_W': close_to_cpu(torch, 'multisets: gradient of W',
                               Wg.grad.reshape(-1, MS_N)[:k], Wc.grad,
                               GRAD_RTOL, GRAD_ATOL_REL)}
    del out, Xg, Wg

    # times at the path's shape: the kernels, their plain versions, the
    # sort route, the whole forward and backward
    P, wn, pad, freqs = path_args
    G2 = Gd.reshape(-1, MS_S).contiguous()
    with torch.no_grad():
        t = {}
        t['k2f_ms'], _ = device_ms(torch, lambda: R.fsw_rank_aggregate(
            *path_args, uniform_w=path_unif, with_dw=path_dw), 10)
        t['k2b_ms'], _ = device_ms(torch, lambda: R.fsw_rank_aggregate_bwd(
            *path_args, G2, uniform_w=path_unif, with_dw=path_dw), 5)
        # without the weight gradient: a third of the shared memory a
        # block, so more blocks resident on an SM
        t['k2b_no_dw_ms'], _ = device_ms(
            torch, lambda: R.fsw_rank_aggregate_bwd(
                *path_args, G2, uniform_w=path_unif, with_dw=False), 5)
        t['k2f_plain_ms'], _ = device_ms(
            torch, lambda: R.fsw_rank_aggregate_plain(
                *path_args, uniform_w=path_unif), 2, 2)
        t['k2b_plain_ms'], _ = device_ms(
            torch, lambda: R.fsw_rank_aggregate_bwd_plain(
                *path_args, G2, uniform_w=path_unif, with_dw=path_dw), 1, 2)
        t['sort_fwd_ms'], _ = device_ms(torch, lambda: bucket_quadrature(
            P, wn, pad, freqs, cfg, 'sort'), 5)

    def fwd_bwd(agg, args=(P, wn, pad)):
        leaves = [a.detach().requires_grad_(True) for a in args]
        o = bucket_quadrature(*leaves, freqs, cfg, agg)
        o.backward(G2)
    t['sort_fwd_bwd_ms'], _ = device_ms(torch, lambda: fwd_bwd('sort'), 3)
    t['rank_fwd_bwd_ms'], _ = device_ms(torch, lambda: fwd_bwd('rank'), 3)
    # the same at the widest multiset 'auto' sends to K2, with weight
    # gradients: normal projections, softmax weights
    gen = torch.Generator(device=dev).manual_seed(7)
    n_cap = RANK_AGGREGATE_MAX_BUCKET_NO_DW
    cap = (torch.randn((n_sets, n_cap, MS_S), generator=gen, device=dev),
           torch.softmax(torch.randn((n_sets, n_cap), generator=gen,
                                     device=dev), dim=-1),
           torch.zeros((n_sets,), device=dev))
    t['cap_n'] = n_cap
    t['cap_sort_fwd_bwd_ms'], _ = device_ms(
        torch, lambda: fwd_bwd('sort', cap), 3)
    t['cap_rank_fwd_bwd_ms'], _ = device_ms(
        torch, lambda: fwd_bwd('rank', cap), 3)
    del cap
    with torch.no_grad():
        t['forward_ms'], t['forward_host_ms'] = device_ms(
            torch, lambda: model(Xd, Wd), 5)

    def module_fwd_bwd():
        Xq = Xd.detach().requires_grad_(True)
        Wq = Wd.detach().requires_grad_(True)
        (model(Xq, Wq) * Gd).sum().backward()
    t['forward_backward_ms'], t['forward_backward_host_ms'] = device_ms(
        torch, module_fwd_bwd, 3)
    t['k2f_bound_ms'], t['k2f_bound_by'] = rank2_bound_ms(wn, MS_S)
    t['k2b_bound_ms'], t['k2b_bound_by'] = rank2_bound_ms(
        wn, MS_S, bwd=True, with_dw=path_dw)
    t['k2b_no_dw_bound_ms'], _ = rank2_bound_ms(wn, MS_S, bwd=True)
    res = {'multisets': n_sets, 'n': MS_N, 'd': MS_D, 'slices': MS_S,
           'P_bytes': 4 * P.numel(), 'launches_k2f': n_f,
           'launches_k2b': n_b, 'k2b_with_dw': path_dw,
           'cpu_sets': k, 'cpu_max_rel_err': cpu_err, **t}
    print('multisets: ' + json.dumps(res), flush=True)
    del path_args, P, wn, pad, freqs
    torch.cuda.empty_cache()
    return t


def table_k2_phase(torch, T, dev, counts, errs):
    """Phase 9: the bench FSWConv on the bench graph with slice_chunk =
    64 = d_in, so the fused route does not apply and every class runs K2
    on gathered projections, forward and backward; checked against the
    CPU and K2 held against its plain version on the captured calls."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    cpu_model, X, graph = bench_setup(torch, T)
    model = copy.deepcopy(cpu_model).to(dev)
    Xd, gd = X.to(dev), graph.to(dev)
    n_classes = len(graph.tables)
    n_chunks = -(-model.embed_cfg.nSlices // TABLE_CHUNK)
    fused = []
    with torch.no_grad():
        calls = capture_rank_calls(lambda: fused.extend(capture_rank_calls(
            lambda: model(Xd, gd, slice_chunk=TABLE_CHUNK))),
            'fsw_rank_aggregate')
    if fused or len(calls) != n_classes * n_chunks:
        fail(f'table K2: {len(calls)} K2 and {len(fused)} K1 calls for '
             f'{n_classes} classes x {n_chunks} chunks')
    check_rank2_calls(torch, dev, calls, model.embed_cfg, 'bench graph, K2',
                      errs)

    def loss_of(out):
        return (out * out).sum() / N_NODES
    R.fsw_rank_aggregate.launches = 0
    R.fsw_rank_aggregate_bwd.launches = 0
    out = model(Xd, gd, slice_chunk=TABLE_CHUNK)
    loss_of(out).backward()
    torch.cuda.synchronize()
    n_f, n_b = R.fsw_rank_aggregate.launches, R.fsw_rank_aggregate_bwd.launches
    want = n_classes * n_chunks
    if (n_f, n_b) != (want, want):
        fail(f'table K2: K2f launched {n_f}, K2b {n_b} times; expected '
             f'{want} each ({n_classes} classes x {n_chunks} chunks)')
    counts['fsw_rank_fwd'] += n_f
    counts['fsw_rank_bwd'] += n_b
    out_c = cpu_model(X, graph, slice_chunk=TABLE_CHUNK)
    loss_of(out_c).backward()
    err = {'out': close_to_cpu(torch, 'table K2: output', out, out_c,
                               GRAD_RTOL, SERVE_ATOL_REL)}
    for (k, p), q in zip(cpu_model.named_parameters(), model.parameters()):
        err[k] = close_to_cpu(torch, f'table K2: gradient of {k}', q.grad,
                              p.grad, GRAD_RTOL, GRAD_ATOL_REL)
    with torch.no_grad():
        fwd_ms, _ = device_ms(
            torch, lambda: model(Xd, gd, slice_chunk=TABLE_CHUNK), 5)
        # K2f and K2b on each captured (class, chunk) call, summed: the
        # per-launch time of this path's K2 launches
        gen = torch.Generator(device=dev).manual_seed(9)
        k2 = dict.fromkeys(('k2f_ms', 'k2b_ms', 'k2f_bound_ms',
                            'k2b_bound_ms'), 0.0)
        for args, unif, dw in calls:
            G = torch.randn(args[0].shape[::2], generator=gen, device=dev)
            k2['k2f_ms'] += device_ms(torch, lambda: R.fsw_rank_aggregate(
                *args, uniform_w=unif, with_dw=dw), 10)[0]
            k2['k2b_ms'] += device_ms(torch, lambda: R.fsw_rank_aggregate_bwd(
                *args, G, uniform_w=unif, with_dw=dw), 10)[0]
            S = args[0].shape[2]
            k2['k2f_bound_ms'] += rank2_bound_ms(args[1], S)[0]
            k2['k2b_bound_ms'] += rank2_bound_ms(args[1], S, bwd=True,
                                                 with_dw=dw)[0]
    res = {'classes': n_classes, 'chunks': n_chunks, 'launches_k2f': n_f,
           'launches_k2b': n_b, 'forward_ms': fwd_ms,
           'k2f_ms_per_forward': k2['k2f_ms'],
           'k2b_ms_per_backward': k2['k2b_ms'],
           'k2f_bound_ms_per_forward': k2['k2f_bound_ms'],
           'k2b_bound_ms_per_backward': k2['k2b_bound_ms'],
           'cpu_max_rel_err': err}
    print('table K2: ' + json.dumps(res), flush=True)


def hub_phase(torch, T, dev, counts):
    """Phase 10: FSWConv(64, 64, mlp_layers=3) on the 2000-node graph
    whose node 0 has 1024 in-edges, forward and backward: classes wider
    than 128 take the sort route (no rank call sees them), and the output
    and gradients match the CPU."""
    from fsw_gnn_tpu_torch.embedding import RANK_AGGREGATE_MAX_BUCKET_NO_DW
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    ei, rng = hub_graph(0, HUB_NODES, HUB_IN)
    layout = T.auto_layout(T.from_edge_index(ei, HUB_NODES))
    widths = [t.bucket_size for t in tables_of(layout)]
    narrow = sum(w <= RANK_AGGREGATE_MAX_BUCKET_NO_DW for w in widths)
    if max(widths) <= RANK_AGGREGATE_MAX_BUCKET_NO_DW:
        fail(f'hub graph: no class wider than 128 ({widths})')
    X = torch.from_numpy(rng.standard_normal((HUB_NODES, D_IN))
                         .astype(np.float32))
    cpu_model = T.FSWConv(D_IN, D_OUT, mlp_layers=3,
                          minimize_slice_coherence=False, device='cpu',
                          generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        X, Vq = dyadic(X, cpu_model.fsw_embed.proj_vecs.t())
        cpu_model.fsw_embed.proj_vecs.copy_(Vq.t())
    model = copy.deepcopy(cpu_model).to(dev)
    Xd, ld = X.to(dev), layout.to(dev)

    def loss_of(out):
        return (out * out).sum() / HUB_NODES
    names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate_bwd',
             'fsw_rank_aggregate', 'fsw_rank_aggregate_proj_bwd')
    for name in names:
        getattr(R, name).launches = 0
    unfused, outs = [], []

    def run():
        outs.append(model(Xd, ld))
        loss_of(outs[0]).backward()
    fused = capture_rank_calls(lambda: unfused.extend(capture_rank_calls(
        run, 'fsw_rank_aggregate')))
    torch.cuda.synchronize()
    launches = {n: getattr(R, n).launches for n in names}
    seen = [c[0][0].shape[1] for c in fused + unfused]
    if max(seen) > RANK_AGGREGATE_MAX_BUCKET_NO_DW or len(seen) != narrow:
        fail(f'hub graph: rank calls at widths {seen}, classes {widths}')
    if (launches['fsw_rank_aggregate_proj'], launches[
            'fsw_rank_aggregate_proj_bwd']) != (narrow, narrow):
        fail(f'hub graph: launches {launches}, {narrow} narrow classes')
    counts['fsw_rank_fwdp'] += launches['fsw_rank_aggregate_proj']
    counts['fsw_rank_bwdp'] += launches['fsw_rank_aggregate_proj_bwd']
    out_c = cpu_model(X, layout)
    loss_of(out_c).backward()
    err = {'out': close_to_cpu(torch, 'hub graph: output', outs[0], out_c,
                               GRAD_RTOL, SERVE_ATOL_REL)}
    for (k, p), q in zip(cpu_model.named_parameters(), model.parameters()):
        err[k] = close_to_cpu(torch, f'hub graph: gradient of {k}', q.grad,
                              p.grad, GRAD_RTOL, GRAD_ATOL_REL)
    res = {'nodes': HUB_NODES, 'edges': int(ei.shape[1]),
           'class_widths': widths, 'rank_call_widths': seen,
           'launches': launches, 'cpu_max_rel_err': err}
    print('hub graph: ' + json.dumps(res), flush=True)


def k3_within(torch, label, got, want, prefix, dtype):
    """Fail unless |got - want| <= K3_ULPS eps (prefix) per element, where
    `prefix` is the segmented prefix of |v| each element sums (float64);
    returns the largest absolute error."""
    err = (got.double() - want.double()).abs()
    eps = torch.finfo(dtype).eps
    if not (bool(torch.isfinite(got).all())
            and bool(torch.all(err <= K3_ULPS * eps * prefix))):
        worst = float((err / (eps * prefix).clamp(min=1e-300)).max())
        fail(f'K3 disagrees with its plain version ({label}): max abs err '
             f'{err.max().item():.3e}, {worst:.2f} eps of the prefix')
    return err.max().item()


def check_k3(torch, label, values, kw):
    """K3 against its plain version on one input: flat values (n,) with
    `kw` segment_ids= or boundaries=, or the row form's values (rows, m)
    with boundaries= (m,); returns the largest absolute error."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum, segcumsum_plain,
                                                 segcumsum_rows,
                                                 segcumsum_rows_plain)
    with torch.no_grad():
        if values.dim() == 2:
            mask = kw['boundaries']
            got = segcumsum_rows(values, mask)
            torch.cuda.synchronize()
            want = segcumsum_rows_plain(values, mask)
            prefix = segcumsum_rows_plain(values.abs().double(), mask)
        else:
            got = segcumsum(values, **kw)
            torch.cuda.synchronize()
            want = segcumsum_plain(values, **kw)
            prefix = segcumsum_plain(values.abs().double(), **kw)
        return k3_within(torch, label, got, want, prefix, values.dtype)


def check_k3_bwd(torch, label, values, mask, g):
    """K3's backward in the row form (the reverse segmented cumsum of the
    cotangent g (rows, m), one launch) against autograd through the plain
    version, on the card; returns the largest absolute error."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum_rows,
                                                 segcumsum_rows_plain)
    grads = []
    for fn in (segcumsum_rows, segcumsum_rows_plain):
        v = values.detach().clone().requires_grad_(True)
        fn(v, mask).backward(g)
        grads.append(v.grad)
    torch.cuda.synchronize()
    with torch.no_grad():
        suffix = segcumsum_rows_plain(g.abs().double(), mask, reverse=True)
    return k3_within(torch, label, grads[0], grads[1], suffix, values.dtype)


def k3_bytes(n, dtype_bytes, by, m=None):
    """Bytes K3 must move for n values: the values read and the output
    written, and the segment structure read once, m ids (4 bytes) or m
    mask bytes.  The flat form has m = n; the rows of the row form share
    one mask of m entries, read once however many rows it serves (the
    tiles of later rows find it in L2), so it counts once."""
    return n * 2 * dtype_bytes + (n if m is None else m) * (
        4 if by == 'ids' else 1)


def k3_phase(torch, dev, errs):
    """Phase 11: K3 alone on 2^24 normal values, against its plain version
    with the ids and with the mask, timed beside its bound and torch's
    unsegmented cumsum of the same array; the reverse scan (the backward's)
    with the mask timed too."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (_run, segcumsum,
                                                 segcumsum_plain,
                                                 segment_boundaries)
    gen = torch.Generator(device=dev).manual_seed(11)
    n = K3_N
    rows = []
    for label, avg, dt in K3_CASES:
        dtype = getattr(torch, dt)
        v = torch.randn(n, generator=gen, device=dev, dtype=dtype)
        if avg == 1:
            ids = torch.arange(n, device=dev, dtype=torch.int32)
        else:
            ids = torch.sort(torch.randint(0, n // avg, (n,), generator=gen,
                                           device=dev)).values.int()
        row = {'case': label, 'n': n, 'dtype': dt,
               'max_segment': int(torch.bincount(ids).max())}
        for by, kw in (('ids', dict(segment_ids=ids)),
                       ('mask', dict(boundaries=segment_boundaries(ids)))):
            e = check_k3(torch, f'{label}, {by}', v, kw)
            errs['segcumsum'] = max(errs['segcumsum'], e)
            ms, _ = device_ms(torch, lambda: segcumsum(v, **kw), 20)
            nbytes = k3_bytes(n, v.element_size(), by)
            row[f'{by}_ms'] = ms
            row[f'{by}_GB_per_s'] = nbytes / ms / 1e6
            row[f'{by}_bound_ms'] = 1e3 * nbytes / PEAK_BYTES
            row[f'{by}_max_abs_err'] = e
        row['mask_reverse_ms'], _ = device_ms(
            torch, lambda: _run(v[None], None, kw['boundaries'], True), 20)
        row['plain_ms'], _ = device_ms(
            torch, lambda: segcumsum_plain(v, ids), 2, 2)
        row['torch_cumsum_ms'], _ = device_ms(
            torch, lambda: torch.cumsum(v, 0), 20)
        rows.append(row)
        del v, ids
        print('K3: ' + json.dumps(row), flush=True)
    return rows


def backward_kernels(torch, forward):
    """([[name, ms, calls]] of every kernel and copy on the card in a
    torch.profiler trace of one backward of forward()'s result, costliest
    first, names cut to 90 characters; and the kernels and host ops among
    them that add by scattering (SCATTER_KERNELS, SCATTER_OPS)).  Fails
    where the trace holds no device activity."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    loss = forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    us, calls, bad = defaultdict(float), defaultdict(int), set()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name[:90]] += e.time_range.elapsed_us()
            calls[e.name[:90]] += 1
            if any(k in e.name for k in SCATTER_KERNELS):
                bad.add(e.name[:90])
        elif e.name in SCATTER_OPS:
            bad.add(e.name)
    if not us:
        fail('the backward\'s trace holds no device activity')
    rows = sorted(us.items(), key=lambda kv: -kv[1])
    return [[k, v / 1e3, calls[k]] for k, v in rows], sorted(bad)


def capture_k3_calls(run, cotangents=False):
    """Run `run()` with the CSR path's K3 entry point, the row form
    (`fsw_gnn_tpu_torch.embedding.segcumsum_rows`), wrapped; return one
    record per call: detached copies of its values (rows, m) and its mask
    (m,) and, with `cotangents`, of the cotangent its output receives in
    the backward."""
    from fsw_gnn_tpu_torch import embedding
    real = embedding.segcumsum_rows
    calls = []

    def spy(values, boundaries):
        out = real(values, boundaries)
        rec = {'values': values.detach().clone(), 'mask': boundaries}
        if cotangents and out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__('cotangent',
                                                        g.detach().clone()))
        calls.append(rec)
        return out
    embedding.segcumsum_rows = spy
    try:
        run()
    finally:
        embedding.segcumsum_rows = real
    return calls


def check_dyadic_conv(torch, T, dev, label, ei, n, X, cpu_model, graph_of,
                      weight_grad=False):
    """Forward and backward of an FSWConv on a CSR graph on the card and on
    the CPU, from the same parameters, X and the slice vectors on the
    dyadic grid; outputs and gradients within 1e-4 of each scale (and the
    edge weights' gradient with `weight_grad`).  Returns the K3 launches
    on the card and the largest error relative to a scale."""
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    with torch.no_grad():
        X, Vq = dyadic(X, cpu_model.fsw_embed.proj_vecs.t())
        cpu_model.fsw_embed.proj_vecs.copy_(Vq.t())
    model = copy.deepcopy(cpu_model).to(dev)
    res = []
    for m, d in ((model, dev), (cpu_model, torch.device('cpu'))):
        g = graph_of().to(d)
        if weight_grad:
            g.weight = g.weight.clone().requires_grad_(True)
        segcumsum.launches = 0
        out = m(X.to(d), g)
        ((out * out).sum() / n).backward()
        if d.type == 'cuda':
            torch.cuda.synchronize()
        res.append(([out] + ([g.weight.grad] if weight_grad else []),
                    segcumsum.launches))
    err = {}
    for i, (a, b) in enumerate(zip(res[0][0], res[1][0])):
        err['out' if i == 0 else 'grad_weight'] = close_to_cpu(
            torch, f'{label}: output' if i == 0 else f'{label}: gradient of '
            f'the edge weights', a, b, GRAD_RTOL, SERVE_ATOL_REL)
    for (k, p), q in zip(cpu_model.named_parameters(), model.parameters()):
        err[k] = close_to_cpu(torch, f'{label}: gradient of {k}', q.grad,
                              p.grad, GRAD_RTOL, GRAD_ATOL_REL)
    return res[0][1], max(err.values())


def csr_conv_phase(torch, T, dev, counts, errs):
    """Phases 12 and 13: the bench FSWConv on the bench graph as a CSR
    Graph: K3 once a forward (the row form on S x E), held against its
    plain version on the captured call; forward and forward + backward
    timed beside the `multi` layout; output and gradients against the CPU
    on an 8192-node graph of in-degree 16; then one gradient of the edge
    weights (K3's backward, one reverse launch) against the plain version,
    timed, and a trace of it that must hold no flip and two K3 launches a
    forward and backward.  Returns K3's entry fields."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (_run, segcumsum,
                                                 segcumsum_rows,
                                                 segcumsum_rows_plain)
    cpu_model, X, graph = bench_setup(torch, T, csr=True)
    model = copy.deepcopy(cpu_model).to(dev)
    Xd, gd = X.to(dev), graph.to(dev)
    md = T.to_multi_table(graph).to(dev)
    S, E = model.embed_cfg.nSlices, graph.padded_num_edges
    with torch.no_grad():
        calls = capture_k3_calls(lambda: model(Xd, gd))
    if len(calls) != 1 or calls[0]['values'].shape != (S, E):
        fail(f'CSR conv: K3 calls {[c["values"].shape for c in calls]}, '
             f'expected one of {S} x {E}')
    vals, mask = calls[0]['values'], calls[0]['mask']
    e = check_k3(torch, 'CSR conv, captured', vals, dict(boundaries=mask))
    errs['segcumsum'] = max(errs['segcumsum'], e)

    def loss_of(out):
        return (out * out).sum() / N_NODES
    segcumsum.launches = 0
    loss_of(model(Xd, gd)).backward()
    torch.cuda.synchronize()
    if segcumsum.launches != 1:
        fail(f'CSR conv: K3 launched {segcumsum.launches} times in one '
             f'forward and backward, expected 1')
    counts['segcumsum'] += segcumsum.launches

    t = {}
    with torch.no_grad():
        t['k3_ms'], _ = device_ms(
            torch, lambda: segcumsum_rows(vals, mask), 20)
        t['k3_plain_ms'], _ = device_ms(
            torch, lambda: segcumsum_rows_plain(vals, mask), 2, 2)
        t['torch_cumsum_ms'], _ = device_ms(
            torch, lambda: torch.cumsum(vals, 1), 20)
        for name, lay in (('csr', gd), ('multi', md)):
            t[f'{name}_forward_ms'], t[f'{name}_forward_host_ms'] = \
                device_ms(torch, lambda: model(Xd, lay), 5)

    for name, lay in (('csr', gd), ('multi', md)):
        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            loss_of(model(Xd, lay)).backward()
        t[f'{name}_fwd_bwd_ms'], _ = device_ms(torch, fwd_bwd, 3)
    with torch.no_grad():
        t['csr_forward_busy_ms'], t['csr_forward_top'] = traced_top_kernels(
            torch, lambda: model(Xd, gd), 5)

    def fwd_bwd_csr():
        model.zero_grad(set_to_none=True)
        loss_of(model(Xd, gd)).backward()
    t['csr_fwd_bwd_busy_ms'], t['csr_fwd_bwd_top'] = traced_top_kernels(
        torch, fwd_bwd_csr, 3)
    e_real = graph.num_edges
    for name in ('csr', 'multi'):
        t[f'{name}_fwd_edges_per_s'] = e_real / (t[f'{name}_forward_ms']
                                                 * 1e-3)
        t[f'{name}_fwd_bwd_edges_per_s'] = e_real / (
            t[f'{name}_fwd_bwd_ms'] * 1e-3)
    t['k3_bound_ms'] = 1e3 * k3_bytes(S * E, 4, 'mask', m=E) / PEAK_BYTES

    # the CPU check: a graph of the same size whose in-degrees are all 16
    ei = regular_graph(3, N_NODES, CSR_CHECK_DEG)
    Xc = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (N_NODES, D_IN)).astype(np.float32))
    n_k3, cpu_err = check_dyadic_conv(
        torch, T, dev, 'CSR conv', ei, N_NODES, Xc,
        T.FSWConv(D_IN, D_OUT, mlp_layers=3, minimize_slice_coherence=False,
                  device='cpu', generator=torch.Generator().manual_seed(0)),
        lambda: T.from_edge_index(ei, N_NODES), weight_grad=True)
    if n_k3 != 2:
        fail(f'CSR conv: K3 launched {n_k3} times with the edge weights\' '
             f'gradient, expected 2')
    counts['segcumsum'] += n_k3

    # 13. K3's backward on the bench graph: one gradient of the edge weights
    gw = graph.to(dev)
    gw.weight = gw.weight.clone().requires_grad_(True)
    segcumsum.launches = 0
    calls = capture_k3_calls(lambda: loss_of(model(Xd, gw)).backward(),
                             cotangents=True)
    torch.cuda.synchronize()
    if segcumsum.launches != 2 or 'cotangent' not in calls[0]:
        fail(f'K3 backward: {segcumsum.launches} launches, expected 2')
    counts['segcumsum'] += segcumsum.launches
    cot = calls[0]['cotangent']
    e_b = check_k3_bwd(torch, 'backward, bench graph', calls[0]['values'],
                       calls[0]['mask'], cot)
    errs['segcumsum'] = max(errs['segcumsum'], e_b)
    if not bool(torch.isfinite(gw.weight.grad).all()):
        fail('K3 backward: the edge weights\' gradient is not finite')
    with torch.no_grad():
        t['k3_reverse_ms'], _ = device_ms(
            torch, lambda: _run(cot, None, calls[0]['mask'], True), 20)

    def fwd_bwd_weight():
        model.zero_grad(set_to_none=True)
        gw.weight.grad = None
        loss_of(model(Xd, gw)).backward()
    t['csr_weight_fwd_bwd_ms'], _ = device_ms(torch, fwd_bwd_weight, 3)
    busy, kern = traced_top_kernels(torch, fwd_bwd_weight, 3, top=10 ** 6)
    flips = [k for k in kern if 'flip' in k[0].lower()]
    k3_traced = sum(k[2] for k in kern if 'scan_kernel' in k[0])
    if flips or k3_traced != 2:
        fail(f'K3 backward trace: flips {flips}, {k3_traced} K3 kernels a '
             f'forward and backward, expected none and 2')
    t['csr_weight_fwd_bwd_busy_ms'] = busy
    t['csr_weight_fwd_bwd_top'] = kern[:8]
    t['csr_weight_k3_traced_per_call'] = k3_traced

    # the scatter-free adjoints: every gradient (X, the slice vectors, the
    # frequencies, the edge weights) twice, the same bits; a trace of the
    # backward alone holds no scatter-add kernel and no scatter-add op
    Xg = Xd.clone().requires_grad_(True)
    emb = model.fsw_embed

    def grads():
        model.zero_grad(set_to_none=True)
        Xg.grad = gw.weight.grad = None
        loss_of(model(Xg, gw)).backward()
        return [v.grad.clone() for v in (Xg, emb.proj_vecs, emb.freqs,
                                         gw.weight)]
    first, second = grads(), grads()
    if not all(bool(torch.equal(a, b)) for a, b in zip(first, second)):
        fail('CSR adjoints: two calls gave other gradient bits for dX, dV, '
             'df or dw')
    del first, second
    t['csr_bwd_kernels'], bad = backward_kernels(
        torch, lambda: loss_of(model(Xg, gw)))
    if bad:
        fail(f'CSR adjoints: the backward runs scatters: {bad}; its '
             f'kernels: {t["csr_bwd_kernels"]}')
    t['csr_grads_same_bits'] = True
    res = {'nodes': N_NODES, 'edges': e_real, 'padded_edges': E,
           'slices': S, 'k3_elements': S * E, 'k3_max_abs_err': e,
           'k3_backward_max_abs_err': e_b,
           'cpu_check_in_degree': CSR_CHECK_DEG,
           'cpu_max_rel_err': cpu_err, **t}
    print('CSR conv: ' + json.dumps(res), flush=True)
    del calls, gw
    return t


def classifier_batch(seed, n_graphs, npg):
    """Disjoint graphs of npg nodes in one node space: class c's graphs
    give every node in-degree CLS_DEGS[c] (sparse against dense, as
    tests/test_graph_classifier.py); X ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    ei = np.concatenate([regular_graph(seed + g, npg, CLS_DEGS[g % 2],
                                       offset=g * npg)
                         for g in range(n_graphs)], axis=1)
    gi = np.repeat(np.arange(n_graphs), npg)
    X = rng.standard_normal((n_graphs * npg, D_IN)).astype(np.float32)
    return ei, gi, X, np.arange(n_graphs) % 2


def classifier_phase(torch, T, dev, counts):
    """Phase 14: FSWGraphClassifier(64, (64, 64), 2, mlp_layers=3) on 256
    graphs of 64 nodes, the conv stack on the CSR Graph and the readout on
    `readout_graph`: logits against the CPU (float32); the first step's
    gradients against the CPU with both in float64 (float32 projections
    computed in another order swap near-ties between the card and the
    CPU, and the gradient jumps at a swap); 5 Adam steps with the loss
    falling."""
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    F = torch.nn.functional
    ei, gi, X, y = classifier_batch(5, CLS_GRAPHS, CLS_NODES)
    n = X.shape[0]
    cpu_model = T.FSWGraphClassifier(
        D_IN, (D_IN, D_OUT), 2, mlp_layers=3, minimize_slice_coherence=False,
        device='cpu', generator=torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu_model).to(dev)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    Xd, yd = Xt.to(dev), yt.to(dev)

    def graphs(dtype, d):
        return (T.from_edge_index(ei, n, dtype=dtype).to(d),
                T.readout_graph(gi, n, CLS_GRAPHS, dtype=dtype).to(d))
    gd, pd = graphs(np.float32, dev)
    segcumsum.launches = 0
    with torch.no_grad():
        logits = model(Xd, gd, pd)
        want = cpu_model(Xt, *graphs(np.float32, 'cpu'))
    err = {'logits': close_to_cpu(torch, 'classifier: logits', logits, want,
                                  GRAD_RTOL, SERVE_ATOL_REL)}
    # first-step gradients, float64 on both sides
    m64c = copy.deepcopy(cpu_model).double()
    m64d = copy.deepcopy(m64c).to(dev)
    for m, d in ((m64d, dev), (m64c, torch.device('cpu'))):
        F.cross_entropy(m(Xt.double().to(d), *graphs(np.float64, d)),
                        yt.to(d)).backward()
    for (k, p), q in zip(m64c.named_parameters(), m64d.parameters()):
        err[k] = close_to_cpu(torch, f'classifier: gradient of {k}', q.grad,
                              p.grad, GRAD_RTOL, GRAD_ATOL_REL)
    del m64c, m64d
    opt = torch.optim.Adam(model.parameters(), lr=CLS_LR)
    losses = []
    for _ in range(CLS_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(Xd, gd, pd), yd)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    losses = torch.stack(losses).cpu().numpy()
    # 3 K3 calls a forward (two convs, the readout), float32 and float64
    n_k3, want_k3 = segcumsum.launches, 3 * (1 + 1 + CLS_STEPS)
    if n_k3 != want_k3:
        fail(f'classifier: K3 launched {n_k3} times, expected {want_k3}')
    counts['segcumsum'] += n_k3
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f'classifier: loss not finite and falling: {losses}')

    def step():
        opt.zero_grad(set_to_none=True)
        F.cross_entropy(model(Xd, gd, pd), yd).backward()
        opt.step()
    step_ms, step_host_ms = device_ms(torch, step, 3)
    res = {'graphs': CLS_GRAPHS, 'nodes': n, 'edges': int(ei.shape[1]),
           'launches_k3': n_k3, 'losses': losses.tolist(),
           'step_device_ms': step_ms, 'step_host_ms': step_host_ms,
           'cpu_max_rel_err': err}
    print('classifier: ' + json.dumps(res), flush=True)


def csr_hub_graph(seed, n, hub_in, deg):
    """Node 0 receives `hub_in` edges from nodes 1 .. hub_in, every other
    node `deg` edges (`regular_graph`): one degree above auto_layout's
    max_bucket, every normalized weight a power of two."""
    ei = regular_graph(seed, n, deg)
    ei = ei[:, ei[1] != 0]
    hub = np.stack([np.arange(1, hub_in + 1), np.zeros(hub_in, np.int64)])
    return np.concatenate([ei, hub], axis=1)


def csr_hub_phase(torch, T, dev, counts):
    """Phase 15: FSWConv(64, 64, mlp_layers=3) on a 16384-node graph whose
    node 0 has 8192 in-edges: `auto_layout` keeps the CSR Graph; forward
    and backward against the CPU."""
    ei = csr_hub_graph(6, CSR_HUB_NODES, CSR_HUB_IN, CSR_HUB_DEG)
    g = T.from_edge_index(ei, CSR_HUB_NODES)
    if not isinstance(T.auto_layout(g), T.Graph):
        fail('CSR hub: auto_layout did not keep the CSR Graph')
    X = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (CSR_HUB_NODES, D_IN)).astype(np.float32))
    cpu_model = T.FSWConv(D_IN, D_OUT, mlp_layers=3,
                          minimize_slice_coherence=False, device='cpu',
                          generator=torch.Generator().manual_seed(0))
    n_k3, err = check_dyadic_conv(
        torch, T, dev, 'CSR hub', ei, CSR_HUB_NODES, X, cpu_model,
        lambda: T.auto_layout(T.from_edge_index(ei, CSR_HUB_NODES)))
    if n_k3 != 1:
        fail(f'CSR hub: K3 launched {n_k3} times, expected 1')
    counts['segcumsum'] += n_k3
    print('CSR hub: ' + json.dumps({
        'nodes': CSR_HUB_NODES, 'edges': int(ei.shape[1]),
        'hub_in_degree': CSR_HUB_IN, 'launches_k3': n_k3,
        'cpu_max_rel_err': err}), flush=True)


def csr_request(seed, n, hub_in=0, duplicate=False):
    """A request of n nodes, every in-degree 16 (`regular_graph`), X ~
    N(0, 1); `hub_in` > 0 gives node 0 that many in-edges instead,
    `duplicate` repeats one edge of node 5 in place of another (weights
    2/16 and 1/16: still exact sums)."""
    ei = regular_graph(seed, n, CSR_CHECK_DEG)
    if hub_in:
        ei = ei[:, ei[1] != 0]
        ei = np.concatenate([ei, np.stack([np.arange(1, hub_in + 1),
                                           np.zeros(hub_in, np.int64)])], 1)
    if duplicate:
        into5 = np.nonzero(ei[1] == 5)[0]
        ei[0, into5[1]] = ei[0, into5[0]]
    X = np.random.default_rng(seed).standard_normal((n, D_IN))
    return ei, X.astype(np.float32)


def csr_server_phase(torch, T, dev, model, counts):
    """Phase 16: the bench FSWConv behind a GraphServer without classes
    (every request through the CSR Graph), 20 requests of 4096 to 8192
    nodes; a classes server (phase 3's envelope, assume_uniform_w) gets a
    2048-node hub request (counted in `fallbacks`) and a 2048-node
    duplicate-edge request (counted in `uniform_w_fallbacks`): at that
    size every in-degree-16 row fits the envelope's class rows.  Outputs
    against the same servers on the CPU, K3 launched once a CSR request."""
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    # eager: K3's launches are counted a request (phase 26 serves the CSR
    # route through its graph)
    server = T.GraphServer(model, N_NODES, MAX_EDGES, cuda_graphs=False,
                           device=dev)
    cpu_server = T.GraphServer(copy.deepcopy(model), N_NODES, MAX_EDGES,
                               device='cpu')
    server.warmup(D_IN)
    sizes = np.random.default_rng(8).integers(MIN_NODES, N_NODES + 1,
                                              CSR_REQUESTS)
    sizes[0] = N_NODES
    reqs = [csr_request(30 + i, int(n)) for i, n in enumerate(sizes)]
    half = CSR_REQUESTS // 2
    segcumsum.launches = 0
    latencies, outs = [], []
    for ei, X in reqs[:half]:
        t0 = time.perf_counter()
        outs.append(server.predict(ei, X))
        latencies.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    outs += server.predict_many(reqs[half:], window=WINDOW)
    t_many = time.perf_counter() - t0
    n_k3 = segcumsum.launches
    if n_k3 != CSR_REQUESTS:
        fail(f'CSR server: K3 launched {n_k3} times for {CSR_REQUESTS} '
             f'requests')
    for (ei, X), out in zip(reqs, outs):
        if out.shape != (X.shape[0], D_OUT) or not np.isfinite(out).all():
            fail(f'CSR server: bad output for a {X.shape[0]}-node request')
    err = {'request_0': close_to_cpu(
        torch, 'CSR server: request 0', torch.from_numpy(outs[0]),
        torch.from_numpy(cpu_server.predict(*reqs[0])), GRAD_RTOL,
        SERVE_ATOL_REL)}

    ref_ei, _ = simple_graph(0, N_NODES)
    classes, class_rows = T.multi_envelope(
        T.from_edge_index(ref_ei, N_NODES), N_NODES)
    env = dict(classes=classes, class_rows=class_rows, assume_uniform_w=True)
    cls_server = T.GraphServer(model, N_NODES, MAX_EDGES, cuda_graphs=False,
                               device=dev, **env)
    cls_cpu = T.GraphServer(copy.deepcopy(model), N_NODES, MAX_EDGES,
                            device='cpu', **env)
    for label, req, counter in (
            ('hub', csr_request(60, CSR_CLASSES_NODES,
                                hub_in=CSR_SERVE_HUB_IN), 'fallbacks'),
            ('duplicate edge', csr_request(61, CSR_CLASSES_NODES,
                                           duplicate=True),
             'uniform_w_fallbacks')):
        segcumsum.launches = 0
        got = cls_server.predict(*req)
        torch.cuda.synchronize()
        if (getattr(cls_server, counter), segcumsum.launches) != (1, 1):
            fail(f'CSR server, {label}: {counter} '
                 f'{getattr(cls_server, counter)}, K3 launched '
                 f'{segcumsum.launches} times; expected 1 and 1')
        n_k3 += 1
        err[label] = close_to_cpu(torch, f'CSR server, {label}',
                                  torch.from_numpy(got),
                                  torch.from_numpy(cls_cpu.predict(*req)),
                                  GRAD_RTOL, SERVE_ATOL_REL)
    if (cls_server.fallbacks, cls_server.uniform_w_fallbacks) != (1, 1):
        fail('CSR server: the fallback counters moved twice')
    counts['segcumsum'] += n_k3
    res = {'requests': CSR_REQUESTS, 'launches_k3': n_k3,
           'p50_latency_ms': 1e3 * float(np.median(latencies)),
           'predict_edges_per_s': (sum(ei.shape[1] for ei, _ in reqs[:half])
                                   / sum(latencies)),
           'predict_many_edges_per_s': (sum(ei.shape[1]
                                            for ei, _ in reqs[half:])
                                        / t_many),
           'cpu_max_rel_err': err}
    print('CSR server: ' + json.dumps(res), flush=True)


def cart_inputs(torch, gen, dev, R, B, S, F):
    """The inputs of the JAX package's cartesian benchmark
    (`benchmarks/bench_cart_dw.py`), drawn on the card: P ~ N(0, 1)
    (R, B, S); weights |N(0, 1)| with a fifth of them zero, normalized by
    max(total, 1), and the phantom mass max(1 - total, 0) in the same
    units; frequencies |N(0, 1)| + 0.1 as an (S, F) matrix."""
    P = torch.randn((R, B, S), generator=gen, device=dev)
    w = torch.randn((R, B), generator=gen, device=dev).abs()
    w = w * (torch.rand((R, B), generator=gen, device=dev) >= CART_ZERO)
    ws = w.sum(dim=1)
    wsp = ws.clamp(min=1.0)
    freqs = torch.randn((S, F), generator=gen, device=dev).abs() + 0.1
    return (P, (w / wsp[:, None]).contiguous(),
            ((1.0 - ws).clamp(min=0.0) / wsp).contiguous(), freqs)


def cart_kernel_phase(torch, T, dev, errs):
    """Phase 17: K4f and K4b alone at the JAX package's cartesian
    benchmark shape (R = 8192, B = 32, S = 128, F = 8), against their
    plain versions in five variants (with_dw on and off, uniform_w, ties
    with an f = 0 column, a phantom mass), each timed beside its bound,
    its plain version and the sort route, forward and forward + backward
    (every input taking a gradient); then with weight gradients at
    B = 128, the widest 'auto' sends to K4.  Returns the times and bounds
    of both widths."""
    from fsw_gnn_tpu_torch.embedding import (
        RANK_AGGREGATE_MAX_BUCKET_NO_DW, bucket_quadrature, table_weights)
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    cfg = T.FSWConfig(d_in=1, n_slices=CART_S, n_freqs=CART_F)
    gen = torch.Generator(device=dev).manual_seed(17)
    res = {}
    for B in (CART_B, RANK_AGGREGATE_MAX_BUCKET_NO_DW):
        P, wn, pad, freqs = cart_inputs(torch, gen, dev, CART_R, B, CART_S,
                                        CART_F)
        G = torch.randn((CART_R, CART_S, CART_F), generator=gen, device=dev)
        variants = [('with_dw', P, wn, pad, freqs, False, True)]
        if B == CART_B:
            _, wn_u, pad_u = table_weights((wn > 0).float(), cfg)
            _, wn_l, pad_l = table_weights(0.02 * wn, cfg)
            if not bool((pad_l > 0).all()):
                fail('cart K4: the light rows have no phantom mass')
            Pt = P.clone()
            Pt[:, 1::2] = Pt[:, 0:B - 1:2]
            f0 = freqs.clone()
            f0[:, 1] = 0.0
            variants += [
                ('without with_dw', P, wn, pad, freqs, False, False),
                ('uniform_w', P, wn_u.contiguous(), pad_u.contiguous(),
                 freqs, True, False),
                ('ties, f=0 column', Pt, wn, pad, f0, False, True),
                ('phantom mass', P, wn_l.contiguous(), pad_l.contiguous(),
                 freqs, False, True)]
        fwd = bwd = (0.0, 0.0)
        with torch.no_grad():
            for label, *args, u, d in variants:
                where = f'cart K4, B={B}, {label}'
                fwd = tuple(map(max, fwd, check_fwd(torch, where,
                                                    tuple(args), u, 'K4')))
                bwd = tuple(map(max, bwd, check_bwd(torch, where,
                                                    tuple(args), G, u, d,
                                                    'K4')))
        del variants
        errs['fsw_rank_cart_fwd'] = max(errs['fsw_rank_cart_fwd'], fwd[0])
        errs['fsw_rank_cart_bwd'] = max(errs['fsw_rank_cart_bwd'], bwd[0])
        args = (P, wn, pad, freqs)
        t = {'R': CART_R, 'B': B, 'S': CART_S, 'F': CART_F,
             'real_entries': int((wn > 0).sum()),
             'k4f_max_abs_err': fwd[0], 'k4f_max_rel_err': fwd[1],
             'k4b_max_abs_err': bwd[0], 'k4b_max_rel_err': bwd[1]}
        with torch.no_grad():
            t['k4f_ms'], _ = device_ms(torch, lambda: R.fsw_rank_aggregate_cart(
                *args, with_dw=False), 20)
            t['k4b_ms'], _ = device_ms(
                torch, lambda: R.fsw_rank_aggregate_cart_bwd(*args, G), 10)
            if B == CART_B:
                t['k4b_no_dw_ms'], _ = device_ms(
                    torch, lambda: R.fsw_rank_aggregate_cart_bwd(
                        *args, G, with_dw=False), 10)
            t['k4f_plain_ms'], _ = device_ms(
                torch, lambda: R.fsw_rank_aggregate_cart_plain(*args), 2, 2)
            t['k4b_plain_ms'], _ = device_ms(
                torch, lambda: R.fsw_rank_aggregate_cart_bwd_plain(*args, G),
                1, 2)
            t['sort_fwd_ms'], _ = device_ms(torch, lambda: bucket_quadrature(
                *args, cfg, 'sort'), 3)

        def fwd_bwd(agg):
            leaves = [a.detach().requires_grad_(True) for a in args]
            bucket_quadrature(*leaves, cfg, agg).backward(G)
        t['rank_fwd_bwd_ms'], _ = device_ms(torch, lambda: fwd_bwd('rank'), 3)
        t['sort_fwd_bwd_ms'], _ = device_ms(torch, lambda: fwd_bwd('sort'), 3)
        t['k4f_bound_ms'], t['k4f_bound_by'] = rank2_bound_ms(
            wn, CART_S, F=CART_F)
        t['k4b_bound_ms'], t['k4b_bound_by'] = rank2_bound_ms(
            wn, CART_S, bwd=True, with_dw=True, F=CART_F)
        res[B] = t
        print('cart K4: ' + json.dumps(t), flush=True)
        del args, P, wn, pad, freqs, G
        torch.cuda.empty_cache()
    return res


def cart_table_phase(torch, T, dev, counts, errs):
    """Phase 18: FSWEmbedding(FSWConfig(d_in=64, n_slices=128, n_freqs=8,
    collapse_freqs=True), learnable slices and frequencies) on the bench
    graph's MultiTable: 'auto' takes K4 on every degree class (the
    captured calls, K4 held against its plain version on each); forward
    and backward with weights_grad False and True (the table weights then
    take a gradient), one K4f and one K4b launch a class each; the output
    and every gradient against the CPU (X and the slice vectors dyadic);
    forward and forward + backward timed beside the sort route, and the
    forward + backward's kernels from a trace."""
    import dataclasses
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    cfg = T.FSWConfig(d_in=D_IN, n_slices=CART_S, n_freqs=CART_F,
                      collapse_freqs=True, learnable_slices=True,
                      learnable_freqs=True)
    ei, rng = simple_graph(0, N_NODES)
    X = torch.from_numpy(rng.standard_normal((N_NODES, D_IN))
                         .astype(np.float32))
    cpu_emb = T.FSWEmbedding(cfg, device='cpu',
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        X, Vq = dyadic(X, cpu_emb.proj_vecs.t())
        cpu_emb.proj_vecs.copy_(Vq.t())
    emb = copy.deepcopy(cpu_emb).to(dev)
    mt = T.to_multi_table(T.from_edge_index(ei, N_NODES))
    layouts = {'cuda': mt.to(dev), 'cpu': mt.to('cpu')}
    n_classes = len(mt.tables)
    Xd, md = X.to(dev), layouts['cuda']

    k1, k2 = [], []
    with torch.no_grad():
        calls = capture_rank_calls(lambda: k2.extend(capture_rank_calls(
            lambda: k1.extend(capture_rank_calls(
                lambda: emb(Xd, graph=md, weights_grad=False))),
            'fsw_rank_aggregate')), 'fsw_rank_aggregate_cart')
    widths = sorted(c[0][0].shape[1] for c in calls)
    if k1 or k2 or widths != sorted(t.bucket_size for t in mt.tables):
        fail(f'cart table: K4 calls at widths {widths}, K1 {len(k1)}, K2 '
             f'{len(k2)}, for the classes {[t.bucket_size for t in mt.tables]}')
    check_rank2_calls(torch, dev, calls, cfg, 'cart table', errs, kind='K4')
    del calls

    G = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (N_NODES, cfg.out_dim)).astype(np.float32))

    def with_leaf_weights(layout):
        ws = [t.weight.clone().requires_grad_(True) for t in layout.tables]
        return ws, dataclasses.replace(layout, tables=tuple(
            dataclasses.replace(t, weight=w)
            for t, w in zip(layout.tables, ws)))

    err = {}
    launched = {}
    for wg in (False, True):
        grads = []
        for m, d in ((emb, dev), (cpu_emb, torch.device('cpu'))):
            m.zero_grad(set_to_none=True)
            Xl = X.to(d).clone().requires_grad_(True)
            ws, lay = (with_leaf_weights(layouts[d.type]) if wg
                       else ([], layouts[d.type]))
            R.fsw_rank_aggregate_cart.launches = 0
            R.fsw_rank_aggregate_cart_bwd.launches = 0
            out = m(Xl, graph=lay, weights_grad=wg)
            (out * G.to(d)).sum().backward()
            if d.type == 'cuda':
                torch.cuda.synchronize()
                n = (R.fsw_rank_aggregate_cart.launches,
                     R.fsw_rank_aggregate_cart_bwd.launches)
                if n != (n_classes, n_classes):
                    fail(f'cart table (weights_grad={wg}): K4f, K4b launched '
                         f'{n}, expected {n_classes} each')
                counts['fsw_rank_cart_fwd'] += n[0]
                counts['fsw_rank_cart_bwd'] += n[1]
                launched[f'weights_grad={wg}'] = n
                if out.shape != (N_NODES, cfg.out_dim):
                    fail(f'cart table: output shape {tuple(out.shape)}')
            grads.append([('out', out), ('X', Xl.grad)]
                         + [(k, p.grad) for k, p in m.named_parameters()]
                         + [(f'table weights {t.bucket_size}', w.grad)
                            for t, w in zip(lay.tables, ws)])
        for (k, got), (_, want) in zip(*grads):
            err[f'{k}, weights_grad={wg}'] = close_to_cpu(
                torch, f'cart table (weights_grad={wg}): {k}', got, want,
                GRAD_RTOL, SERVE_ATOL_REL if k == 'out' else GRAD_ATOL_REL)
        del grads

    t = {}
    Gd = G.to(dev)
    with torch.no_grad():
        for agg in ('auto', 'sort'):
            t[f'{agg}_forward_ms'], _ = device_ms(torch, lambda: emb(
                Xd, graph=md, aggregate=agg, weights_grad=False), 5)
    for wg in (False, True):
        ws, lay = with_leaf_weights(md) if wg else ([], md)
        for agg in ('auto', 'sort'):
            def fwd_bwd():
                emb.zero_grad(set_to_none=True)
                Xq = Xd.detach().requires_grad_(True)
                (emb(Xq, graph=lay, aggregate=agg, weights_grad=wg)
                 * Gd).sum().backward()
            t[f'{agg}_fwd_bwd_weights_grad_{wg}_ms'], _ = device_ms(
                torch, fwd_bwd, 3)
            if agg == 'auto' and not wg:
                t['auto_fwd_bwd_busy_ms'], t['auto_fwd_bwd_top'] = \
                    traced_top_kernels(torch, fwd_bwd, 3)
    e_real = int(mt.num_edges)
    res = {'nodes': N_NODES, 'edges': e_real, 'classes': n_classes,
           'class_widths': [tb.bucket_size for tb in mt.tables],
           'launches': launched, 'cpu_max_rel_err': err,
           'auto_fwd_edges_per_s': e_real / (t['auto_forward_ms'] * 1e-3),
           **t}
    print('cart table: ' + json.dumps(res), flush=True)


def cart_multiset_phase(torch, T, dev, counts, errs):
    """Phase 19: FSWEmbedding(FSWConfig(d_in=20, n_slices=128,
    n_freqs=8)) on the demo's 2048 multisets of n = 100 (P 105 MB): K4
    held against its plain version on the arguments 'auto' passes with W
    given and W = None; forward and backward through the module with W
    given (gradients of X and W) and with W = None (of X), one K4f and
    one K4b launch each; the first 128 multisets against the CPU; forward
    and forward + backward timed beside the sort route, and the forward +
    backward's kernels from a trace."""
    from fsw_gnn_tpu_torch.embedding import _resolve_aggregate
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    cfg = T.FSWConfig(d_in=MS_D, n_slices=CART_S, n_freqs=CART_F)
    cpu_model, X, W, G = multiset_setup(torch, T, dev, cfg)
    model = copy.deepcopy(cpu_model).to(dev)
    if _resolve_aggregate('auto', cfg, MS_N) != 'rank':
        fail(f"cart multisets: 'auto' does not take K4 at n = {MS_N}")
    Xd, Wd, Gd = X.to(dev), W.to(dev), G.to(dev)
    n_sets = int(np.prod(MS_LEAD))
    for label, run in (('W given', lambda: model(Xd, Wd)),
                       ("W=None, w_mode='unit'",
                        lambda: model(Xd, w_mode='unit'))):
        with torch.no_grad():
            calls = capture_rank_calls(run, 'fsw_rank_aggregate_cart')
        if len(calls) != 1 or calls[0][0][0].shape != (n_sets, MS_N, CART_S):
            fail(f'cart multisets ({label}): K4 calls '
                 f'{[tuple(c[0][0].shape) for c in calls]}')
        check_rank2_calls(torch, dev, calls, cfg, f'cart multisets, {label}',
                          errs, extra=label == 'W given', kind='K4')
        del calls

    def run_path(m, Xs, Ws, Gs):
        """Forward and backward with W given, then with W = None (unit
        weights): the outputs and the gradients of X, W and X."""
        Xg = Xs.clone().requires_grad_(True)
        Wg = Ws.clone().requires_grad_(True)
        Xu = Xs.clone().requires_grad_(True)
        out = m(Xg, Wg)
        (out * Gs).sum().backward()
        out_u = m(Xu, w_mode='unit')
        (out_u * Gs).sum().backward()
        return [('out', out), ('grad_X', Xg.grad), ('grad_W', Wg.grad),
                ('out W=None', out_u), ('grad_X W=None', Xu.grad)]
    R.fsw_rank_aggregate_cart.launches = 0
    R.fsw_rank_aggregate_cart_bwd.launches = 0
    got = run_path(model, Xd, Wd, Gd)
    torch.cuda.synchronize()
    n = (R.fsw_rank_aggregate_cart.launches,
         R.fsw_rank_aggregate_cart_bwd.launches)
    if n != (2, 2):
        fail(f'cart multisets: K4f, K4b launched {n}, expected 2 each')
    counts['fsw_rank_cart_fwd'] += n[0]
    counts['fsw_rank_cart_bwd'] += n[1]
    if got[0][1].shape != MS_LEAD + (CART_S, CART_F):
        fail(f'cart multisets: output shape {tuple(got[0][1].shape)}')
    k = MS_CPU_SETS
    want = run_path(cpu_model, X.reshape(-1, MS_N, MS_D)[:k],
                    W.reshape(-1, MS_N)[:k],
                    G.reshape((-1,) + G.shape[len(MS_LEAD):])[:k])
    err = {}
    for (name, g), (_, w) in zip(got, want):
        err[name] = close_to_cpu(
            torch, f'cart multisets: {name}', g.reshape((-1,) + w.shape[1:])[:k],
            w, GRAD_RTOL, SERVE_ATOL_REL if name.startswith('out')
            else GRAD_ATOL_REL)
    del got, want

    t = {}
    with torch.no_grad():
        for agg in ('auto', 'sort'):
            t[f'{agg}_forward_ms'], _ = device_ms(
                torch, lambda: model(Xd, Wd, aggregate=agg), 5)
    for agg in ('auto', 'sort'):
        def fwd_bwd():
            Xq = Xd.detach().requires_grad_(True)
            Wq = Wd.detach().requires_grad_(True)
            (model(Xq, Wq, aggregate=agg) * Gd).sum().backward()
        t[f'{agg}_fwd_bwd_ms'], _ = device_ms(torch, fwd_bwd, 3)
        if agg == 'auto':
            t['auto_fwd_bwd_busy_ms'], t['auto_fwd_bwd_top'] = \
                traced_top_kernels(torch, fwd_bwd, 3)
    res = {'multisets': n_sets, 'n': MS_N, 'd': MS_D, 'slices': CART_S,
           'freqs': CART_F, 'P_bytes': 4 * n_sets * MS_N * CART_S,
           'launches': n, 'cpu_sets': k, 'cpu_max_rel_err': err,
           'auto_multisets_per_s_fwd_bwd': n_sets / (t['auto_fwd_bwd_ms']
                                                     * 1e-3), **t}
    print('cart multisets: ' + json.dumps(res), flush=True)


def citeseer_phase(torch, T, dev, counts, errs):
    """Phase 20: the Trainer on the Citeseer stand-in (3327 nodes, 3703
    features, 6 classes; BASELINE config #3's other dataset), whose first
    layer the fused kernel once could not hold.  Its initial loss
    against a CPU forward of the same model, the rank calls of one forward
    held against their plain versions, a fit of CITESEER_EPOCHS epochs at
    learning rate 1e-3 with the loss finite and falling, every launch
    counted.  (At the default 1e-2 this model's loss climbs for the first
    epochs: 1.90 to 490 in four on an 800-node stand-in on the CPU.)  Then FSWConv(3703,
    64) forward and backward on the card against the CPU, on a 1024-node
    graph of in-degree 8 whose first 8 nodes take 8 more in-edges (classes
    (1016, 8), routed to K2, and (8, 16), routed to K1 at D = 3703), with
    the features and slice vectors on the dyadic grid."""
    from fsw_gnn_tpu_torch import embedding as E
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.data import load
    from fsw_gnn_tpu_torch.train import masked_softmax_cross_entropy
    data = load('citeseer')
    tr = T.Trainer(data, T.TrainConfig(
        hidden_dims=(64, 64), epochs=CITESEER_EPOCHS,
        eval_every=CITESEER_EPOCHS, learning_rate=CITESEER_LR), device=dev)
    cpu_model = copy.deepcopy(tr.model).to('cpu').train()
    with torch.no_grad():
        logits = cpu_model(torch.from_numpy(data.features),
                           T.auto_layout(tr.graph))
        s_, c_ = masked_softmax_cross_entropy(
            logits, torch.from_numpy(data.labels).long(),
            torch.from_numpy(data.train_mask.astype(np.float32)))
        loss0_cpu = (s_ / max(c_.item(), 1.0)).item()
    del cpu_model, logits
    n_classes = len(tables_of(tr.compute_graph))
    tr.model.eval()
    run = lambda: tr.model(tr.X, tr.compute_graph)  # noqa: E731
    with torch.no_grad():
        calls = capture_rank_calls(run)
        calls2 = capture_rank_calls(run, 'fsw_rank_aggregate')
    if len(calls) + len(calls2) != len(tr.model.convs) * n_classes:
        fail(f'citeseer: one forward made {len(calls)} K1 and '
             f'{len(calls2)} K2 calls')
    routes = {'K1': [tuple(a[0].shape) for a, _, _ in calls],
              'K2': [tuple(a[0].shape) for a, _, _ in calls2]}
    print(f'citeseer: rank route per (layer, class): {routes}')
    check_rank_calls(torch, dev, calls, tr.model.convs[0].embed_cfg,
                     'citeseer', errs, all_variants=False)
    check_rank2_calls(torch, dev, calls2, tr.model.convs[0].embed_cfg,
                      'citeseer', errs, extra=False)
    names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_bwd',
             'fsw_rank_aggregate', 'fsw_rank_aggregate_bwd')
    for name in names:
        getattr(R, name).launches = 0
    t0 = time.perf_counter()
    out = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    got = [getattr(R, name).launches for name in names]
    n_evals = 2                     # at epoch CITESEER_EPOCHS and the final
    want = [len(c) * k for c in (calls, calls2)
            for k in (CITESEER_EPOCHS + n_evals, CITESEER_EPOCHS)]
    if got != want:
        fail(f'citeseer: K1f, K1b, K2f, K2b launched {got}; expected {want}')
    for key, n in zip(('fsw_rank_fwdp', 'fsw_rank_bwdp', 'fsw_rank_fwd',
                       'fsw_rank_bwd'), got):
        counts[key] += n
    losses = [h['loss'] for h in tr.history]
    if not abs(losses[0] - loss0_cpu) <= LOSS0_RTOL * abs(loss0_cpu):
        fail(f'citeseer: initial loss {losses[0]} differs from the CPU '
             f'forward {loss0_cpu}')
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f'citeseer: loss not finite and falling: {losses}')
    k2_ms, k2_rows = time_k2_calls(
        torch, calls2, torch.Generator(device=dev).manual_seed(3))

    # FSWConv(3703, 64) on a small graph, forward and backward, card and CPU
    n, d = CITESEER_SUB_NODES, data.features.shape[1]
    ei = regular_graph(20, n, 8)
    rng = np.random.default_rng(21)
    extra = [np.stack([(v + 1 + rng.permutation(n - 1)[:16]) % n,
                       np.full(16, v)]) for v in range(CITESEER_SUB_HUBS)]
    pairs = np.unique(np.concatenate([ei] + extra, axis=1), axis=1)
    ei = pairs[:, :0]
    for v in range(n):          # in-degree 8, or 16 for the first nodes
        src = pairs[0][pairs[1] == v]
        k = 16 if v < CITESEER_SUB_HUBS else 8
        ei = np.concatenate([ei, np.stack([src[:k], np.full(k, v)])], axis=1)
    mt = T.to_multi_table(T.from_edge_index(ei, n))
    if sorted(t.bucket_size for t in mt.tables) != [8, 16]:
        fail(f'citeseer: subgraph classes '
             f'{[t.bucket_size for t in mt.tables]}')
    cpu_conv = T.FSWConv(d, 64, minimize_slice_coherence=False,
                         device='cpu',
                         generator=torch.Generator().manual_seed(4))
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    with torch.no_grad():
        X, Vq = dyadic(X, cpu_conv.fsw_embed.proj_vecs.t())
        cpu_conv.fsw_embed.proj_vecs.copy_(Vq.t())
    G = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    conv = copy.deepcopy(cpu_conv).to(dev)
    before = [getattr(R, name).launches for name in names]
    Xd = X.to(dev).detach().requires_grad_(True)
    out_d = conv(Xd, mt.to(dev))
    (out_d * G.to(dev)).sum().backward()
    torch.cuda.synchronize()
    sub = [getattr(R, name).launches - b for name, b in zip(names, before)]
    cfg = conv.embed_cfg
    fused = sum(E._resolve_aggregate('auto', cfg, t.bucket_size,
                                     cfg.nSlices, False, t.idx.size / n)
                == 'rank_proj' for t in mt.tables)
    if sub != [fused, fused, 2 - fused, 2 - fused]:
        fail(f'citeseer: K1f, K1b, K2f, K2b launched {sub} for the '
             f'subgraph\'s two classes, {fused} of them routed to K1')
    for key, k in zip(('fsw_rank_fwdp', 'fsw_rank_bwdp', 'fsw_rank_fwd',
                       'fsw_rank_bwd'), sub):
        counts[key] += k
    Xc = X.detach().clone().requires_grad_(True)
    out_c = cpu_conv(Xc, mt)
    (out_c * G).sum().backward()
    errs_rel = {'output': close_to_cpu(torch, 'citeseer conv output', out_d,
                                       out_c, GRAD_RTOL, GRAD_ATOL_REL),
                'X': close_to_cpu(torch, 'citeseer conv dX', Xd.grad,
                                  Xc.grad, GRAD_RTOL, GRAD_ATOL_REL)}
    for (k, p), q in zip(cpu_conv.named_parameters(), conv.parameters()):
        errs_rel[k] = close_to_cpu(torch, f'citeseer conv d{k}', q.grad,
                                   p.grad, GRAD_RTOL, GRAD_ATOL_REL)
    res = {'dataset': data.name, 'nodes': data.num_nodes, 'features': d,
           'routes': routes, 'launches_k1f_k1b_k2f_k2b': got,
           'subgraph_launches_k1f_k1b_k2f_k2b': sub,
           'epochs': out['epochs_run'], 'fit_s': fit_s,
           'seconds_per_epoch_fit': out['seconds'] / out['epochs_run'],
           'loss_first': losses[0], 'loss_first_cpu': loss0_cpu,
           'loss_last': losses[-1],
           **{k: v for k, v in out['final'].items()},
           'k2f_ms_per_epoch': k2_ms['fwd'], 'k2b_ms_per_epoch': k2_ms['bwd'],
           'k2f_bound_ms_per_epoch': k2_ms['fwd_bound'],
           'k2b_bound_ms_per_epoch': k2_ms['bwd_bound'],
           'k2_classes': k2_rows,
           'conv_3703_vs_cpu_max_rel_err': max(errs_rel.values())}
    print('citeseer: ' + json.dumps(res), flush=True)


def _route_case(torch, T, dev, mt, N, D, gen):
    """The bench model's embedding widened to D features (FSWConv(D, 64):
    S = 2 max(D, 64) - 1 slices, 'spread' frequencies, random unit slice
    vectors from seed D), X ~ N(0, 1) on N nodes, both on the dyadic grid,
    and a cotangent a class."""
    conv = T.FSWConv(D, D_OUT, minimize_slice_coherence=False, device='cpu',
                     generator=torch.Generator().manual_seed(D))
    cfg = conv.embed_cfg
    X = torch.randn((N, D), generator=gen, device=dev)
    with torch.no_grad():
        X, Vq = dyadic(X, conv.fsw_embed.proj_vecs.t().to(dev))
    V = Vq.t().contiguous().requires_grad_(True)
    freqs = conv.fsw_embed.freqs.detach().to(dev)
    Gs = [torch.randn((t.idx.shape[0], cfg.nSlices), generator=gen,
                      device=dev) for t in tables_of(mt)]
    return cfg, X, V, freqs, Gs


def routing_phase(torch, T, dev):
    """Phase 21: the fused route (K1: the gather of Z, K1f; K1b) against the
    unfused route (X @ V in float32, the gather of P, K2f; K2b and the
    gather's and the product's backward) on every degree class, through
    `fsw_embed_table` with the route forced, in turns (fused, unfused,
    unfused, fused), forward and forward + backward (the slice vectors
    taking the gradient, as in a first layer): the bench graph at D = 64
    (S = 127) and at D = 128 .. 1024 (S = 2D - 1), and Cora's layer 0
    (D = 1433, S = 2865, its (2712, 8) and (8, 16) classes).  Both routes'
    outputs agree (dyadic inputs).  Prints a `routing:` line with the
    rule's pick beside each measurement; returns K1's arguments at Cora's
    layer 0 for phase 22."""
    from fsw_gnn_tpu_torch import embedding as E
    from fsw_gnn_tpu_torch.data import load
    ei, _ = simple_graph(0, N_NODES)
    bench_mt = T.to_multi_table(T.from_edge_index(ei, N_NODES)).to(dev)
    cora = load('cora')
    cora_mt = T.auto_layout(T.from_edge_index(
        cora.edge_index, cora.num_nodes)).to(dev)
    cases = [('bench', bench_mt, N_NODES, D) for D in ROUTE_DS]
    cases.append(('cora', cora_mt, cora.num_nodes, CORA_D))
    gen = torch.Generator(device=dev).manual_seed(6)
    real = E._k1_faster
    rows, cora_calls = [], []
    for graph, mt, N, D in cases:
        cfg, X, V, freqs, Gs = _route_case(torch, T, dev, mt, N, D, gen)
        S = cfg.nSlices
        for tbl, G in zip(tables_of(mt), Gs):
            rho = tbl.idx.numel() / N

            def run(fused, bwd, tbl=tbl, G=G):
                E._k1_faster = lambda d, r, rules=None: fused
                try:
                    with torch.set_grad_enabled(bwd):
                        out = E.fsw_embed_table(X, tbl, V, freqs, cfg,
                                                return_raw=True,
                                                weights_grad=False)[0]
                        if bwd:
                            torch.autograd.grad(out, V, G)
                finally:
                    E._k1_faster = real
                return out
            if graph == 'cora':
                cora_calls += capture_rank_calls(lambda: run(True, False))
            with torch.no_grad():
                a, b = run(True, False), run(False, False)
                torch.cuda.synchronize()
                err = (a - b).abs()
                if not bool(torch.all(err <= KERNEL_ATOL_REL * b.abs().max()
                                      + KERNEL_RTOL * b.abs())):
                    fail(f'routing: the fused and unfused routes disagree at '
                         f'{graph} D={D} B={tbl.bucket_size}: max abs err '
                         f'{err.max().item():.3e}')
                del a, b, err
            n = 3
            t = {}
            for key, bwd in (('fwd', False), ('fwd_bwd', True)):
                order = (True, False, False, True)
                ms = [device_ms(torch, lambda f=f: run(f, bwd), n, 3)[0]
                      for f in order]
                t['fused_' + key] = (ms[0] + ms[3]) / 2
                t['unfused_' + key] = (ms[1] + ms[2]) / 2
            rule = E._resolve_aggregate('auto', cfg, tbl.bucket_size, S,
                                        False, rho)
            rows.append(dict(graph=graph, D=D, S=S, B=tbl.bucket_size,
                             R=int(tbl.idx.shape[0]), rho=rho, **t,
                             rule=rule))
            print(f'  routing {graph} D={D} S={S} B={tbl.bucket_size} '
                  f'R={tbl.idx.shape[0]} rho={rho:.3f}: ' +
                  ', '.join(f'{k} {v:.4f} ms' for k, v in t.items()) +
                  f'; rule {rule}', flush=True)
        del X, V, Gs
        torch.cuda.empty_cache()
    agree = sum((r['rule'] == 'rank_proj')
                == (r['fused_fwd_bwd'] <= r['unfused_fwd_bwd']) for r in rows)
    print('routing: ' + json.dumps({
        'rows': rows, 'rule': {'K1_RHO0': E.K1_RHO0, 'K1_D0': E.K1_D0},
        'rule_agrees_fwd_bwd': f'{agree} of {len(rows)}'}), flush=True)
    return cora_calls


def k1_ab_phase(torch, dev, call_sets):
    """Phase 22: where K1's time goes, on the calls of a served request, a
    bench step and Cora's layer 0: K1f's kernel up to its projection
    (written out), K1b's step 1 alone and `torch.matmul` of the same
    product in float32 (a reference the port never calls)."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import fsw_rank_proj_projections
    keys = ('k1f_new_projection_only', 'k1b_new_step1_only',
            'matmul_f32_projection')
    res = {}
    for label, calls in call_sets.items():
        tot = dict.fromkeys(keys, 0.0)
        with torch.no_grad():
            for args, unif, dw in calls:
                Z, wn, pad, freqs, V = args
                R, B, D = Z.shape
                n = 3 if D > 256 else 10
                for key, kern in (('k1f_new_projection_only',
                                   'fsw_rank_fwdp'),
                                  ('k1b_new_step1_only', 'fsw_rank_bwdp')):
                    tot[key] += device_ms(torch, lambda: (
                        fsw_rank_proj_projections(Z, V, kern)), n, 3)[0]
                Z2 = Z.reshape(R * B, D)
                tot['matmul_f32_projection'] += device_ms(
                    torch, lambda: torch.matmul(Z2, V), n, 3)[0]
        res[label] = tot
        print(f'  k1 ab {label}: ' + ', '.join(
            f'{k} {v:.4f} ms' for k, v in tot.items()), flush=True)
    print('k1 ab: ' + json.dumps(res), flush=True)


def coherence_phase(torch, dev):
    """Phase 23: the coherence minimizer on the card at Cora's layer-0
    frame (CORA_S x CORA_D, float64, N(0, 1) from seed 0, rows
    normalized): the stages kept and each stage's iterations, the total
    time and the time an iteration beside its bound, the two products of
    one iteration timed alone, the coherence before and after (it must
    fall) and the rows unit within 1e-12, and a trace of the first stage
    (its device-busy ms an iteration, its costliest kernels); then the
    card's result against the CPU's at COH_CHECK in float64, within
    1e-9."""
    from fsw_gnn_tpu_torch.ops.coherence import (
        _STEP_INIT, P_SCHEDULE, _minimize_p, gram_offdiag,
        minimize_mutual_coherence, mutual_coherence)
    f64 = torch.float64
    X = torch.randn((CORA_S, CORA_D), generator=torch.Generator()
                    .manual_seed(0), dtype=f64)
    Xd = (X / torch.linalg.norm(X, dim=1, keepdim=True)).to(dev)
    mu0 = mutual_coherence(Xd).item()
    # minimize_mutual_coherence's loop, stage by stage (Xd's rows are unit)
    stages = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    V, step = Xd, _STEP_INIT
    for p in P_SCHEDULE:
        V, step, it, kept = _minimize_p(V, p, step)
        stages.append({'iterations': it, 'kept': kept})
    torch.cuda.synchronize()
    total_ms = 1e3 * (time.perf_counter() - t0)
    mu1 = mutual_coherence(V).item()
    iters = sum(st['iterations'] for st in stages)
    unit_err = (torch.linalg.norm(V, dim=1) - 1).abs().max().item()
    if not (mu1 < mu0 and unit_err <= COH_UNIT_TOL):
        fail(f'coherence: mu {mu0} -> {mu1}, rows off unit by {unit_err}')
    G = gram_offdiag(V)
    products_ms, _ = device_ms(torch, lambda: (G @ V, V @ V.t()), 5)
    # where an iteration's time goes: a trace of the first stage
    iters0 = []

    def stage0():
        iters0.append(_minimize_p(Xd, P_SCHEDULE[0], _STEP_INIT)[2])
    busy0, top0 = traced_top_kernels(torch, stage0, 1, top=6)
    n, d = CORA_S, CORA_D
    bound_ms = 1e3 * 2 * 2 * n * n * d / PEAK_F64_TC_OPS

    m, k = COH_CHECK
    Xs = torch.randn((m, k), generator=torch.Generator().manual_seed(1),
                     dtype=f64)
    got = minimize_mutual_coherence(Xs.to(dev)).cpu()
    want = minimize_mutual_coherence(Xs)
    cpu_err = (got - want).abs().max().item()
    if not cpu_err <= COH_CPU_TOL:
        fail(f'coherence: the card differs from the CPU at {m} x {k} by '
             f'{cpu_err:.3e}')
    res = {'frame': [n, d], 'dtype': 'float64', 'mu_before': mu0,
           'mu_after': mu1, 'unit_row_max_err': unit_err,
           'stages_kept': sum(st['kept'] for st in stages),
           'iterations': iters,
           'iterations_per_stage': [st['iterations'] for st in stages],
           'kept_per_stage': [st['kept'] for st in stages],
           'total_ms': total_ms, 'ms_per_iteration': total_ms / iters,
           'bound_ms_per_iteration': bound_ms,
           'products_ms_per_iteration': products_ms,
           'stage0_iterations': iters0[-1],
           'stage0_busy_ms_per_iteration': busy0 / iters0[-1],
           'stage0_top_kernels_ms_per_stage': top0,
           'cpu_check': [m, k], 'cpu_max_abs_err': cpu_err}
    print('coherence: ' + json.dumps(res), flush=True)


def defaults_phase(torch, T, dev, counts, errs):
    """Phase 24: models with their default arguments, which minimize their
    slice coherence on the card as they are built.  FSWConv(64, 64) served
    through a GraphServer on the bench envelope (K1f), request 0 against a
    CPU copy (its state_dict loaded); the Trainer's FSWGNN on the Cora
    stand-in with minimize_slice_coherence=True (layer 0's frame 2865 x
    1433), built and timed, then DEFAULTS_EPOCHS steps at learning rate
    1e-3 with the loss falling (K1f, K1b, K2f, K2b; at the default 1e-2
    the stand-in's loss climbs for the first steps); FSWConv(64, 64, mlp_layers=0) (the
    coherence-minimized dim_reduct, concat_self) forward on the bench graph
    against its CPU copy."""
    from fsw_gnn_tpu_torch.data import load
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    res = {}

    def fresh(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = T.FSWConv(D_IN, D_OUT, device=dev,
                      generator=torch.Generator().manual_seed(0), **kw)
        torch.cuda.synchronize()
        build_ms = 1e3 * (time.perf_counter() - t0)
        cpu = T.FSWConv(D_IN, D_OUT, minimize_slice_coherence=False,
                        device='cpu', **kw)
        cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        return m, cpu, build_ms

    # FSWConv(64, 64) served
    model, cpu_model, res['conv_build_ms'] = fresh()
    res['conv_slice_mu'] = T.mutual_coherence(
        model.fsw_embed.proj_vecs.detach()).item()
    ref_ei, _ = simple_graph(0, N_NODES)
    classes, class_rows = T.multi_envelope(
        T.from_edge_index(ref_ei, N_NODES), N_NODES)
    env = dict(classes=classes, class_rows=class_rows,
               assume_uniform_w=True)
    server = T.GraphServer(model, N_NODES, MAX_EDGES, cuda_graphs=False,
                           device=dev, **env)
    server.warmup(D_IN)
    reqs = []
    for i in range(DEFAULTS_REQUESTS):
        ei, rng = simple_graph(70 + i, N_NODES)
        reqs.append((ei, rng.standard_normal((N_NODES, D_IN))
                     .astype(np.float32)))
    R.fsw_rank_aggregate_proj.launches = 0
    outs = [server.predict(ei, X) for ei, X in reqs]
    torch.cuda.synchronize()
    n_f = R.fsw_rank_aggregate_proj.launches
    if n_f != len(classes) * len(reqs):
        fail(f'defaults: K1f launched {n_f} times for {len(reqs)} '
             f'requests of {len(classes)} classes')
    counts['fsw_rank_fwdp'] += n_f
    for out in outs:
        if out.shape != (N_NODES, D_OUT) or not np.isfinite(out).all():
            fail('defaults: a served output is not finite')
    cpu_server = T.GraphServer(cpu_model, N_NODES, MAX_EDGES, device='cpu',
                               **env)
    res['served_cpu_max_rel_err'] = close_to_cpu(
        torch, 'defaults: served FSWConv(64, 64)',
        torch.from_numpy(outs[0]), torch.from_numpy(
            cpu_server.predict(*reqs[0])), GRAD_RTOL, SERVE_ATOL_REL)
    res['served_k1f_launches'] = n_f
    del server, cpu_server, model, cpu_model

    # the Trainer's FSWGNN, every coherence minimizer on
    data = load('cora')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = T.Trainer(data, T.TrainConfig(hidden_dims=(64, 64),
                                       learning_rate=DEFAULTS_LR,
                                       minimize_slice_coherence=True),
                   device=dev)
    torch.cuda.synchronize()
    res['trainer_build_ms'] = 1e3 * (time.perf_counter() - t0)
    V0 = tr.model.convs[0].fsw_embed.proj_vecs.detach()
    res['layer0_frame'] = list(V0.shape)
    res['layer0_slice_mu'] = T.mutual_coherence(V0).item()
    names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_bwd',
             'fsw_rank_aggregate', 'fsw_rank_aggregate_bwd')
    for name in names:
        getattr(R, name).launches = 0
    losses = [tr.train_epoch() for _ in range(DEFAULTS_EPOCHS)]
    torch.cuda.synchronize()
    n = [getattr(R, name).launches for name in names]
    if min(n) == 0 or any(k % DEFAULTS_EPOCHS for k in n):
        fail(f'defaults: the Trainer launched K1f, K1b, K2f, K2b {n} times '
             f'in {DEFAULTS_EPOCHS} steps')
    for key, k in zip(('fsw_rank_fwdp', 'fsw_rank_bwdp', 'fsw_rank_fwd',
                       'fsw_rank_bwd'), n):
        counts[key] += k
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f'defaults: the Trainer\'s loss is not finite and falling: '
             f'{losses}')
    res['trainer_losses'] = losses
    res['trainer_launches_k1f_k1b_k2f_k2b'] = n
    del tr

    # mlp_layers=0 with concat_self: the dim_reduct head
    model, cpu_model, res['dim_reduct_build_ms'] = fresh(mlp_layers=0)
    _, X, mt = bench_setup(torch, T)
    R.fsw_rank_aggregate_proj.launches = 0
    with torch.no_grad():
        out = model(X.to(dev), mt.to(dev))
        torch.cuda.synchronize()
        n_f = R.fsw_rank_aggregate_proj.launches
        want = cpu_model(X, mt)
    if n_f != len(tables_of(mt)):
        fail(f'defaults: mlp_layers=0 launched K1f {n_f} times')
    counts['fsw_rank_fwdp'] += n_f
    res['dim_reduct_shape'] = list(model.head.dim_reduct.shape)
    res['dim_reduct_cpu_max_rel_err'] = close_to_cpu(
        torch, 'defaults: mlp_layers=0', out, want, GRAD_RTOL,
        SERVE_ATOL_REL)
    print('defaults: ' + json.dumps(res), flush=True)


def _strict(torch, fn):
    """fn with torch's sync debug mode at 'error' while it runs: any host
    synchronisation inside it (a read of a device value, a blocking copy)
    raises instead of passing unseen."""
    def run(*args):
        torch.cuda.set_sync_debug_mode('error')
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return run


def k3_graph_phase(torch, T, dev):
    """Phase 25: K3 replayed in CUDA graphs.  Two graphs captured on one
    stream, so they share its K3 workspace: the flat scan on 2^24 values
    (mask, segments of about 32) and the row form at the CSR call's shape
    (127 rows of the bench graph's padded edges over its mask), each over
    a static input.  They are replayed alternately, each on two different
    inputs in turn, K3G_REPLAYS rounds; every output must be the eager
    call's bits.  The captures run under sync debug mode 'error' and count
    no launch.  Returns a summary."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum, segcumsum_rows,
                                                 segment_boundaries)
    rng = np.random.default_rng(40)
    ids = np.sort(rng.integers(0, K3_N // 32, K3_N)).astype(np.int32)
    mask = segment_boundaries(torch.from_numpy(ids).to(dev))
    g = T.from_edge_index(simple_graph(0, N_NODES)[0], N_NODES)
    rmask = segment_boundaries(torch.from_numpy(g.dst).to(dev))
    m = rmask.shape[0]
    flat = [torch.from_numpy(rng.standard_normal(K3_N).astype(np.float32))
            .to(dev) for _ in range(2)]
    rows = [torch.from_numpy(rng.standard_normal((127, m))
                             .astype(np.float32)).to(dev) for _ in range(2)]
    flat_want = [segcumsum(v, boundaries=mask) for v in flat]
    rows_want = [segcumsum_rows(v, rmask) for v in rows]
    sf, sr = flat[0].clone(), rows[0].clone()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):      # the stream's workspace, made here
        segcumsum(sf, boundaries=mask)
        segcumsum_rows(sr, rmask)
    torch.cuda.current_stream(dev).wait_stream(stream)
    g1, g2 = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    before = segcumsum.launches
    with torch.cuda.graph(g1, stream=stream):
        o1 = _strict(torch, lambda: segcumsum(sf, boundaries=mask))()
    with torch.cuda.graph(g2, stream=stream):
        o2 = _strict(torch, lambda: segcumsum_rows(sr, rmask))()
    if segcumsum.launches != before:
        fail('K3 graphs: a capture counted as a launch')
    checks = 0
    for _ in range(K3G_REPLAYS):
        for i in (0, 1):
            sf.copy_(flat[i])
            g1.replay()
            sr.copy_(rows[i])
            g2.replay()
            if not (torch.equal(o1, flat_want[i])
                    and torch.equal(o2, rows_want[i])):
                fail(f'K3 graphs: a replay on input {i} differs from the '
                     f'eager bits')
            checks += 2
    eager_ms, eager_host = device_ms(
        torch, lambda: segcumsum(sf, boundaries=mask), 20)
    replay_ms, replay_host = device_ms(torch, g1.replay, 20)
    res = {'graphs': 2, 'shared_stream_workspace': True,
           'replays_checked_bit_equal': checks,
           'flat_2^24': {'eager_ms': eager_ms, 'eager_host_ms': eager_host,
                         'replay_ms': replay_ms,
                         'replay_host_ms': replay_host},
           'rows': [127, m]}
    print('K3 graphs: ' + json.dumps(res), flush=True)
    del g1, g2
    return res


def _requests(seed, n_req, n_min, n_max, deg=AVG_DEG):
    sizes = np.random.default_rng(seed).integers(n_min, n_max + 1, n_req)
    sizes[0] = n_max
    out = []
    for i, n in enumerate(sizes):
        ei, rng = simple_graph(seed * 1000 + i, int(n), deg)
        out.append((ei, rng.standard_normal((int(n), D_IN))
                    .astype(np.float32)))
    return out


def _serve(servers, reqs):
    """{name: (outputs, latencies in s)} of `predict` on every request by
    each server, the servers taking each request in turns (the first
    server first on even requests, last on odd ones), so that drift of
    the shared host's speed falls on both alike."""
    res = {k: ([], []) for k in servers}
    for i, (ei, X) in enumerate(reqs):
        order = list(servers) if i % 2 == 0 else list(servers)[::-1]
        for k in order:
            t0 = time.perf_counter()
            res[k][0].append(servers[k].predict(ei, X))
            res[k][1].append(time.perf_counter() - t0)
    return res


def _pct(lat):
    return (1e3 * float(np.median(lat)),
            1e3 * float(np.percentile(lat, 90)))


def graph_server_phase(torch, T, dev, model, counts):
    """Phase 26: the headline server through CUDA graphs.  The bench
    FSWConv behind two GraphServers each on the `multi` route (phase 4's
    envelope, assume_uniform_w) and on the CSR route (no classes): one
    serving through its graphs (the default), one eagerly
    (cuda_graphs=False).  The graph server's routes run their warm-up and
    capture under sync debug mode 'error'; `warmup` must return 2 (1
    without classes) and count its eager warm-up's launches (K1f a class,
    K3 once a CSR forward); then GRAPH_REQUESTS requests of 4096-8192
    nodes (GRAPH_CSR_REQUESTS on the CSR server) must leave
    `num_compiles()` as it was and launch nothing from Python; every
    output against the eager server's (bit for bit, else the largest
    difference); predict_many's window against predict; p50 and p90 of
    `predict`, and the route's device time and host-enqueue time, eager
    against graph (the graph's as one replay)."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    ref_ei, _ = simple_graph(0, N_NODES)
    classes, class_rows = T.multi_envelope(
        T.from_edge_index(ref_ei, N_NODES), N_NODES)
    env = dict(classes=classes, class_rows=class_rows, assume_uniform_w=True)
    res = {}
    for route, kw, n_req in (('multi', env, GRAPH_REQUESTS),
                             ('csr', {}, GRAPH_CSR_REQUESTS)):
        eager = T.GraphServer(model, N_NODES, MAX_EDGES, cuda_graphs=False,
                              device=dev, **kw)
        graph = T.GraphServer(model, N_NODES, MAX_EDGES, device=dev, **kw)
        graph._graphs._fns = {k: _strict(torch, f)
                              for k, f in graph._graphs._fns.items()}
        eager.warmup(D_IN)
        R.fsw_rank_aggregate_proj.launches = 0
        segcumsum.launches = 0
        new = graph.warmup(D_IN)
        torch.cuda.synchronize()
        k1f, k3 = R.fsw_rank_aggregate_proj.launches, segcumsum.launches
        want = (2, len(classes), 1) if kw else (1, 0, 1)
        if (new, k1f, k3) != want:
            fail(f'graph server ({route}): warmup returned {new}, launched '
                 f'K1f {k1f} and K3 {k3} times; expected {want}')
        counts['fsw_rank_fwdp'] += k1f
        counts['segcumsum'] += k3
        reqs = _requests(50 + len(kw), n_req, MIN_NODES, N_NODES)
        for s in (graph, eager):     # each host path once before timing
            s.predict(*reqs[1])
        R.fsw_rank_aggregate_proj.launches = 0
        segcumsum.launches = 0
        served = _serve({'graph': graph}, reqs)
        torch.cuda.synchronize()
        if (R.fsw_rank_aggregate_proj.launches, segcumsum.launches) != (
                0, 0):
            fail(f'graph server ({route}): a request launched a kernel from '
                 f'Python')
        served.update(_serve({'eager': eager, 'graph': graph}, reqs))
        (outs_g, lat_g), (outs_e, lat_e) = served['graph'], served['eager']
        if graph.num_compiles() != want[0]:
            fail(f'graph server ({route}): num_compiles() '
                 f'{graph.num_compiles()} after {n_req} requests')
        if graph.fallbacks or graph.uniform_w_fallbacks:
            fail(f'graph server ({route}): a request left the envelope')
        diff = max(float(np.abs(a - b).max()) for a, b in zip(outs_g,
                                                               outs_e))
        equal = all(np.array_equal(a, b) for a, b in zip(outs_g, outs_e))
        scale = max(float(np.abs(b).max()) for b in outs_e)
        if not all(np.isfinite(a).all() for a in outs_g):
            fail(f'graph server ({route}): an output is not finite')
        if not diff <= SERVE_ATOL_REL * scale:
            fail(f'graph server ({route}): graph against eager max abs err '
                 f'{diff:.3e}, scale {scale:.3e}')
        many = graph.predict_many(reqs[:2 * WINDOW], window=WINDOW)
        if not all(np.array_equal(a, b) for a, b in zip(many, outs_g)):
            fail(f'graph server ({route}): predict_many differs from '
                 f'predict')
        # one forward of the full-size request, eager and replayed (the
        # graph's input buffer holds the same request)
        rt, host, _ = graph._host_request(*reqs[0])
        buf = [t.to(dev) for t in host]
        fn = eager._graphs._fns[rt]
        e_ms, e_host = device_ms(torch, lambda: fn(*buf), 10)
        entry = graph._graphs._graphs[graph._graphs._key(rt, host)]
        entry._copy_in(buf)
        g_ms, g_host = device_ms(torch, entry.graph.replay, 10)
        # where the device time of one forward goes, eager and replayed
        traces = {k: traced_top_kernels(torch, f, 5, top=12) for k, f in
                  (('eager', lambda: fn(*buf)), ('graph', entry.graph.replay))}
        # the smallest request: its padding edges all land in the last
        # recipient's segment
        small = min(reqs, key=lambda r: r[1].shape[0])
        entry._copy_in([t.to(dev) for t in graph._host_request(*small)[1]])
        s_ms, _ = device_ms(torch, entry.graph.replay, 10)
        res[route] = {
            'warmup_compiles': new, 'num_compiles': graph.num_compiles(),
            'requests': n_req, 'warmup_launches': {'k1f': k1f, 'k3': k3},
            'bit_equal_to_eager': equal, 'max_abs_diff': diff,
            'output_scale': scale,
            'p50_ms': {'eager': _pct(lat_e)[0], 'graph': _pct(lat_g)[0]},
            'p90_ms': {'eager': _pct(lat_e)[1], 'graph': _pct(lat_g)[1]},
            'forward_device_ms': {'eager': e_ms, 'graph': g_ms},
            'smallest_request': {'nodes': small[1].shape[0],
                                 'edges': small[0].shape[1],
                                 'graph_device_ms': s_ms},
            'forward_host_enqueue_ms': {'eager': e_host, 'graph': g_host},
            'wire_bytes': sum(t.nbytes for t in host),
            'traced_busy_ms': {k: v[0] for k, v in traces.items()},
            'top_kernels': {k: v[1] for k, v in traces.items()}}
        del eager, graph, entry
    print('graph server: ' + json.dumps(res), flush=True)
    return res


def dtype_server_phase(torch, T, dev, model, counts):
    """Phase 27: the other wire layouts through graphs.  A bfloat16 server
    at the headline envelope (the single carrier with pair-packed floats;
    int32 indices, since the envelope's 131072 edges exceed uint16), beside
    a float32 server, on BF16_REQUESTS requests: the largest difference
    relative to the float32 output's scale, and the wire bytes of a
    request.  Then Cora's envelope (2708 nodes, 10556 edges: uint16
    indices by the JAX rule; the degree classes from the Cora stand-in)
    with the same model on random 64-wide features, the stand-in's graph
    and its subgraphs on its first nodes as requests (every degree within
    the envelope): the float32 server with uint16 indices against one with
    int32 indices (pack_indices=False), bit for bit, and a bfloat16 one,
    each request's wire bytes."""
    from fsw_gnn_tpu_torch.data.datasets import load
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    ref_ei, _ = simple_graph(0, N_NODES)
    classes, class_rows = T.multi_envelope(
        T.from_edge_index(ref_ei, N_NODES), N_NODES)
    env = dict(classes=classes, class_rows=class_rows, assume_uniform_w=True)
    reqs = _requests(60, BF16_REQUESTS, MIN_NODES, N_NODES)
    res = {}

    def run(servers, reqs):
        R.fsw_rank_aggregate_proj.launches = 0
        segcumsum.launches = 0
        for s in servers.values():
            if s.warmup(D_IN) != 2:
                fail('dtype servers: warmup did not capture two graphs')
        torch.cuda.synchronize()
        k1f, k3 = R.fsw_rank_aggregate_proj.launches, segcumsum.launches
        if not (k1f and k3 == len(servers)):
            fail(f'dtype servers: the warm-ups launched K1f {k1f} and K3 '
                 f'{k3} times')
        counts['fsw_rank_fwdp'] += k1f
        counts['segcumsum'] += k3
        outs = {k: [s.predict(*r) for r in reqs] for k, s in servers.items()}
        wire = {k: sum(t.nbytes for t in s._host_request(*reqs[0])[1])
                for k, s in servers.items()}
        for k, s in servers.items():
            if s.num_compiles() != 2 or s.fallbacks:
                fail(f'dtype servers ({k}): {s.num_compiles()} graphs, '
                     f'{s.fallbacks} fallbacks')
            if not all(np.isfinite(o).all() for o in outs[k]):
                fail(f'dtype servers ({k}): an output is not finite')
        return outs, wire

    servers = {
        'float32': T.GraphServer(model, N_NODES, MAX_EDGES, device=dev,
                                 **env),
        'bfloat16': T.GraphServer(model, N_NODES, MAX_EDGES, device=dev,
                                  dtype=torch.bfloat16, **env)}
    if servers['bfloat16']._idx16 or not servers['bfloat16']._single:
        fail('bfloat16 server: expected the single carrier, int32 indices')
    outs, wire = run(servers, reqs)
    res['headline'] = {
        'bf16_max_rel_err': max(
            float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(outs['bfloat16'], outs['float32'])),
        'wire_bytes': wire}
    del servers

    cora = load('cora')
    n_c, e_c = CORA_NODES, CORA_EDGES
    if cora.num_nodes != n_c or cora.edge_index.shape[1] > e_c:
        fail(f'the Cora stand-in ({cora.num_nodes} nodes, '
             f'{cora.edge_index.shape[1]} edges) leaves Cora\'s envelope')
    c_classes, c_rows = T.multi_envelope(
        T.from_edge_index(cora.edge_index, n_c), n_c)
    c_env = dict(classes=c_classes, class_rows=c_rows)
    rng = np.random.default_rng(61)
    creqs = []
    for n in [n_c] + list(rng.integers(n_c // 2, n_c, BF16_REQUESTS - 1)):
        keep = (cora.edge_index < n).all(axis=0)
        creqs.append((cora.edge_index[:, keep],
                      rng.standard_normal((int(n), D_IN))
                      .astype(np.float32)))
    servers = {
        'uint16': T.GraphServer(model, n_c, e_c, device=dev, **c_env),
        'int32': T.GraphServer(model, n_c, e_c, device=dev,
                               pack_indices=False, **c_env),
        'uint16 bfloat16': T.GraphServer(model, n_c, e_c, device=dev,
                                         dtype=torch.bfloat16, **c_env)}
    if not (servers['uint16']._idx16 and servers['uint16 bfloat16']._idx16):
        fail('Cora envelope: uint16 indices expected')
    outs, wire = run(servers, creqs)
    if not all(np.array_equal(a, b)
               for a, b in zip(outs['uint16'], outs['int32'])):
        fail('Cora envelope: uint16 and int32 indices served other bits')
    res['cora'] = {
        'envelope': [n_c, e_c], 'requests': len(creqs),
        'uint16_bit_equal_to_int32': True,
        'bf16_max_rel_err': max(
            float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(outs['uint16 bfloat16'], outs['uint16'])),
        'wire_bytes': wire}
    del servers
    print('dtype servers: ' + json.dumps(res), flush=True)
    return res


def export_phase(torch, T, dev, model, counts):
    """Phase 28: `export_forward` on the card of the bench FSWConv closed
    over the bench graph, in the `multi` layout and as a CSR Graph; each
    artifact saved, loaded back (`load_artifact`) and called on the
    bench features: its output against the eager module's, and one call
    timed against it (device and host time).  The artifact's calls go
    through the kernels' custom ops (K1f, K3), whose launches count."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    ei, rng = simple_graph(0, N_NODES)
    Xd = torch.from_numpy(rng.standard_normal((N_NODES, D_IN))
                          .astype(np.float32)).to(dev)
    g = T.from_edge_index(ei, N_NODES)
    res = {}
    for layout, graph in (('multi', T.to_multi_table(g)), ('csr', g)):
        t0 = time.perf_counter()
        blob = T.export_forward(model, Xd, graph, device=dev)
        export_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f'{layout}.pt2')
            T.save_artifact(path, blob)
            fwd = T.load_artifact(path)
        gd = graph.to(dev)
        R.fsw_rank_aggregate_proj.launches = 0
        segcumsum.launches = 0
        got = fwd(Xd)
        torch.cuda.synchronize()
        k1f, k3 = R.fsw_rank_aggregate_proj.launches, segcumsum.launches
        if (k1f > 0) != (layout == 'multi') or (k3 > 0) != (layout == 'csr'):
            fail(f'export ({layout}): the artifact launched K1f {k1f} and '
                 f'K3 {k3} times')
        counts['fsw_rank_fwdp'] += k1f
        counts['segcumsum'] += k3
        with torch.inference_mode():
            want = model(Xd, gd)
            m_ms, m_host = device_ms(torch, lambda: model(Xd, gd), 10)
            a_ms, a_host = device_ms(torch, lambda: fwd(Xd), 10)
        diff = float((got - want).abs().max().detach())
        scale = float(want.abs().max())
        if not (bool(torch.isfinite(got).all())
                and diff <= SERVE_ATOL_REL * scale):
            fail(f'export ({layout}): artifact against module max abs err '
                 f'{diff:.3e}, scale {scale:.3e}')
        res[layout] = {'bytes': len(blob), 'export_s': export_s,
                       'bit_equal': bool(torch.equal(got, want)),
                       'max_abs_diff': diff,
                       'device_ms': {'module': m_ms, 'artifact': a_ms},
                       'host_ms': {'module': m_host, 'artifact': a_host},
                       'launches': {'k1f': k1f, 'k3': k3}}
    print('export: ' + json.dumps(res), flush=True)
    return res


def arxiv_data(seed=0):
    """A node-classification graph of ogbn-arxiv's published counts (169343
    nodes, 1166243 directed edges, 128 features, 40 classes, OGB's split
    sizes), built in O(E) from `seed`: planted labels, ARXIV_SAME_CLASS of
    the edges within the recipient's class (senders drawn from it, the rest
    uniform), no self-loops, features N(mean of the class, 1)."""
    from fsw_gnn_tpu_torch.data import NodeClassificationData
    rng = np.random.default_rng(seed)
    N, E, F, C = ARXIV_NODES, ARXIV_EDGES, ARXIV_FEATURES, ARXIV_CLASSES
    labels = rng.integers(0, C, N)
    by_class = np.argsort(labels, kind='stable')
    starts = np.searchsorted(labels[by_class], np.arange(C + 1))
    dst = rng.integers(0, N, E)
    src = rng.integers(0, N, E)
    same = rng.random(E) < ARXIV_SAME_CLASS
    cls = labels[dst[same]]
    size = starts[cls + 1] - starts[cls]
    src[same] = by_class[starts[cls] + (rng.random(cls.shape[0])
                                        * size).astype(np.int64)]
    src = np.where(src == dst, (src + 1) % N, src)
    means = rng.standard_normal((C, F)) * ARXIV_MEAN_SCALE
    features = (means[labels]
                + rng.standard_normal((N, F))).astype(np.float32)
    perm = rng.permutation(N)
    n_tr, n_va, _ = ARXIV_SPLIT
    masks = []
    for lo, hi in ((0, n_tr), (n_tr, n_tr + n_va), (n_tr + n_va, N)):
        m = np.zeros(N, bool)
        m[perm[lo:hi]] = True
        masks.append(m)
    return NodeClassificationData(
        name='ogbn-arxiv-shaped', edge_index=np.stack([src, dst]),
        features=features, labels=labels, train_mask=masks[0],
        val_mask=masks[1], test_mask=masks[2])


def minibatch_phase(torch, T, dev, smi_line, counts, errs):
    """Phase 29: the MinibatchTrainer at arxiv's published scale
    (`arxiv_data`): FSWGNN hidden (64,) and 40 outputs at the CLI's
    defaults, batch 1024, fanouts (10, 10), one epoch (89 steps).  The
    first step's loss against the same step on the CPU (the plain path),
    the loss finite and falling, every batch one shape, K3 two launches a
    step and no rank kernel (the batches take the CSR route); K3 held
    against its plain version on one step's calls and timed on each beside
    its bound, its plain version and torch.cumsum; the epoch's seconds,
    a step's host parts beside its device time, the idle share, a trace of
    a step and the peak memory.  Returns the trainer for phase 30."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.ops import segcumsum
    from fsw_gnn_tpu_torch.train import (MinibatchTrainer,
                                         masked_softmax_cross_entropy)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = arxiv_data(0)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = MinibatchTrainer(data, T.TrainConfig(hidden_dims=MB_HIDDEN,
                                              epochs=1, eval_every=1),
                          batch_size=MB_BATCH, fanouts=MB_FANOUTS,
                          device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if (tr.max_nodes, tr.max_edges) != MB_CAPS:
        fail(f'minibatch: caps {(tr.max_nodes, tr.max_edges)}, expected '
             f'{MB_CAPS}')
    cpu_model = copy.deepcopy(tr.model).to('cpu')

    fields = ('src', 'dst', 'weight', 'row_ptr', 'in_degrees', 'src_order',
              'src_sorted')
    shapes, losses, first = set(), [], []
    real_build, real_step = tr._build_batch, tr._mb_step

    def build(seeds):
        out = real_build(seeds)
        g = out[0]
        shapes.add(tuple(tuple(getattr(g, f).shape) for f in fields)
                   + tuple(tuple(t.shape) for t in out[1:])
                   + ((g.num_nodes, g.num_recipients, g.num_edges),))
        if not first:
            first.append(out)
        return out

    def step(*args):
        loss = real_step(*args)
        losses.append(loss)
        return loss
    tr._build_batch, tr._mb_step = build, step
    rank_names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_bwd',
                  'fsw_rank_aggregate', 'fsw_rank_aggregate_bwd')
    for name in rank_names:
        getattr(R, name).launches = 0
    segcumsum.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mean_loss = tr.train_epoch()          # ends in a wait for the device
    epoch_s = time.perf_counter() - t0
    peak_train = torch.cuda.max_memory_allocated()
    tr._build_batch, tr._mb_step = real_build, real_step
    n_k3 = segcumsum.launches
    n_rank = {n: getattr(R, n).launches for n in rank_names}
    n_steps = len(losses)
    want_steps = -(-int(data.train_mask.sum()) // MB_BATCH)
    n_layers = len(tr.model.convs)
    if n_steps != want_steps or n_k3 != n_steps * n_layers or any(
            n_rank.values()):
        fail(f'minibatch: {n_steps} steps (expected {want_steps}), K3 '
             f'launched {n_k3} times (expected {n_steps * n_layers}), rank '
             f'kernels {n_rank} (expected none)')
    counts['segcumsum'] += n_k3
    L = torch.stack(losses).cpu().numpy()
    if not (np.isfinite(L).all() and L[-10:].mean() < L[:10].mean()
            and L[-1] < L[0]):
        fail(f'minibatch: loss not finite and falling: {L.tolist()}')
    if len(shapes) != 1:
        fail(f'minibatch: the batches took {len(shapes)} shapes: {shapes}')

    # the first step's loss on the CPU, the plain path, the same model
    g0, X0, y0, m0 = first[0]
    cpu_model.train()
    t0 = time.perf_counter()
    with torch.no_grad():
        s, c = masked_softmax_cross_entropy(
            cpu_model(X0.cpu(), g0.to('cpu')), y0.cpu(), m0.cpu())
        loss0_cpu = (s / torch.clamp(c, min=1.0)).item()
    cpu_s = time.perf_counter() - t0
    if not abs(L[0] - loss0_cpu) <= LOSS0_RTOL * abs(loss0_cpu):
        fail(f'minibatch: first loss {L[0]} differs from the CPU\'s '
             f'{loss0_cpu}')
    del first, cpu_model, g0, X0, y0, m0

    # K3 on one step's calls; a step's parts, timed on one batch
    seeds = tr.train_seeds[:MB_BATCH]
    batch = real_build(seeds)
    calls = capture_k3_calls(lambda: tr._mb_step(*batch))
    if len(calls) != n_layers:
        fail(f'minibatch: {len(calls)} K3 calls in a step, expected '
             f'{n_layers}')
    from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum_rows,
                                                 segcumsum_rows_plain)
    e, k3_calls = 0.0, []
    for k, call in enumerate(calls):
        vals, mask = call['values'], call['mask']
        e = max(e, check_k3(torch, f'minibatch step, layer {k}', vals,
                            dict(boundaries=mask)))
        # this call's K3 beside its bound, its plain version and
        # torch.cumsum along the rows (unsegmented, a floor)
        with torch.no_grad():
            k3_calls.append({
                'shape': list(vals.shape),
                'ms': device_ms(torch, lambda: segcumsum_rows(vals, mask),
                                20)[0],
                'plain_ms': device_ms(torch, lambda: segcumsum_rows_plain(
                    vals, mask), 2, 2)[0],
                'torch_cumsum_ms': device_ms(
                    torch, lambda: torch.cumsum(vals, 1), 20)[0],
                'bound_ms': 1e3 * k3_bytes(vals.numel(), 4, 'mask',
                                           m=vals.shape[1]) / PEAK_BYTES})
    errs['segcumsum'] = max(errs['segcumsum'], e)
    del calls

    def host_ms(fn, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(times))
    sampled = tr.sampler.sample(seeds, labels=data.labels,
                                max_nodes=tr.max_nodes)
    g_host = T.from_edge_index(sampled.edge_index_local, tr.max_nodes,
                               pad_to=tr.max_edges, dtype=np.float32)
    real_edges = g_host.num_edges

    def copy_in():
        g_host.to(dev)
        tr.X[torch.from_numpy(sampled.node_ids).to(dev)]
        torch.from_numpy(np.zeros(tr.max_nodes, np.int64)).to(dev)
        torch.from_numpy(np.zeros(tr.max_nodes, np.float32)).to(dev)
    parts = {
        'sample_ms': host_ms(lambda: tr.sampler.sample(
            seeds, labels=data.labels, max_nodes=tr.max_nodes)),
        'csr_build_ms': host_ms(lambda: T.from_edge_index(
            sampled.edge_index_local, tr.max_nodes, pad_to=tr.max_edges,
            dtype=np.float32)),
        'copy_in_ms': host_ms(copy_in),
        'build_batch_ms': host_ms(lambda: real_build(seeds))}
    parts['step_device_ms'], parts['step_host_enqueue_ms'] = device_ms(
        torch, lambda: tr._mb_step(*batch), 3)
    parts['step_busy_ms'], kern = traced_top_kernels(
        torch, lambda: tr._mb_step(*batch), 3, top=10 ** 6)
    seg_reduce_ms = sum(k[1] for k in kern
                        if 'segment_reduce' in k[0].lower()
                        or 'segmentreduce' in k[0].lower())
    pad = padding_segment_ms(torch, batch[0], k3_calls[0]['shape'][0])
    res = {
        'card': smi_line, 'nodes': data.num_nodes,
        'edges': int(tr.graph.num_edges),
        'features': ARXIV_FEATURES, 'classes': data.num_classes,
        'train_seeds': int(data.train_mask.sum()), 'batch': MB_BATCH,
        'fanouts': list(MB_FANOUTS), 'max_nodes': tr.max_nodes,
        'max_edges': tr.max_edges, 'real_edges_one_batch': real_edges,
        'padding_edges_one_batch': tr.max_edges - real_edges,
        'real_nodes_one_batch': sampled.num_real_nodes,
        'steps': n_steps, 'k3_launches': n_k3, 'k3_calls': k3_calls,
        'k3_max_abs_err': e, 'rank_kernel_launches': n_rank,
        'data_s': data_s, 'init_s': init_s, 'epoch_s': epoch_s,
        'loss_first': float(L[0]), 'loss_first_cpu': loss0_cpu,
        'cpu_step_forward_s': cpu_s, 'loss_last': float(L[-1]),
        'loss_epoch_mean': mean_loss, **parts,
        'device_idle_share': 1.0 - n_steps * parts['step_device_ms']
        / (1e3 * epoch_s),
        'segment_reduce_ms_per_step': seg_reduce_ms,
        'padding_segment': pad,
        'step_top_kernels': kern[:10],
        'max_memory_allocated_mb': peak_train / 2 ** 20,
        'phase_s': time.perf_counter() - t_phase}
    print('minibatch: ' + json.dumps(res), flush=True)
    del batch
    return tr


def padding_segment_ms(torch, g, S):
    """What the batch graph's padding segment costs the CSR path's sorted
    segment-sum (`ops.segment.segment_sum`, `torch.segment_reduce`): its
    device ms on (S, E) terms with the graph's segments, where every
    padding edge lies in the last recipient's segment, against the same
    terms with the padding edges given one each to the empty padded
    recipients before the last (a layout the port does not build; timed
    only to price the padding)."""
    from fsw_gnn_tpu_torch.ops.segment import segment_sum
    R, E = g.num_recipients, g.src.shape[0]
    real = int((g.weight > 0).sum())
    lengths = torch.diff(g.row_ptr.long())
    spread = lengths.clone()
    n_pad = E - real
    spread[R - 1] -= n_pad
    empty = torch.nonzero(spread[:R - 1] == 0).flatten()
    if empty.numel() < n_pad:
        return None
    spread[empty[-n_pad:]] += 1
    dst_spread = torch.repeat_interleave(
        torch.arange(R, device=g.dst.device), spread)
    terms = torch.randn((S, E), device=g.dst.device)
    out = {}
    with torch.no_grad():
        for name, ids, ln in (('as_built', g.dst, lengths),
                              ('padding_spread', dst_spread, spread)):
            out[f'{name}_ms'] = device_ms(torch, lambda: segment_sum(
                terms, ids, R, 1, ln), 10)[0]
    out.update(rows=S, edges=E, padding_edges=n_pad)
    return out


def layerwise_phase(torch, T, dev, tr, smi_line, counts, errs):
    """Phase 30: the trained model of phase 29 through `layerwise_predict`
    (node_chunk 16384) and through the full-graph predict (the `multi`
    layout: K1f and K2f), both timed with their peak memory; the largest
    difference within 1e-4 of the logits' scale; K1f and K2f held against
    their plain versions on every call of the full forward, and timed on
    each beside its bound and plain version; K3 on one chunk's calls; the
    launches counted."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.ops import segcumsum
    from fsw_gnn_tpu_torch.train.infer import layerwise_predict
    t_phase = time.perf_counter()
    data = tr.data
    n_layers = len(tr.model.convs)
    n_classes = len(tables_of(tr.compute_graph))
    tr.model.eval()
    run = lambda: tr.model(tr.X, tr.compute_graph)  # noqa: E731
    with torch.no_grad():
        calls = capture_rank_calls(run)
        calls2 = capture_rank_calls(run, 'fsw_rank_aggregate')
    if len(calls) + len(calls2) != n_layers * n_classes:
        fail(f'layer-wise: the full forward made {len(calls)} K1 and '
             f'{len(calls2)} K2 calls for {n_layers} layers x {n_classes} '
             f'classes')
    fwd = {'K1': 0.0, 'K2': 0.0}
    timed_calls = []
    with torch.no_grad():
        for kind, cs in (('K1', calls), ('K2', calls2)):
            _, _, kernel, plain, _, _, _ = rank_fns(kind)
            for args, unif, _ in cs:
                label = f'arxiv evaluation, {kind}, {tuple(args[0].shape)}'
                fwd[kind] = max(fwd[kind], check_fwd(torch, label, args,
                                                     unif, kind)[0])
                if kind == 'K2':
                    check_fwd_padding(torch, label, args, unif, kind)
                    bound, by = rank2_bound_ms(args[1], args[0].shape[2])
                else:
                    bound, by, _ = rank_bound_ms(args[1], args[0].shape[2],
                                                 args[4].shape[1])
                # each call's kernel beside its bound and plain version
                timed_calls.append({
                    'kernel': f'{kind}f', 'shape': list(args[0].shape),
                    'ms': device_ms(torch, lambda: kernel(
                        *args, uniform_w=unif, with_dw=False), 5)[0],
                    'plain_ms': device_ms(torch, lambda: plain(
                        *args, uniform_w=unif), 2, 2)[0],
                    'bound_ms': bound, 'bound_by': by})
    errs['fsw_rank_fwdp'] = max(errs['fsw_rank_fwdp'], fwd['K1'])
    errs['fsw_rank_fwd'] = max(errs['fsw_rank_fwd'], fwd['K2'])
    del calls, calls2

    names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate')
    for name in names:
        getattr(R, name).launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = tr.predict()
    full_s = time.perf_counter() - t0
    full_peak = torch.cuda.max_memory_allocated()
    n_f, n_f2 = (getattr(R, name).launches for name in names)
    if n_f + n_f2 != n_layers * n_classes:
        fail(f'layer-wise: the full predict launched K1f {n_f} and K2f '
             f'{n_f2} times, expected {n_layers * n_classes} in all')
    counts['fsw_rank_fwdp'] += n_f
    counts['fsw_rank_fwd'] += n_f2

    n_chunks = -(-data.num_nodes // LW_NODE_CHUNK)
    segcumsum.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lw = layerwise_predict(tr.model, data.features, tr.graph, LW_NODE_CHUNK,
                           device=dev)
    lw_s = time.perf_counter() - t0
    lw_peak = torch.cuda.max_memory_allocated()
    n_k3 = segcumsum.launches
    if n_k3 != n_layers * n_chunks:
        fail(f'layer-wise: K3 launched {n_k3} times, expected '
             f'{n_layers * n_chunks}')
    counts['segcumsum'] += n_k3
    scale = float(np.abs(full).max())
    diff = float(np.abs(lw - full).max())
    if not (np.isfinite(lw).all() and diff <= LW_ATOL_REL * scale):
        fail(f'layer-wise: differs from the full predict by {diff:.3e} '
             f'(scale {scale:.3e})')

    # K3 on one chunk's calls: the first chunk of each layer
    calls = capture_k3_calls(lambda: layerwise_predict(
        tr.model, data.features, tr.graph, LW_NODE_CHUNK, device=dev))
    e = 0.0
    for k in range(n_layers):
        call = calls[k * n_chunks]
        e = max(e, check_k3(torch, f'layer-wise, layer {k}, chunk 0',
                            call['values'], dict(boundaries=call['mask'])))
    errs['segcumsum'] = max(errs['segcumsum'], e)
    k3_shapes = [list(calls[k * n_chunks]['values'].shape)
                 for k in range(n_layers)]
    del calls
    pred = full.argmax(-1)
    acc = {f'{split}_acc': float((pred[m] == data.labels[m]).mean())
           for split, m in (('train', data.train_mask),
                            ('val', data.val_mask),
                            ('test', data.test_mask))}
    res = {'card': smi_line, 'node_chunk': LW_NODE_CHUNK,
           'chunks': n_chunks, 'degree_classes': n_classes,
           'k1f_launches': n_f, 'k2f_launches': n_f2,
           'rank_calls': timed_calls,
           'k1f_max_abs_err': fwd['K1'], 'k2f_max_abs_err': fwd['K2'],
           'k3_launches': n_k3, 'k3_chunk_shapes': k3_shapes,
           'k3_max_abs_err': e,
           'full_predict_s': full_s, 'layerwise_s': lw_s,
           'allocated_before_mb': base / 2 ** 20,
           'full_peak_mb': full_peak / 2 ** 20,
           'layerwise_peak_mb': lw_peak / 2 ** 20,
           'max_abs_diff': diff, 'logit_scale': scale, **acc,
           'phase_s': time.perf_counter() - t_phase}
    print('layer-wise: ' + json.dumps(res), flush=True)


def cli_minibatch_phase(smi_line):
    """Phase 31: `python -m fsw_gnn_tpu_torch.cli train --dataset
    ogbn-arxiv --minibatch ...` on the loader's stand-in (or
    data/ogbn-arxiv.npz where it is present), in a process of its own:
    exit 0 and a JSON line that says device cuda."""
    cmd = [sys.executable, '-m', 'fsw_gnn_tpu_torch.cli', 'train',
           '--dataset', 'ogbn-arxiv', '--minibatch', '--batch-size',
           str(MB_BATCH), '--fanouts', ','.join(map(str, MB_FANOUTS)),
           '--epochs', str(CLI_EPOCHS), '--eval-node-chunk',
           str(CLI_NODE_CHUNK)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f'cli: {" ".join(cmd[1:])} ran past {CLI_TIMEOUT} s')
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f'cli: exit {proc.returncode}:\n{proc.stderr[-3000:]}')
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        fail(f'cli: no JSON line in its output:\n{proc.stdout[-2000:]}')
    if out.get('device') != 'cuda' or out.get('epochs_run') != CLI_EPOCHS:
        fail(f'cli: {out}')
    print('cli: ' + json.dumps({'card': smi_line,
                                'command': ' '.join(cmd[1:]), **out,
                                'wall_s': wall}), flush=True)


def start_one_rank_group(torch, tmp):
    """A one-process group on NCCL over a file store in `tmp` (no TCP
    port), through the port's own start-up."""
    from fsw_gnn_tpu_torch.parallel import ensure_distributed
    ensure_distributed(init_method='file://' + os.path.join(tmp, 'store'),
                       world_size=1, rank=0, device='cuda')
    import torch.distributed as dist
    if not (dist.is_initialized() and dist.get_backend() == 'nccl'
            and dist.get_world_size() == 1):
        fail('distributed: no one-rank NCCL group')


def exchange_calls(torch, tr, exchange):
    """The exchange of one forward of the distributed trainer `tr`: each
    call's input (detached), and the callable that exchanges it (the
    all-gather, the all-to-all with its index, or one chunk's all-gather,
    started and waited for)."""
    from fsw_gnn_tpu_torch.parallel.dist import _model_exchange_kwargs
    kw = _model_exchange_kwargs(exchange, tr.mesh, tr.shards,
                                tr.cfg.overlap_chunks)
    key = 'proj_gather_fn' if exchange == 'overlap' else 'gather_fn'
    real, seen = kw[key], []

    def spy(x):
        seen.append(x.detach().clone())
        return real(x)
    kw[key] = spy
    tr.model.eval()
    with torch.no_grad():
        out = tr.model(tr.X, tr.compute_graph, **kw)
    del out
    if exchange == 'overlap':
        return seen, lambda x: real(x).wait()
    return seen, real


def exchange_ms(torch, seen, fn):
    """Device ms of the exchange of one training step: every call of one
    forward, run forward and backward (the reduce-scatter, or the reverse
    all-to-all) on its recorded input."""
    total = 0.0
    for x in seen:
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            g = torch.ones_like(fn(xr))

            def both():
                torch.autograd.backward(fn(xr), g)
            total += device_ms(torch, both, 5)[0]
        xr.grad = None
    return total


def dist_phase(torch, T, dev, smi_line, counts, errs):
    """Phase 33: the edge-partitioned trainer at world size 1 on NCCL.  The
    Trainer's FSWGNN on the Cora stand-in, hidden (64, 64), defaults:
    partitioned with P = 1, then for each exchange the logits against the
    single-device forward on the card with the same parameters, one train
    step's loss and every gradient against the single-device step, the
    rank kernels held against their plain versions on the forward's calls,
    every kernel's launches on one forward and one step (the overlap must
    launch K2f and K2b and no K1, the exchanges K1f and K1b), the step's
    and its exchange's ms, K1 and K2 on the captured calls, a trace's top
    kernels; then arxiv's full graph (phase 29's `arxiv_data`), FSWGNN
    hidden (64,), all_to_all: a step's ms and its peak memory."""
    from fsw_gnn_tpu_torch.data import load
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.train import masked_softmax_cross_entropy
    t_phase = time.perf_counter()
    names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_bwd',
             'fsw_rank_aggregate', 'fsw_rank_aggregate_bwd')
    keys = ('fsw_rank_fwdp', 'fsw_rank_bwdp', 'fsw_rank_fwd', 'fsw_rank_bwd')
    data = load('cora')
    ref = T.Trainer(data, T.TrainConfig(hidden_dims=DIST_HIDDEN), device=dev)
    ref.model.eval()
    with torch.no_grad():
        want = ref.model(ref.X, ref.compute_graph)
    state = copy.deepcopy(ref.model.state_dict())

    def single_step():
        # the single-device Trainer's step, without its wait for the loss
        ref.model.train()
        ref.opt.zero_grad(set_to_none=True)
        s, c = masked_softmax_cross_entropy(
            ref.model(ref.X, ref.compute_graph), ref.labels, ref.train_mask)
        loss = s / torch.clamp(c, min=1.0)
        loss.backward()
        return loss
    loss_ref = single_step().item()
    grads_ref = {k: p.grad.clone() for k, p in ref.model.named_parameters()}
    scale = want.abs().max().item()
    res = {'card': smi_line, 'dataset': data.name,
           'hidden': list(DIST_HIDDEN), 'exchanges': {}}
    gen = torch.Generator(device=dev).manual_seed(11)
    for exchange in ('all_gather', 'all_to_all', 'overlap'):
        tr = T.Trainer(data, T.TrainConfig(
            hidden_dims=DIST_HIDDEN, num_devices=1, exchange=exchange,
            overlap_chunks=DIST_CHUNKS), device=dev)
        tr.model.load_state_dict(state)
        where = f'distributed {exchange}'
        tr.model.eval()
        run = lambda: tr._fwd(tr.X)  # noqa: E731
        with torch.no_grad():
            calls1 = capture_rank_calls(run)
            calls2 = capture_rank_calls(run, 'fsw_rank_aggregate')
        cfg0 = tr.model.convs[0].embed_cfg
        if calls1:
            check_rank_calls(torch, dev, calls1, cfg0, where, errs,
                             all_variants=False)
        if calls2:
            check_rank2_calls(torch, dev, calls2, cfg0, where, errs,
                              extra=False)
        for name in names:
            getattr(R, name).launches = 0
        torch.cuda.synchronize()
        with torch.no_grad():
            got = tr._fwd(tr.X)
        loss = tr._step(tr.X, tr.labels, tr.train_mask,
                        generator=tr.generator).item()
        torch.cuda.synchronize()
        n = {k: getattr(R, name).launches for k, name in zip(keys, names)}
        for k in keys:
            counts[k] += n[k]
        if exchange == 'overlap':
            ok = n['fsw_rank_fwd'] and n['fsw_rank_bwd'] and not (
                n['fsw_rank_fwdp'] or n['fsw_rank_bwdp'])
        else:
            ok = n['fsw_rank_fwdp'] and n['fsw_rank_bwdp']
        if not ok:
            fail(f'{where}: launches {n}')
        err = (got[:data.num_nodes] - want).abs().max().item()
        if not err <= SERVE_ATOL_REL * scale:
            fail(f'{where}: logits differ from the single-device forward by '
                 f'{err:.3e} (scale {scale:.3e})')
        if not abs(loss - loss_ref) <= LOSS0_RTOL * abs(loss_ref):
            fail(f'{where}: loss {loss} against the single-device {loss_ref}')
        grad_err = 0.0
        for k, p in tr.model.named_parameters():
            w = grads_ref[k]
            e = (p.grad - w).abs().max().item()
            if not e <= GRAD_ATOL_REL * w.abs().max().item():
                fail(f'{where}: gradient {k} differs from the single-device '
                     f'step by {e:.3e} (scale {w.abs().max().item():.3e})')
            grad_err = max(grad_err, e / max(w.abs().max().item(), 1e-30))

        def step():
            tr._step(tr.X, tr.labels, tr.train_mask, generator=tr.generator)
        step_ms = device_ms(torch, step, 3)[0]
        seen, fn = exchange_calls(torch, tr, exchange)
        x_ms = exchange_ms(torch, seen, fn)
        busy, kern = traced_top_kernels(torch, step, 3, top=8)
        k1, _ = time_rank_kernels(torch, calls1, gen, n=3)
        k2, _ = time_k2_calls(torch, calls2, gen)
        res['exchanges'][exchange] = {
            'launches': n, 'logits_max_abs_err': err, 'logits_scale': scale,
            'loss': loss, 'loss_single': loss_ref,
            'grad_max_err_rel': grad_err, 'step_ms': step_ms,
            'exchange_ms': x_ms, 'exchange_calls': [list(x.shape)
                                                    for x in seen],
            'exchange_share': x_ms / step_ms, 'step_busy_ms': busy,
            'k1f_ms': k1['fwd'], 'k1b_ms': k1['bwd'],
            'k2f_ms': k2['fwd'], 'k2b_ms': k2['bwd'],
            'k1_calls': len(calls1), 'k2_calls': len(calls2),
            'step_top_kernels': kern}
        del tr, calls1, calls2, seen
    def single_update():
        single_step()
        ref.opt.step()
    res['single_device_step_ms'] = device_ms(torch, single_update, 3)[0]
    res['single_device_busy_ms'], res['single_device_top_kernels'] = (
        traced_top_kernels(torch, single_update, 3, top=8))
    del ref
    torch.cuda.empty_cache()

    # arxiv's full graph on one rank, the all-to-all exchange
    t0 = time.perf_counter()
    data = arxiv_data(0)
    tr = T.Trainer(data, T.TrainConfig(hidden_dims=MB_HIDDEN, num_devices=1,
                                       exchange='all_to_all'), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for name in names:
        getattr(R, name).launches = 0
    loss = tr.train_epoch()
    torch.cuda.synchronize()
    n = {k: getattr(R, name).launches for k, name in zip(keys, names)}
    for k in keys:
        counts[k] += n[k]
    if not np.isfinite(loss):
        fail(f'distributed arxiv: loss {loss}')
    torch.cuda.reset_peak_memory_stats()

    def step():
        tr._step(tr.X, tr.labels, tr.train_mask, generator=tr.generator)
    step_ms = device_ms(torch, step, 1, reps=3)[0]   # 0.4 s a step
    peak = torch.cuda.max_memory_allocated()
    busy, kern = traced_top_kernels(torch, step, 1, top=6)
    res['arxiv_full_graph'] = {
        'nodes': data.num_nodes, 'edges': int(tr.graph.num_edges),
        'hidden': list(MB_HIDDEN), 'exchange': 'all_to_all',
        'a2a_rows': tr.shards.a2a_rows, 'init_s': init_s,
        'loss_first': loss, 'launches': n, 'step_ms': step_ms,
        'step_busy_ms': busy, 'step_top_kernels': kern,
        'max_memory_allocated_mb': peak / 2 ** 20}
    del tr
    torch.cuda.empty_cache()
    res['phase_s'] = time.perf_counter() - t_phase
    print('distributed: ' + json.dumps(res), flush=True)


def dp_phase(torch, T, dev, tr, smi_line, counts):
    """Phase 34: one data-parallel step at world size 1 (`make_dp_train_step`
    on the one-rank group) on one arxiv-scale batch of phase 29's sampler,
    against the single-device minibatch step on the same batch and
    parameters: the loss and every gradient; both steps timed in turns
    (single, DP, DP, single)."""
    from fsw_gnn_tpu_torch.ops import segcumsum
    from fsw_gnn_tpu_torch.parallel import make_data_mesh, make_dp_train_step
    from fsw_gnn_tpu_torch.train import masked_softmax_cross_entropy
    batch = tr._build_batch(tr.train_seeds[:MB_BATCH])
    single, dp = copy.deepcopy(tr.model), copy.deepcopy(tr.model)
    opt_s = torch.optim.SGD(single.parameters(), lr=0.0)
    opt_d = torch.optim.SGD(dp.parameters(), lr=0.0)
    g, Xb, labels, mask = batch

    def single_step():
        single.train()
        opt_s.zero_grad(set_to_none=True)
        s, c = masked_softmax_cross_entropy(single(Xb, g), labels, mask)
        loss = s / torch.clamp(c, min=1.0)
        loss.backward()
        opt_s.step()
        return loss
    step = make_dp_train_step(dp, opt_d, make_data_mesh(1, dev))
    want = single_step().item()
    segcumsum.launches = 0
    got = step(*batch).item()
    torch.cuda.synchronize()
    n_k3 = segcumsum.launches
    if n_k3 != len(dp.convs):
        fail(f'dp: K3 launched {n_k3} times, expected {len(dp.convs)}')
    counts['segcumsum'] += n_k3
    if not abs(got - want) <= LOSS0_RTOL * abs(want):
        fail(f'dp: loss {got} against the single-device {want}')
    grad_err = 0.0
    gs = dict(single.named_parameters())
    for k, p in dp.named_parameters():
        w = gs[k].grad
        e = (p.grad - w).abs().max().item()
        if not e <= GRAD_ATOL_REL * w.abs().max().item():
            fail(f'dp: gradient {k} differs by {e:.3e}')
        grad_err = max(grad_err, e / max(w.abs().max().item(), 1e-30))
    t = {}
    for label, fn in (('single_a', single_step), ('dp_a', lambda: step(
            *batch)), ('dp_b', lambda: step(*batch)), ('single_b',
                                                       single_step)):
        t[label] = device_ms(torch, fn, 3)[0]
    print('dp: ' + json.dumps({
        'card': smi_line, 'batch': MB_BATCH, 'fanouts': list(MB_FANOUTS),
        'loss': got, 'loss_single': want, 'grad_max_err_rel': grad_err,
        'k3_launches': n_k3, 'dp_step_ms': [t['dp_a'], t['dp_b']],
        'single_step_ms': [t['single_a'], t['single_b']]}), flush=True)


def cli_dist_phase(smi_line):
    """Phase 35: `python -m fsw_gnn_tpu_torch.parallel.launch --nproc 1 --
    train --dataset cora --hidden 64 64 --epochs 2 --num-devices 1
    --exchange all_to_all`: one process on the card through the launcher,
    exit 0 and one JSON line (device cuda, one process)."""
    cmd = [sys.executable, '-m', 'fsw_gnn_tpu_torch.parallel.launch',
           '--nproc', '1', '--timeout', str(CLI_TIMEOUT), '--', 'train',
           '--dataset', 'cora', '--hidden', '64', '64', '--epochs',
           str(CLI_EPOCHS), '--num-devices', '1', '--exchange', 'all_to_all']
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT + 60)
    except subprocess.TimeoutExpired:
        fail(f'cli dist: {" ".join(cmd[1:])} ran past {CLI_TIMEOUT} s')
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f'cli dist: exit {proc.returncode}:\n{proc.stderr[-3000:]}')
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{')]
    if len(lines) != 1:
        fail(f'cli dist: {len(lines)} JSON lines:\n{proc.stdout[-2000:]}')
    out = json.loads(lines[0])
    if (out.get('device') != 'cuda' or out.get('processes') != 1
            or out.get('epochs_run') != CLI_EPOCHS):
        fail(f'cli dist: {out}')
    print('cli dist: ' + json.dumps({'card': smi_line,
                                     'command': ' '.join(cmd[1:]), **out,
                                     'wall_s': wall}), flush=True)


def dsmetric_pairs(seed, n_pairs, n, d, p=0.3):
    """(A1, V1, A2, V2) of n_pairs graph pairs as the demo draws them: the
    even pairs two unrelated graphs, the odd ones a graph and a permuted
    copy of it."""
    rng = np.random.default_rng(seed)

    def graph():
        A = (rng.random((n, n)) < p).astype(float)
        np.fill_diagonal(A, 0)
        return np.maximum(A, A.T), rng.standard_normal((n, d))
    out = [[], [], [], []]
    for k in range(n_pairs):
        A, V = graph()
        if k % 2:
            P = np.eye(n)[rng.permutation(n)]
            B, W = P @ A @ P.T, P @ V
        else:
            B, W = graph()
        for lst, x in zip(out, (A, V, B, W)):
            lst.append(x)
    return [np.stack(x) for x in out]


def dsmetric_phase(torch, T, dev, smi_line):
    """Phase 32: dsmetric on the card.  The demo's pair (n = 12, d = 4,
    examples/demo_dsmetric.py) in float32; a batch of 64 pairs at n = 64
    (`dsmetric_pairs`) in float64 and float32: float64 on the card within
    1e-9 of float64 on the CPU (the first DS_CPU_PAIRS pairs), float32
    within 1e-2 of float64 on the unrelated pairs, the isomorphic pairs
    below 1e-2 of the unrelated ones in both; the ms a solve (500 steps),
    and the launches and busy ms of a DS_TRACE_OUTER-step solve from a
    trace.  No CUDA graph: the solver is an eager loop of small ops.""" 
    from fsw_gnn_tpu_torch.ops.sinkhorn import dsmetric_batched
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    n, d = DS_DEMO_N, DS_DEMO_D
    A1 = (rng.random((n, n)) < 0.3).astype(float)
    np.fill_diagonal(A1, 0)
    A1 = np.maximum(A1, A1.T)
    V1 = rng.standard_normal((n, d))
    P = np.eye(n)[rng.permutation(n)]
    A2, V2 = P @ A1 @ P.T, P @ V1
    A3 = (rng.random((n, n)) < 0.3).astype(float)
    np.fill_diagonal(A3, 0)
    A3 = np.maximum(A3, A3.T)
    V3 = rng.standard_normal((n, d))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)
    d_iso, iso_ms = timed(lambda: T.dsmetric(A1, V1, A2, V2, device=dev))
    d_rand, rand_ms = timed(lambda: T.dsmetric(A1, V1, A3, V3, device=dev))
    if not (np.isfinite(d_rand) and 0 <= d_iso < DS_ISO_SHARE * d_rand):
        fail(f'dsmetric: demo pair gave {d_iso} (isomorphic) and {d_rand} '
             f'(unrelated)')
    # a trace of a DS_TRACE_OUTER-step solve: its launches a step (every
    # step runs the same ops) and the share of its wall the card is busy
    _, trace_ms = timed(lambda: T.dsmetric(A1, V1, A3, V3, device=dev,
                                           n_outer=DS_TRACE_OUTER))
    busy, kern = traced_top_kernels(
        torch, lambda: T.dsmetric(A1, V1, A3, V3, device=dev,
                                  n_outer=DS_TRACE_OUTER), 1, top=10 ** 6)
    launches = int(sum(k[2] for k in kern))

    pairs = dsmetric_pairs(1, DS_PAIRS, DS_N, DS_D)
    v64, b64_ms = timed(lambda: dsmetric_batched(
        *pairs, device=dev, dtype=torch.float64).cpu().numpy())
    v32, b32_ms = timed(lambda: dsmetric_batched(
        *pairs, device=dev, dtype=torch.float32).cpu().numpy())
    t0 = time.perf_counter()
    v_cpu = dsmetric_batched(*(x[:DS_CPU_PAIRS] for x in pairs),
                             device='cpu', dtype=torch.float64).numpy()
    cpu_s = time.perf_counter() - t0
    err64 = np.abs(v64[:DS_CPU_PAIRS] - v_cpu)
    rand, iso = v64[0::2], v64[1::2]
    rel32 = np.abs(v32[0::2] - rand) / rand
    ok = (np.isfinite(v64).all() and np.isfinite(v32).all()
          and bool(np.all(err64 <= DS_F64_RTOL * np.abs(v_cpu)))
          and bool(np.all(rel32 <= DS_F32_RTOL))
          and np.abs(v32 - v64).max() <= DS_F32_RTOL * v64.max()
          and iso.max() < DS_ISO_SHARE * rand.min()
          and v32[1::2].max() < DS_ISO_SHARE * v32[0::2].min())
    if not ok:
        fail(f'dsmetric batch: float64 card against CPU {err64.tolist()}, '
             f'float32 relative {rel32.max():.3e}, isomorphic '
             f'{iso.max():.3e} / {v32[1::2].max():.3e}, unrelated '
             f'{rand.min():.3e}')
    res = {'card': smi_line, 'demo_isomorphic': d_iso,
           'demo_unrelated': d_rand, 'demo_solve_ms': [iso_ms, rand_ms],
           'traced_steps': DS_TRACE_OUTER, 'traced_solve_ms': trace_ms,
           'traced_solve_launches': launches, 'traced_solve_busy_ms': busy,
           'traced_solve_idle_share': 1.0 - busy / trace_ms,
           'launches_per_step': launches / DS_TRACE_OUTER,
           'batch': [DS_PAIRS, DS_N, DS_D],
           'batch_solve_ms_float64': b64_ms, 'batch_solve_ms_float32': b32_ms,
           'cpu_float64_s': cpu_s, 'cpu_pairs': DS_CPU_PAIRS,
           'float64_max_rel_err_vs_cpu': float(
               (err64 / np.abs(v_cpu)).max()),
           'float32_max_rel_err': float(rel32.max()),
           'isomorphic_max': float(iso.max()),
           'unrelated_min': float(rand.min()),
           'top_kernels': kern[:6],
           'phase_s': time.perf_counter() - t_phase}
    print('dsmetric: ' + json.dumps(res), flush=True)


def capture_all(run, names):
    """{name: calls} of `run()` with each of the rank route's entry points
    `names` wrapped (`capture_rank_calls`)."""
    calls = {}

    def nest(i):
        if i == len(names):
            return run()
        calls[names[i]] = capture_rank_calls(lambda: nest(i + 1), names[i])
    nest(0)
    return calls


def distinct(calls):
    """The first call of each (shapes, uniform_w, with_dw)."""
    seen, out = set(), []
    for args, unif, dw in calls:
        key = (tuple(tuple(a.shape) for a in args), unif, dw)
        if key not in seen:
            seen.add(key)
            out.append((args, unif, dw))
    return out


def autotune_phase(torch, T, dev, smi_line, counts, errs):
    """Phase 36: `python -m fsw_gnn_tpu_torch.cli autotune` in a process of
    its own, its cache in a temporary directory: exit 0, one JSON line,
    the cache written under the card's kind; the measured rules held to
    the one-sided contract against the H100 table (K2's decisive wins
    measured as wins; K2 wins beyond the table's cap, and the K1 ladder's
    points that the measurement decides beyond SAFETY where K1_RHO0 and
    K1_D0 decide them otherwise, listed); `_rank_rules` of the card still the
    table's with that cache in place; then the autotune's cells in this
    process at AT_REDUCED (K1f, K1b, K2f, K2b, K4f and K4b launched by
    them, each held against its plain version on the calls it made)."""
    from fsw_gnn_tpu_torch import embedding as E
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.utils import autotune as AT
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0).lower()
    table = E._RANK_RULES_BY_KIND['h100']
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, 'autotune.json')
        cmd = [sys.executable, '-m', 'fsw_gnn_tpu_torch.cli', 'autotune']
        try:
            proc = subprocess.run(
                cmd, cwd=ROOT, capture_output=True, text=True,
                timeout=AUTOTUNE_TIMEOUT,
                env=dict(os.environ, FSW_AUTOTUNE_CACHE=cache))
        except subprocess.TimeoutExpired:
            fail(f'autotune: the CLI ran past {AUTOTUNE_TIMEOUT} s')
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f'autotune: exit {proc.returncode}:\n{proc.stderr[-3000:]}')
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        if len(lines) != 1:
            fail(f'autotune: {len(lines)} lines on stdout, not one JSON '
                 f'line:\n{proc.stdout[-2000:]}')
        out = json.loads(lines[0])
        rules = out['rules']
        if out['cache'] != cache or not os.path.exists(cache):
            fail(f'autotune: no cache written ({out["cache"]})')
        with open(cache) as f:
            cached = json.load(f)
        if list(cached) != [kind] or cached[kind] != rules:
            fail(f'autotune: the cache holds {list(cached)}, not the rules '
                 f'under {kind!r}')
        old = os.environ.get('FSW_AUTOTUNE_CACHE')
        os.environ['FSW_AUTOTUNE_CACHE'] = cache
        try:
            if E._rank_rules(dev) is not table:
                fail('autotune: the cache took precedence over the H100 '
                     'table')
        finally:
            if old is None:
                del os.environ['FSW_AUTOTUNE_CACHE']
            else:
                os.environ['FSW_AUTOTUNE_CACHE'] = old
    # the one-sided contract of scripts/validate_autotune.py against the
    # H100 table: K2's decisive wins (B = 32 with weight gradients, 32 and
    # 64 without) must be measured as wins; a win beyond the table's cap
    # is listed (the table keeps routing the H100: the cap is the JAX
    # package's, which no H100 measurement set)
    lost = [f'{mode} B={b}: {rules["margins"][mode].get(str(b))}'
            for mode, bs in (('dw', (32,)), ('nodw', (32, 64)))
            for b in bs if not rules['margins'][mode].get(str(b), 0.0)
            >= AT.SAFETY]
    if lost:
        fail(f'autotune: decisive K2 wins not measured as wins: {lost}')
    over_cap = [dict(mode=mode, B=int(b), margin=m)
                for mode, key in (('dw', 'cap_dw'), ('nodw', 'cap_nodw'))
                for b, m in rules['margins'][mode].items()
                if m >= AT.SAFETY and int(b) > table[key]]
    cells = rules['cells']
    differ = {}
    for mode in ('k1', 'k1_fwd'):
        differ[mode] = [
            dict(D=c['D'], rho=c['rho'], margin=round(c['margin'], 3))
            for c in cells if c['mode'] == mode and AT._verdict(c)
            and E._k1_faster(c['D'], c['rho']) != (AT._verdict(c) > 0)]

    # ---- the cells in this process: launches, and each kernel against
    # its plain version on the calls they made
    t1 = time.perf_counter()
    names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_bwd',
             'fsw_rank_aggregate', 'fsw_rank_aggregate_bwd',
             'fsw_rank_aggregate_cart', 'fsw_rank_aggregate_cart_bwd')
    keys = ('fsw_rank_fwdp', 'fsw_rank_bwdp', 'fsw_rank_fwd', 'fsw_rank_bwd',
            'fsw_rank_cart_fwd', 'fsw_rank_cart_bwd')
    before = [getattr(R, n).launches for n in names]
    calls = capture_all(lambda: AT._measure_margins(**AT_REDUCED,
                                                    device=dev),
                        ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate',
                         'fsw_rank_aggregate_cart'))
    torch.cuda.synchronize()
    launched = [getattr(R, n).launches - b for n, b in zip(names, before)]
    if not all(k > 0 for k in launched):
        fail(f'autotune: K1f, K1b, K2f, K2b, K4f, K4b launched {launched}')
    for key, k in zip(keys, launched):
        counts[key] += k
    reduced_s = time.perf_counter() - t1
    cfg_k2 = T.FSWConfig(d_in=4, d_out=129, enable_bias=False)
    cfg_k4 = T.FSWConfig(d_in=4, n_slices=128, n_freqs=8, enable_bias=False)
    check_rank_calls(torch, dev, distinct(calls['fsw_rank_aggregate_proj']),
                     T.FSWConfig(d_in=64, d_out=127), 'autotune K1', errs,
                     False)
    check_rank2_calls(torch, dev, distinct(calls['fsw_rank_aggregate']),
                      cfg_k2, 'autotune K2', errs, extra=False)
    check_rank2_calls(torch, dev, distinct(calls['fsw_rank_aggregate_cart']),
                      cfg_k4, 'autotune K4', errs, extra=False, kind='K4')
    del calls
    torch.cuda.empty_cache()
    fits = {k: rules.get(k) for k in (
        'k1_rho0', 'k1_d0', 'k1_fit', 'k1_misjudged', 'k1_fwd_rho0',
        'k1_fwd_d0', 'k1_fwd_fit', 'k1_fwd_misjudged')}
    print('autotune: ' + json.dumps({
        'card': smi_line, 'kind': kind, 'margins': rules['margins'],
        'caps': {k: rules[k] for k in ('cap_dw', 'cap_nodw')},
        'table': table, **fits,
        'constants': {'K1_RHO0': E.K1_RHO0, 'K1_D0': E.K1_D0},
        'k2_wins_beyond_the_table_cap': over_cap,
        'k1_points_the_constants_decide_otherwise': differ['k1'],
        'k1_fwd_points_the_constants_decide_otherwise': differ['k1_fwd'],
        'cells': [{k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in c.items()} for c in cells],
        'launches_k1f_k1b_k2f_k2b_k4f_k4b': launched,
        'cli_s': cli_s, 'reduced_s': reduced_s,
        'phase_s': time.perf_counter() - t0}), flush=True)


def utils_phase(torch, T, dev, smi_line, counts, errs):
    """Phase 37: the utilities on the card.  `validate_edge_index` and
    `validate_graph` on the bench graph with tensors on the card (and a
    corrupted copy of each, which must raise); `checkify_embed` around the
    headline FSWConv(64, 64, mlp_layers=3) forward on the bench graph's
    `multi` layout (K1f) and on its CSR Graph (K3): the bits of the
    unwrapped call, a copy of X with one inf feature raising and naming an
    op, its time beside the unwrapped forward's (host clock until the
    output is ready, the least of UTILS_REPS calls in turns); `trace()`
    around one served request (an eager GraphServer) and one CSR forward:
    the Chrome trace holds K1f's and K3's kernels and the fsw_project and
    fsw_segcumsum ranges; a SectionTimer summary of the phase."""
    import dataclasses
    from fsw_gnn_tpu_torch import utils as U
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    timer = U.SectionTimer()
    t0 = time.perf_counter()
    before = (R.fsw_rank_aggregate_proj.launches, segcumsum.launches)
    ei, _ = simple_graph(0, N_NODES)
    with timer.section('validate'):
        g = T.from_edge_index(ei, N_NODES).to(dev)
        U.validate_edge_index(torch.from_numpy(ei).to(dev), N_NODES)
        U.validate_graph(g)
        bad_ei = torch.from_numpy(ei).to(dev)
        bad_ei[0, 7] = N_NODES
        bad_w = g.weight.clone()
        bad_w[3] = -1.0
        for label, fn in (
                ('edge index', lambda: U.validate_edge_index(bad_ei, N_NODES)),
                ('graph', lambda: U.validate_graph(
                    dataclasses.replace(g, weight=bad_w)))):
            try:
                fn()
            except AssertionError:
                continue
            fail(f'utils: a corrupted {label} passed validation')
    model = T.FSWConv(D_IN, D_OUT, mlp_layers=3,
                      minimize_slice_coherence=False, dtype=torch.float32,
                      device=dev, generator=torch.Generator().manual_seed(0))
    mt = T.to_multi_table(T.from_edge_index(ei, N_NODES)).to(dev)
    X = torch.randn((N_NODES, D_IN),
                    generator=torch.Generator(device=dev).manual_seed(37),
                    device=dev)
    checked = U.checkify_embed(model)
    res = {}
    with torch.no_grad():
        for name, layout in (('multi', mt), ('csr', g)):
            model(X, layout)                                   # warm-up
            for _ in range(UTILS_REPS):       # in turns; the minimum counts
                plain = timer.time_fn(f'{name} forward', model, X, layout)
                got = timer.time_fn(f'{name} checkify', checked, X, layout)
            if not torch.equal(got, plain):
                fail(f'utils: checkify_embed changed the {name} output')
            Xi = X.clone()
            Xi[5, 3] = float('inf')
            try:
                checked(Xi, layout)
            except U.FloatCheckError as e:
                res[f'{name}_inf_raised'] = str(e)
            else:
                fail(f'utils: checkify_embed passed an inf feature ({name})')
        classes, class_rows = T.multi_envelope(
            T.from_edge_index(ei, N_NODES), N_NODES)
        server = T.GraphServer(model, N_NODES, MAX_EDGES, classes=classes,
                               class_rows=class_rows, assume_uniform_w=True,
                               cuda_graphs=False, device=dev)
        server.warmup(D_IN)
        req_ei, rng = simple_graph(3, N_NODES)
        req_X = rng.standard_normal((N_NODES, D_IN)).astype(np.float32)
        with tempfile.TemporaryDirectory() as tmp:
            with timer.section('trace'):
                with U.trace(tmp):
                    server.predict(req_ei, req_X)
                    model(X, g)
                    torch.cuda.synchronize()
            with open(os.path.join(tmp, 'trace.json')) as f:
                names = [str(e.get('name', ''))
                         for e in json.load(f)['traceEvents']]
    found = {k: sum(k in n for n in names) for k in (
        K1F_KERNEL, K3_KERNEL, 'fsw_project', 'fsw_segcumsum')}
    if not all(found.values()):
        fail(f'utils: the trace lacks '
             f'{[k for k, v in found.items() if not v]}')
    launched = (R.fsw_rank_aggregate_proj.launches - before[0],
                segcumsum.launches - before[1])
    if not all(launched):
        fail(f'utils: K1f, K3 launched {launched}')
    counts['fsw_rank_fwdp'] += launched[0]
    counts['segcumsum'] += launched[1]
    summary = timer.summary()
    print('utils: ' + json.dumps({
        'card': smi_line, **res, 'trace_events_found': found,
        'launches_k1f_k3': launched,
        'checkify_over_forward': {
            k: summary[f'{k} checkify']['min_ms']
            / summary[f'{k} forward']['min_ms'] for k in ('multi', 'csr')},
        'sections': summary, 'phase_s': time.perf_counter() - t0}),
        flush=True)


BF_TABLE_WIDTHS = (16, 32, 64, 128, 256, 512, 1024)
BF_CE_OPS, BF_TRIG_OPS = 4, 26     # a compare-exchange; a pair's scan + trig
BF_SCRIPTS = ('bench_fused_table', 'probe_kernel_matmul',
              'probe_select_ceiling', 'probe_emit_pipeline')


def table_sort_bound_ms(wn, S, n_xp=None):
    """(bound ms, 'operations' or 'bytes') of one A1 call on (R, B)
    normalized weights wn: the network's B log2 B (log2 B + 1) / 4
    compare-exchanges a row and slice (BF_CE_OPS each), the scan and the
    trig of the real entries (BF_TRIG_OPS each), against P, wn, pad and
    freqs read once and the output written once; with n_xp, the gathered
    entry's: Xp (n_xp, S) and the int32 idx read instead of P."""
    R, B = wn.shape
    lg = int(np.log2(B))
    deg = float((wn > 0).sum())
    ops = S * (R * BF_CE_OPS * B * lg * (lg + 1) / 4 + BF_TRIG_OPS * deg)
    read = R * B * S if n_xp is None else n_xp * S + R * B
    return _bound(ops, 4 * (read + R * B + R + S + R * S))


def bench_folder_phase(torch, T, dev, smi_line):
    """Phase 38: the benchmark folder's kernels (A1, P1, P4, P6) on the
    card.  Each against its plain version at its script's shapes, timed
    beside it and its bound: A1's P entry and its gathered entry on
    bench_fused_table's default graph, bit for bit each other (and against
    the port's sort route there, `fsw_embed_table(..., aggregate='sort')`,
    and on P of widths 16 .. 1024 against `bucket_quadrature(...,
    'sort')`, the gathered entry on P's own rows bit for bit the P entry;
    `torch.sort` of P along B, the sort route and PyTorch's gather before
    the P entry timed beside them); P1's five contractions on both tile
    routines at each of its script's shapes (the probe's, K1's headline,
    Cora's layer 0) against float64 and the plain einsum, the same bits on
    two calls, the headline's and Cora's timed beside `torch.matmul` in
    float32 and TF32; P4's staged forward bit-equal to
    K2f at the probe's shape and on padded rows with NaN projections; P6's
    21 bodies and its two pipe bodies on the probe's whole launch (R 8192,
    B 32, S 128) against their plain versions, the 'rank' body timed.
    Then every launch counter at 0 and the four scripts' `main` on the
    card, each printing its JSON lines (the main path of this slice) and
    raising where its kernel disagrees with its reference: every kernel
    must be launched there.  Returns the five kernels' entries of the
    `kernels` line (A1's two entries apart)."""
    from fsw_gnn_tpu_torch import embedding as E
    from fsw_gnn_tpu_torch.benchmarks import (bench_fused_table as BFT,
                                              probe_emit_pipeline as P4,
                                              probe_kernel_matmul as P1,
                                              probe_select_ceiling as P6)
    from fsw_gnn_tpu_torch.benchmarks.attic import fsw_table as A1
    from fsw_gnn_tpu_torch.ops.fsw_rank import fsw_rank_aggregate
    t0 = time.perf_counter()
    src = 'fsw_gnn_tpu_torch/csrc/'
    within = KERNEL_ATOL_REL, KERNEL_RTOL

    def close(label, got, want):
        err = (got - want).abs()
        scale = want.abs().max().item()
        if not bool(torch.all(err <= within[0] * scale
                              + within[1] * want.abs())):
            fail(f'bench folder: {label}: max abs err '
                 f'{err.max().item():.3e} (scale {scale:.3e})')
        return err.max().item()

    res = {}
    # ---- A1 at bench_fused_table's defaults, then the width ladder ------
    g, t, X, cfg, proj, freqs, wn, pad = BFT.setup(dev)
    with torch.no_grad():
        Xp = (X @ proj.t()).contiguous()
        idx = t.idx.to(torch.int32).contiguous()
        P = A1._gather(idx, Xp)
        a1 = A1.fsw_table_sort(P, wn, pad, freqs)
        a1_err = close('A1 against its plain version', a1,
                       A1.fsw_table_sort_plain(P, wn, pad, freqs))
        a1g = A1.fsw_table_forward(idx, wn, pad, Xp, freqs)
        if not (torch.equal(a1g, a1) and torch.equal(
                A1.fsw_table_sort(P, wn, pad, freqs), a1)):
            fail('bench folder: A1\'s gathered entry is not its P entry bit '
                 'for bit, or a call changed its bits')
        route = E.fsw_embed_table(X, t, proj, freqs, cfg, aggregate='sort')
        close("A1 against the sort route's fsw_embed_table", a1g, route)
        S = P.shape[2]
        a1_ms = device_ms(torch, lambda: A1.fsw_table_sort(P, wn, pad, freqs),
                          20)[0]
        a1g_ms = device_ms(torch, lambda: A1.fsw_table_forward(
            idx, wn, pad, Xp, freqs), 20)[0]
        gather_p_ms = device_ms(torch, lambda: A1.fsw_table_sort(
            A1._gather(idx, Xp), wn, pad, freqs), 20)[0]
        a1_plain = device_ms(torch, lambda: A1.fsw_table_sort_plain(
            P, wn, pad, freqs), 3, 3)[0]
        a1g_plain = device_ms(torch, lambda: A1.fsw_table_forward_plain(
            idx, wn, pad, Xp, freqs), 3, 3)[0]
        sort_cfg = E.FSWConfig(d_in=1, d_out=S, enable_bias=False)
        route_ms = device_ms(torch, lambda: E.bucket_quadrature(
            P, wn, pad, freqs, sort_cfg, 'sort'), 5)[0]
        tsort_ms = device_ms(torch, lambda: torch.sort(P, dim=1), 20)[0]
        bound, by = table_sort_bound_ms(wn, S)
        g_bound, g_by = table_sort_bound_ms(wn, S, n_xp=Xp.shape[0])
        ladder, ladder_ms = {}, {}
        for B in BF_TABLE_WIDTHS:
            Pb, wb, pb, fb = BFT.sweep_inputs(B, dev)
            got = A1.fsw_table_sort(Pb, wb, pb, fb)
            ladder[B] = close(f'A1 against the sort route at B={B}', got,
                              E.bucket_quadrature(Pb, wb, pb, fb, sort_cfg,
                                                  'sort'))
            # the gathered entry on Xp = P's rows, idx = their numbers
            rows = torch.arange(Pb.shape[0] * B, dtype=torch.int32,
                                device=dev).reshape(-1, B)
            if not torch.equal(A1.fsw_table_forward(
                    rows, wb, pb, Pb.reshape(-1, Pb.shape[2]), fb), got):
                fail(f'bench folder: A1\'s entries part at B={B}')
            ladder_ms[B] = device_ms(torch, lambda: A1.fsw_table_sort(
                Pb, wb, pb, fb), 5)[0]
            del Pb, wb, pb, fb, got, rows
    a1_common = {'route': 'cuda', 'source': src + 'fsw_table_sort.cu',
                 'replaces': 'benchmarks/attic/fsw_table_pallas.py:107',
                 'library_ms': None, 'shape': list(P.shape)}
    res['a1'] = {'name': 'fsw_table_sort', **a1_common,
                 'max_abs_err': a1_err, 'ms': a1_ms, 'plain_ms': a1_plain,
                 'bound_ms': bound, 'bound_by': by,
                 'sort_route_ms': route_ms, 'torch_sort_ms': tsort_ms,
                 'vs_sort_route_by_B': ladder, 'ms_by_B': ladder_ms}
    res['a1g'] = {'name': 'fsw_table_gather', **a1_common,
                  'max_abs_err': close('A1 gathered against its plain '
                                       'version', a1g,
                                       A1.fsw_table_forward_plain(
                                           idx, wn, pad, Xp, freqs)),
                  'ms': a1g_ms, 'plain_ms': a1g_plain, 'bound_ms': g_bound,
                  'bound_by': g_by,
                  'torch_gather_and_p_entry_ms': gather_p_ms}
    del g, t, X, Xp, P, route, idx
    # ---- P1: both routines at each of its script's shapes; the headline's
    # and Cora's timed beside torch.matmul -----------------------------------
    errs, times = {}, {}
    with torch.no_grad():
        for shape in P1.SHAPES:
            x = P1.operands(shape, dev)
            for kind in P1.KINDS:
                a, b = (x[n] for n in P1.SPEC[kind][0])
                want = P1.kernel_matmul_plain(kind, a, b)
                for routine in P1.ROUTINES:
                    got = P1.kernel_matmul(kind, a, b, routine)
                    if not torch.equal(got, P1.kernel_matmul(kind, a, b,
                                                             routine)):
                        fail(f'bench folder: P1 {kind} ({routine}) at '
                             f'{shape[0]} changed its bits on a second call')
                    e = dict(zip(('vs_f64', 'vs_f64_rel'),
                                 P1.check(kind, x, routine)))
                    if not e['vs_f64_rel'] <= P1.TOL_REL:
                        fail(f'bench folder: P1 {kind} ({routine}) at '
                             f'{shape[0]} is {e} from float64')
                    e['vs_plain'] = close(
                        f'P1 {kind} ({routine}) at {shape[0]} against its '
                        f'plain version', got, want)
                    errs[f'{shape[0]}/{kind}/{routine}'] = e
                    del got
                if shape[0] == 'probe':
                    continue
                n = 5 if shape[3] > 256 else 20
                row = {r: device_ms(torch, lambda: P1.kernel_matmul(
                    kind, a, b, r), n)[0] for r in P1.ROUTINES}
                ma, mb = P1.matmul_operands(kind, x)
                for tf32 in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    row['matmul_tf32' if tf32 else 'matmul_f32'] = \
                        device_ms(torch, lambda: torch.matmul(ma, mb), n)[0]
                torch.backends.cuda.matmul.allow_tf32 = False
                times[f'{shape[0]}/{kind}'] = row
                del ma, mb, want
            del x, a, b
        shape = dict((s[0], s) for s in P1.SHAPES)['headline']
        x = P1.operands(shape, dev)
        p1_plain = device_ms(torch, lambda: P1.kernel_matmul_plain(
            'fwd', x['Z'], x['V']), 20)[0]
        del x
    _, TR, B1, D1, S1 = shape
    bound, by = _bound(0.0, 4 * (TR * B1 * D1 + D1 * S1 + TR * B1 * S1),
                       2.0 * TR * B1 * D1 * S1)
    head = times['headline/fwd']
    res['p1'] = {'name': 'probe_matmul', 'route': 'cuda',
                 'source': src + 'probe_matmul.cu',
                 'source_routine': src + 'tf32x3_wgmma.cuh',
                 'replaces': 'benchmarks/probe_kernel_matmul.py:45',
                 'max_abs_err': errs['headline/fwd/wgmma']['vs_plain'],
                 'ms': head['wgmma'], 'k1_ms': head['k1'],
                 'plain_ms': p1_plain, 'bound_ms': bound, 'bound_by': by,
                 'library_ms': head['matmul_f32'],
                 'library_tf32_ms': head['matmul_tf32'],
                 'contraction': 'fwd', 'routine': 'wgmma',
                 'shape': list(shape[1:]), 'ms_by_contraction': times,
                 'errors': errs}
    # ---- P4 at the probe's shape, and on padded rows -----------------------
    args = P4.inputs(dev)
    pad_args = list(BFT.sweep_inputs(32, dev))
    pad_args[0] = torch.where(pad_args[1][:, :, None] == 0, float('nan'),
                              pad_args[0]).contiguous()
    with torch.no_grad():
        for label, a in (('the probe', args), ('padded rows', pad_args)):
            got = P4.fsw_rank_aggregate_staged(*a)
            if not torch.equal(got, fsw_rank_aggregate(*a, with_dw=False)):
                fail(f'bench folder: P4 is not K2f bit for bit on {label}')
        p4_err = close('P4 against the plain version',
                       P4.fsw_rank_aggregate_staged(*args),
                       P4.fsw_rank_aggregate_plain(*args))
        turns = [device_ms(torch, f, 20)[0] for f in (
            lambda: fsw_rank_aggregate(*args, with_dw=False),
            lambda: P4.fsw_rank_aggregate_staged(*args),
            lambda: P4.fsw_rank_aggregate_staged(*args),
            lambda: fsw_rank_aggregate(*args, with_dw=False))]
        p4_plain = device_ms(torch, lambda: P4.fsw_rank_aggregate_plain(
            *args), 2, 3)[0]
    bound, by = rank2_bound_ms(args[1], args[0].shape[2])
    res['p4'] = {'name': 'probe_stage', 'route': 'cuda',
                 'source': src + 'probe_stage.cu',
                 'replaces': 'benchmarks/probe_emit_pipeline.py:102',
                 'max_abs_err': p4_err, 'ms': (turns[1] + turns[2]) / 2,
                 'plain_ms': p4_plain, 'bound_ms': bound, 'bound_by': by,
                 'library_ms': None, 'k2f_ms': (turns[0] + turns[3]) / 2,
                 'turns_k2f_staged_staged_k2f': turns,
                 'shape': list(args[0].shape)}
    del args, pad_args
    # ---- P6: every body against plain on the whole launch, 'rank' timed ---
    rng = np.random.default_rng(0)
    Pq = torch.from_numpy(rng.standard_normal((P6.R, P6.B, P6.S)).astype(
        np.float32)).to(dev)
    wq = torch.from_numpy(rng.random((P6.R, P6.B)).astype(np.float32)).to(dev)
    with torch.no_grad():
        body_err = {}
        for name in P6.KERNEL_BODIES:
            got = P6.probe_select(name, Pq, wq, P6.REP)
            want = P6.probe_select_plain(name, Pq, wq, P6.REP)
            err = (got - want).abs().max().item()
            if not err <= P6.TOL_REL * want.abs().max().item():
                fail(f'bench folder: P6 body {name}: max abs err {err:.3e}')
            body_err[name] = err
            del got, want
        p6_ms = device_ms(torch, lambda: P6.probe_select(
            'rank', Pq, wq, P6.REP), 10)[0]
        p6_plain = device_ms(torch, lambda: P6.probe_select_plain(
            'rank', Pq, wq, P6.REP), 1, 3)[0]
    R6, B6, S6 = Pq.shape
    bound, by = _bound(R6 * B6 * S6 * B6 * P6.REP * P6.BODIES['rank'][1],
                       4 * (R6 * B6 * S6 + R6 * B6 + R6 * S6))
    res['p6'] = {'name': 'probe_select', 'route': 'cuda',
                 'source': src + 'probe_select.cu',
                 'replaces': 'benchmarks/probe_select_ceiling.py:409',
                 'max_abs_err': max(body_err.values()), 'ms': p6_ms,
                 'plain_ms': p6_plain, 'bound_ms': bound, 'bound_by': by,
                 'library_ms': None, 'body': 'rank',
                 'shape': [R6, B6, S6, P6.REP], 'errors': body_err}
    del Pq, wq
    torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t0
    # ---- the scripts, every counter from 0 --------------------------------
    wrappers = {'a1': A1.fsw_table_sort, 'a1g': A1.fsw_table_forward,
                'p1': P1.kernel_matmul,
                'p4': P4.fsw_rank_aggregate_staged, 'p6': P6.probe_select}
    for w in wrappers.values():
        w.launches = 0
    t1 = time.perf_counter()
    for name in BF_SCRIPTS:
        print(f'  bench folder: python -m fsw_gnn_tpu_torch.benchmarks.{name}',
              flush=True)
        importlib.import_module(
            f'fsw_gnn_tpu_torch.benchmarks.{name}').main([])
        torch.cuda.synchronize()
    scripts_s = time.perf_counter() - t1
    for key, w in wrappers.items():
        res[key]['launches'] = w.launches
        if w.launches == 0:
            fail(f'bench folder: {res[key]["name"]} was not launched by the '
                 f'scripts')
    print('bench folder: ' + json.dumps({
        'checks_s': checks_s, 'scripts_s': scripts_s,
        'total_s': time.perf_counter() - t0, 'power': smi_line,
        **{k: v for k, v in res.items()}}), flush=True)
    return res


K3P_SCRIPTS = ('probe_segscan_variants', 'probe_fill_floor',
               'probe_segcumsum_fill', 'bench_segcumsum')


def k3_probes_phase(torch, T, dev, smi_line):
    """Phase 39: K3's probes on the card, at their scripts' default shapes.
    P5's three loops (`probe_segscan`, 2^24 values over sorted ids of
    segments of about 32) against their plain versions (the TPU's tiles of
    256 rows) within 2 P5.TOL_ULPS float32 eps of each element's segment
    prefix of |v| and against K3 in float64 within P5.TOL_ULPS; P2's six
    stages (2^24 |normal| values, segments of about 4096) against their
    plain versions, io and the fills bit for bit, the others against the
    plain version in float64 within P2.TOL_EPS eps of each element's
    scale (`P2.within`: the sum of v from the first element of the row
    where its segment starts, plus its value; full also against K3 in
    float64); K3's packed form (2^24 values, the probe's geometric
    segments of mean 256 capped at 2048) against its plain version within
    K3_ULPS eps of the prefix, and bit for bit K3's mask form on the same
    values and ends.  Each timed beside its plain version, K3 on the same
    data and `torch.cumsum` (unsegmented, the library floor); the bounds
    are the bytes: 12, 9 and 8 an element.  Then every launch counter at
    0 and the four scripts' `main` on the card (`python -m
    fsw_gnn_tpu_torch.benchmarks.<name>`, their JSON lines printed, each
    raising where its kernel disagrees with its reference): P5, P2 and the
    packed form must be launched there, and K3 by bench_segcumsum.
    Returns the three kernels' entries of the `kernels` line."""
    from fsw_gnn_tpu_torch.benchmarks import (probe_fill_floor as P2,
                                              probe_segcumsum_fill as P3,
                                              probe_segscan_variants as P5)
    from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum, segcumsum_plain,
                                                 segment_boundaries)
    t0 = time.perf_counter()
    src = 'fsw_gnn_tpu_torch/csrc/'
    eps = torch.finfo(torch.float32).eps
    res = {}
    with torch.no_grad():
        # ---- P5: the three loops -------------------------------------------
        _, _, _, v, s = P5.inputs(dev)
        prefix = segcumsum(v.abs().double(), s)
        errs, ms = {}, {}
        for name in P5.VARIANT_CODES:
            got = P5.segscan_variant(v, s, name)
            want = P5.segscan_variant_plain(v, s, name)
            err = (got.double() - want.double()).abs()
            ulps = P5.ulps_of_prefix(got, v, s)
            if not (bool(torch.all(err <= 2 * P5.TOL_ULPS * eps * prefix))
                    and ulps <= P5.TOL_ULPS):
                worst = err.max().item()
                fail(f'K3 probes: P5 {name}: max abs err {worst:.3e} from '
                     f'plain, {ulps:.2f} eps of the prefix from float64')
            errs[name] = err.max().item()
            ms[name] = device_ms(torch, lambda: P5.segscan_variant(
                v, s, name), 20)[0]
            del got, want, err
        n = v.shape[0]
        res['p5'] = {
            'name': 'probe_segscan_variant', 'route': 'cuda',
            'source': src + 'probe_segscan.cu',
            'replaces': 'benchmarks/probe_segscan_variants.py:85',
            'max_abs_err': max(errs.values()), 'ms': ms['fma'],
            'plain_ms': device_ms(torch, lambda: P5.segscan_variant_plain(
                v, s, 'fma'), 1, 2)[0],
            'bound_ms': 1e3 * 12 * n / PEAK_BYTES, 'bound_by': 'bytes',
            'library_ms': device_ms(torch, lambda: torch.cumsum(v, 0),
                                    20)[0],
            'variant': 'fma', 'variants_ms': ms,
            'k3_ids_ms': device_ms(torch, lambda: segcumsum(v, s), 20)[0],
            'errors': errs, 'n': n}
        del v, s, prefix
        # ---- P2: the six stages --------------------------------------------
        v, m, max_seg = P2.inputs(dev)
        fields, ms = {}, {}
        for name, passes in P2.ABLATIONS:
            got = P2.fill_floor(v, m, name, passes, max_seg=max_seg)
            try:
                fields[name] = P2.check(dev, v, m, name, passes, max_seg, got)
            except RuntimeError as e:
                fail(f'K3 probes: {e}')
            ms[name] = device_ms(torch, lambda: P2.fill_floor(
                v, m, name, passes, max_seg=max_seg), 20)[0]
            del got
        full = P2.fill_floor(v, m, 'full', max_seg=max_seg)
        p2_err = (full - P2.fill_floor_plain(v, m, 'full', 0, max_seg)
                  ).abs().max().item()
        n = v.shape[0]
        res['p2'] = {
            'name': 'probe_segscan_stage', 'route': 'cuda',
            'source': src + 'probe_segscan.cu',
            'replaces': 'benchmarks/probe_fill_floor.py:66',
            'max_abs_err': p2_err, 'ms': ms['full'],
            'plain_ms': device_ms(torch, lambda: P2.fill_floor_plain(
                v, m, 'full', 0, max_seg), 1, 2)[0],
            'bound_ms': 1e3 * 9 * n / PEAK_BYTES, 'bound_by': 'bytes',
            'library_ms': device_ms(torch, lambda: torch.cumsum(v, 0),
                                    20)[0],
            'stage': 'full', 'stages_ms': ms,
            'k3_mask_ms': device_ms(torch, lambda: segcumsum(
                v, boundaries=m), 20)[0],
            'checks': fields, 'n': n, 'max_seg': max_seg}
        del v, m, full
        # ---- P3: K3's packed form ------------------------------------------
        v, s, m, p, _ = P3.inputs(dev)
        got = P3.segcumsum_packed(p)
        if not torch.equal(got, segcumsum(v, boundaries=m)):
            fail('K3 probes: the packed form is not the mask form bit for '
                 'bit')
        p3_err = k3_within(torch, 'packed', got,
                           P3.segcumsum_packed_plain(p, P3.MAX_SEG),
                           segcumsum_plain(v.abs().double(), boundaries=m),
                           torch.float32)
        turns = [device_ms(torch, f, 20)[0] for f in (
            lambda: segcumsum(v, boundaries=m), lambda: P3.segcumsum_packed(p),
            lambda: P3.segcumsum_packed(p),
            lambda: segcumsum(v, boundaries=m))]
        n = v.shape[0]
        res['p3'] = {
            'name': 'segcumsum_packed', 'route': 'cuda',
            'source': src + 'segcumsum.cu',
            'replaces': 'benchmarks/probe_segcumsum_fill.py:116',
            'max_abs_err': p3_err, 'ms': (turns[1] + turns[2]) / 2,
            'plain_ms': device_ms(torch, lambda: P3.segcumsum_packed_plain(
                p, P3.MAX_SEG), 1, 2)[0],
            'bound_ms': 1e3 * 8 * n / PEAK_BYTES, 'bound_by': 'bytes',
            'library_ms': device_ms(torch, lambda: torch.cumsum(v, 0),
                                    20)[0],
            'k3_mask_ms': (turns[0] + turns[3]) / 2,
            'turns_mask_packed_packed_mask': turns,
            'k3_ids_ms': device_ms(torch, lambda: segcumsum(v, s), 20)[0],
            'n': n}
        del v, s, m, p, got
    torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t0
    # ---- the scripts, every counter from 0 --------------------------------
    wrappers = {'p5': P5.segscan_variant, 'p2': P2.fill_floor,
                'p3': P3.segcumsum_packed, 'k3': segcumsum}
    for w in wrappers.values():
        w.launches = 0
    t1 = time.perf_counter()
    for name in K3P_SCRIPTS:
        print(f'  K3 probes: python -m fsw_gnn_tpu_torch.benchmarks.{name}',
              flush=True)
        importlib.import_module(
            f'fsw_gnn_tpu_torch.benchmarks.{name}').main([])
        torch.cuda.synchronize()
    scripts_s = time.perf_counter() - t1
    for key, w in wrappers.items():
        if key in res:
            res[key]['launches'] = w.launches
        if w.launches == 0:
            fail(f'K3 probes: {key} was not launched by the scripts')
    print('K3 probes: ' + json.dumps({
        'checks_s': checks_s, 'scripts_s': scripts_s,
        'total_s': time.perf_counter() - t0, 'power': smi_line,
        'k3_launches_in_scripts': segcumsum.launches, **res}), flush=True)
    return res


# the ported scripts of phase 40: (script, knobs set for its run, the
# kernels it must launch: each inner tuple names kernels of which one at
# least must be launched).  bench_multiset runs twice: 'auto' sorts at its
# n = 256 (the H100's cap is 128), 'rank' takes K2 there.
_ENVELOPE, _K3 = ('fsw_rank_fwdp', 'fsw_rank_fwd'), ('segcumsum',)
_K4 = (('fsw_rank_cart_fwd',), ('fsw_rank_cart_bwd',))
PORT_SCRIPTS = (
    ('bench_serving', {}, (_ENVELOPE, _K3)),
    ('bench_serving_aba', {}, (_ENVELOPE,)),
    ('probe_serving_budget', {}, (_ENVELOPE,)),
    ('probe_serving_fresh', {}, (_ENVELOPE, _K3)),
    ('bench_csr_vs_table', {}, (_K3, ('fsw_rank_fwdp',),
                                ('fsw_rank_bwdp',))),
    ('bench_breakdown', {}, (_K3,)),
    ('bench_table_breakdown', {}, (('fsw_rank_fwdp',), ('fsw_rank_bwdp',))),
    # the K1 rule sends arxiv's tables (D = 128, 7 entries a node) to K2
    ('bench_arxiv_scale', {}, (('fsw_rank_fwd',), ('fsw_rank_bwd',))),
    ('bench_multiset', {}, ()),
    ('bench_multiset', {'FSW_MS_AGG': 'rank'}, (('fsw_rank_fwd',),
                                                ('fsw_rank_bwd',))),
    ('bench_cart_kernel', {}, _K4),
    ('bench_cart_dw', {}, _K4),
    ('bench_cart_waste', {}, _K4),
    # its children launch K4 (counted there and reported back)
    ('probe_cart_dw_frontier', {}, _K4),
    # its rank process launches the rank kernels (reported back)
    ('bench_scaling', {}, (('fsw_rank_fwdp', 'fsw_rank_fwd'),
                           ('fsw_rank_bwdp', 'fsw_rank_bwd'))),
)
# depth cuts of phase 40 (requests, steps, calls; never widths or rows), to
# keep the smoke's time: most of what is left is process start-up
# (probe_cart_dw_frontier's two children, bench_scaling's launch)
PORT_SCRIPT_CUTS = {
    'bench_serving': {'SRV_REQUESTS': '16'},
    'bench_csr_vs_table': {'FSW_CT_ITERS': '3'},
    'bench_arxiv_scale': {'FSW_AX_STEPS': '2'},
    'probe_cart_dw_frontier': {'CART_STEPS': '3'},
    'bench_scaling': {'FSW_SC_ITERS': '3'},
}
PORT_DEMOS = (
    ('demo_fsw_embedding', [], (('fsw_rank_fwd',),)),
    ('demo_conv', [], (_K3,)),
    ('demo_serving', [], (('fsw_rank_fwdp',), ('fsw_rank_bwdp',), _K3)),
    ('demo_dsmetric', [], ()),
    # its rank process runs the steps (its counts reported back)
    ('demo_distributed', [], (('fsw_rank_fwdp', 'fsw_rank_fwd'),
                              ('fsw_rank_bwdp', 'fsw_rank_bwd'))),
)


def _missing(launched, need):
    """The groups of `need` none of whose kernels was launched."""
    return [g for g in need if not any(launched.get(k, 0) for k in g)]


def _launched(res):
    """This process's launches since the counts were reset, plus those a
    script or demo ran in its children and returned under 'launches'."""
    from fsw_gnn_tpu_torch.ops import launch_counts
    launched = launch_counts()
    child = res.get('launches', {}) if isinstance(res, dict) else {}
    for k, v in child.items():
        launched[k] = launched.get(k, 0) + v
    return launched


def _run_with_env(torch, module, env, call):
    """call(module reloaded under `env`), the environment restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mod = importlib.reload(importlib.import_module(module))
        out = call(mod)
        torch.cuda.synchronize()
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        importlib.reload(importlib.import_module(module))


def ported_scripts_phase(torch, smi_line):
    """Phase 40: the ported benchmark scripts (`fsw_gnn_tpu_torch/
    benchmarks/`) on the card at their defaults but for the depth cuts of
    `PORT_SCRIPT_CUTS`, which keep the smoke's time (requests and steps,
    never a width: SRV_REQUESTS 16 of bench_serving's 32, FSW_CT_ITERS 3 of
    10, FSW_AX_STEPS 2 of 5, probe_cart_dw_frontier's CART_STEPS 3 of 10,
    FSW_SC_ITERS 3 of 10), each from every launch counter at 0: `main([])`, its JSON lines printed, must return
    (each raises where its own check fails: the serving routes' cross-check
    at 1e-4 of the scale, K4b's gradients against the sort route, the CSR
    and multi-table outputs against each other, bench_scaling's first loss
    against the single device) and must launch the kernels `PORT_SCRIPTS`
    names for it (probe_cart_dw_frontier's children and bench_scaling's
    rank process return their counts under 'launches', added to this
    process's by `_launched`).  Prints the `ported scripts:`
    line (each script's seconds, launches and result) and returns it."""
    from fsw_gnn_tpu_torch.ops import reset_launches
    out, t_all = {}, time.perf_counter()
    for name, env, need in PORT_SCRIPTS:
        label = name + ''.join(f' {k}={v}' for k, v in env.items())
        env = {**PORT_SCRIPT_CUTS.get(name, {}), **env}
        print(f'  ported scripts: python -m fsw_gnn_tpu_torch.benchmarks.'
              f'{label}', flush=True)
        reset_launches()
        t0 = time.perf_counter()
        try:
            res = _run_with_env(
                torch, f'fsw_gnn_tpu_torch.benchmarks.{name}', env,
                lambda mod: mod.main([]))
        except Exception as e:          # the script's own check, or a fault
            fail(f'ported scripts: {label}: {type(e).__name__}: {e}')
        launched = _launched(res)
        missing = _missing(launched, need)
        if missing:
            fail(f'ported scripts: {label} launched none of {missing} '
                 f'({launched})')
        out[label] = {'s': time.perf_counter() - t0,
                      'launches': {k: v for k, v in launched.items() if v},
                      'result': res}
        print(f'  ported scripts: {label}: {out[label]["s"]:.1f} s',
              flush=True)
    print('ported scripts: ' + json.dumps({
        'total_s': time.perf_counter() - t_all, 'power': smi_line,
        'cuts': PORT_SCRIPT_CUTS, **out}, default=str), flush=True)
    return out


def ported_demos_phase(torch, smi_line):
    """Phase 41: the five demos (`fsw_gnn_tpu_torch/examples/`) on
    the card with their default arguments, each from every launch counter
    at 0: each must return (each raises where its output is not finite,
    demo_serving where its artifact differs from the module by 1e-4 of the
    scale or its server did not capture one graph a route,
    demo_distributed where the three exchanges' 5-step losses differ by
    1e-4) and launch the kernels `PORT_DEMOS` names for it
    (demo_distributed's rank process returns its counts under 'launches';
    demo_dsmetric takes no kernel of the port).  Prints the `ported demos:` line."""
    from fsw_gnn_tpu_torch.ops import reset_launches
    out, t_all = {}, time.perf_counter()
    for name, argv, need in PORT_DEMOS:
        print(f'  ported demos: python -m fsw_gnn_tpu_torch.examples.{name}',
              flush=True)
        reset_launches()
        t0 = time.perf_counter()
        try:
            mod = importlib.import_module(f'fsw_gnn_tpu_torch.examples.{name}')
            res = mod.main(argv)
            torch.cuda.synchronize()
        except Exception as e:
            fail(f'ported demos: {name}: {type(e).__name__}: {e}')
        launched = _launched(res)
        missing = _missing(launched, need)
        if missing:
            fail(f'ported demos: {name} launched none of {missing} '
                 f'({launched})')
        out[name] = {'s': time.perf_counter() - t0,
                     'launches': {k: v for k, v in launched.items() if v}}
        print(f'  ported demos: {name}: {out[name]["s"]:.1f} s', flush=True)
    print('ported demos: ' + json.dumps({
        'total_s': time.perf_counter() - t_all, 'power': smi_line, **out}),
        flush=True)
    return out


# phase 42: the headline benchmark (`fsw_gnn_tpu_torch.bench`) at its
# defaults, in bfloat16, and on the CSR and one-table layouts (the last two
# at 2 reps of its 5, a depth cut), then bench_repspread at 4 reps of 12
BENCH_RUNS = (
    ('multi', {}),
    ('multi, bfloat16', {'FSW_BENCH_DTYPE': 'bfloat16'}),
    ('csr', {'FSW_BENCH_LAYOUT': 'csr', 'FSW_BENCH_REPS': '2'}),
    ('table', {'FSW_BENCH_LAYOUT': 'table', 'FSW_BENCH_REPS': '2'}),
)
SPREAD_REPS, PLAIN_SUM_STEPS = 4, 4


def bench_phase(torch, smi_line, counts):
    """Phase 42: `fsw_gnn_tpu_torch.bench.main([])` under each of
    `BENCH_RUNS`' knobs and `bench_repspread.main([])` at FSW_SPREAD_REPS
    4, each from every launch counter at 0; each must return (each raises
    where a probe or a parameter is not finite, bench where its captured
    step's parameters after 60 steps differ from the eager step's).  The
    `multi` runs must launch K1f and K1b (classes x eager steps) times
    each: one a class in every eager step, the capture's warm-up step
    included, and none in a replay; the CSR run must launch K3, the table
    run a rank kernel.  Then, as a record and not a check, bench.py's own
    loss sum(out**2) on the bench's model for four eager SGD(1e-3) steps:
    the losses, and whether they left the finite numbers.  Every launch is
    added to `counts`.  Prints the `bench:` line (each run's line, its
    launches and seconds) and returns it."""
    from fsw_gnn_tpu_torch.ops import launch_counts, reset_launches
    out, t_all = {}, time.perf_counter()
    runs = [('fsw_gnn_tpu_torch.bench', label, env)
            for label, env in BENCH_RUNS] + [
        ('fsw_gnn_tpu_torch.benchmarks.bench_repspread', 'repspread',
         {'FSW_SPREAD_REPS': str(SPREAD_REPS)})]
    for module, label, env in runs:
        print(f'  bench: {label}', flush=True)
        reset_launches()
        t0 = time.perf_counter()
        try:
            res = _run_with_env(torch, module, env, lambda mod: mod.main([]))
        except Exception as e:          # the bench's own check, or a fault
            fail(f'bench: {label}: {type(e).__name__}: {e}')
        launched = {k: v for k, v in launch_counts().items() if v}
        for k, v in launched.items():
            counts[k] += v
        if not res['probes_finite']:
            fail(f'bench: {label}: a probe is not finite')
        if label.startswith('multi') or label == 'repspread':
            want = res['classes'] * res['eager_steps']
            got = (launched.get('fsw_rank_fwdp', 0),
                   launched.get('fsw_rank_bwdp', 0))
            if got != (want, want):
                fail(f'bench: {label}: K1f and K1b launched {got} times; '
                     f'expected {want} each ({res["classes"]} classes x '
                     f'{res["eager_steps"]} eager steps)')
        if label == 'csr' and not launched.get('segcumsum'):
            fail(f'bench: csr launched no K3 ({launched})')
        if label == 'table' and not any(
                launched.get(k) for k in ('fsw_rank_fwdp', 'fsw_rank_fwd')):
            fail(f'bench: table launched no rank kernel ({launched})')
        out[label] = {'s': time.perf_counter() - t0, 'launches': launched,
                      'result': res}
        print(f'  bench: {label}: {out[label]["s"]:.1f} s', flush=True)

    # bench.py's loss on the same model and graph (the record for the
    # bench's sum(out**2) / N)
    from fsw_gnn_tpu_torch import bench
    reset_launches()
    b = bench.build()
    model, X, g = b['model'], b['X'], b['graph']
    opt = torch.optim.SGD(model.parameters(), lr=bench.LR)
    losses = []
    for _ in range(PLAIN_SUM_STEPS):
        opt.zero_grad(set_to_none=False)
        y = model(X, g)
        loss = (y * y).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    for k, v in launch_counts().items():
        counts[k] += v
    del b, model, X, g, opt
    out['plain_sum_losses'] = losses
    out['plain_sum_goes_non_finite'] = not bool(np.isfinite(losses).all())
    print('bench: ' + json.dumps({
        'total_s': time.perf_counter() - t_all, 'power': smi_line, **out},
        default=str), flush=True)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke test needs an '
             'NVIDIA GPU')
    sys.path.insert(0, ROOT)
    import fsw_gnn_tpu_torch as T
    from fsw_gnn_tpu_torch import kernels

    # ---- 1. device -------------------------------------------------------
    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f'device: {kind} (count {torch.cuda.device_count()}, torch '
          f'{torch.__version__}, CUDA {torch.version.cuda})')
    print(smi_line, flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build(kernels.sources())
    print(f'build: {sorted(logs) or "(already built)"} in '
          f'{time.perf_counter() - t0:.2f} s')
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'smem' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')
    sys.stdout.flush()
    for name in kernels.sources():   # built earlier: the saved reports
        logs[name] = logs.get(name) or kernels.build_log(name)

    # K1's blocks an SM from ptxas' report, and shared memory a block
    from fsw_gnn_tpu_torch.ops.fsw_rank import entry_shape, smem_bytes
    widths = (8, 16, 24, 32, 64, 100, 128)
    occ = {}
    for lib, dyn in (('fsw_rank_fwdp', {B: smem_bytes('fsw_rank_fwdp', B)
                                        for B in widths}),
                     ('fsw_rank_bwdp', {0: 0})):
        for kern, (regs, static) in ptxas_kernels(logs.get(lib, '')).items():
            if 'fwdp_kernel' in kern or kern in (
                    'bwdp_proj_kernel', 'bwdp_dz_kernel', 'bwdp_dv_kernel'):
                occ[kern] = {B: blocks_per_sm(regs, static + d, MMA_THREADS)
                             for B, d in dyn.items()}
    # the backward entry kernel of K2b, K4b (at CART_F frequencies) and
    # K1b, with and without with_dw: its block shape, shared memory,
    # blocks and warps an SM
    entry = {}
    for lib, F in (('fsw_rank_bwd', 1), ('fsw_rank_cart_bwd', CART_F),
                   ('fsw_rank_bwdp', 1)):
        report = ptxas_kernels(logs.get(lib, ''))
        for dw in (True, False):
            kern = f'rank_bwd_entry_kernel<{F},{int(dw)}>'
            if kern not in report:
                continue
            regs, static = report[kern]
            for B in widths:
                K, tsb = entry_shape(B, F, dw)
                need = smem_bytes(lib, B, F, dw)
                nb = blocks_per_sm(regs, static + need, K * tsb)
                entry[f'{lib} B={B}{" dw" if dw else ""}'] = dict(
                    registers=regs, threads_a_slice=K, slices=tsb,
                    smem_bytes=need, blocks_per_sm=nb,
                    warps_per_sm=nb * K * tsb // 32)
    # the forward kernels K2f and K4f (its instance for CART_F frequencies):
    # one thread a slice, 64 slices a block
    fwd = {}
    for lib, kern, F in (
            ('fsw_rank_fwd', 'fsw_rank_fwd_kernel', 1),
            ('fsw_rank_cart_fwd', f'fsw_rank_cart_fwd_kernel<{CART_F}>',
             CART_F)):
        report = ptxas_kernels(logs.get(lib, ''))
        if kern not in report:
            continue
        regs, static = report[kern]
        for B in widths:
            need = smem_bytes(lib, B, F)
            nb = blocks_per_sm(regs, static + need, FWD_THREADS)
            fwd[f'{lib} B={B}'] = dict(
                registers=regs, smem_bytes=need, blocks_per_sm=nb,
                warps_per_sm=nb * FWD_THREADS // 32)
    # K3: one scan kernel a (type, ids or mask, direction), 16 elements a
    # scan thread, its padded tile (and the ids') in dynamic shared memory
    k3_tile = kernels.load('segcumsum').segcumsum_tile()
    k3_occ = {'tile': k3_tile}
    for kern, (regs, static) in ptxas_kernels(
            logs.get('segcumsum', '')).items():
        parts = kern[kern.find('<') + 1:-1].split(',')
        if not kern.startswith('scan_kernel<') or len(parts) != 3:
            continue
        elem = 4 if parts[0] == 'float' else 8
        by = {'0': 'mask', '1': 'ids', '2': 'packed'}[parts[1]]
        dyn = (k3_tile + k3_tile // 8) * (elem + (4 if by == 'ids' else 0))
        threads = k3_tile // K3_ITEMS + 32     # and the look-back warp
        nb = blocks_per_sm(regs, static + dyn, threads)
        k3_occ[f'{parts[0]} {by}'
               f'{" reverse" if parts[2] == "1" else ""}'] = dict(
            registers=regs, smem_bytes=static + dyn, blocks_per_sm=nb,
            warps_per_sm=nb * threads // 32)
    print('occupancy: ' + json.dumps({
        'blocks_per_sm': occ,
        'k1f_smem_bytes': {B: smem_bytes('fsw_rank_fwdp', B)
                           for B in widths},
        'entry_kernel': entry, 'rank_fwd': fwd, 'segcumsum': k3_occ}),
        flush=True)

    counts = dict.fromkeys(KERNEL_NAMES, 0)
    errs = dict.fromkeys(KERNEL_NAMES, 0.0)

    # ---- 3., 4. K1f and serving -------------------------------------------
    torch.manual_seed(0)
    model = T.FSWConv(D_IN, D_OUT, mlp_layers=3,
                      minimize_slice_coherence=False, dtype=torch.float32,
                      device=dev, generator=torch.Generator().manual_seed(0))
    served_calls, k1f = serve_and_check_k1f(torch, T, dev, model, counts,
                                            errs)

    # ---- 5., 6. the kernels on the bench graph, the bench training step ----
    bench_calls, k1b_times = bench_step(torch, T, dev, counts, errs)

    # ---- 7. the Trainer -----------------------------------------------------
    trainer_phase(torch, T, dev, counts, errs)

    # ---- 8. multisets (K2), 9. K2 on the table path, 10. the hub graph ----
    k2 = multiset_phase(torch, T, dev, counts, errs)
    table_k2_phase(torch, T, dev, counts, errs)
    hub_phase(torch, T, dev, counts)

    # ---- 11. K3 alone, 12.-13. the CSR conv and K3's backward, 14. the
    # graph classifier, 15. the CSR hub, 16. the server's CSR route ---------
    k3_phase(torch, dev, errs)
    k3 = csr_conv_phase(torch, T, dev, counts, errs)
    classifier_phase(torch, T, dev, counts)
    csr_hub_phase(torch, T, dev, counts)
    csr_server_phase(torch, T, dev, model, counts)

    # ---- 17. K4 alone, 18. the cartesian MultiTable, 19. multisets --------
    k4 = cart_kernel_phase(torch, T, dev, errs)[CART_B]
    cart_table_phase(torch, T, dev, counts, errs)
    cart_multiset_phase(torch, T, dev, counts, errs)

    # ---- 20. Citeseer, 21. the K1 crossover, 22. where K1's time goes -----
    citeseer_phase(torch, T, dev, counts, errs)
    cora_calls = routing_phase(torch, T, dev)
    k1_ab_phase(torch, dev, {'served request': served_calls,
                             'bench step': bench_calls,
                             "Cora's layer 0": cora_calls})

    # ---- 23. the coherence minimizer, 24. models with default arguments --
    coherence_phase(torch, dev)
    defaults_phase(torch, T, dev, counts, errs)

    # ---- 25. K3 in graphs, 26. the server through graphs, 27. bfloat16 and
    # uint16 servers, 28. export ---------------------------------------------
    k3_graph_phase(torch, T, dev)
    graph_server_phase(torch, T, dev, model, counts)
    dtype_server_phase(torch, T, dev, model, counts)
    export_phase(torch, T, dev, model, counts)

    # ---- 29. minibatch training at arxiv's scale, 30. layer-wise inference,
    # 31. the CLI's minibatch run, 32. dsmetric ------------------------------
    del model, served_calls, bench_calls, cora_calls
    tr = minibatch_phase(torch, T, dev, smi_line, counts, errs)
    layerwise_phase(torch, T, dev, tr, smi_line, counts, errs)
    torch.cuda.empty_cache()
    cli_minibatch_phase(smi_line)
    dsmetric_phase(torch, T, dev, smi_line)

    # ---- 33. the edge-partitioned trainer and 34. a data-parallel step on a
    # one-rank NCCL group, 35. the launcher's command line -------------------
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        start_one_rank_group(torch, tmp)
        try:
            dist_phase(torch, T, dev, smi_line, counts, errs)
            dp_phase(torch, T, dev, tr, smi_line, counts)
        finally:
            dist.destroy_process_group()
    del tr
    torch.cuda.empty_cache()
    cli_dist_phase(smi_line)

    # ---- 36. the autotune, 37. the utilities --------------------------------
    autotune_phase(torch, T, dev, smi_line, counts, errs)
    utils_phase(torch, T, dev, smi_line, counts, errs)

    # ---- 38. the benchmark folder's kernels, 39. K3's probes ----------------
    folder = bench_folder_phase(torch, T, dev, smi_line)
    probes = k3_probes_phase(torch, T, dev, smi_line)

    # ---- 40. the ported benchmark scripts, 41. the demos --------------------
    torch.cuda.empty_cache()
    ported_scripts_phase(torch, smi_line)
    ported_demos_phase(torch, smi_line)

    # ---- 42. the headline benchmark -----------------------------------------
    torch.cuda.empty_cache()
    bench_phase(torch, smi_line, counts)

    # ---- 43. kernels line, 44. last line ------------------------------------
    src = 'fsw_gnn_tpu_torch/csrc/'
    pallas = 'fsw_gnn_tpu/ops/fsw_rank_pallas.py:'
    line = {'kernels': [
        dict(k1f, launches=counts['fsw_rank_fwdp'],
             max_abs_err=errs['fsw_rank_fwdp']),
        {'name': 'fsw_rank_bwdp', 'route': 'cuda',
         'source': src + 'fsw_rank_bwdp.cu', 'replaces': pallas + '605',
         'launches': counts['fsw_rank_bwdp'],
         'max_abs_err': errs['fsw_rank_bwdp'],
         'ms': k1b_times['bwd'], 'plain_ms': k1b_times['bwd_plain'],
         'bound_ms': k1b_times['bwd_bound'],
         'bound_by': k1b_times['bwd_bound_by'], 'library_ms': None},
        {'name': 'fsw_rank_fwd', 'route': 'cuda',
         'source': src + 'fsw_rank_fwd.cu', 'replaces': pallas + '284',
         'launches': counts['fsw_rank_fwd'],
         'max_abs_err': errs['fsw_rank_fwd'],
         'ms': k2['k2f_ms'], 'plain_ms': k2['k2f_plain_ms'],
         'bound_ms': k2['k2f_bound_ms'], 'bound_by': k2['k2f_bound_by'],
         'library_ms': None},
        {'name': 'fsw_rank_bwd', 'route': 'cuda',
         'source': src + 'fsw_rank_bwd.cu', 'replaces': pallas + '292',
         'launches': counts['fsw_rank_bwd'],
         'max_abs_err': errs['fsw_rank_bwd'],
         'ms': k2['k2b_ms'], 'plain_ms': k2['k2b_plain_ms'],
         'bound_ms': k2['k2b_bound_ms'], 'bound_by': k2['k2b_bound_by'],
         'library_ms': None},
        {'name': 'segcumsum', 'route': 'cuda',
         'source': src + 'segcumsum.cu',
         'replaces': 'fsw_gnn_tpu/ops/segcumsum_pallas.py:274',
         'replaces_mask_body': 'fsw_gnn_tpu/ops/segcumsum_pallas.py:200',
         'launches': counts['segcumsum'], 'max_abs_err': errs['segcumsum'],
         'ms': k3['k3_ms'], 'plain_ms': k3['k3_plain_ms'],
         'bound_ms': k3['k3_bound_ms'], 'bound_by': 'bytes',
         'library_ms': None},
        {'name': 'fsw_rank_cart_fwd', 'route': 'cuda',
         'source': src + 'fsw_rank_cart_fwd.cu', 'replaces': pallas + '878',
         'launches': counts['fsw_rank_cart_fwd'],
         'max_abs_err': errs['fsw_rank_cart_fwd'],
         'ms': k4['k4f_ms'], 'plain_ms': k4['k4f_plain_ms'],
         'bound_ms': k4['k4f_bound_ms'], 'bound_by': k4['k4f_bound_by'],
         'library_ms': None},
        {'name': 'fsw_rank_cart_bwd', 'route': 'cuda',
         'source': src + 'fsw_rank_cart_bwd.cu', 'replaces': pallas + '897',
         'replaces_mask_body': pallas + '966',
         'launches': counts['fsw_rank_cart_bwd'],
         'max_abs_err': errs['fsw_rank_cart_bwd'],
         'ms': k4['k4b_ms'], 'plain_ms': k4['k4b_plain_ms'],
         'bound_ms': k4['k4b_bound_ms'], 'bound_by': k4['k4b_bound_by'],
         'library_ms': None}] + [
             {k: v for k, v in folder[key].items()
              if k not in ('errors', 'vs_sort_route_by_B')}
             for key in ('a1', 'a1g', 'p1', 'p4', 'p6')] + [
             {k: v for k, v in probes[key].items()
              if k not in ('errors', 'checks')}
             for key in ('p2', 'p3', 'p5')]}
    if not all(k['launches'] > 0 for k in line['kernels']):
        fail(f'a kernel was not launched on its path: {counts}')
    print(json.dumps(line))
    print(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
