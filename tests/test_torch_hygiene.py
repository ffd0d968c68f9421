"""The port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points refuse to run on a card that is not there."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / 'fsw_gnn_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']
FORBIDDEN = re.compile(
    r'^\s*(import\s+(jax|flax|optax|orbax|fsw_gnn_tpu)\b'
    r'|from\s+(jax|flax|optax|orbax|fsw_gnn_tpu)(\.|\s))', re.M)


def test_import_pulls_in_no_jax():
    code = ('import sys, fsw_gnn_tpu_torch, fsw_gnn_tpu_torch.serving, '
            'fsw_gnn_tpu_torch.bridge, fsw_gnn_tpu_torch.kernels, '
            'fsw_gnn_tpu_torch.models.gnn, fsw_gnn_tpu_torch.data.datasets, '
            'fsw_gnn_tpu_torch.train.trainer, fsw_gnn_tpu_torch.cli, '
            'fsw_gnn_tpu_torch.ops.segment, fsw_gnn_tpu_torch.ops.segcumsum, '
            'fsw_gnn_tpu_torch.data.sampler, '
            'fsw_gnn_tpu_torch.train.minibatch, '
            'fsw_gnn_tpu_torch.train.infer, fsw_gnn_tpu_torch.ops.sinkhorn, '
            'fsw_gnn_tpu_torch.utils.dsmetric, fsw_gnn_tpu_torch.parallel, '
            'fsw_gnn_tpu_torch.parallel.runtime, '
            'fsw_gnn_tpu_torch.parallel.partition, '
            'fsw_gnn_tpu_torch.parallel.collectives, '
            'fsw_gnn_tpu_torch.parallel.dist, fsw_gnn_tpu_torch.parallel.dp, '
            'fsw_gnn_tpu_torch.parallel.overlap, '
            'fsw_gnn_tpu_torch.parallel.launch, '
            'fsw_gnn_tpu_torch.parallel.workers, '
            'fsw_gnn_tpu_torch.benchmarks._timing, '
            'fsw_gnn_tpu_torch.benchmarks.attic.fsw_table, '
            'fsw_gnn_tpu_torch.benchmarks.bench_fused_table, '
            'fsw_gnn_tpu_torch.benchmarks.probe_kernel_matmul, '
            'fsw_gnn_tpu_torch.benchmarks.probe_select_ceiling, '
            'fsw_gnn_tpu_torch.benchmarks.probe_emit_pipeline, '
            'fsw_gnn_tpu_torch.benchmarks.bench_rank_proj, '
            'fsw_gnn_tpu_torch.benchmarks.bench_rank_kernel, '
            'fsw_gnn_tpu_torch.benchmarks.probe_segscan_variants, '
            'fsw_gnn_tpu_torch.benchmarks.probe_fill_floor, '
            'fsw_gnn_tpu_torch.benchmarks.probe_segcumsum_fill, '
            'fsw_gnn_tpu_torch.benchmarks.bench_segcumsum, '
            'fsw_gnn_tpu_torch.benchmarks.bench_serving, '
            'fsw_gnn_tpu_torch.benchmarks.bench_serving_aba, '
            'fsw_gnn_tpu_torch.benchmarks.probe_serving_budget, '
            'fsw_gnn_tpu_torch.benchmarks.probe_serving_fresh, '
            'fsw_gnn_tpu_torch.benchmarks.bench_csr_vs_table, '
            'fsw_gnn_tpu_torch.benchmarks.bench_breakdown, '
            'fsw_gnn_tpu_torch.benchmarks.bench_table_breakdown, '
            'fsw_gnn_tpu_torch.benchmarks.bench_arxiv_scale, '
            'fsw_gnn_tpu_torch.benchmarks.bench_multiset, '
            'fsw_gnn_tpu_torch.benchmarks.bench_cart_kernel, '
            'fsw_gnn_tpu_torch.benchmarks.bench_cart_dw, '
            'fsw_gnn_tpu_torch.benchmarks.bench_cart_waste, '
            'fsw_gnn_tpu_torch.benchmarks.probe_cart_dw_frontier, '
            'fsw_gnn_tpu_torch.benchmarks.bench_scaling, '
            'fsw_gnn_tpu_torch.examples.demo_fsw_embedding, '
            'fsw_gnn_tpu_torch.examples.demo_conv, '
            'fsw_gnn_tpu_torch.examples.demo_serving, '
            'fsw_gnn_tpu_torch.examples.demo_dsmetric, '
            'fsw_gnn_tpu_torch.examples.demo_distributed; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "optax", "orbax", "fsw_gnn_tpu")]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: p.name)
def test_no_jax_imports_in_source(path):
    assert path.exists(), path
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f'{path}: {hits}'


def test_no_port_source_loads_the_jax_packages_native_library():
    """The port builds its own host library from csrc/fswgraph.cpp; no
    source of it names the JAX package's native directory or library."""
    port = ROOT / 'fsw_gnn_tpu_torch'
    files = [p for p in port.rglob('*')
             if p.suffix in ('.py', '.cpp', '.cu', '.cuh')
             and '_build' not in p.parts] + [ROOT / 'chip_smoke.py']
    assert port / 'csrc' / 'fswgraph.cpp' in files
    bad = re.compile(r'fsw_gnn_tpu[/.\\]native|libfswgraph\.so|'
                     r"['\"]native['\"]")
    hits = [f'{p.relative_to(ROOT)}: {m.group(0)}' for p in files
            for m in bad.finditer(p.read_text())]
    assert not hits, hits


def test_entry_points_default_to_the_card():
    """With no device given, the entry points ask for CUDA; where there is
    none they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the refusal cannot be shown')
    import fsw_gnn_tpu_torch as T
    for build in (lambda: T.FSWConv(4, 4, minimize_slice_coherence=False),
                  lambda: T.FSWConv(4, 4, minimize_slice_coherence=False,
                                    device='cuda'),
                  lambda: T.resolve_device(None),
                  lambda: T.FSWGNN(4, (4,), minimize_slice_coherence=False),
                  lambda: T.FSWGraphClassifier(
                      4, (4,), 2, minimize_slice_coherence=False)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()
    conv = T.FSWConv(4, 4, minimize_slice_coherence=False, device='cpu')
    for env in ({}, dict(classes=[8], class_rows=[16])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            T.GraphServer(conv, 16, 64, **env)
    from fsw_gnn_tpu_torch.data import synthetic_planted_partition
    from fsw_gnn_tpu_torch.train import MinibatchTrainer, TrainConfig
    from fsw_gnn_tpu_torch.train.infer import layerwise_predict
    data = synthetic_planted_partition(num_nodes=40, num_classes=2,
                                       feat_dim=4)
    gnn = T.FSWGNN(4, (2,), minimize_slice_coherence=False, device='cpu')
    graph = T.from_edge_index(data.edge_index, data.num_nodes)
    eye = np.eye(6)
    for run in (lambda: MinibatchTrainer(data, TrainConfig(hidden_dims=(4,)),
                                         batch_size=8, fanouts=(2,)),
                lambda: layerwise_predict(gnn, data.features, graph, 16),
                lambda: T.dsmetric(eye, eye[:, :2], eye, eye[:, :2])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            run()



def test_distributed_entry_points_default_to_the_card(tmp_path):
    """The launcher, the group's start-up, the mesh and the trainers of
    the distributed paths ask for the card (NCCL) unless told 'cpu'; where
    there is none they raise instead of starting gloo on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the refusal cannot be shown')
    import torch.distributed as dist
    from fsw_gnn_tpu_torch.data import synthetic_planted_partition
    from fsw_gnn_tpu_torch.parallel import ensure_distributed, make_graph_mesh
    from fsw_gnn_tpu_torch.parallel.launch import launch
    from fsw_gnn_tpu_torch.train import MinibatchTrainer, TrainConfig, Trainer
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        launch(1, 'fsw_gnn_tpu_torch.parallel.workers:mesh_refusal',
               dict(num_devices=1))
    store = 'file://' + str(tmp_path / 'store')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ensure_distributed(init_method=store, world_size=1, rank=0)
    assert not dist.is_initialized()
    # inside a one-rank group the mesh and the trainers still default to
    # the card
    dist.init_process_group('gloo', init_method=store + '_cpu',
                            world_size=1, rank=0)
    try:
        data = synthetic_planted_partition(num_nodes=40, num_classes=2,
                                           feat_dim=4)
        cfg = TrainConfig(hidden_dims=(4,), num_devices=1)
        for run in (lambda: make_graph_mesh(1),
                    lambda: Trainer(data, cfg),
                    lambda: MinibatchTrainer(data, cfg, batch_size=8,
                                             fanouts=(2,))):
            with pytest.raises(RuntimeError, match='no CUDA device'):
                run()
        assert make_graph_mesh(1, device='cpu').device.type == 'cpu'
    finally:
        dist.destroy_process_group()


SCRIPTS_AND_DEMOS = (
    [f'benchmarks.{n}' for n in (
        'bench_serving', 'bench_serving_aba', 'probe_serving_budget',
        'probe_serving_fresh', 'bench_csr_vs_table', 'bench_breakdown',
        'bench_table_breakdown', 'bench_arxiv_scale', 'bench_multiset',
        'bench_cart_kernel', 'bench_cart_dw', 'bench_cart_waste',
        'probe_cart_dw_frontier', 'bench_scaling')]
    + [f'examples.{n}' for n in (
        'demo_fsw_embedding', 'demo_conv', 'demo_serving', 'demo_dsmetric',
        'demo_distributed')])


@pytest.mark.parametrize('name', SCRIPTS_AND_DEMOS)
def test_scripts_and_demos_default_to_the_card(name):
    """With no `--device`, each benchmark script and demo asks for the card
    and, where there is none, raises before any work."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the refusal cannot be shown')
    import importlib
    mod = importlib.import_module(f'fsw_gnn_tpu_torch.{name}')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main([])
