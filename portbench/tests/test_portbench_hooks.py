"""The parts a configuration or cell may bring as files of its own (a data
generator, a model kind, a reference, a driver's count of its steps' own
work), and the frozen sampler that the minibatch cell's reference rebuilds
its batches with."""
from __future__ import annotations

import io
import json
import textwrap
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from portbench import gen, run, sampler
from portbench.tests.conftest import REPO
from portbench.tests.test_portbench_run import add_to_rate

CPU = torch.device('cpu')

GENERATOR = '''
import numpy as np


def graph(data, g):
    """A ring whose nodes each receive from their next two and one
    random node, random labels and a split."""
    n, C = int(data['num_nodes']), int(data['classes'])
    i = np.arange(n)
    src = np.concatenate([(i + 1) % n, (i + 2) % n, g.integers(0, n, n)])
    dst = np.concatenate([i, i, i])
    src = np.where(src == dst, (src + 1) % n, src)
    perm = g.permutation(n)
    masks = [np.zeros(n, bool) for _ in range(3)]
    for m, part in zip(masks, np.array_split(perm, 3)):
        m[part] = True
    return {'edge_index': np.stack([src, dst]),
            'labels': g.integers(0, C, n), 'train_mask': masks[0],
            'val_mask': masks[1], 'test_mask': masks[2], 'num_nodes': n}


def features(data, g, graph):
    return g.standard_normal((graph['num_nodes'], int(data['features']))
                             ).astype(np.float32)
'''

MODEL = '''
from portbench.gen import conv_leaves


def leaves(model):
    """One FSWConv straight to the classes, named as an FSWGNN's."""
    return conv_leaves('convs.0.', model['in_channels'],
                       model['num_classes'], model['mlp_layers'])
'''

REFERENCE = '''
from portbench import reference


def train_steps(cfg, inputs, n_steps, ar, wl):
    """The full-graph steps of an FSW-GNN of one layer."""
    model = dict(cfg['model'], kind='fsw_gnn')
    return reference.train_steps(dict(cfg, model=model), inputs, n_steps, ar)
'''


def last_line(root, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(argv, root=root, device=CPU)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_a_configuration_added_as_files(tiny_root):
    """A configuration with a generator, a model kind and a reference that
    the benchmark's own files do not have needs only new files: each is
    found by its name."""
    pb = tiny_root / 'portbench'
    for folder, name, text in (('generators', 'ring_classes', GENERATOR),
                               ('models', 'one_layer_gnn', MODEL),
                               ('references', 'one_layer', REFERENCE)):
        (pb / folder).mkdir(exist_ok=True)
        (pb / folder / f'{name}.py').write_text(textwrap.dedent(text))
    cfg = json.loads((pb / 'configs' / 'tiny-fswgnn-arxiv.json').read_text())
    cfg['model'].update(kind='one_layer_gnn', in_channels=6, hidden_dims=[],
                        num_classes=3)
    cfg['data'] = {'generator': 'ring_classes', 'structure_seed': 0,
                   'num_nodes': 90, 'features': 6, 'classes': 3}
    (pb / 'configs' / 'ring.json').write_text(json.dumps(cfg))
    wl = json.loads((pb / 'workloads' / 'arxiv-full-train.json').read_text())
    wl['reference'] = 'one_layer'
    (pb / 'workloads' / 'ring-train.json').write_text(json.dumps(wl))
    bench = json.loads((tiny_root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'ring', 'source': 'a test',
                             'file': 'portbench/configs/ring.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'ring-train', 'config': 'ring',
                               'traffic': 'trainer-epoch', 'chips': 1,
                               'why': 'a test'})
    add_to_rate(bench, 'ring-train')
    (tiny_root / 'BENCHMARK.json').write_text(json.dumps(bench))
    spec = run.load_spec(tiny_root, 'ring-train')
    inputs = run.make_inputs(spec['cfg'], 4, CPU, tiny_root)
    assert inputs['num_nodes'] == 90
    assert {k.split('.')[1] for k in inputs['params']} == {'0'}
    out = last_line(tiny_root, ['--workload', 'ring-train', '--seed', '4',
                                '--seconds', '0.2', '--trace', '1'])
    assert out['correct'] is True, out['compared']
    assert out['metrics']['step_mfu_pct']['value'] > 0


def test_the_rate_and_the_floor_with_and_without_a_tally():
    """A cell whose driver keeps no count of its steps' work reads what the
    readers always read; one that does reads its counts."""
    rate = run.load_module(REPO, 'metrics', 'train_edges_per_s')
    mfu = run.load_module(REPO, 'metrics', 'step_mfu_pct')
    ctx = {'edges': 1000, 'window': {'steps': 7, 'seconds': 2.0},
           'step': {'floor_s': 1e-3}, 'traced_steps': 3,
           'trace': {'window_s': 0.5}}
    assert rate.read(ctx) == 1000 * 7 / 2.0
    assert mfu.read(ctx) == 100.0 * 1e-3 * 3 / 0.5
    ctx['window'].update(work={'edges': 5000.0, 'floor_s': 0.01},
                         traced_work={'edges': 900.0, 'floor_s': 2e-3})
    assert rate.read(ctx) == 2500.0
    assert mfu.read(ctx) == pytest.approx(0.4)


def test_the_window_counts_the_batches_it_trained(tiny_root):
    """The minibatch driver's tally of a call is the real edges of the
    batches that the frozen sampler draws for the second epoch."""
    spec = run.load_spec(tiny_root, 'arxiv-minibatch-train')
    cfg, wl = spec['cfg'], spec['wl']
    inputs = run.make_inputs(cfg, 2 ** 31 + 9, CPU, tiny_root)
    driver = run.load_module(tiny_root, 'drivers', wl['driver'])
    cell = driver.Cell(cfg, wl, inputs, CPU)
    steps = cell.call()
    train = cfg['train']
    batches = sampler.epoch_batches(
        sampler.Sampler(inputs['edge_index'], inputs['num_nodes'],
                        train['fanouts'], inputs['seed']),
        np.nonzero(inputs['train_mask'])[0], train['batch_size'],
        inputs['seed'])
    per_epoch = -(-int(inputs['train_mask'].sum()) // train['batch_size'])
    assert steps == per_epoch
    want = [b for _, b in zip(range(2 * steps), batches)][steps:]
    edges = sum(len(gen.coalesce(b['edge_index'], len(b['node_ids']))[0])
                for b in want)
    got = cell.tally(0, steps)
    assert got['edges'] == edges
    assert got['floor_s'] > 0
    assert cell.tally(1, 2)['edges'] < got['edges']
    host = got['host_s']
    assert host['sample'] > 0 and host['csr'] > 0
    assert host['build'] > host['sample'] + host['csr']
    from fsw_gnn_tpu_torch.train import minibatch
    from fsw_gnn_tpu_torch.graph import from_edge_index
    assert minibatch.from_edge_index is from_edge_index


def test_a_split_metric_is_read_by_its_quantity(tiny_root):
    """`<quantity>.<part>` without a reader of its own is read by the
    quantity's reader; a file of its own comes first."""
    metrics = tiny_root / 'portbench' / 'metrics'
    assert not (metrics / 'device_idle_pct.sampled.py').exists()
    split = run.metric_reader(tiny_root, 'device_idle_pct.sampled')
    whole = run.load_module(tiny_root, 'metrics', 'device_idle_pct')
    ctx = {'trace': {'busy_s': 3.0, 'window_s': 4.0}}
    assert split.read(ctx) == whole.read(ctx) == 25.0
    (metrics / 'device_idle_pct.sampled.py').write_text(
        'def read(ctx):\n    return 1.0\n')
    assert run.metric_reader(tiny_root, 'device_idle_pct.sampled'
                             ).read(ctx) == 1.0


def test_host_batch_build_ms_reads_the_traced_steps():
    """The sampler's and the CSR build's host time a traced step; nothing
    where the driver times no host work."""
    reader = run.metric_reader(REPO, 'host_batch_build_ms')
    ctx = {'traced_steps': 4, 'window': {}}
    assert reader.read(ctx) is None
    ctx['window']['traced_work'] = {
        'edges': 1.0, 'floor_s': 1.0,
        'host_s': {'sample': 0.06, 'csr': 0.02, 'build': 0.5}}
    assert reader.read(ctx) == pytest.approx(20.0)


def test_the_undirected_generator():
    """planted_classes made undirected: every pair in both directions
    once, no self loops, the directed graph's pairs all in it, and its
    labels and split unchanged."""
    mod = run.load_module(REPO, 'generators', 'planted_classes_undirected')
    data = {'num_nodes': 200, 'num_edges': 900, 'classes': 4,
            'split': [100, 40, 60], 'same_class': 0.8, 'mean_scale': 0.5,
            'features': 5}
    directed = gen.planted_classes(data, gen.rng(3))
    undirected = mod.graph(data, gen.rng(3))
    src, dst = undirected['edge_index']
    n = undirected['num_nodes']
    key = dst * n + src
    assert len(np.unique(key)) == len(key) and not (src == dst).any()
    assert set(key) == set(src * n + dst)
    assert set(directed['edge_index'][1] * n + directed['edge_index'][0]
               ) <= set(key)
    for k in ('labels', 'train_mask', 'val_mask', 'test_mask'):
        np.testing.assert_array_equal(undirected[k], directed[k])
    assert mod.features(data, gen.rng(1), undirected).shape == (200, 5)


@pytest.mark.parametrize('fanouts', [(4, 3), (2, 2, 2)])
def test_the_frozen_sampler_draws_the_programs_batches(fanouts):
    """Bit for bit the batches of the program's sampler with its native
    library, on a small graph with duplicate edges and nodes of many
    in-edges (Floyd's draws)."""
    from fsw_gnn_tpu_torch.data import sampler as program
    from fsw_gnn_tpu_torch.kernels import KernelError
    try:
        native = program._load_native()
    except KernelError as e:
        pytest.skip(f'the native sampler does not build here: {e}')
    if native is None:
        pytest.skip('the native sampler is switched off')
    g = np.random.default_rng(5)
    n = 300
    dst = np.concatenate([g.integers(0, n, 3000), np.full(200, 7)])
    src = g.integers(0, n, dst.shape[0])
    edge_index = np.stack([src, dst])
    seed = 2 ** 31 + 77
    theirs = program.NeighborSampler(edge_index, n, fanouts=fanouts,
                                     seed=seed)
    ours = sampler.Sampler(edge_index, n, fanouts, seed)
    for seeds in (np.array([7, 3, 250, 11]), g.permutation(n)[:40],
                  g.permutation(n)[:90]):
        a, b = theirs.sample(seeds), ours.sample(seeds)
        assert b['num_seeds'] == a.num_seeds
        np.testing.assert_array_equal(b['node_ids'],
                                      a.node_ids[:a.num_real_nodes])
        np.testing.assert_array_equal(b['edge_index'], a.edge_index_local)


def test_splitmix_bounded_draws():
    """SplitMix64's first output for seed 0 (its published test value) and
    draws that stay in range."""
    rng = sampler.SplitMix64(0)
    assert rng.next() == 0xE220A8397B1DCDAF
    assert all(0 <= rng.bounded(n) < n for n in (1, 2, 3, 7, 1000))
