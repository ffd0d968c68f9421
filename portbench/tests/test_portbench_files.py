"""Every file of the benchmark loads, and BENCHMARK.json keeps to the
contract's shape: keys, names, units, lengths and cross references."""
from __future__ import annotations

import ast
import json
import re

import pytest

from portbench import run
from portbench.tests.conftest import REPO

NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}')
UNIT = re.compile(r'[A-Za-z0-9_/%.\-]{1,16}')
BENCH = json.loads((REPO / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


def keys_of(tree) -> set:
    """Every key of a JSON object, at any depth."""
    if isinstance(tree, dict):
        return set(tree).union(*(keys_of(v) for v in tree.values()))
    if isinstance(tree, list):
        return set().union(*(keys_of(v) for v in tree))
    return set()


def line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and '\n' not in text and '\t' not in text)


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['portbench']
    assert 1 <= len(BENCH['command']) <= 32
    assert all(line(w) and not w.startswith('/') and '..' not in w
               for w in BENCH['command'])
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len((REPO / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


@pytest.mark.parametrize('entry', BENCH['configs'], ids=lambda c: c['name'])
def test_config_entry(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.fullmatch(entry['name'])
    assert line(entry['source']) and line(entry['why'])
    assert entry['file'].startswith('portbench/configs/')
    cfg = json.loads((REPO / entry['file']).read_text())
    assert cfg['source'] == entry['source']
    # a configuration cut to one chip lists its cut keys in both places,
    # each a key its file names
    assert cfg['reduced'] == entry['reduced']
    assert len(entry['reduced']) <= 16
    assert all(NAME.fullmatch(k) for k in entry['reduced'])
    assert set(entry['reduced']) <= keys_of(
        {g: cfg[g] for g in ('model', 'data', 'train')})
    assert {'model', 'data', 'train'} <= set(cfg)
    assert any(w['config'] == entry['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda w: w['name'])
def test_cell_entry(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    for key in ('name', 'config', 'traffic'):
        assert NAME.fullmatch(cell[key])
    assert cell['chips'] == 1 and line(cell['why'])
    spec = run.load_spec(REPO, cell['name'])
    wl = spec['wl']
    assert (REPO / 'portbench' / 'drivers' / f"{wl['driver']}.py").exists()
    if 'reference' in wl:
        assert (REPO / 'portbench' / 'references'
                / f"{wl['reference']}.py").exists()
    assert set(wl['limits']) == {'loss', 'out', 'grad', 'change'}
    assert all(0 < v < 1 for v in wl['limits'].values())
    names = {m['name'] for m in spec['end_to_end']}
    assert 'setup_s' in names and len(names) >= 2
    assert spec['per_layer']


def test_pairs_and_names_unique():
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(set(pairs)) == len(pairs)
    for group in ('configs', 'workloads'):
        names = [e['name'] for e in BENCH[group]]
        assert len(set(names)) == len(names)
    assert len({m['name'] for m in METRICS}) == len(METRICS)


@pytest.mark.parametrize('metric', METRICS, ids=lambda m: m['name'])
def test_metric_entry(metric):
    e2e = metric in BENCH['end_to_end']
    keys = ({'name', 'unit', 'better', 'bound', 'source'} if e2e else
            {'name', 'unit', 'better', 'source', 'layer', 'moves'})
    assert set(metric) - {'workloads'} == keys
    assert NAME.fullmatch(metric['name']) and UNIT.fullmatch(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    if e2e:
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
    else:
        assert metric['source'] in ('device_trace', 'program_span',
                                    'program_counter', 'host_clock')
        assert line(metric['layer'])
        assert metric['moves'] in {m['name'] for m in BENCH['end_to_end']}
    assert set(metric.get('workloads', CELLS)) <= set(CELLS)
    reader = run.metric_reader(REPO, metric['name'])
    assert callable(reader.read)


def test_setup_bound():
    setup = [m for m in BENCH['end_to_end'] if m['name'] == 'setup_s']
    assert len(setup) == 1 and setup[0]['bound'] <= 0.25


def test_file_names():
    for path in (REPO / 'portbench').rglob('*'):
        if '__pycache__' in path.parts or '_build' in path.parts:
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.fullmatch(r'[A-Za-z0-9_.\-/]{1,200}', rel), rel


def test_sources_parse():
    for path in (REPO / 'portbench').rglob('*.py'):
        ast.parse(path.read_text(), str(path))
