"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
configurations are cut to a size the CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY = {
    'fswconv-64': {'data': {'num_nodes': 96, 'draws_per_node': 4,
                            'features': 8},
                   'model': {'in_channels': 8, 'out_channels': 8}},
    'fswgnn-arxiv': {'data': {'num_nodes': 300, 'num_edges': 1500,
                              'features': 12, 'classes': 5,
                              'split': [150, 50, 100]},
                     'model': {'in_channels': 12, 'hidden_dims': [8, 8],
                               'num_classes': 5}},
}


def make_tiny_root(dest: Path) -> Path:
    """dest/BENCHMARK.json and dest/portbench/: the benchmark with every
    configuration cut to TINY's sizes (the files renamed tiny-*.json) and
    a settle of one second."""
    shutil.copytree(REPO / 'portbench', dest / 'portbench',
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    for c in bench['configs']:
        cfg = json.loads((REPO / c['file']).read_text())
        for group, values in TINY[c['name']].items():
            cfg[group].update(values)
        c['file'] = f"portbench/configs/tiny-{c['name']}.json"
        (dest / c['file']).write_text(json.dumps(cfg))
    (dest / 'BENCHMARK.json').write_text(json.dumps(bench, indent=1))
    for path in (dest / 'portbench' / 'workloads').glob('*.json'):
        wl = json.loads(path.read_text())
        if 'settle_s' in wl:
            # a tiny graph on the card: the settle's path, not its length
            wl['settle_s'] = 1.0
            path.write_text(json.dumps(wl))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch's thread pool against the other test workers: one thread."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
