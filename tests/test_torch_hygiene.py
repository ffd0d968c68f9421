"""The port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points refuse to run on a card that is not there."""
import re
import subprocess
import sys
from pathlib import Path

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
            'fsw_gnn_tpu_torch.train.trainer, fsw_gnn_tpu_torch.cli; '
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
                  lambda: T.FSWGNN(4, (4,), minimize_slice_coherence=False)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()
    conv = T.FSWConv(4, 4, minimize_slice_coherence=False, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        T.GraphServer(conv, 16, 64, classes=[8], class_rows=[16])
