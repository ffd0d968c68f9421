"""Nothing the benchmark runs imports JAX, flax, the JAX package or the
repository's JAX benchmarks, and the reference nothing of the program."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import types

from portbench import run
from portbench.tests.conftest import REPO

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'fsw_gnn_tpu', 'benchmarks'}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.', 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split('.', 1)[0])
    return tops


def test_sources_import_nothing_forbidden():
    for path in (REPO / 'portbench').rglob('*.py'):
        assert not imported_tops(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    plain = {'__future__', 'math', 'numpy', 'torch', 'statistics'}
    for name in ('reference.py', 'gen.py', 'compare.py', 'workmodel.py',
                 'sampler.py'):
        tops = imported_tops(REPO / 'portbench' / name)
        assert tops <= plain, (name, tops)
    # a cell's own reference, generator or model kind: plain modules and
    # the plain files above
    yardstick = {'portbench.' + n for n in ('reference', 'gen', 'compare',
                                             'workmodel', 'sampler')}
    for path in [p for folder in ('references', 'generators', 'models')
                 for p in (REPO / 'portbench' / folder).glob('*.py')]:
        tops = imported_tops(path)
        assert tops <= plain | {'itertools', 'portbench'}, (path, tops)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                    node.module.startswith('portbench'):
                names = ({node.module} if node.module != 'portbench' else
                         {f'portbench.{a.name}' for a in node.names})
                assert names <= yardstick, (path, names)


def test_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split('.', 1)[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, 'fsw_gnn_tpu_torch_extra',
                        types.ModuleType('fsw_gnn_tpu_torch_extra'))
    import fsw_gnn_tpu_torch  # noqa: F401  (the port is allowed)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'fsw_gnn_tpu.ops',
                        types.ModuleType('fsw_gnn_tpu.ops'))
    assert run.forbidden_modules() == ['fsw_gnn_tpu']
    monkeypatch.setitem(sys.modules, 'jax.numpy',
                        types.ModuleType('jax.numpy'))
    assert run.forbidden_modules() == ['fsw_gnn_tpu', 'jax']


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    standard output."""
    proc = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'conv64-multi-train', '--seed', '1', '--seconds', '1'],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert proc.returncode != 0
    assert proc.stdout == ''
