"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  The build happens at first use, from the sources in
the package, into `_build/` beside them (listed in .gitignore).  A
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and never confused with an old build.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = Path(home) / 'bin' / 'nvcc'
    if not path.exists():
        raise RuntimeError('nvcc not found on PATH, in CUDA_HOME or in '
                           '/usr/local/cuda: the CUDA kernels cannot be built')
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:16]}.so'


def _start(name: str):
    """Start nvcc for one source; returns (process, target, tmp) or None
    when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp


def _finish(name: str, started) -> str:
    """Wait for one nvcc; move its output into place; return its log."""
    proc, target, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu '
                           f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, target)
    target.with_suffix('.log').write_text(log)
    return log


def build(names) -> dict:
    """Compile every named source that is not built yet, all nvcc
    processes started together.  Returns {name: compiler log} for the
    sources compiled by this call (ptxas' register and shared-memory
    report included)."""
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, s) for n, s in started.items() if s is not None}


def sources() -> list:
    """Names of every kernel source in the package."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                _libs[name] = lib
    return lib
