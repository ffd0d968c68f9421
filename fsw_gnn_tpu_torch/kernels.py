"""Build and load the port's CUDA kernels and its host library.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  The build happens at first use, from the sources in
the package, into BUILD_DIR: `_build/` beside them (listed in .gitignore),
or the directory `utils.enable_compilation_cache` names.
Device
code shared between sources lives in `csrc/*.cuh` headers.  A library's
file name carries a hash of its source, the headers and the flags, so an
edited source or header is rebuilt and never confused with an old build.

`csrc/fswgraph.cpp`, the host-side sampler and CSR builder, is plain C++:
`load_host` builds it with the host compiler (`c++`, CXX_FLAGS) in the same
way, and `sources()` leaves it out.

Nothing here runs at import: the CPU tests import every module, and a
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

from .utils.profiling import span

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-shared')

_lock = threading.Lock()
_libs: dict = {}


class KernelError(RuntimeError):
    """A kernel library that cannot be built, or a launch that failed."""


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = Path(home) / 'bin' / 'nvcc'
    if not path.exists():
        raise KernelError('nvcc not found on PATH, in CUDA_HOME or in '
                          '/usr/local/cuda: the CUDA kernels cannot be built')
    return str(path)


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, every header of
    `csrc/` (the sources include them) and the flags."""
    src = (CSRC / f'{name}.cu').read_bytes() + b''.join(
        p.read_bytes() for p in sorted(CSRC.glob('*.cuh')))
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
        raise KernelError(f'nvcc failed for {name}.cu '
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


def build_log(name: str) -> str:
    """The compiler log (ptxas' report included) saved beside the built
    library of `csrc/<name>.cu`, or '' when it is not built."""
    log = _target(name).with_suffix('.log')
    return log.read_text() if log.exists() else ''


def sources() -> list:
    """Names of every kernel source in the package."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with span('fsw.setup.kernel_load', library=name,
                  built=not _target(name).exists()):
            build([name])
            with _lock:
                lib = _libs.get(name)
                if lib is None:
                    lib = ctypes.CDLL(str(_target(name)))
                    _libs[name] = lib
    return lib


def _host_target(name: str) -> Path:
    """The host library's path, named by a hash of its source and the
    flags."""
    src = (CSRC / f'{name}.cpp').read_bytes()
    digest = hashlib.sha256(src + ' '.join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-host-{digest[:16]}.so'


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for `csrc/<name>.cpp`, compiled by `c++`
    first if needed (a per-process temporary file, then a rename, so
    several processes may build it at once).  A failed build raises with
    the compiler's log."""
    key = f'{name}.cpp'
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        target = _host_target(name)
        with span('fsw.setup.kernel_load', library=key,
                  built=not target.exists()):
            if not target.exists():
                cxx = shutil.which('c++')
                if cxx is None:
                    raise KernelError(f'no host C++ compiler (c++) on PATH: '
                                      f'{name}.cpp cannot be built')
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f'.{os.getpid()}.tmp')
                proc = subprocess.run(
                    [cxx, *CXX_FLAGS, '-o', str(tmp), str(CSRC / key)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                if proc.returncode != 0:
                    raise KernelError(f'c++ failed for {key} (exit '
                                      f'{proc.returncode}):\n{proc.stdout}')
                os.replace(tmp, target)
            lib = _libs[key] = ctypes.CDLL(str(target))
    return lib
