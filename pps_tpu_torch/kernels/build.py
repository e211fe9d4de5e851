"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``pps_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds).  Libraries go to
``<repo>/build/pps_tpu_torch_kernels/`` (git-ignored), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  Only sources in the package are built.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them together; ``load(name)`` builds on demand and returns the
``ctypes.CDLL``.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / \
    'pps_tpu_torch_kernels'
NVCC_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS = {}
_LOCK = threading.Lock()


def sources():
    """Names of every kernel source in ``csrc/`` (``zero_even`` for
    ``csrc/zero_even.cu``), sorted."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin): the CUDA kernels cannot be '
                       'built without the CUDA toolkit')


def library_path(name):
    """Where ``name``'s library lives for the current source and flags."""
    src = CSRC / (name + '.cu')
    h = hashlib.sha256(src.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / '{}-{}.so'.format(name, h.hexdigest()[:16])


def _start(name):
    """Start nvcc for ``name`` unless its library is current.  Returns
    (process, tmp path, final path, log path) or None when up to date."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix('.so.tmp{}'.format(os.getpid()))
    log = out.with_suffix('.log')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / (name + '.cu'))]
    with open(log, 'w') as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name, started):
    proc, tmp, out, log = started
    rc = proc.wait()
    if rc != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError('nvcc failed for {} (exit {}):\n{}'.format(
            name, rc, log.read_text()))
    os.replace(tmp, out)


def build_all(names=None):
    """Build every kernel (or ``names``) in parallel.  Returns
    {name: {'seconds': wall seconds, 'log': nvcc output or ''}}."""
    names = sources() if names is None else list(names)
    t0 = time.perf_counter()
    with _LOCK:
        started = {}
        try:
            for n in names:
                started[n] = _start(n)
            for n, s in started.items():
                if s is not None:
                    _finish(n, s)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
    dt = time.perf_counter() - t0
    report = {}
    for n, s in started.items():
        log = s[3] if s is not None else library_path(n).with_suffix('.log')
        report[n] = {'seconds': dt if s is not None else 0.0,
                     'log': log.read_text() if log.exists() else ''}
    return report


def load(name):
    """The ``ctypes.CDLL`` of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
