"""Build the port's native sources at first use and load them with ctypes.

Each ``pps_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds); each ``csrc/<name>.cc`` is host C++
(OpenMP), compiled by the host's ``c++``.  Libraries go to
``<repo>/build/pps_tpu_torch_kernels/`` (git-ignored), named by a hash of
the source, the flags and the compiler (its resolved path and its
``--version`` output), so an edited source or another toolchain rebuilds
and an unchanged one is reused.  A library is written to a temporary name and renamed into
place, and builds hold a file lock, so processes that build at once (test
workers) neither collide nor load a half-written file.  Only sources in
the package are built.

``build_all()`` starts one compiler per source, all at once, and waits for
them together; ``load(name)`` builds on demand and returns the
``ctypes.CDLL``.  Nothing here runs at import time.
"""

import contextlib
import ctypes
import fcntl
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
# no -march=native: a library built on one host may be loaded on another
HOST_FLAGS = ('-O3', '-fopenmp', '-shared', '-fPIC', '-std=c++17')

_LIBS = {}
_LOCK = threading.Lock()
_CXX = None  # the host compiler, once probed
_VERSIONS = {}  # compiler path -> its --version output


def sources():
    """Names of every source in ``csrc/`` (``zero_even`` for
    ``csrc/zero_even.cu``, ``rerank`` for ``csrc/rerank.cc``), sorted."""
    return sorted(p.stem for p in CSRC.glob('*.cu')) + \
        sorted(p.stem for p in CSRC.glob('*.cc'))


def _source(name):
    cu = CSRC / (name + '.cu')
    return cu if cu.exists() else CSRC / (name + '.cc')


def _host_cxx():
    """The first host C++ compiler ($CXX, c++, g++) that links an OpenMP
    shared library (a compiler may come without its OpenMP runtime)."""
    global _CXX
    if _CXX is None:
        tried = []
        for cand in dict.fromkeys((os.environ.get('CXX'), 'c++', 'g++')):
            found = cand and shutil.which(cand)
            if not found:
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            probe = BUILD_DIR / '.openmp_probe{}.so'.format(os.getpid())
            r = subprocess.run(
                [found, *HOST_FLAGS, '-x', 'c++', '-', '-o', str(probe)],
                input='', capture_output=True, text=True)
            if probe.exists():
                probe.unlink()
            if r.returncode == 0:
                _CXX = found
                break
            tried.append('{}: {}'.format(found, r.stderr.strip()[-300:]))
        else:
            raise RuntimeError(
                'no host C++ compiler with OpenMP found ($CXX, c++, g++): '
                'the native sources cannot be built\n' + '\n'.join(tried))
    return _CXX


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


def _flags(src):
    return NVCC_FLAGS if src.suffix == '.cu' else HOST_FLAGS


def _compiler_id(src):
    """The compiler that builds ``src``: its path and ``--version`` output
    ('' for a .cu source when nvcc is missing: the build then raises)."""
    if src.suffix == '.cu':
        try:
            cc = _nvcc()
        except RuntimeError:
            return ''
    else:
        cc = _host_cxx()
    if cc not in _VERSIONS:
        r = subprocess.run([cc, '--version'], capture_output=True, text=True)
        _VERSIONS[cc] = r.stdout
    return cc + '\n' + _VERSIONS[cc]


def library_path(name):
    """Where ``name``'s library lives for the current source, flags and
    compiler."""
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    h.update(' '.join(_flags(src)).encode())
    h.update(_compiler_id(src).encode())
    return BUILD_DIR / '{}-{}.so'.format(name, h.hexdigest()[:16])


def _start(name):
    """Start the compiler for ``name`` unless its library is current.  Returns
    (process, tmp path, final path, log path) or None when up to date."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix('.so.tmp{}'.format(os.getpid()))
    log = out.with_suffix('.log')
    src = _source(name)
    cc = _nvcc() if src.suffix == '.cu' else _host_cxx()
    cmd = [cc, *_flags(src), '-o', str(tmp), str(src)]
    with open(log, 'w') as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name, started):
    proc, tmp, out, log = started
    rc = proc.wait()
    if rc != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError('{} failed for {} (exit {}):\n{}'.format(
            proc.args[0], name, rc, log.read_text()))
    os.replace(tmp, out)


@contextlib.contextmanager
def _file_lock():
    """Hold the build directory's lock (across processes)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / '.lock', 'w') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names=None):
    """Build every kernel (or ``names``) in parallel.  Returns
    {name: {'seconds': wall seconds, 'log': nvcc output or ''}}."""
    names = sources() if names is None else list(names)
    t0 = time.perf_counter()
    with _LOCK, _file_lock():
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
