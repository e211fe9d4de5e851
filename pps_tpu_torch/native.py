"""The host C++ re-ranking engine (``csrc/rerank.cc``, OpenMP), loaded
with ctypes (counterpart of ``pps_tpu/native/__init__.py``).

The library is built at first use by ``kernels/build.py`` with the host
compiler into the git-ignored build directory.  If it cannot be built or
loaded, the call raises: nothing falls back to numpy quietly (the numpy
golden path is ``evaluation/rerank.re_ranking``, chosen by name).
"""

import ctypes

import numpy as np

from pps_tpu_torch.kernels import build

_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        lib = build.load('rerank')
        lib.pps_rerank.restype = ctypes.c_int
        lib.pps_rerank.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
    return _LIB


def _as_c_float(a):
    a = np.ascontiguousarray(a, dtype=np.float32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rerank_native(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6,
                  lambda_value=0.3):
    """C++ k-reciprocal re-ranking; the contract of
    ``evaluation.rerank.re_ranking`` (numpy in, [Nq, Ng] float32 out)."""
    lib = _load()
    nq, ng = q_g_dist.shape
    qg, qg_p = _as_c_float(q_g_dist)
    qq, qq_p = _as_c_float(q_q_dist)
    gg, gg_p = _as_c_float(g_g_dist)
    out = np.empty((nq, ng), np.float32)
    rc = lib.pps_rerank(qg_p, qq_p, gg_p, nq, ng, int(k1), int(k2),
                        float(lambda_value),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError('pps_rerank returned {}'.format(rc))
    return out


def rerank(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6, lambda_value=0.3,
           engine='auto'):
    """Host re-ranking by engine name: 'auto' (the C++ engine; raises if
    it cannot be built or loaded) or 'numpy' (the golden path)."""
    if engine == 'auto':
        return rerank_native(q_g_dist, q_q_dist, g_g_dist, k1=k1, k2=k2,
                             lambda_value=lambda_value)
    if engine == 'numpy':
        from pps_tpu_torch.evaluation.rerank import re_ranking
        return re_ranking(np.asarray(q_g_dist), np.asarray(q_q_dist),
                          np.asarray(g_g_dist), k1=k1, k2=k2,
                          lambda_value=lambda_value)
    raise ValueError("engine must be 'auto' or 'numpy': {!r}".format(engine))
