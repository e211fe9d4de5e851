"""ZeroEven: a copy of a 1-D tensor with every even index set to 0.

Port of the TPU kernel ``pps_tpu/ops/pallas/zero_even.py:zero_even`` as a
CUDA C++ kernel (``pps_tpu_torch/csrc/zero_even.cu``), built with nvcc for
sm_90a and bound with ctypes.  It proves the route every later kernel of
the port takes: build at first use, launch on PyTorch's current stream,
check the launch, count it, hold it against its plain version.

``zero_even(x)`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it returns ``zero_even_plain(x)``.  ``launches``
counts kernel launches.
"""

import ctypes

import torch

from pps_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches = 0


def zero_even_plain(x):
    """Plain PyTorch version: the same function, any device."""
    assert x.ndim == 1, 'ZeroEven expects a 1-D tensor'
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(idx % 2 == 0, torch.zeros((), dtype=x.dtype,
                                                 device=x.device), x)


def _lib():
    lib = build.load('zero_even')
    fn = lib.pps_zero_even
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def zero_even(x):
    """x: 1-D float32 / bfloat16 / float16 tensor -> same shape and dtype,
    even indices zeroed."""
    global launches
    assert x.ndim == 1, 'ZeroEven expects a 1-D tensor'
    if x.device.type == 'cpu':
        return zero_even_plain(x)
    if x.device.type != 'cuda':
        raise ValueError('zero_even: unsupported device {}'.format(x.device))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError('zero_even: dtype {} is not one of {}'.format(
            x.dtype, sorted(str(d) for d in _DTYPE_CODE)))
    if not x.is_contiguous():
        raise ValueError('zero_even: x must be contiguous')
    out = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return out
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, _DTYPE_CODE[x.dtype],
                 stream)
    if err != 0:
        raise RuntimeError('zero_even: kernel launch failed (cudaError '
                           '{})'.format(err))
    launches += 1
    return out
