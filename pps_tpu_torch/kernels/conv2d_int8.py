"""conv2d_int8: the quantized convolution of the int8 serving body.

Counterpart of ``pps_tpu/models/resnet.py:conv2d_int8``, which the JAX
package leaves to XLA (s8 x s8 -> s32 ``conv_general_dilated``).  PyTorch
has no int8 convolution on CUDA, so the port's is a CUDA C++ kernel,
``pps_tpu_torch/csrc/conv2d_int8.cu`` (an implicit GEMM on
``mma.sync`` s8 tensor-core products, the quantize fused into its load and
the dequantize into its store), built with nvcc for sm_90a at first use
and bound with ctypes.

``conv2d_int8(x, wq, xinv, osc, fb, ...)`` is the operator
``torch.ops.pps_tpu_torch.conv2d_int8``: a ``torch.library`` custom op with
a fake (shape) function, so ``torch.export`` records it as one node and a
saved program calls it again once this module is imported.  For a CUDA
tensor it launches the kernel (and counts the launch in ``launches``) or
raises; it never falls back.  For a CPU tensor it returns
``conv2d_int8_plain``.

Layouts: ``x`` is NCHW float32 or bfloat16 (on the card its memory must be
channels_last, i.e. NHWC), ``wq`` int8 OHWI ``[C_out, KH, KW, C_in/groups]``,
``xinv`` float32 0-d or ``[C_in]``, ``osc`` and ``fb`` float32 ``[C_out]``.
The output is NCHW with channels_last memory, in ``out_dtype``.
"""

import ctypes

import torch
import torch.nn.functional as F

from pps_tpu_torch.kernels import build

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

launches = 0


def _out_hw(h, w, kh, kw, stride, dilation):
    ph, pw = ((kh - 1) * dilation) // 2, ((kw - 1) * dilation) // 2
    return ((h + 2 * ph - dilation * (kh - 1) - 1) // stride + 1,
            (w + 2 * pw - dilation * (kw - 1) - 1) // stride + 1)


def quantize_input(x, xinv):
    """``clamp(round(float(x) * xinv), -127, 127)`` as float32 (round half
    to even, as ``jnp.round``); ``xinv`` 0-d or per input channel."""
    inv = xinv if xinv.ndim == 0 else xinv[None, :, None, None]
    return torch.clamp(torch.round(x.float() * inv), -127.0, 127.0)


def conv2d_int8_accumulators(x, wq, xinv, stride=1, dilation=1, groups=1):
    """The plain int32 accumulators: the quantized input convolved with
    ``wq`` as a float64 ``F.conv2d`` (exact: |acc| <= 4608 * 127^2 < 2^53)
    with cuDNN off (no Winograd or FFT rounding), cast to int32."""
    q = quantize_input(x, xinv).double()
    w = wq.permute(0, 3, 1, 2).double()
    kh, kw = w.shape[2], w.shape[3]
    pad = (((kh - 1) * dilation) // 2, ((kw - 1) * dilation) // 2)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(q, w, stride=stride, padding=pad, dilation=dilation,
                       groups=groups)
    return acc.to(torch.int32)


def conv2d_int8_plain(x, wq, xinv, osc, fb, stride=1, dilation=1, groups=1,
                      out_dtype=None, accumulators=False):
    """Plain PyTorch version on any device: quantize, exact int32
    accumulators, then ``float(acc) * osc`` and ``+ fb`` as two separately
    rounded float32 ops, cast to ``out_dtype`` (default ``x.dtype``).  With
    ``accumulators`` the int32 accumulators instead."""
    acc = conv2d_int8_accumulators(x, wq, xinv, stride, dilation, groups)
    if accumulators:
        return acc.contiguous(memory_format=torch.channels_last)
    y = acc.float() * osc[None, :, None, None]
    y = y + fb[None, :, None, None]
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return y.to(out_dtype).contiguous(memory_format=torch.channels_last)


def _lib():
    lib = build.load('conv2d_int8')
    fn = lib.pps_conv2d_int8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, i,
                       i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, wq, xinv, osc, fb, groups, out_dtype):
    if x.ndim != 4 or wq.ndim != 4:
        raise ValueError('conv2d_int8: x and wq must be 4-d, got {} and {}'
                         .format(tuple(x.shape), tuple(wq.shape)))
    if wq.dtype != torch.int8:
        raise TypeError('conv2d_int8: wq must be int8, got {}'.format(
            wq.dtype))
    if x.dtype not in _X_CODE:
        raise TypeError('conv2d_int8: x dtype {} is not float32 or '
                        'bfloat16'.format(x.dtype))
    if out_dtype not in _OUT_CODE:
        raise TypeError('conv2d_int8: out_dtype {} is not float32, bfloat16 '
                        'or int32'.format(out_dtype))
    cin, cout = x.shape[1], wq.shape[0]
    if cin % groups or cout % groups or wq.shape[3] * groups != cin:
        raise ValueError('conv2d_int8: x has {} channels, wq {} with {} '
                         'groups'.format(cin, tuple(wq.shape), groups))
    if xinv.numel() not in (1, cin) or xinv.ndim > 1:
        raise ValueError('conv2d_int8: xinv must be 0-d or [{}], got {}'
                         .format(cin, tuple(xinv.shape)))
    for name, t in (('osc', osc), ('fb', fb)):
        if tuple(t.shape) != (cout,):
            raise ValueError('conv2d_int8: {} must be [{}], got {}'.format(
                name, cout, tuple(t.shape)))


@torch.library.custom_op('pps_tpu_torch::conv2d_int8', mutates_args=())
def _conv2d_int8_op(x: torch.Tensor, wq: torch.Tensor, xinv: torch.Tensor,
                    osc: torch.Tensor, fb: torch.Tensor, stride: int,
                    dilation: int, groups: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    if x.device.type == 'cpu':
        return conv2d_int8_plain(x, wq, xinv, osc, fb, stride, dilation,
                                 groups, out_dtype,
                                 accumulators=out_dtype == torch.int32)
    if x.device.type != 'cuda':
        raise ValueError('conv2d_int8: unsupported device {}'.format(
            x.device))
    for name, t in (('wq', wq), ('xinv', xinv), ('osc', osc), ('fb', fb)):
        if t.device != x.device:
            raise ValueError('conv2d_int8: {} is on {}, x on {}'.format(
                name, t.device, x.device))
        if not t.is_contiguous():
            raise ValueError('conv2d_int8: {} must be contiguous'.format(
                name))
    for name, t in (('xinv', xinv), ('osc', osc), ('fb', fb)):
        if t.dtype != torch.float32:
            raise TypeError('conv2d_int8: {} must be float32'.format(name))
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('conv2d_int8: x must be channels_last (NHWC '
                         'memory), got strides {}'.format(x.stride()))
    n, cin, h, w = x.shape
    cout, kh, kw = wq.shape[0], wq.shape[1], wq.shape[2]
    ho, wo = _out_hw(h, w, kh, kw, stride, dilation)
    out = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), _X_CODE[x.dtype], xinv.data_ptr(),
                 int(xinv.numel() != 1), wq.data_ptr(), osc.data_ptr(),
                 fb.data_ptr(), out.data_ptr(), _OUT_CODE[out_dtype], n, h, w,
                 cin, cout, kh, kw, stride, dilation, groups, stream)
    if err != 0:
        raise RuntimeError('conv2d_int8: kernel launch failed (code {})'
                           .format(err))
    launches += 1
    return out


@_conv2d_int8_op.register_fake
def _(x, wq, xinv, osc, fb, stride, dilation, groups, out_dtype):
    n, _, h, w = x.shape
    ho, wo = _out_hw(h, w, wq.shape[1], wq.shape[2], stride, dilation)
    return torch.empty((n, wq.shape[0], ho, wo), dtype=out_dtype,
                       device=x.device, memory_format=torch.channels_last)


def conv2d_int8(x, wq, xinv, osc, fb, stride=1, dilation=1, groups=1,
                out_dtype=None, accumulators=False):
    """The quantized NCHW conv (see the module docstring); ``out_dtype``
    defaults to ``x.dtype``.  ``accumulators=True`` returns the int32
    accumulators instead of the dequantized output (a check entry)."""
    out_dtype = torch.int32 if accumulators else (
        x.dtype if out_dtype is None else out_dtype)
    _check(x, wq, xinv, osc, fb, groups, out_dtype)
    return torch.ops.pps_tpu_torch.conv2d_int8(
        x, wq, xinv, osc, fb, stride, dilation, groups, out_dtype)
