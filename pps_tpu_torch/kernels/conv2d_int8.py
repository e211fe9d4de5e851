"""conv2d_int8: the quantized convolution of the int8 serving body.

Counterpart of ``pps_tpu/models/resnet.py:conv2d_int8``, which the JAX
package leaves to XLA (s8 x s8 -> s32 ``conv_general_dilated``).  PyTorch
has no int8 convolution on CUDA, so the port's is a CUDA C++ kernel,
``pps_tpu_torch/csrc/conv2d_int8.cu``, built with nvcc for sm_90a at first
use and bound with ctypes.  It has three routes, chosen by shape alone
(``route`` below is the C entry's choice, in Python): the R-50 body's convs
on ``wgmma`` s8 products fed by TMA through a shared-memory ring (the
quantize fused into the activation path, the dequantize into a TMA store),
the stem on the same ``wgmma`` path with K laid out per kernel row, and
every other shape on a simple ``mma.sync`` kernel.

``conv2d_int8(x, wq, xinv, osc, fb, ...)`` is the operator
``torch.ops.pps_tpu_torch.conv2d_int8``: a ``torch.library`` custom op with
a fake (shape) function, so ``torch.export`` records it as one node and a
saved program calls it again once this module is imported (an eager call
on the card launches the kernel without the dispatcher, whose host time
per call was ~50 us).  For a CUDA tensor it launches the kernel (and
counts the launch in ``launches``) or raises; it never falls back.  For a
CPU tensor it returns ``conv2d_int8_plain``.

Layouts: ``x`` is NCHW float32 or bfloat16 (on the card its memory must be
channels_last, i.e. NHWC), ``wq`` int8 OHWI ``[C_out, KH, KW, C_in/groups]``,
``xinv`` float32 0-d or ``[C_in]``, ``osc`` and ``fb`` float32 ``[C_out]``.
The output is NCHW with channels_last memory, in ``out_dtype``.
"""

import ctypes

import torch
import torch.nn.functional as F
from torch.utils import _python_dispatch

from pps_tpu_torch.kernels import build

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

launches = 0


def _out_hw(h, w, kh, kw, stride, dilation):
    ph, pw = ((kh - 1) * dilation) // 2, ((kw - 1) * dilation) // 2
    return ((h + 2 * ph - dilation * (kh - 1) - 1) // stride + 1,
            (w + 2 * pw - dilation * (kw - 1) - 1) // stride + 1)


# the wgmma routes' tiling (csrc/conv2d_int8.cu: choose_route, stem_boxes)
ROUTES = ('general', 'wgmma', 'wgmma_stem')
TILE_M = 128          # output pixels per tile
_BK = 64              # input channels per ring stage
_SMS = 132            # the H100's SMs, as the N-tile choice assumes
_QUANT_CYCLES = 448   # one stage's quantize, cycles per SM sub-partition


def _cdiv(a, b):
    return -(-a // b)


def _stem_boxes(bw, bh, cin, kh, kw, stride, dilation):
    """(rows_in, box_w, nbox) of the stem route's ring stage for a tile of
    bh x bw output pixels, or None when it does not fit."""
    rows = (bh - 1) * stride + (kh - 1) * dilation + 1
    span = ((bw - 1) * stride + (kw - 1) * dilation + 1) * cin + 3
    nbox = _cdiv(span, 256)
    while True:
        width = _cdiv(_cdiv(span, nbox), 32) * 32
        if width <= 256:
            break
        nbox += 1
    if rows > 256 or nbox > 4 or rows * nbox * width * 4 > 32768:
        return None
    return rows, width, nbox


def _general():
    return dict(kind='general', bn=0, box=(0, 0, 0), out=(0, 0, 0),
                m_tiles=0, n_tiles=0)


def route(x_dtype, n, cin, h, w, cout, kh, kw, stride=1, dilation=1,
          groups=1):
    """The route ``conv2d_int8`` takes for a conv shape, as the C entry
    chooses it (``pps_conv2d_int8_route``): a dict with ``kind`` (one of
    ``ROUTES``), the N tile ``bn``, the tile's pixel box ``box`` (width,
    height, images), the output ``out`` (n, ho, wo) as the tiles walk it (a
    1x1 stride-1 conv's pixels as one row), ``m_tiles`` and ``n_tiles``.
    ``x_dtype`` is a torch dtype (float32 or bfloat16)."""
    general = _general()
    ho, wo = _out_hw(h, w, kh, kw, stride, dilation)
    if groups != 1 or cout % 8 or ho <= 0 or wo <= 0:
        return general
    if x_dtype == torch.bfloat16 and cin % _BK == 0 and stride <= 8:
        flat = kh == 1 and kw == 1 and stride == 1
        out = (1, 1, n * ho * wo) if flat else (n, ho, wo)
        s = 1 if flat else stride
        best = None
        for lw in range(7, -1, -1):
            for lh in range(7 - lw, -1, -1):
                bw, bh, bimg = 1 << lw, 1 << lh, 128 >> (lw + lh)
                if bw * s > 256 or bh * s > 256:
                    continue
                tiles = (_cdiv(out[2], bw) * _cdiv(out[1], bh) *
                         _cdiv(out[0], bimg))
                if best is None or tiles < best[0]:
                    best = (tiles, (bw, bh, bimg))
        m_tiles, box = best
        ksteps = kh * kw * cin // _BK
        best_bn = None
        for bn in (256, 128, 64):
            if bn > 64 and bn >= 2 * cout:
                continue
            cost = (_cdiv(m_tiles * _cdiv(cout, bn), _SMS) *
                    (ksteps * max(2 * bn + 64, _QUANT_CYCLES) + 8 * bn))
            if best_bn is None or cost < best_bn[0]:
                best_bn = (cost, bn)
        bn = best_bn[1]
        return dict(kind='wgmma', bn=bn, box=box, out=out, m_tiles=m_tiles,
                    n_tiles=_cdiv(cout, bn))
    if (x_dtype == torch.float32 and cin * kw <= 32 and kh <= 8 and
            cout <= 64 and (w * cin) % 4 == 0):
        best = None
        for lw in range(7, -1, -1):
            bw, bh = 1 << lw, 128 >> lw
            if _stem_boxes(bw, bh, cin, kh, kw, stride, dilation) is None:
                continue
            tiles = _cdiv(wo, bw) * _cdiv(ho, bh) * n
            if best is None or tiles < best[0]:
                best = (tiles, (bw, bh, 1))
        if best is not None:
            return dict(kind='wgmma_stem', bn=64, box=best[1],
                        out=(n, ho, wo), m_tiles=best[0], n_tiles=1)
    return general


def tile_schedule(r, grid):
    """The wgmma routes' persistent schedule, as the kernel walks it: for
    each of ``grid`` CTAs, its tiles in order as ((w0, h0, n0) output pixel
    origin in ``r['out']``'s coordinates, c0 first output channel); CTA i
    takes tiles i, i + grid, ..., a tile row's N tiles back to back."""
    bw, bh, bimg = r['box']
    tw = _cdiv(r['out'][2], bw)
    th = _cdiv(r['out'][1], bh)
    tiles = r['m_tiles'] * r['n_tiles']
    out = []
    for cta in range(grid):
        mine = []
        for tile in range(cta, tiles, grid):
            mt, nt = divmod(tile, r['n_tiles'])
            wb, rest = mt % tw, mt // tw
            hb, nb = rest % th, rest // th
            mine.append(((wb * bw, hb * bh, nb * bimg), nt * r['bn']))
        out.append(mine)
    return out


def resnet_body_convs(spec, h, w):
    """The convs of a ResNet body at input h x w, in order, as (name, c_in,
    h, w, c_out, k, stride, dilation, groups) with each conv's input
    size."""
    out = [('conv1', 3, h, w, 64, 7, 2, 1, 1)]
    h, w = -(-h // 4), -(-w // 4)  # conv1 /2, then the 3x3/2 max pool
    dim_in = 64
    for stage, n, dim_out, inner, stride, dil in spec['stages']:
        for i in range(n):
            s = stride if i == 0 else 1
            s1, s3 = (s, 1) if spec['stride_1x1'] else (1, s)
            p = '{}_{}'.format(stage, i)
            if i == 0 and dim_in != dim_out:
                out.append((p + '_branch1', dim_in, h, w, dim_out, 1, s, 1,
                            1))
            out.append((p + '_branch2a', dim_in, h, w, inner, 1, s1, 1, 1))
            h, w = -(-h // s1), -(-w // s1)
            out.append((p + '_branch2b', inner, h, w, inner, 3, s3, dil,
                        spec['num_groups']))
            h, w = -(-h // s3), -(-w // s3)
            out.append((p + '_branch2c', inner, h, w, dim_out, 1, 1, 1, 1))
            dim_in = dim_out
    return out


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


def native_route(x_dtype, n, cin, h, w, cout, kh, kw, stride=1, dilation=1,
                 groups=1):
    """The C entry's own route for a shape (``pps_conv2d_int8_route``),
    with ``route``'s keys; builds the library.  For checking ``route``."""
    fn = build.load('conv2d_int8').pps_conv2d_int8_route
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    v = (ctypes.c_int * 7)()
    fn(_X_CODE[x_dtype], n, h, w, cin, cout, kh, kw, stride, dilation,
       groups, ctypes.addressof(v))
    if v[0] == 0:
        return _general()
    r = route(x_dtype, n, cin, h, w, cout, kh, kw, stride, dilation, groups)
    r.update(kind=ROUTES[v[0]], bn=v[1], box=(v[2], v[3], v[4]),
             m_tiles=v[5], n_tiles=v[6])
    return r


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


def _launch(x, wq, xinv, osc, fb, stride, dilation, groups, out_dtype):
    """Launch the kernel on CUDA tensors (checked here), count it."""
    global launches
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
    # the wgmma routes' TMA needs 16-byte aligned addresses: a view with an
    # odd storage offset is copied (fresh tensors always are aligned)
    if x.data_ptr() % 16:
        x = x.clone(memory_format=torch.channels_last)
    if wq.data_ptr() % 16:
        wq = wq.clone()
    args = (x.data_ptr(), _X_CODE[x.dtype], xinv.data_ptr(),
            int(xinv.numel() != 1), wq.data_ptr(), osc.data_ptr(),
            fb.data_ptr(), out.data_ptr(), _OUT_CODE[out_dtype], n, h, w, cin,
            cout, kh, kw, stride, dilation, groups)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError('conv2d_int8: kernel launch failed (code {})'
                           .format(err))
    launches += 1
    return out


@torch.library.custom_op('pps_tpu_torch::conv2d_int8', mutates_args=())
def _conv2d_int8_op(x: torch.Tensor, wq: torch.Tensor, xinv: torch.Tensor,
                    osc: torch.Tensor, fb: torch.Tensor, stride: int,
                    dilation: int, groups: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type == 'cpu':
        return conv2d_int8_plain(x, wq, xinv, osc, fb, stride, dilation,
                                 groups, out_dtype,
                                 accumulators=out_dtype == torch.int32)
    if x.device.type != 'cuda':
        raise ValueError('conv2d_int8: unsupported device {}'.format(
            x.device))
    return _launch(x, wq, xinv, osc, fb, stride, dilation, groups, out_dtype)


@_conv2d_int8_op.register_fake
def _(x, wq, xinv, osc, fb, stride, dilation, groups, out_dtype):
    n, _, h, w = x.shape
    ho, wo = _out_hw(h, w, wq.shape[1], wq.shape[2], stride, dilation)
    return torch.empty((n, wq.shape[0], ho, wo), dtype=out_dtype,
                       device=x.device, memory_format=torch.channels_last)


def _eager(x):
    """True outside tracing: a plain tensor, no dispatch mode (export's
    fake and proxy tensors), not compiling.  Traced calls go through the
    custom op, so a program records it as one node."""
    return (type(x) is torch.Tensor and not torch.compiler.is_compiling()
            and _python_dispatch._get_current_dispatch_mode() is None)


def conv2d_int8(x, wq, xinv, osc, fb, stride=1, dilation=1, groups=1,
                out_dtype=None, accumulators=False):
    """The quantized NCHW conv (see the module docstring); ``out_dtype``
    defaults to ``x.dtype``.  ``accumulators=True`` returns the int32
    accumulators instead of the dequantized output (a check entry)."""
    out_dtype = torch.int32 if accumulators else (
        x.dtype if out_dtype is None else out_dtype)
    _check(x, wq, xinv, osc, fb, groups, out_dtype)
    if x.is_cuda and _eager(x):
        # the kernel without the dispatcher's ~50 us of host time a call
        return _launch(x, wq, xinv, osc, fb, stride, dilation, groups,
                       out_dtype)
    return torch.ops.pps_tpu_torch.conv2d_int8(
        x, wq, xinv, osc, fb, stride, dilation, groups, out_dtype)
