"""On-device training augmentation on the uint8 wire (counterpart of
``pps_tpu/data/device_augment.py``).

The host ships raw uint8 decodes and a per-sample flip flag; on the
device, in the reference chain's order:

  flip -> random_crop -> horizontal_crop -> hsv_jitter -> gaussian_blur
  -> random_erasing -> float32 - PIXEL_MEANS -> cv2-exact bicubic resize
  to REID.SCALE

* A crop followed by a bicubic resize is a linear map, so both crops fuse
  into per-sample resize matrices built from the crop length and offset
  (the Keys weights of ``data/device_preprocess.py``), applied as two
  batched products.  With no crop they equal cv2's resize matrices.
* Parameters are drawn from an explicit ``torch.Generator`` on the
  device with the distributions of the JAX package's ``sample_params``;
  the streams differ, so the tests hand the JAX package's drawn params to
  ``apply_augment`` instead of comparing streams.
* hsv_jitter is cv2's uint8 fixed-point RGB2HSV (channel 0 plays R on the
  BGR array, the reference's quirk) and its float HSV2RGB with cvRound
  half-to-even; H clips at 255, not 179, as in the reference.
* gaussian_blur uses cv2's fixed small-sigma kernels (ksize 1, 3, 5, 7)
  with REFLECT_101 borders, summed tap by tap in float32: every product
  and partial sum is a dyadic fraction below 2^8 with at most 18
  significant bits, so the sum is exact in any order.
* random_erasing keeps the reference's accept-reject over 100 attempts,
  ``round`` half-to-even, and fills the uint8 truncation of PIXEL_MEANS.
* The padded wire (mixed-size datasets): decodes reflect-padded
  bottom/right to one dataset-global bucket plus each sample's
  ``valid_hw``; draws scale with each sample's valid size (see
  ``apply_augment``).

Every uint8 stage is integer work or exact float32 work done op by op, so
the card, the CPU and the JAX package agree on it bit for bit.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pps_tpu_torch.data.device_preprocess import _CV2_A

_HSV_SHIFT = 12      # cv2 fixed-point shift for u8 HSV


def augment_spec(cfg):
    """Static dict of the REID.* augmentation knobs."""
    r = cfg.REID
    return {
        'crop_prob': float(r.CROP_PROB),
        'crop_ratio': float(r.CROP_RATIO),
        'hcrop_prob': float(r.HORIZONTAL_CROP_PROB),
        'hcrop_ratio': float(r.HORIZONTAL_CROP_RATIO),
        'hsv_prob': float(r.HSV_JITTER_PROB),
        'sat_range': int(r.SATURATION_RANGE),
        'hue_range': int(r.HUE_RANGE),
        'val_range': int(r.VALUE_RANGE),
        'blur_prob': float(r.GAUSSIAN_BLUR_PROB),
        'blur_kernel': int(r.GAUSSIAN_BLUR_KERNEL),
        'erase_prob': float(r.RANDOM_ERASING_PROB),
        'sl': float(r.SL), 'sh': float(r.SH), 'r1': float(r.R1),
        'out_hw': (int(r.SCALE[1]), int(r.SCALE[0])),  # (H', W')
    }


# ---------------------------------------------------------------------------
# fused crop + cv2-exact bicubic resize (per-sample linear maps)
# ---------------------------------------------------------------------------


def _keys_w(d):
    """Keys cubic weights, a = -0.75 (cv2 interpolateCubic), on tensors."""
    d = torch.abs(d)
    w1 = (_CV2_A + 2.0) * d ** 3 - (_CV2_A + 3.0) * d ** 2 + 1.0
    w2 = _CV2_A * (d ** 3 - 5.0 * d ** 2 + 8.0 * d - 4.0)
    return torch.where(d <= 1.0, w1, torch.where(d < 2.0, w2, 0.0))


def crop_resize_matrices(out_size, in_size, crop_len, crop_start):
    """[B, out_size, in_size] float32: per sample, rows
    [start, start + len) cropped then cv2.resize INTER_CUBIC to out_size,
    replicating the *crop* edges.  crop_len / crop_start: [B] int."""
    o = torch.arange(out_size, dtype=torch.float32, device=crop_len.device)
    cl = crop_len.float()[:, None]
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its float32 reciprocal, which moves the source positions by an ulp
    # and the output by up to ~1e-2 against the CPU and the JAX package
    src = (o + 0.5) * (cl / torch.full_like(cl, out_size)) - 0.5
    ix = torch.floor(src)
    t = src - ix
    m = torch.zeros((crop_len.shape[0], out_size, in_size),
                    dtype=torch.float32, device=crop_len.device)
    for tap in range(-1, 3):
        w = _keys_w(tap - t)
        j = (torch.minimum(torch.clamp(ix + tap, min=0.0), cl - 1.0).long()
             + crop_start.long()[:, None])
        m = m + w[..., None] * F.one_hot(j, in_size).float()
    return m


def crop_resize_batch(x_f32, ch, cw, y0, x0, out_hw):
    """[B, H, W, C] float32 -> [B, H', W', C]: per-sample crop windows
    resized with cv2-exact bicubic, as two batched products."""
    out_h, out_w = out_hw
    rh = crop_resize_matrices(out_h, x_f32.shape[1], ch, y0)
    rw = crop_resize_matrices(out_w, x_f32.shape[2], cw, x0)
    y = torch.einsum('bOh,bhwc->bOwc', rh, x_f32)
    return torch.einsum('bOw,bHwc->bHOc', rw, y)


# ---------------------------------------------------------------------------
# cv2-u8 HSV round trip
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _hsv_tables():
    """cv2's fixed-point divisor tables (numpy int32; index 0 is 0)."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide='ignore'):
        sdiv = np.rint((255 << _HSV_SHIFT) / i)
        hdiv = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    sdiv[0] = 0
    hdiv[0] = 0
    return sdiv.astype(np.int32), hdiv.astype(np.int32)


def rgb2hsv_u8(x):
    """cv2 COLOR_RGB2HSV uint8 fixed point; x int32 [..., 3] whose
    channel 0 plays R.  Every product fits int32 (at most 255 x 4096 for
    S, 5 x 255 x 120 x 4096 / 255 for H)."""
    sdiv_t, hdiv_t = _hsv_tables()
    sdiv = torch.as_tensor(sdiv_t, device=x.device)
    hdiv = torch.as_tensor(hdiv_t, device=x.device)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    # >> on a signed integer tensor is an arithmetic (flooring) shift
    s = (diff * sdiv[v.long()] + half) >> _HSV_SHIFT
    hraw = torch.where(v == r, g - b,
                       torch.where(v == g, b - r + 2 * diff,
                                   r - g + 4 * diff))
    h = (hraw * hdiv[diff.long()] + half) >> _HSV_SHIFT
    h = h + torch.where(h < 0, 180, 0).to(h.dtype)
    return torch.stack([h, s, v], dim=-1)


# per-sector (r, g, b) -> index into (v, p, q, t) of cv2's HSV2RGB
_SECTOR_TAB = [[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0],
               [0, 1, 2]]


def hsv2rgb_u8(hsv):
    """cv2 COLOR_HSV2RGB uint8: float32 sector math with the constants
    6/180 and 1/255, then cvRound (half-to-even, as ``torch.round``).  An
    H past 179 (the reference clips at 255) wraps once by 6 sectors, as
    cv2's does."""
    h = hsv[..., 0].float() * (6.0 / 180.0)
    s = hsv[..., 1].float() * (1.0 / 255.0)
    v = hsv[..., 2].float() * (1.0 / 255.0)
    h = torch.where(h >= 6.0, h - 6.0, h)
    sector = torch.floor(h)
    f = h - sector
    tab = torch.stack([v, v * (1.0 - s), v * (1.0 - s * f),
                       v * (1.0 - s * (1.0 - f))], dim=-1)
    sd = torch.as_tensor(_SECTOR_TAB, device=hsv.device)
    idx = sd[torch.clamp(sector.long(), 0, 5)]             # [..., 3] r,g,b
    rgb = torch.gather(tab, -1, idx)
    return torch.clamp(torch.round(rgb * 255.0), 0, 255).int()


def hsv_jitter_u8(x, d_sat, d_hue, d_val):
    """Per-sample integer deltas on H, S and V; int32 [B, H, W, 3] in and
    out.  All three channels clip at [0, 255] after the shift (H too: the
    reference's quirk; values past 179 reach HSV2RGB)."""
    hsv = rgb2hsv_u8(x)
    shift = torch.stack([d_hue, d_sat, d_val], dim=-1).to(hsv.dtype)
    return hsv2rgb_u8(torch.clamp(hsv + shift[:, None, None, :], 0, 255))


# ---------------------------------------------------------------------------
# gaussian blur (cv2 small-sigma fixed kernels, REFLECT_101)
# ---------------------------------------------------------------------------

# cv2 getGaussianKernel(ksize, sigma<=0) for ksize <= 7: fixed tables
_BLUR_TAPS = {
    1: [0, 0, 0, 1.0, 0, 0, 0],
    3: [0, 0, 0.25, 0.5, 0.25, 0, 0],
    5: [0, 0.0625, 0.25, 0.375, 0.25, 0.0625, 0],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}
_BLUR_PAD = 3


def reflect_index(n, pad, device=None):
    """Source indices of an axis of ``n`` padded by ``pad`` on each side
    with numpy's 'reflect' (cv2 BORDER_REFLECT_101), for any pad: the
    periodic extension numpy builds by repeated reflection when the pad
    exceeds the axis (``F.pad`` refuses pads that large)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m >= n, period - m, m)


def gaussian_blur_u8(x, taps):
    """Separable 7-tap blur with per-sample kernels; x int32 [B, H, W, 3],
    taps [B, 7] float32 (smaller kernels zero-padded).  REFLECT_101
    borders, rounded back to the uint8 range."""
    def conv_axis(y, axis):
        n = y.shape[axis]
        yp = torch.index_select(y, axis,
                                reflect_index(n, _BLUR_PAD, y.device))
        out = torch.zeros_like(y)
        for t in range(7):
            out = out + taps[:, t, None, None, None] * yp.narrow(axis, t, n)
        return out

    yf = conv_axis(conv_axis(x.float(), 1), 2)
    return torch.clamp(torch.round(yf), 0, 255).int()


# ---------------------------------------------------------------------------
# parameter sampling (the JAX package's distributions)
# ---------------------------------------------------------------------------


def _uniform(gen, shape, device, low=0.0, high=1.0):
    return low + torch.rand(shape, generator=gen, device=device) * (
        high - low)


def _randint(gen, shape, device, low, high):
    """numpy RandomState.randint semantics: uniform over [low, high);
    ``high`` may be a per-sample tensor."""
    u = _uniform(gen, shape, device)
    return low + torch.floor(u * (high - low)).int()


def sample_params(generator, spec, batch, raw_hw, device):
    """All per-sample augmentation parameters, drawn from ``generator``
    (a ``torch.Generator`` on ``device``) with no host round trip.

    raw_hw: the (H, W) every sample shares, as ints, or per-sample [B]
    int tensors (the padded wire: each sample's valid decode size, so its
    draws scale as the host chain's would for that image's true size).
    Returns a dict of [B] tensors: ch, cw, y0, x0 (the crop window);
    with HSV on, hsv_on, d_sat, d_hue, d_val; with blur on, blur_taps
    [B, 7]; with erasing on, erase_on, er_y, er_x, er_h, er_w (full-image
    coordinates).  A knob at probability 0 draws nothing, so the stream
    of the others does not move.
    """
    g, dev = generator, device
    i32 = dict(dtype=torch.int32, device=dev)
    ch = torch.as_tensor(raw_hw[0], **i32).expand(batch).clone()
    cw = torch.as_tensor(raw_hw[1], **i32).expand(batch).clone()
    y0 = torch.zeros((batch,), **i32)
    x0 = torch.zeros((batch,), **i32)
    if spec['crop_prob'] > 0:
        fire = _uniform(g, (batch,), dev) <= spec['crop_prob']
        hr = _uniform(g, (batch,), dev, spec['crop_ratio'], 1.0)
        wr = _uniform(g, (batch,), dev, spec['crop_ratio'], 1.0)
        nch = (ch * hr).int()
        ncw = (cw * wr).int()
        ny0 = _randint(g, (batch,), dev, 0, torch.clamp(ch - nch, min=1))
        nx0 = _randint(g, (batch,), dev, 0, torch.clamp(cw - ncw, min=1))
        ch = torch.where(fire, nch, ch)
        cw = torch.where(fire, ncw, cw)
        y0 = torch.where(fire, ny0, y0)
        x0 = torch.where(fire, nx0, x0)

    # horizontal_crop: the top slice of tall (h / w > 1.5) images
    if spec['hcrop_prob'] > 0 and spec['hcrop_ratio'] < 1:
        fire = ((_uniform(g, (batch,), dev) < spec['hcrop_prob'])
                & (ch.float() / cw.float() > 1.5))
        hr = _uniform(g, (batch,), dev, spec['hcrop_ratio'], 1.0)
        ch = torch.where(fire, (ch * hr).int(), ch)
    p = {'ch': ch, 'cw': cw, 'y0': y0, 'x0': x0}

    # hsv_jitter: one integer delta per image per channel
    if spec['hsv_prob'] > 0:
        fire = _uniform(g, (batch,), dev) <= spec['hsv_prob']
        deltas = {}
        for key, rng in (('d_sat', spec['sat_range']),
                         ('d_hue', spec['hue_range']),
                         ('d_val', spec['val_range'])):
            d = (_randint(g, (batch,), dev, -rng, rng) if rng > 0
                 else torch.zeros((batch,), **i32))
            deltas[key] = torch.where(fire, d, 0)
        p.update(hsv_on=fire, **deltas)

    # gaussian_blur: an odd ksize from 1 .. blur_kernel - 1
    if spec['blur_prob'] > 0:
        sizes = list(range(1, spec['blur_kernel'], 2))
        fire = _uniform(g, (batch,), dev) <= spec['blur_prob']
        idx = _randint(g, (batch,), dev, 0, len(sizes))
        ktab = torch.tensor([_BLUR_TAPS[s] for s in sizes],
                            dtype=torch.float32, device=dev)
        ident = torch.tensor(_BLUR_TAPS[1], dtype=torch.float32, device=dev)
        p['blur_taps'] = torch.where(fire[:, None], ktab[idx.long()],
                                     ident[None, :])

    # random_erasing: accept-reject over 100 attempts in crop coordinates;
    # python round() is half-to-even, as torch.round is
    if spec['erase_prob'] > 0:
        fire = _uniform(g, (batch,), dev) <= spec['erase_prob']
        area = (ch * cw).float()[:, None]
        ta = _uniform(g, (batch, 100), dev, spec['sl'], spec['sh']) * area
        ar = _uniform(g, (batch, 100), dev, spec['r1'], 1.0 / spec['r1'])
        eh = torch.round(torch.sqrt(ta * ar)).int()
        ew = torch.round(torch.sqrt(ta / ar)).int()
        valid = (ew < cw[:, None]) & (eh < ch[:, None])
        # the first accepted attempt (argmax returns the first maximum)
        first = torch.argmax(valid.to(torch.uint8), dim=1, keepdim=True)
        eh = torch.gather(eh, 1, first)[:, 0]
        ew = torch.gather(ew, 1, first)[:, 0]
        ex = _randint(g, (batch,), dev, 0, ch - eh + 1)  # row, crop coords
        ey = _randint(g, (batch,), dev, 0, cw - ew + 1)  # col, crop coords
        p.update(erase_on=fire & valid.any(dim=1), er_y=y0 + ex,
                 er_x=x0 + ey, er_h=eh, er_w=ew)
    return p


# ---------------------------------------------------------------------------
# the fused pipeline
# ---------------------------------------------------------------------------


def apply_augment(x_u8, flipped, params, spec, pixel_means, valid_hw=None):
    """uint8 [B, H, W, 3] + drawn params -> float32 [B, H', W', 3].

    flipped: [B] bool (or None): mirror those samples first.  The uint8
    stages (flip, HSV, blur, erasing) are exact integer or exact float32
    work; the float32 stage is the mean subtraction and the crop-resize
    products.

    valid_hw (the padded wire): [B, 2] int tensor of each sample's true
    decode size in an array reflect-padded bottom/right on the host.
    Flipping the padded array gives the padded flipped image with the
    valid region moved to columns [W_pad - w, W_pad), so a flipped
    sample's column coordinates (crop start, erase box) shift by
    W_pad - w; blur taps read the reflected pad, and the resize matrices
    never sample outside the valid window.  So the output equals running
    each sample at its true size, except blur taps across a pad of 1-2
    px (below the 3 px blur radius the pad reflects twice; pads of 0 or
    >= 3 are exact), as in the JAX package.
    """
    x = x_u8.int()
    off_w = None
    if flipped is not None:
        x = torch.where(flipped[:, None, None, None], torch.flip(x, (2,)), x)
        if valid_hw is not None:
            off_w = torch.where(flipped, x.shape[2] - valid_hw[:, 1].int(),
                                0)
    if 'hsv_on' in params:
        jit_x = hsv_jitter_u8(x, params['d_sat'], params['d_hue'],
                              params['d_val'])
        x = torch.where(params['hsv_on'][:, None, None, None], jit_x, x)
    if 'blur_taps' in params:
        x = gaussian_blur_u8(x, params['blur_taps'])
    if 'erase_on' in params:
        # the uint8 truncation of PIXEL_MEANS (the reference assigns float
        # means into a uint8 array)
        fill = torch.as_tensor(
            np.asarray(pixel_means).reshape(3).astype(np.uint8).astype(
                np.int32), device=x.device)
        rows = torch.arange(x.shape[1], device=x.device)[None, :]
        cols = torch.arange(x.shape[2], device=x.device)[None, :]
        er_x = params['er_x'] if off_w is None else params['er_x'] + off_w
        rmask = ((rows >= params['er_y'][:, None]) &
                 (rows < (params['er_y'] + params['er_h'])[:, None]))
        cmask = ((cols >= er_x[:, None]) &
                 (cols < (er_x + params['er_w'])[:, None]))
        mask = (params['erase_on'][:, None, None]
                & rmask[:, :, None] & cmask[:, None, :])
        x = torch.where(mask[..., None], fill, x)
    means = torch.as_tensor(np.asarray(pixel_means, np.float32).reshape(3),
                            device=x.device)
    xf = x.float() - means
    x0 = params['x0'] if off_w is None else params['x0'] + off_w
    return crop_resize_batch(xf, params['ch'], params['cw'], params['y0'],
                             x0, spec['out_hw'])


def augment_batch(generator, x_u8, flipped, spec, pixel_means, params=None,
                  valid_hw=None):
    """Draw (unless ``params`` is given) and apply in one call: the train
    step's entry point.  ``valid_hw`` [B, 2] selects the padded wire.
    Returns images [B, H', W', 3] float32."""
    if params is None:
        raw_hw = ((int(x_u8.shape[1]), int(x_u8.shape[2]))
                  if valid_hw is None else (valid_hw[:, 0], valid_hw[:, 1]))
        params = sample_params(generator, spec, x_u8.shape[0], raw_hw,
                               x_u8.device)
    return apply_augment(x_u8, flipped, params, spec, pixel_means,
                         valid_hw=valid_hw)
