"""On-device training augmentation on the uint8 wire (counterpart of
``pps_tpu/data/device_augment.py``, uniform-size form).

The host ships raw uint8 decodes and a per-sample flip flag; on the
device, in the reference chain's order:

  flip -> random_crop -> horizontal_crop -> random_erasing
  -> float32 - PIXEL_MEANS -> cv2-exact bicubic resize to REID.SCALE

* A crop followed by a bicubic resize is a linear map, so both crops fuse
  into per-sample resize matrices built from the crop length and offset
  (the Keys weights of ``data/device_preprocess.py``), applied as two
  batched products.  With no crop they equal cv2's resize matrices.
* Parameters are drawn from an explicit ``torch.Generator`` on the
  device with the distributions of the JAX package's ``sample_params``;
  the streams differ, so the tests hand the JAX package's drawn params to
  ``apply_augment`` instead of comparing streams.
* random_erasing keeps the reference's accept-reject over 100 attempts,
  ``round`` half-to-even, and fills the uint8 truncation of PIXEL_MEANS.

Not ported: HSV jitter, Gaussian blur and the padded ``valid_hw`` wire
(ROADMAP slice 3).  They raise NotImplementedError.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pps_tpu_torch.data.device_preprocess import _CV2_A

_TODO = ('{} is not ported yet (ROADMAP slice 3: the rest of '
         'device_augment)')


def augment_spec(cfg):
    """Static dict of the REID.* augmentation knobs."""
    r = cfg.REID
    return {
        'crop_prob': float(r.CROP_PROB),
        'crop_ratio': float(r.CROP_RATIO),
        'hcrop_prob': float(r.HORIZONTAL_CROP_PROB),
        'hcrop_ratio': float(r.HORIZONTAL_CROP_RATIO),
        'hsv_prob': float(r.HSV_JITTER_PROB),
        'blur_prob': float(r.GAUSSIAN_BLUR_PROB),
        'erase_prob': float(r.RANDOM_ERASING_PROB),
        'sl': float(r.SL), 'sh': float(r.SH), 'r1': float(r.R1),
        'out_hw': (int(r.SCALE[1]), int(r.SCALE[0])),  # (H', W')
    }


def _check_spec(spec):
    if spec.get('hsv_prob', 0.0) > 0:
        raise NotImplementedError(_TODO.format('HSV jitter'))
    if spec.get('blur_prob', 0.0) > 0:
        raise NotImplementedError(_TODO.format('Gaussian blur'))


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
    src = (o + 0.5) * (cl / out_size) - 0.5
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

    raw_hw: the (H, W) every sample shares.  Returns a dict of [B]
    tensors: ch, cw, y0, x0 (the crop window) and, when erasing is on,
    erase_on, er_y, er_x, er_h, er_w (full-image coordinates).
    """
    _check_spec(spec)
    if not all(isinstance(v, (int, np.integer)) for v in raw_hw):
        raise NotImplementedError(_TODO.format('the padded valid_hw wire'))
    in_h, in_w = raw_hw
    g, dev = generator, device
    i32 = dict(dtype=torch.int32, device=dev)
    ch = torch.full((batch,), in_h, **i32)
    cw = torch.full((batch,), in_w, **i32)
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


def apply_augment(x_u8, flipped, params, spec, pixel_means):
    """uint8 [B, H, W, 3] + drawn params -> float32 [B, H', W', 3].

    flipped: [B] bool (or None): mirror those samples first.  The uint8
    stages (flip, erasing) are exact integer work; the float32 stage is
    the mean subtraction and the crop-resize products."""
    for key in ('hsv_on', 'blur_taps'):
        if key in params:
            raise NotImplementedError(_TODO.format(key))
    x = x_u8.int()
    if flipped is not None:
        x = torch.where(flipped[:, None, None, None], torch.flip(x, (2,)), x)
    if 'erase_on' in params:
        # the uint8 truncation of PIXEL_MEANS (the reference assigns float
        # means into a uint8 array)
        fill = torch.as_tensor(
            np.asarray(pixel_means).reshape(3).astype(np.uint8).astype(
                np.int32), device=x.device)
        rows = torch.arange(x.shape[1], device=x.device)[None, :]
        cols = torch.arange(x.shape[2], device=x.device)[None, :]
        rmask = ((rows >= params['er_y'][:, None]) &
                 (rows < (params['er_y'] + params['er_h'])[:, None]))
        cmask = ((cols >= params['er_x'][:, None]) &
                 (cols < (params['er_x'] + params['er_w'])[:, None]))
        mask = (params['erase_on'][:, None, None]
                & rmask[:, :, None] & cmask[:, None, :])
        x = torch.where(mask[..., None], fill, x)
    means = torch.as_tensor(np.asarray(pixel_means, np.float32).reshape(3),
                            device=x.device)
    xf = x.float() - means
    return crop_resize_batch(xf, params['ch'], params['cw'], params['y0'],
                             params['x0'], spec['out_hw'])


def augment_batch(generator, x_u8, flipped, spec, pixel_means, params=None):
    """Draw (unless ``params`` is given) and apply in one call: the train
    step's entry point.  Returns images [B, H', W', 3] float32."""
    if params is None:
        params = sample_params(generator, spec, x_u8.shape[0],
                               (int(x_u8.shape[1]), int(x_u8.shape[2])),
                               x_u8.device)
    return apply_augment(x_u8, flipped, params, spec, pixel_means)
