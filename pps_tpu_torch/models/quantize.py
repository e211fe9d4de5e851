"""int8 post-training quantization of the serving body.

Counterpart of ``pps_tpu/models/quantize.py``.  The recipe:

1. fold BN into the convs (``models/folding.py``), so each body conv is
   ``y = conv(x, w') + fb``;
2. calibrate: run a few hundred test images through the folded eval graph
   and record the per-channel absmax of every body conv's input
   (``calibrate_amax``);
3. quantize: per-output-channel symmetric int8 weights
   (``s_w[o] = absmax(w'[o]) / 127``) and one static input scale per conv
   (``s_x = amax / 127``); the serving conv (``kernels/conv2d_int8.py``)
   quantizes its input inline, multiplies in int8 with int32 sums and
   dequantizes as ``acc * (s_x * s_w[o]) + fb``.

Only the conv body is quantized (conv1 and res2..res5); the FPN convs and
the head stay in float32.  GroupNorm bodies quantize too: GN is not
foldable, so the quantized conv carries ``fb = 0`` and GN runs on its
output; their inputs get per-input-channel scales, absorbed into the
weights before quantization (block-diagonally for grouped convs).

The scales are computed on the host in numpy with the JAX package's own
expressions (a Python-float division by 127, ``1 / s_x`` cast to
float32), so ``wq``, ``xinv`` and ``osc`` are bitwise pps_tpu's for the
same absmax.  They are not computed on the card, where a division by a
Python scalar is a product with its reciprocal.  The port's ``*_wq`` are
OHWI (the int8 kernel's layout); ``*_xinv`` is 0-d, or ``[C_in]`` for GN
bodies.
"""

import numpy as np
import torch

from pps_tpu_torch.models import resnet as resnet_lib
from pps_tpu_torch.models.folding import fold_conv_bn


def _is_body_conv(base, params, use_gn=False):
    w = params.get(base + '_w')
    if w is None or w.ndim != 4:
        return False
    if not (base == 'conv1' or base.startswith('res')):
        return False
    if use_gn:
        # GN is not foldable: the quantized conv carries fb = 0
        return (base + '_gn_s') in params
    return (base + '_fb') in params


@torch.no_grad()
def calibrate_amax(folded_params, state, spec, image_batches, device=None):
    """Per-conv input absmax over calibration batches.

    ``folded_params`` must be BN-folded, so the capture runs the eval
    graph the quantized model replaces; ``image_batches`` are [B, H, W, 3]
    preprocessed NHWC arrays.  Returns {conv base name: [C_in] float32
    numpy absmax}."""
    if device is None:
        device = next(iter(folded_params.values())).device
    amax = {}
    for x in image_batches:
        images = torch.as_tensor(np.asarray(x, np.float32), device=device)
        rec = {}
        resnet_lib.apply_resnet(folded_params, state,
                                images.permute(0, 3, 1, 2), spec,
                                calibrate=rec)
        for name, v in rec.items():
            v = v.cpu().numpy().astype(np.float32)
            amax[name] = np.maximum(amax.get(name, 0.0), v)
    return amax


def _hwio(w):
    """A port conv weight (OIHW tensor) as a float32 HWIO numpy array."""
    return w.detach().cpu().numpy().astype(np.float32).transpose(2, 3, 1, 0)


def quantize_body(folded_params, amax, use_gn=False):
    """Folded params -> int8-quantized body params.

    For every body conv ``base`` it replaces ``base_w`` with
      base_wq   int8 OHWI weights (per-output-channel symmetric)
      base_xinv float32 1 / input scale (0-d; [C_in] for GN bodies)
      base_osc  float32 [C_out] dequant factor
    and keeps ``base_fb`` (zeros for GN bodies).  Raises if a body conv has
    no calibration record."""
    q = dict(folded_params)
    n_quantized = 0
    for name in list(folded_params):
        if not name.endswith('_w'):
            continue
        base = name[:-2]
        if not _is_body_conv(base, folded_params, use_gn=use_gn):
            continue
        if base not in amax:
            raise KeyError(
                'no calibration record for body conv {!r}; run '
                'calibrate_amax over at least one batch first'.format(base))
        device = folded_params[name].device
        w = _hwio(folded_params[name])
        amax_c = np.atleast_1d(np.asarray(amax[base], np.float32))
        if use_gn:
            # per-input-channel scales folded into the weights:
            # w''[..., c, o] = w[..., c, o] * s_c, block-diagonal for a
            # grouped conv: factor[i, o] = s_c[(o // opg) * i_w + i]
            s_c = np.maximum(amax_c, 1e-12) / 127.0
            cin, i_w = s_c.size, w.shape[2]
            g = cin // i_w
            opg = w.shape[3] // g
            factor = np.repeat(s_c.reshape(g, i_w).T, opg, axis=1)
            w = w * factor[None, None]
            s_w = np.maximum(
                np.max(np.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
            wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
            xinv = (1.0 / s_c).astype(np.float32)
            osc = s_w.astype(np.float32)
        else:
            # BN-folded body: one static input scale
            s_x = max(float(amax_c.max()), 1e-12) / 127.0
            s_w = np.maximum(
                np.max(np.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
            wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
            xinv = np.float32(1.0 / s_x)
            osc = (s_w * s_x).astype(np.float32)
        q[base + '_wq'] = torch.tensor(
            np.ascontiguousarray(wq.transpose(3, 0, 1, 2)), device=device)
        q[base + '_xinv'] = torch.tensor(xinv, device=device)
        q[base + '_osc'] = torch.tensor(osc, device=device)
        if (base + '_fb') not in q:  # GN body: a bias-free quantized conv
            q[base + '_fb'] = torch.zeros(w.shape[-1], device=device)
        del q[name]
        n_quantized += 1
    assert n_quantized, 'no body convs found to quantize'
    return q


def quantize_for_eval(model, params, state, calib_images, batch_size=64):
    """One call: fold, calibrate and quantize the conv body.

    calib_images: [N, H, W, 3] preprocessed (mean-subtracted BGR) stack.
    Returns the quantized params, ready for ``model.extract_features``
    (the int8 path follows from the ``_wq`` keys)."""
    folded = fold_conv_bn(params, state)
    calib_images = np.asarray(calib_images)
    batches = [calib_images[i:i + batch_size]
               for i in range(0, len(calib_images), batch_size)]
    # the tail batch is the last batch_size images, as in the JAX package
    if len(batches) > 1 and len(batches[-1]) != batch_size:
        batches[-1] = calib_images[-batch_size:]
    use_gn = bool(model.resnet_spec.get('use_gn'))
    amax = calibrate_amax(folded, state, model.resnet_spec, batches,
                          device=model.device)
    return quantize_body(folded, amax, use_gn=use_gn)
