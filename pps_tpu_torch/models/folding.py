"""Inference-time BatchNorm folding.

Counterpart of ``pps_tpu/models/folding.py``.  At eval a SpatialBN is an
affine map with frozen statistics, so it folds into the conv before it:
``w' = w * s / sqrt(riv + eps)`` and ``fb = bn_b - rm * s / sqrt(riv +
eps)`` (plus the conv's own bias times the same factor, for the FPN
convs).  The folded dict adds a ``{conv}_fb`` bias per folded conv; the
eval paths of ``models/resnet.py`` and ``models/fpn.py`` see it and skip
the BN, so folded params run through the same apply functions.  This
removes the body's and the pyramid's written-out BN passes and the casts
around them from extraction.

The arithmetic is the JAX package's, tensor by tensor (a division by the
square root, not a product with rsqrt), so folded weights equal pps_tpu's
bit for bit after the layout transpose.  The square root is taken in
float64 and rounded to float32, which is the correctly rounded float32
root: torch's vectorised float32 ``sqrt`` on the CPU is not (measured an
ulp off numpy and XLA on some inputs).  The port's 4-d conv weights are
OIHW, so the factor broadcasts over dim 0; the 2-d FPN weights are
``[C_in, C_out]``, as in the JAX package, so it broadcasts over the last.
"""

import torch

from pps_tpu_torch.models.resnet import BN_EPSILON


def fold_conv_bn(params, state):
    """A new params dict with the body's and the FPN's conv + BN pairs
    folded (AffineChannel pairs too: ``w * s``, ``fb = b``)."""
    folded = dict(params)
    for name in list(params):
        if not name.endswith('_w'):
            continue
        base = name[:-2]
        # stem quirk: conv1_w pairs with res_conv1_bn (reference naming)
        bn = 'res_conv1_bn' if base == 'conv1' else base + '_bn'
        if bn + '_s' not in params:
            continue
        w = params[name]
        if w.ndim not in (2, 4):
            continue  # stacked head convs pair with differently-named BN
        if bn + '_rm' in state:
            var = state[bn + '_riv'] + BN_EPSILON
            inv = params[bn + '_s'] / torch.sqrt(var.double()).float()
        else:
            # AffineChannel (MODEL.USE_BN False): no statistics to absorb
            inv = params[bn + '_s']
        folded[name] = w * (inv[:, None, None, None] if w.ndim == 4 else inv)
        fb = params[bn + '_b']
        if bn + '_rm' in state:
            fb = fb - state[bn + '_rm'] * inv
        if base + '_b' in params:  # the FPN convs carry a conv bias too
            fb = fb + params[base + '_b'] * inv
        folded[base + '_fb'] = fb
    return folded
