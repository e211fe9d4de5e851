"""Analytic forward-FLOP accounting (counterpart of
``pps_tpu/utils/flops.py``).

Counts conv/FC multiply-adds x2 from the static cfg-derived specs; BN,
pooling and elementwise work are left out (they are not matrix-unit
work).  ``chip_smoke.py`` and the measurement tools divide these counts
by measured times for TFLOP/s and MFU, against the peaks below.
"""

from pps_tpu_torch.models import heads as head_lib
from pps_tpu_torch.models import resnet as resnet_lib
from pps_tpu_torch.models.model import _depth_from_name

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
BF16_PEAK_FLOPS = 989e12   # bf16 tensor-core FLOP/s: the MFU yardstick
INT8_PEAK_OPS = 1979e12    # int8 tensor-core OP/s
HBM_BYTES_PER_S = 3.35e12  # device memory rate


def _conv_flops(h, w, kh, kw, c_in, c_out, stride=1, groups=1):
    ho, wo = -(-h // stride), -(-w // stride)
    return 2 * ho * wo * kh * kw * (c_in // groups) * c_out, ho, wo


def resnet_fwd_flops(spec, h, w):
    """Forward FLOPs per image of the conv body, and its output size."""
    total, h, w = _conv_flops(h, w, 7, 7, 3, 64, stride=2)
    h, w = -(-h // 2), -(-w // 2)  # 3x3/2 max pool
    dim_in = 64
    groups = spec['num_groups']
    for (_stage, n_blocks, dim_out, dim_inner, stride, _dil) in spec['stages']:
        for i in range(n_blocks):
            s = stride if i == 0 else 1
            s1, s3 = (s, 1) if spec['stride_1x1'] else (1, s)
            if i == 0 and dim_in != dim_out:
                f, _, _ = _conv_flops(h, w, 1, 1, dim_in, dim_out, stride=s)
                total += f
            f, h1, w1 = _conv_flops(h, w, 1, 1, dim_in, dim_inner, stride=s1)
            total += f
            f, h1, w1 = _conv_flops(h1, w1, 3, 3, dim_inner, dim_inner,
                                    stride=s3, groups=groups)
            total += f
            f, _, _ = _conv_flops(h1, w1, 1, 1, dim_inner, dim_out)
            total += f
            h, w = h1, w1
            dim_in = dim_out
    return total, h, w


def model_fwd_flops(cfg):
    """Forward FLOPs per image of the whole model: the body, the FPN's
    coarsest-level terms when FPN_ON (the JAX package's accounting: a
    1x1 and a 3x3 conv of FPN.DIM at the res5 map), the stacked per-combo
    head (dim_in -> D) and the classifiers (D -> NUM_CLASSES)."""
    rspec = resnet_lib.resnet_spec(cfg, _depth_from_name(cfg.MODEL.CONV_BODY))
    w_in, h_in = cfg.REID.SCALE
    total, h, w = resnet_fwd_flops(rspec, h_in, w_in)
    dim_in = rspec['dim_out']
    if cfg.FPN.FPN_ON:
        fd = cfg.FPN.DIM
        total += 2 * h * w * dim_in * fd + 2 * h * w * 9 * fd * fd
        dim_in = fd
    hspec = head_lib.head_spec(cfg, rspec['spatial_scale'])
    r, d = len(hspec['combos']), hspec['bpm_dim']
    total += 2 * r * (dim_in * d + d * cfg.MODEL.NUM_CLASSES)
    return total
