"""ResNet-50/101/152 conv body in PyTorch (eval and train mode).

Counterpart of ``pps_tpu/models/resnet.py``.  Params live in a flat
``{name: tensor}`` dict under the reference's blob names (``conv1_w``,
``res2_0_branch2a_w``, ``res2_0_branch2a_bn_s`` ...), BN running stats
(``*_bn_rm`` / ``*_bn_riv``) in a separate ``state`` dict.  Differences
from the JAX layout:

* conv weights are OIHW (the reference pkl and torch layout), not HWIO;
* activations run NCHW; on the card a map whose memory is NHWC is
  ``channels_last`` to cuDNN, so the NHWC input needs no transpose copy.

Numerics follow the JAX body exactly (``resnet.py:183-259``):

* padding is symmetric ``((k-1)*d)//2`` per side, not torch's 'same', so
  the stride-2 stem and ``branch1`` match Caffe2;
* with a bfloat16 body each conv casts input and weight to bfloat16, BN
  computes ``(x.f32 - rm) * (rsqrt(riv + 1e-5) * s) + b`` in float32 and
  casts back, ReLU and the residual add run in bfloat16;
* max-pool pads with -inf;
* train-mode BN takes the batch stats by hand in float32, the *biased*
  variance ``max(E[x^2] - mean^2, 0)``, and returns running-stat updates
  ``0.9 * old + 0.1 * new`` (Caffe2 momentum 0.9).  ``F.batch_norm`` with
  ``training=True`` updates with the unbiased variance, so it is not used;
* ``TRAIN.FREEZE_AT`` detaches the map at the stage boundary.

Not ported: GroupNorm / AffineChannel bodies, BN-folded (``_fb``) and
int8 (``_wq``) bodies.  They raise NotImplementedError naming the ROADMAP
slice that ports them.
"""

import math

import torch
import torch.nn.functional as F

BN_EPSILON = 1e-5  # Caffe2 SpatialBN default epsilon
BN_MOMENTUM = 0.9  # Caffe2 SpatialBN default momentum

_VARIANT_TODO = ('{} bodies are not ported yet (ROADMAP slice 6: the '
                 'variants)')

BLOCK_COUNTS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def resnet_spec(cfg, depth=50):
    """Static description of the conv body derived from cfg: the JAX
    ``resnet_spec`` less the keys only the GN body reads."""
    n1, n2, n3, n4 = BLOCK_COUNTS[depth]
    res5_stride = cfg.RESNETS.RES5_STRIDE
    res5_dilation = cfg.RESNETS.RES5_DILATION
    width = cfg.RESNETS.NUM_GROUPS * cfg.RESNETS.WIDTH_PER_GROUP
    return {
        'depth': depth,
        'num_groups': cfg.RESNETS.NUM_GROUPS,
        'stride_1x1': cfg.RESNETS.STRIDE_1X1,
        'stages': [
            # (name, n_blocks, dim_out, dim_inner, stride, dilation)
            ('res2', n1, 256, width, 1, 1),
            ('res3', n2, 512, width * 2, 2, 1),
            ('res4', n3, 1024, width * 4, 2, 1),
            ('res5', n4, 2048, width * 8, res5_stride, res5_dilation),
        ],
        'spatial_scale': 1.0 / (4 * 1 * 2 * 2 * res5_stride) * res5_dilation,
        'dim_out': 2048,
        'freeze_at': cfg.TRAIN.FREEZE_AT,
        'dtype': cfg.MODEL.DTYPE,
        'use_gn': bool(cfg.MODEL.USE_GN),
        'use_affine': not bool(cfg.MODEL.USE_BN),
    }


def check_spec(spec):
    """Raise for body variants this slice does not port."""
    if spec['use_gn']:
        raise NotImplementedError(_VARIANT_TODO.format('GroupNorm'))
    if spec['use_affine']:
        raise NotImplementedError(_VARIANT_TODO.format('AffineChannel'))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _msra_fill(gen, shape, device):
    """He-normal fan_out init (Caffe2 MSRAFill) for an OIHW conv weight."""
    c_out, _, kh, kw = shape
    std = math.sqrt(2.0 / (kh * kw * c_out))
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return w.to(device)


def _init_bn(params, state, bn, c_out, device):
    params[bn + '_s'] = torch.ones(c_out, device=device)
    params[bn + '_b'] = torch.zeros(c_out, device=device)
    state[bn + '_rm'] = torch.zeros(c_out, device=device)
    state[bn + '_riv'] = torch.ones(c_out, device=device)


def _init_conv_bn(gen, params, state, name, kh, kw, c_in, c_out, device):
    params[name + '_w'] = _msra_fill(gen, (c_out, c_in, kh, kw), device)
    _init_bn(params, state, name + '_bn', c_out, device)


def init_resnet_params(gen, spec, device):
    """Randomly initialised (params, state) for the conv body.  ``gen`` is
    a CPU ``torch.Generator``; tensors are placed on ``device``."""
    check_spec(spec)
    params, state = {}, {}
    # stem: conv1 7x7/2 + bn, the bn named res_conv1_bn (reference naming)
    params['conv1_w'] = _msra_fill(gen, (64, 3, 7, 7), device)
    _init_bn(params, state, 'res_conv1_bn', 64, device)
    dim_in = 64
    for (stage, n_blocks, dim_out, dim_inner, _s, _d) in spec['stages']:
        for i in range(n_blocks):
            prefix = '{}_{}'.format(stage, i)
            if i == 0 and dim_in != dim_out:
                _init_conv_bn(gen, params, state, prefix + '_branch1',
                              1, 1, dim_in, dim_out, device)
            _init_conv_bn(gen, params, state, prefix + '_branch2a',
                          1, 1, dim_in, dim_inner, device)
            _init_conv_bn(gen, params, state, prefix + '_branch2b',
                          3, 3, dim_inner // spec['num_groups'], dim_inner,
                          device)
            _init_conv_bn(gen, params, state, prefix + '_branch2c',
                          1, 1, dim_inner, dim_out, device)
            dim_in = dim_out
    return params, state


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def conv2d(x, w, stride=1, dilation=1, dtype=None, groups=1):
    """NCHW conv with the JAX body's ``SAME_LOWER`` padding: symmetric
    ``((k-1)*d)//2`` per side.  ``w`` is OIHW.  With ``dtype`` bfloat16,
    input and weight are cast first."""
    kh, kw = w.shape[2], w.shape[3]
    ph = ((kh - 1) * dilation) // 2
    pw = ((kw - 1) * dilation) // 2
    if dtype is not None and dtype != torch.float32:
        x = x.to(dtype)
        w = w.to(dtype)
    if x.is_cuda:
        w = w.contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, padding=(ph, pw),
                    dilation=dilation, groups=groups)


def batch_norm(x, s, b, rm, riv):
    """Eval-mode SpatialBN on an NCHW map with the JAX op order:
    ``(x.f32 - rm) * (rsqrt(riv + eps) * s) + b`` in float32, cast back to
    the input dtype."""
    inv = (torch.rsqrt(riv + BN_EPSILON) * s)[None, :, None, None]
    y = (x.float() - rm[None, :, None, None]) * inv + b[None, :, None, None]
    return y.to(x.dtype)


def batch_stats(xf, dims):
    """Float32 batch mean and biased variance ``max(E[x^2] - mean^2, 0)``
    over ``dims`` (the JAX package's formula, autograd through both)."""
    mean = torch.mean(xf, dim=dims)
    var = torch.clamp(torch.mean(xf * xf, dim=dims) - mean * mean, min=0.0)
    return mean, var


def running_update(old, new):
    """Caffe2 running-stat update at momentum 0.9 (no gradient)."""
    return BN_MOMENTUM * old + (1.0 - BN_MOMENTUM) * new.detach()


def batch_norm_train(x, s, b, rm, riv):
    """Train-mode SpatialBN on an NCHW map: batch stats over (N, H, W) in
    float32, the eval op order on them, cast back to the input dtype.
    Returns (y, (new_rm, new_riv))."""
    xf = x.float()
    mean, var = batch_stats(xf, (0, 2, 3))
    inv = (torch.rsqrt(var + BN_EPSILON) * s)[None, :, None, None]
    y = (xf - mean[None, :, None, None]) * inv + b[None, :, None, None]
    return y.to(x.dtype), (running_update(rm, mean),
                           running_update(riv, var))


def _bn(x, params, state, name, updates):
    """SpatialBN ``name`` (eval when ``updates`` is None, else train mode
    with the new running stats written into ``updates``)."""
    args = (x, params[name + '_s'], params[name + '_b'], state[name + '_rm'],
            state[name + '_riv'])
    if updates is None:
        return batch_norm(*args)
    y, (updates[name + '_rm'], updates[name + '_riv']) = \
        batch_norm_train(*args)
    return y


def _conv_bn(x, params, state, name, stride=1, dilation=1, dtype=None,
             groups=1, updates=None):
    if (name + '_wq') in params:
        raise NotImplementedError(_VARIANT_TODO.format('int8 (_wq)'))
    if (name + '_fb') in params:
        raise NotImplementedError(_VARIANT_TODO.format('BN-folded (_fb)'))
    y = conv2d(x, params[name + '_w'], stride=stride, dilation=dilation,
               dtype=dtype, groups=groups)
    return _bn(y, params, state, name + '_bn', updates)


def bottleneck_block(x, params, state, prefix, stride, dilation, stride_1x1,
                     dtype=None, groups=1, updates=None):
    """1x1 -> 3x3 -> 1x1 bottleneck; ``stride_1x1`` puts the stride on the
    first 1x1 conv, else on the 3x3.  ``updates``: see ``_bn``."""
    str1, str3 = (stride, 1) if stride_1x1 else (1, stride)
    shortcut = x
    if (prefix + '_branch1_w') in params:
        shortcut = _conv_bn(x, params, state, prefix + '_branch1',
                            stride=stride, dtype=dtype, updates=updates)
    cur = _conv_bn(x, params, state, prefix + '_branch2a', stride=str1,
                   dtype=dtype, updates=updates)
    cur = F.relu(cur)
    cur = _conv_bn(cur, params, state, prefix + '_branch2b', stride=str3,
                   dilation=dilation, dtype=dtype, groups=groups,
                   updates=updates)
    cur = F.relu(cur)
    cur = _conv_bn(cur, params, state, prefix + '_branch2c', stride=1,
                   dtype=dtype, updates=updates)
    return F.relu(cur + shortcut)


def max_pool_3x3_s2(x):
    """kernel 3, stride 2, pad 1 with -inf padding (Caffe2 pool1).
    ``F.max_pool2d`` pads with -inf, as the JAX ``reduce_window`` does."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def apply_resnet(params, state, x, spec, train=False, return_stages=False):
    """Run the conv body.

    Args:
      params / state: flat dicts (see module docstring).
      x: [N, 3, H, W] float mean-subtracted BGR batch (NCHW; any memory
        format).
      train: batch-stat BN, running-stat updates and the FREEZE_AT
        detaches.
      return_stages: also return {res2..res5} intermediate maps.

    Returns:
      eval: the res5 NCHW map, or (res5, stages) with return_stages.
      train: (res5, updates), or (res5, stages, updates), where updates
        maps each ``*_bn_rm`` / ``*_bn_riv`` to its new value.
    """
    check_spec(spec)
    if 'conv1_wq' in params or 'conv1_fb' in params:
        raise NotImplementedError(_VARIANT_TODO.format('int8 / BN-folded'))
    dtype = DTYPES[spec.get('dtype', 'float32')]
    updates = {} if train else None
    freeze_at = spec.get('freeze_at', 0) if train else 0
    cur = conv2d(x, params['conv1_w'], stride=2, dtype=dtype)
    cur = _bn(cur, params, state, 'res_conv1_bn', updates)
    cur = F.relu(cur)
    cur = max_pool_3x3_s2(cur)
    if freeze_at == 1:
        cur = cur.detach()
    stages = {}
    for si, (stage, n_blocks, _dim_out, _dim_inner, stride,
             dilation) in enumerate(spec['stages']):
        for i in range(n_blocks):
            cur = bottleneck_block(
                cur, params, state, '{}_{}'.format(stage, i),
                stride=stride if i == 0 else 1, dilation=dilation,
                stride_1x1=spec['stride_1x1'], dtype=dtype,
                groups=spec['num_groups'], updates=updates)
        # the reference freezes by a stop-gradient at the stage boundary
        if freeze_at == si + 2:
            cur = cur.detach()
        stages[stage] = cur
    if train:
        return (cur, stages, updates) if return_stages else (cur, updates)
    return (cur, stages) if return_stages else cur
