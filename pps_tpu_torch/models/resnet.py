"""ResNet-50/101/152 conv body in PyTorch (eval and train mode).

Counterpart of ``pps_tpu/models/resnet.py``.  Params live in a flat
``{name: tensor}`` dict under the reference's blob names (``conv1_w``,
``res2_0_branch2a_w``, ``res2_0_branch2a_bn_s`` ...), BN running stats
(``*_bn_rm`` / ``*_bn_riv``) in a separate ``state`` dict.  Differences
from the JAX layout:

* conv weights are OIHW (the reference pkl and torch layout), not HWIO;
  int8 weights (``*_wq``) are OHWI, the layout of the int8 kernel;
* activations run NCHW; on the card a map whose memory is NHWC is
  ``channels_last`` to cuDNN, so the NHWC input needs no transpose copy.

Numerics follow the JAX body exactly (``resnet.py:183-325``):

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

Body variants, as in the JAX package: ``MODEL.USE_GN`` (ConvGN: a
bias-free conv + GroupNorm, no running stats, the stem's norm named
``conv1_gn``), ``MODEL.USE_BN False`` (AffineChannel: ``y * s + b``, no
statistics), a BN-folded body (``*_fb`` biases from
``models/folding.py``, eval only) and the int8 body (``*_wq``/``*_xinv``/
``*_osc``/``*_fb`` from ``models/quantize.py``, eval only, through
``kernels/conv2d_int8.py``).  Int8 calibration records each conv input's
per-channel absmax into the ``calibrate`` dict of ``apply_resnet``.
"""

import math

import torch
import torch.nn.functional as F

from pps_tpu_torch.kernels.conv2d_int8 import conv2d_int8
from pps_tpu_torch.parallel import collectives

BN_EPSILON = 1e-5  # Caffe2 SpatialBN default epsilon
BN_MOMENTUM = 0.9  # Caffe2 SpatialBN default momentum

BLOCK_COUNTS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def resnet_spec(cfg, depth=50):
    """Static description of the conv body derived from cfg (the JAX
    ``resnet_spec``)."""
    n1, n2, n3, n4 = BLOCK_COUNTS[depth]
    res5_stride = cfg.RESNETS.RES5_STRIDE
    res5_dilation = cfg.RESNETS.RES5_DILATION
    width = cfg.RESNETS.NUM_GROUPS * cfg.RESNETS.WIDTH_PER_GROUP
    return {
        'depth': depth,
        'num_groups': cfg.RESNETS.NUM_GROUPS,
        'width_per_group': cfg.RESNETS.WIDTH_PER_GROUP,
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
        # GroupNorm body (MODEL.USE_GN); MODEL.USE_BN False ->
        # AffineChannel (y = x * s + b, no statistics), ignored under GN
        'use_gn': bool(cfg.MODEL.USE_GN),
        'use_affine': not bool(cfg.MODEL.USE_BN),
        'gn_dim_per_gp': cfg.GROUP_NORM.DIM_PER_GP,
        'gn_num_groups': cfg.GROUP_NORM.NUM_GROUPS,
        'gn_eps': cfg.GROUP_NORM.EPSILON,
    }


def get_group_gn(dim, dim_per_gp, num_groups):
    """Number of GroupNorm groups for ``dim`` channels (one of
    GROUP_NORM.DIM_PER_GP / NUM_GROUPS is -1)."""
    assert dim_per_gp == -1 or num_groups == -1, \
        'GroupNorm: can only specify G or C/G.'
    if dim_per_gp > 0:
        assert dim % dim_per_gp == 0
        return dim // dim_per_gp
    assert dim % num_groups == 0
    return num_groups


def _gn_groups(spec, dim):
    return get_group_gn(dim, spec['gn_dim_per_gp'], spec['gn_num_groups'])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _msra_fill(gen, shape, device):
    """He-normal fan_out init (Caffe2 MSRAFill) for an OIHW conv weight."""
    c_out, _, kh, kw = shape
    std = math.sqrt(2.0 / (kh * kw * c_out))
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return w.to(device)


def _init_norm(params, state, norm, c_out, device, kind):
    """The norm after a conv: 'bn' (SpatialBN: scale, bias, running
    stats), 'affine' (AffineChannel: scale and bias only) or 'gn'
    (GroupNorm: scale and bias; ``norm`` names its ``_gn`` prefix)."""
    params[norm + '_s'] = torch.ones(c_out, device=device)
    params[norm + '_b'] = torch.zeros(c_out, device=device)
    if kind == 'bn':
        state[norm + '_rm'] = torch.zeros(c_out, device=device)
        state[norm + '_riv'] = torch.ones(c_out, device=device)


def _norm_kind(spec):
    if spec.get('use_gn'):
        return 'gn'
    return 'affine' if spec.get('use_affine') else 'bn'


def _init_conv_bn(gen, params, state, name, kh, kw, c_in, c_out, device,
                  kind):
    params[name + '_w'] = _msra_fill(gen, (c_out, c_in, kh, kw), device)
    _init_norm(params, state, name + ('_gn' if kind == 'gn' else '_bn'),
               c_out, device, kind)


def init_resnet_params(gen, spec, device):
    """Randomly initialised (params, state) for the conv body.  ``gen`` is
    a CPU ``torch.Generator``; tensors are placed on ``device``."""
    kind = _norm_kind(spec)
    params, state = {}, {}
    # stem: conv1 7x7/2 + its norm, named res_conv1_bn (conv1_gn under GN)
    params['conv1_w'] = _msra_fill(gen, (64, 3, 7, 7), device)
    _init_norm(params, state, 'conv1_gn' if kind == 'gn' else 'res_conv1_bn',
               64, device, kind)
    dim_in = 64
    for (stage, n_blocks, dim_out, dim_inner, _s, _d) in spec['stages']:
        for i in range(n_blocks):
            prefix = '{}_{}'.format(stage, i)
            if i == 0 and dim_in != dim_out:
                _init_conv_bn(gen, params, state, prefix + '_branch1',
                              1, 1, dim_in, dim_out, device, kind)
            _init_conv_bn(gen, params, state, prefix + '_branch2a',
                          1, 1, dim_in, dim_inner, device, kind)
            _init_conv_bn(gen, params, state, prefix + '_branch2b',
                          3, 3, dim_inner // spec['num_groups'], dim_inner,
                          device, kind)
            _init_conv_bn(gen, params, state, prefix + '_branch2c',
                          1, 1, dim_inner, dim_out, device, kind)
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
    over ``dims`` (the JAX package's formula, autograd through both).

    Under an active data mesh (``parallel/collectives.data_parallel``) the
    statistics are those of the GLOBAL batch, as in pps_tpu's step: one
    differentiable all-reduce of ``[sum x, sum x^2, count]`` over the data
    group (a model group's ranks hold the same rows)."""
    if collectives.data_size() == 1:
        mean = torch.mean(xf, dim=dims)
        var = torch.clamp(torch.mean(xf * xf, dim=dims) - mean * mean,
                          min=0.0)
        return mean, var
    s1 = torch.sum(xf, dim=dims)
    s2 = torch.sum(xf * xf, dim=dims)
    m = s1.numel()
    count = xf.new_full((1,), float(xf.numel() // m))
    tot = collectives.all_reduce(torch.cat([s1.reshape(-1), s2.reshape(-1),
                                            count]))
    mean = (tot[:m] / tot[-1]).reshape(s1.shape)
    ex2 = (tot[m:2 * m] / tot[-1]).reshape(s1.shape)
    return mean, torch.clamp(ex2 - mean * mean, min=0.0)


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


def group_norm(x, s, b, groups, eps=1e-5):
    """GroupNorm over an NCHW map (the reference's SpatialGN): stats per
    (sample, group) in float32, no running state, cast back."""
    n, c, h, w = x.shape
    xg = x.float().reshape(n, groups, c // groups, h, w)
    mean = torch.mean(xg, dim=(2, 3, 4), keepdim=True)
    var = torch.mean(torch.square(xg - mean), dim=(2, 3, 4), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    y = xg.reshape(n, c, h, w) * s[None, :, None, None] + \
        b[None, :, None, None]
    return y.to(x.dtype)


def affine_channel(x, s, b):
    """AffineChannel ``x.f32 * s + b``, cast back (no statistics)."""
    y = x.float() * s[None, :, None, None] + b[None, :, None, None]
    return y.to(x.dtype)


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


def _gn(y, params, name, spec):
    """GroupNorm after conv ``name``."""
    return group_norm(y, params[name + '_gn_s'], params[name + '_gn_b'],
                      _gn_groups(spec, y.shape[1]), spec['gn_eps'])


def _norm(y, params, state, name, norm, spec, updates):
    """The norm after conv ``name`` (its BN/affine params under ``norm``):
    GroupNorm, a folded bias (eval), AffineChannel or SpatialBN, in the JAX
    package's order of precedence."""
    if spec.get('use_gn'):
        return _gn(y, params, name, spec)
    if updates is None and (name + '_fb') in params:
        # BN pre-folded into the conv (models/folding.py): the bias only,
        # added in the activation dtype
        return y + params[name + '_fb'].to(y.dtype)[None, :, None, None]
    if spec.get('use_affine'):
        return affine_channel(y, params[norm + '_s'], params[norm + '_b'])
    return _bn(y, params, state, norm, updates)


def _record_amax(calibrate, name, x):
    """int8 calibration: the per-channel absmax of conv ``name``'s input."""
    calibrate[name] = torch.amax(torch.abs(x.float()), dim=(0, 2, 3))


def _conv_int8(x, params, name, spec, stride=1, dilation=1, dtype=None,
               groups=1):
    """The int8 serving conv (BN folded into ``_wq``/``_osc``/``_fb``), then
    GroupNorm for GN bodies: GN is input-dependent, so their quantized conv
    carries fb = 0 and GN runs on its dequantized output."""
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    y = conv2d_int8(x, params[name + '_wq'], params[name + '_xinv'],
                    params[name + '_osc'], params[name + '_fb'],
                    stride=stride, dilation=dilation, groups=groups,
                    out_dtype=dtype)
    return _gn(y, params, name, spec) if spec.get('use_gn') else y


def _conv_bn(x, params, state, name, stride=1, dilation=1, dtype=None,
             groups=1, updates=None, spec=None, calibrate=None):
    spec = spec or {}
    if updates is None:
        if calibrate is not None:
            _record_amax(calibrate, name, x)
        if (name + '_wq') in params:
            return _conv_int8(x, params, name, spec, stride, dilation, dtype,
                              groups)
    y = conv2d(x, params[name + '_w'], stride=stride, dilation=dilation,
               dtype=dtype, groups=groups)
    return _norm(y, params, state, name, name + '_bn', spec, updates)


def bottleneck_block(x, params, state, prefix, stride, dilation, stride_1x1,
                     dtype=None, groups=1, updates=None, spec=None,
                     calibrate=None):
    """1x1 -> 3x3 -> 1x1 bottleneck; ``stride_1x1`` puts the stride on the
    first 1x1 conv, else on the 3x3.  ``updates``: see ``_bn``."""
    str1, str3 = (stride, 1) if stride_1x1 else (1, stride)
    kw = dict(dtype=dtype, updates=updates, spec=spec, calibrate=calibrate)
    shortcut = x
    if (prefix + '_branch1_w') in params or (prefix + '_branch1_wq') in params:
        shortcut = _conv_bn(x, params, state, prefix + '_branch1',
                            stride=stride, **kw)
    cur = _conv_bn(x, params, state, prefix + '_branch2a', stride=str1, **kw)
    cur = F.relu(cur)
    cur = _conv_bn(cur, params, state, prefix + '_branch2b', stride=str3,
                   dilation=dilation, groups=groups, **kw)
    cur = F.relu(cur)
    cur = _conv_bn(cur, params, state, prefix + '_branch2c', stride=1, **kw)
    return F.relu(cur + shortcut)


def max_pool_3x3_s2(x):
    """kernel 3, stride 2, pad 1 with -inf padding (Caffe2 pool1).
    ``F.max_pool2d`` pads with -inf, as the JAX ``reduce_window`` does."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def _stem(params, state, x, spec, dtype, updates, calibrate):
    if updates is None and calibrate is not None:
        _record_amax(calibrate, 'conv1', x)
    if updates is None and 'conv1_wq' in params:
        return _conv_int8(x, params, 'conv1', spec, stride=2, dtype=dtype)
    cur = conv2d(x, params['conv1_w'], stride=2, dtype=dtype)
    # the stem's norm is conv1_gn or res_conv1_bn (its folded bias conv1_fb)
    return _norm(cur, params, state, 'conv1', 'res_conv1_bn', spec, updates)


def apply_resnet(params, state, x, spec, train=False, return_stages=False,
                 calibrate=None):
    """Run the conv body.

    Args:
      params / state: flat dicts (see module docstring).
      x: [N, 3, H, W] float mean-subtracted BGR batch (NCHW; any memory
        format).
      train: batch-stat BN, running-stat updates and the FREEZE_AT
        detaches.
      return_stages: also return {res2..res5} intermediate maps.
      calibrate: eval only; a dict that receives each conv's input absmax
        per channel ({conv base name: [C_in] float32}).

    Returns:
      eval: the res5 NCHW map, or (res5, stages) with return_stages.
      train: (res5, updates), or (res5, stages, updates), where updates
        maps each ``*_bn_rm`` / ``*_bn_riv`` to its new value.
    """
    dtype = DTYPES[spec.get('dtype', 'float32')]
    updates = {} if train else None
    freeze_at = spec.get('freeze_at', 0) if train else 0
    cur = _stem(params, state, x, spec, dtype, updates, calibrate)
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
                groups=spec['num_groups'], updates=updates, spec=spec,
                calibrate=calibrate)
        # the reference freezes by a stop-gradient at the stage boundary
        if freeze_at == si + 2:
            cur = cur.detach()
        stages[stage] = cur
    if train:
        return (cur, stages, updates) if return_stages else (cur, updates)
    return (cur, stages) if return_stages else cur
