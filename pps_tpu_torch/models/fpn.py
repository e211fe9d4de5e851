"""FPN for the "scale-free" multi-scale re-ID variant.

Counterpart of ``pps_tpu/models/fpn.py`` (the reference's re-ID fork of
FPN, ``FPN_reid.py``):

* coarsest level: a 1x1 conv + SpatialBN + ReLU on res5, or under
  ``FPN.USE_GN`` the reference's ConvGN (a bias-free 1x1 conv + GroupNorm,
  no ReLU); skipped when res5's width already is ``FPN.DIM``;
* each finer level: a lateral 1x1 conv + SpatialBN + ReLU (never GN) when
  the stage's width differs from ``FPN.DIM``, plus the previous level, 2x
  nearest-upsampled unless both are at 1/16 (res5 and res4 with
  ``RES5_STRIDE 1``);
* ``REID.FPN_NUM`` levels in {2, 3, 4}, coarse to fine.

The 1x1 convs run in float32 whatever the body's dtype (``einsum`` over
the map cast to float32, as the JAX package's
``preferred_element_type=f32``); TF32 stays off (``device.py``).  Their
weights are 2-d ``[C_in, C_out]``, the JAX package's layout; the pkl holds
them as OIHW ``[C_out, C_in, 1, 1]`` (``engine/checkpoint.py``).  Maps are
NCHW.  A BN-folded conv (``{name}_fb``, ``models/folding.py``) adds its
bias and skips the BN at eval.
"""

import math

import torch

from pps_tpu_torch.models import resnet as resnet_lib

# last block index per stage for each depth (reference FpnLevelInfo tables)
_LAST_BLOCK = {
    50: {'res2': 2, 'res3': 3, 'res4': 5, 'res5': 2},
    101: {'res2': 2, 'res3': 3, 'res4': 22, 'res5': 2},
    152: {'res2': 2, 'res3': 7, 'res4': 35, 'res5': 2},
}
_STAGE_DIMS = {'res5': 2048, 'res4': 1024, 'res3': 512, 'res2': 256}


def fpn_spec(cfg, depth=50):
    """Static FPN description: levels coarse -> fine."""
    if cfg.RESNETS.RES5_STRIDE != 1:
        raise ValueError('the re-ID FPN variant assumes RES5_STRIDE 1')
    fpn_num = cfg.REID.FPN_NUM
    if fpn_num not in (2, 3, 4):
        raise ValueError('REID.FPN_NUM must be 2, 3 or 4, not {}'.format(
            fpn_num))
    stages = ['res5', 'res4', 'res3', 'res2'][:fpn_num]
    use_gn = bool(cfg.FPN.USE_GN)
    gn_groups = 0
    if use_gn:
        from pps_tpu_torch.models.heads import _get_group_gn
        gn_groups = _get_group_gn(cfg, cfg.FPN.DIM)
    return {
        'fpn_dim': cfg.FPN.DIM,
        'stages': stages,
        'blobs': ['{}_{}_sum'.format(s, _LAST_BLOCK[depth][s])
                  for s in stages],
        'dims': [_STAGE_DIMS[s] for s in stages],
        'spatial_scales': [1. / 16., 1. / 16., 1. / 8., 1. / 4.][:fpn_num],
        'fpn_num': fpn_num,
        'zero_init_lateral': cfg.FPN.ZERO_INIT_LATERAL,
        # ConvGN on the coarsest 1x1 only; laterals always SpatialBN + ReLU
        'use_gn': use_gn,
        'gn_groups': gn_groups,
        'gn_eps': cfg.GROUP_NORM.EPSILON,
    }


def _xavier_conv(gen, c_in, c_out, device, zero=False):
    """Caffe2 XavierFill for a 1x1 conv: uniform(+-sqrt(3 / fan_in))."""
    if zero:
        return torch.zeros((c_in, c_out), device=device)
    lim = math.sqrt(3.0 / c_in)
    w = torch.rand((c_in, c_out), generator=gen) * (2 * lim) - lim
    return w.to(device)


def _add_conv_bn(gen, params, state, name, c_in, c_out, device, zero=False,
                 use_gn=False):
    params[name + '_w'] = _xavier_conv(gen, c_in, c_out, device, zero=zero)
    if use_gn:
        # ConvGN: a bias-free conv + GroupNorm params, no running stats
        params[name + '_gn_s'] = torch.ones(c_out, device=device)
        params[name + '_gn_b'] = torch.zeros(c_out, device=device)
        return
    params[name + '_b'] = torch.zeros(c_out, device=device)
    params[name + '_bn_s'] = torch.ones(c_out, device=device)
    params[name + '_bn_b'] = torch.zeros(c_out, device=device)
    state[name + '_bn_rm'] = torch.zeros(c_out, device=device)
    state[name + '_bn_riv'] = torch.ones(c_out, device=device)


def init_fpn_params(gen, spec, device):
    """Random (params, state) of the pyramid from a CPU generator."""
    params, state = {}, {}
    dim = spec['fpn_dim']
    if spec['dims'][0] != dim:
        _add_conv_bn(gen, params, state, 'fpn_inner_' + spec['blobs'][0],
                     spec['dims'][0], dim, device, use_gn=spec['use_gn'])
    for i in range(1, spec['fpn_num']):
        if spec['dims'][i] != dim:
            _add_conv_bn(gen, params, state,
                         'fpn_inner_' + spec['blobs'][i] + '_lateral',
                         spec['dims'][i], dim, device,
                         zero=spec['zero_init_lateral'])
    return params, state


def _conv1x1(params, name, x):
    """The float32 1x1 conv of an NCHW map with a [C_in, C_out] weight."""
    return torch.einsum('bchw,cd->bdhw', x.float(), params[name + '_w'])


def _conv1x1_bn_relu(params, state, updates, name, x):
    """1x1 conv + bias + SpatialBN + ReLU (eval when ``updates`` is None);
    a folded conv adds its bias and skips the BN."""
    y = _conv1x1(params, name, x)
    if updates is None and (name + '_fb') in params:
        return torch.relu(y + params[name + '_fb'][None, :, None, None])
    y = y + params[name + '_b'][None, :, None, None]
    return torch.relu(resnet_lib._bn(y, params, state, name + '_bn',
                                     updates))


def _conv1x1_gn(params, name, x, spec):
    """ConvGN: a bias-free 1x1 conv + GroupNorm, no ReLU."""
    return resnet_lib.group_norm(_conv1x1(params, name, x),
                                 params[name + '_gn_s'],
                                 params[name + '_gn_b'], spec['gn_groups'],
                                 spec['gn_eps'])


def _upsample2x(x):
    """Nearest-neighbour 2x of an NCHW map (C2 UpsampleNearest)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)


def apply_fpn(params, state, stage_feats, spec, train=False, levels=None):
    """stage_feats: {res2..res5: NCHW map} from ``apply_resnet``
    (``return_stages=True``).  Returns the pyramid, a list coarse -> fine
    of float32 [B, FPN.DIM, H_l, W_l] maps (the first ``levels`` only, when
    given: extraction reads the coarsest), and in train mode also the BN
    running-stat updates."""
    updates = {} if train else None
    dim = spec['fpn_dim']
    coarse_name = 'fpn_inner_' + spec['blobs'][0]
    coarse_in = stage_feats[spec['stages'][0]]
    if spec['dims'][0] == dim:
        out = [coarse_in.float()]  # pass-through: no conv at all
    elif spec['use_gn']:
        out = [_conv1x1_gn(params, coarse_name, coarse_in, spec)]
    else:
        out = [_conv1x1_bn_relu(params, state, updates, coarse_name,
                                coarse_in)]
    for i in range(1, spec['fpn_num'] if levels is None else levels):
        lateral_in = stage_feats[spec['stages'][i]]
        if spec['dims'][i] != dim:
            lat = _conv1x1_bn_relu(
                params, state, updates,
                'fpn_inner_' + spec['blobs'][i] + '_lateral', lateral_in)
        else:
            lat = lateral_in.float()
        td = out[i - 1]
        # res5 -> res4: both 1/16 under RES5_STRIDE 1, so no upsample
        if spec['spatial_scales'][i] != spec['spatial_scales'][i - 1]:
            td = _upsample2x(td)
        out.append(lat + td)
    return (out, updates) if train else out
