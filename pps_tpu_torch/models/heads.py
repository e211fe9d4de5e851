"""Part heads: strip splits, power-set combos, strip pooling, the stacked
per-combo embedding head (eval and train mode), CRM and the test
embedding.

Counterpart of ``pps_tpu/models/heads.py``.  Every combination is an index
of a stacked ``[R, ...]`` axis and the per-combo 1x1 convs and FCs are one
batched product each (``torch.bmm`` in float32).  Combination order is the
reference's bitmask enumeration, so the 3968-d embedding layout is the
same as the JAX package's.

Train mode: the head BN takes batch stats over axis 0 per combo (biased
variance, as in the body), dropout draws its keep-mask from an explicit
``torch.Generator`` unless the caller hands one in (the tests inject the
JAX package's mask).  Under ``MODEL.USE_GN`` the head is the reference's
ConvGN: GroupNorm over D per (sample, combo), no running stats
(``{p}_gn_s`` / ``{p}_gn_b``).  ``MODEL.USE_BN`` does not reach the head:
without GN it always carries real BN, as in the JAX package.
"""

import math

import numpy as np
import torch

from pps_tpu_torch.models.resnet import (BN_EPSILON, batch_stats,
                                         get_group_gn, running_update)
from pps_tpu_torch.parallel import collectives

DROPOUT = 0.2  # reference reid_heads.py:81-90 (REID.DROPOUT_FEATURE)


# ---------------------------------------------------------------------------
# Static head specification
# ---------------------------------------------------------------------------


def strip_splits(strip_num, scale_h, spatial_scale):
    """Per-strip row counts for the feature map: the reference's uneven
    tables at input height 384, else uniform ``int(H_feat / strip_num)``."""
    tables = {7: [3, 3, 4, 4, 4, 3, 3],
              5: [5, 5, 4, 5, 5],
              9: [2, 3, 3, 3, 3, 3, 3, 2, 2],
              10: [2, 2, 2, 3, 3, 3, 3, 2, 2, 2]}
    if strip_num in tables and scale_h == 16 * 24:
        scale = 16 * spatial_scale
        return [int(s * scale) for s in tables[strip_num]]
    strip_h = int(scale_h * spatial_scale / strip_num)
    return [strip_h for _ in range(strip_num)]


def powerset_combos(strip_num, preprefix='pps'):
    """All non-empty strip subsets in bitmask order: index i in
    1..2^n-1, bit j set => strip j."""
    combos = []
    for i in range(1, 1 << strip_num):
        members = tuple(j for j in range(strip_num) if i & (1 << j))
        prefix = preprefix + ''.join(str(c) for c in members)
        combos.append((prefix, members))
    return combos


def bpm_combos(strip_num, preprefix='bpm'):
    """One single-strip 'combination' per strip."""
    return [(preprefix + str(i), (i,)) for i in range(strip_num)]


def youtu_combos(strip_num, preprefix='youtu'):
    """All contiguous strip windows, coarse-to-fine: for level s = n..1 the
    window covers n-s+1 strips at each of s positions."""
    combos = []
    for s in range(strip_num, 0, -1):
        k = strip_num - s + 1
        for i in range(s):
            combos.append((preprefix + str(s) + str(i),
                           tuple(range(i, i + k))))
    return combos


def head_spec(cfg, spatial_scale, fpn_level=None):
    """Static head description from cfg (the JAX ``head_spec``)."""
    name = cfg.FAST_RCNN.ROI_BOX_HEAD
    strip_num = cfg.REID.BPM_STRIP_NUM
    scale_h = cfg.REID.SCALE[1]
    level_tag = '' if fpn_level is None else '_{}_'.format(fpn_level)

    if 'pps' in name:
        kind = 'pps'
        combos = powerset_combos(strip_num, 'pps' + level_tag)
        mode = 'mean_max' if cfg.REID.MAX_AVE_FEATURE else 'max'
    elif 'youtu' in name:
        kind = 'youtu'
        combos = youtu_combos(strip_num, 'youtu' + level_tag)
        mode = 'mean_max'
    elif 'bpm' in name or 'uniform' in name:
        kind = 'bpm'
        combos = bpm_combos(strip_num, 'bpm' + level_tag)
        mode = 'mean_max' if cfg.REID.MAX_AVE_FEATURE else 'ave'
    else:
        raise ValueError('Unknown ROI_BOX_HEAD: {}'.format(name))

    return {
        'kind': kind,
        'strip_num': strip_num,
        'splits': strip_splits(strip_num, scale_h, spatial_scale),
        'combos': combos,
        'mode': mode,
        'bpm_dim': cfg.REID.BPM_DIM,
        'num_logits': cfg.MODEL.NUM_CLASSES - 1,
        'dropout': DROPOUT if cfg.REID.DROPOUT_FEATURE else 0.0,
        'use_gn': cfg.MODEL.USE_GN,
        'gn_groups': (_get_group_gn(cfg, cfg.REID.BPM_DIM)
                      if cfg.MODEL.USE_GN else 0),
        'gn_eps': cfg.GROUP_NORM.EPSILON,
    }


def _get_group_gn(cfg, dim):
    """GroupNorm groups for ``dim`` channels under cfg.GROUP_NORM."""
    return get_group_gn(dim, cfg.GROUP_NORM.DIM_PER_GP,
                        cfg.GROUP_NORM.NUM_GROUPS)


def combo_masks(spec):
    """[R, n] float32 numpy mask of strip membership per combination."""
    m = np.zeros((len(spec['combos']), spec['strip_num']), dtype=np.float32)
    for r, (_, members) in enumerate(spec['combos']):
        for j in members:
            m[r, j] = 1.0
    return m


# ---------------------------------------------------------------------------
# Strip pooling + combination features
# ---------------------------------------------------------------------------


def strip_pools(feat, splits):
    """Split an NCHW map [B, C, H, W] into strips along H; global ave and
    max pool each.  Returns (ave, mx), both [B, n, C]."""
    aves, maxs = [], []
    start = 0
    for rows in splits:
        s = feat[:, :, start:start + rows]
        aves.append(s.mean(dim=(2, 3)))
        maxs.append(s.amax(dim=(2, 3)))
        start += rows
    return torch.stack(aves, dim=1), torch.stack(maxs, dim=1)


def combine_strips(ave, mx, masks, mode):
    """Per-combination features [B, R, C] from per-strip pools [B, n, C].

    mode 'mean_max': mean of member aves + max of member maxes
    mode 'max':      max of member ave-pools
    mode 'ave':      mean of member ave-pools
    The masked max fills non-members with finfo(float32).min, not -inf.
    """
    fill = torch.finfo(ave.dtype).min
    counts = masks.sum(dim=1)  # [R]
    mean_of_ave = torch.einsum('rn,bnc->brc', masks, ave) / \
        counts[None, :, None]
    member = masks[None, :, :, None] > 0
    if mode == 'mean_max':
        masked_max = torch.where(member, mx[:, None], fill).amax(dim=2)
        return mean_of_ave + masked_max
    if mode == 'max':
        return torch.where(member, ave[:, None], fill).amax(dim=2)
    if mode == 'ave':
        return mean_of_ave
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Re-ID embedding head (per-combo 1x1 conv + BN + ReLU + FC), eval mode
# ---------------------------------------------------------------------------


def init_head_params(gen, spec, dim_in, device, param_prefix='reid'):
    """Stacked head params and BN state: ``{p}_conv_w [R, C, D]`` (MSRA
    fan-out), ``{p}_conv_b [R, D]``, ``{p}_bn_s/_b [R, D]`` with running
    stats (``{p}_gn_s/_b`` and no state under GN), ``{p}_fc_w [R, D, K]``
    (gauss 0.001), ``{p}_fc_b [R, K]``."""
    r, d, k = len(spec['combos']), spec['bpm_dim'], spec['num_logits']
    p = param_prefix
    conv_w = torch.randn((r, dim_in, d), generator=gen) * math.sqrt(2.0 / d)
    fc_w = torch.randn((r, d, k), generator=gen) * 0.001
    norm = p + ('_gn' if spec.get('use_gn') else '_bn')
    params = {
        p + '_conv_w': conv_w.to(device),
        p + '_conv_b': torch.zeros((r, d), device=device),
        norm + '_s': torch.ones((r, d), device=device),
        norm + '_b': torch.zeros((r, d), device=device),
        p + '_fc_w': fc_w.to(device),
        p + '_fc_b': torch.zeros((r, k), device=device),
    }
    state = {}
    if not spec.get('use_gn'):
        state = {p + '_bn_rm': torch.zeros((r, d), device=device),
                 p + '_bn_riv': torch.ones((r, d), device=device)}
    return params, state


def init_crm_params(gen, spec, device, param_prefix='crm'):
    """crm_fc8c / crm_fc8d: [D, K] Xavier-uniform + zero bias (CRM runs
    only in training; ``apply_crm``)."""
    d, k = spec['bpm_dim'], spec['num_logits']
    lim = math.sqrt(3.0 / d)
    out = {}
    for name in ('fc8c', 'fc8d'):
        w = torch.rand((d, k), generator=gen) * (2 * lim) - lim
        out['{}_{}_w'.format(param_prefix, name)] = w.to(device)
        out['{}_{}_b'.format(param_prefix, name)] = torch.zeros(
            k, device=device)
    return out


def apply_head(params, state, combo_feats, spec, train=False,
               param_prefix='reid', dropout_mask=None, generator=None):
    """Stacked embedding head.

    Args:
      combo_feats: [B, R, C] float32 combination features.
      train: batch-stat BN with running-stat updates, then dropout (rate
        ``spec['dropout']``) before the classifier.
      dropout_mask: optional [B, R, D] bool keep-mask; else it is drawn
        from ``generator`` (keep with probability 1 - rate).
    The FC runs on whatever class slice ``{p}_fc_w`` holds: under a model
    axis, this rank's [R, D, K/m], and the logits are that slice.
    Returns:
      eval: (features [B, R, D] post-ReLU, logits [B, R, K]);
      train: (features, logits, updates) with the new ``{p}_bn_rm/_riv``.
      The features are pre-dropout in both.
    """
    p = param_prefix
    x = torch.bmm(combo_feats.transpose(0, 1), params[p + '_conv_w'])
    x = x.transpose(0, 1) + params[p + '_conv_b'][None]
    updates = {}
    if spec.get('use_gn'):
        # GroupNorm over D per (sample, combo): no batch statistics
        bsz, r, d = x.shape
        xg = x.reshape(bsz, r, spec['gn_groups'], d // spec['gn_groups'])
        mean = torch.mean(xg, dim=3, keepdim=True)
        var = torch.mean(torch.square(xg - mean), dim=3, keepdim=True)
        x = ((xg - mean) * torch.rsqrt(var + spec['gn_eps'])).reshape(
            bsz, r, d)
        x = x * params[p + '_gn_s'][None] + params[p + '_gn_b'][None]
    else:
        # SpatialBN on [B, D, 1, 1] per combo: batch stats over axis 0
        if train:
            mean, var = batch_stats(x, (0,))
            updates = {
                p + '_bn_rm': running_update(state[p + '_bn_rm'], mean),
                p + '_bn_riv': running_update(state[p + '_bn_riv'], var)}
        else:
            mean, var = state[p + '_bn_rm'], state[p + '_bn_riv']
        x = (x - mean) * (torch.rsqrt(var + BN_EPSILON) *
                          params[p + '_bn_s']) + params[p + '_bn_b']
    features = torch.relu(x)
    fc_in = features
    if train and spec['dropout'] > 0.0:
        keep = 1.0 - spec['dropout']
        if dropout_mask is None:
            if generator is None:
                raise ValueError(
                    'dropout needs a generator or a mask in train mode')
            # the draw jax.random.bernoulli makes: uniform < keep
            dropout_mask = torch.rand(features.shape, generator=generator,
                                      device=features.device) < keep
        fc_in = torch.where(dropout_mask, features / keep, 0.0)
    logits = torch.bmm(fc_in.transpose(0, 1), params[p + '_fc_w'])
    logits = logits.transpose(0, 1) + params[p + '_fc_b'][None]
    if train:
        return features, logits, updates
    return features, logits


def test_embedding(features, normalize=True):
    """Concat per-combo features to the embedding [B, R*D] (combo order
    preserved), optionally L2-normalised with a 1e-12 norm clamp."""
    emb = features.reshape(features.shape[0], -1)
    if normalize:
        norm = torch.sqrt(torch.sum(emb * emb, dim=1, keepdim=True))
        emb = emb / torch.clamp(norm, min=1e-12)
    return emb


# ---------------------------------------------------------------------------
# CRM: combination ranking module
# ---------------------------------------------------------------------------


def apply_crm(params, features, param_prefix='crm', sharded=False):
    """Two-branch soft attention over combinations.

    features: [B, R, D] pre-dropout post-ReLU combo features.
    Returns probs [B, K]: softmax over classes (axis 2) times softmax over
    combos (axis 1), summed over combos.  ``sharded``: the fc8 weights are
    this rank's class slice (the active mesh's model group); the softmax
    over classes takes its max and its sum over the group, the softmax
    over combos stays local, and probs is this rank's slice [B, K/m].
    """
    p = param_prefix
    fc8c = torch.matmul(features, params[p + '_fc8c_w']) + \
        params[p + '_fc8c_b']
    fc8d = torch.matmul(features, params[p + '_fc8d_w']) + \
        params[p + '_fc8d_b']
    if sharded:
        e = torch.exp(fc8c - collectives.max_model(
            fc8c.amax(dim=2, keepdim=True)))
        alpha_cls = e / collectives.all_reduce(
            torch.sum(e, dim=2, keepdim=True), axis='model')
    else:
        alpha_cls = torch.softmax(fc8c, dim=2)
    alpha_det = torch.softmax(fc8d, dim=1)
    return torch.sum(alpha_cls * alpha_det, dim=1)
