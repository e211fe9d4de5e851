"""The GroupNorm and AffineChannel bodies, the ConvGN head and the FPN's
ConvGN (coarsest level only) in the port against pps_tpu.  The GN int8
path is in ``test_torch_port_gn_int8.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_variants_common import (cut, images, jax_extract, jax_model,
                                         numpy_params, port_extract,
                                         port_model, tmp_path, _two_threads)
from pps_tpu.engine import checkpoint as jckpt
from pps_tpu.models import fpn as jfpn
from pps_tpu.models import heads as jheads
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.models import fpn as tfpn
from pps_tpu_torch.models import heads as theads

R50 = 'market1501/pps_crm_triplet_R-50_1x'
FPN2 = 'market1501/pps_crm_triplet_R-50-FPN2_1x'
GN = ['MODEL.USE_GN', 'True', 'MODEL.USE_BN', 'False']
AFFINE = ['MODEL.USE_BN', 'False']
RESNEXT_GN = GN + ['GROUP_NORM.NUM_GROUPS', '4', 'RESNETS.NUM_GROUPS', '4',
                   'RESNETS.WIDTH_PER_GROUP', '4']
# float32 on both sides, GN statistics and conv sums in other orders
EXTRACT_ATOL = 1e-6
LOSS_RTOL = 1e-5
HEAD_RTOL, HEAD_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.mark.parametrize('extra', [GN, AFFINE, RESNEXT_GN],
                         ids=['GroupNorm', 'AffineChannel', 'ResNeXt-GN'])
def test_body_extraction_matches(extra):
    jm = jax_model(R50, cut(extra=extra))
    params, state = numpy_params(jm, seed=51)
    x = images(2, seed=52)
    want = jax_extract(jm, params, state, x)
    tm = port_model(R50, cut(extra=extra))
    assert tm.resnet_spec == jm.resnet_spec
    tp, ts = params_from_numpy(tm, params, state)
    assert sorted(tm.init(torch.Generator())[0]) == sorted(params)
    got = port_extract(tm, tp, ts, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXTRACT_ATOL)
    if extra is not AFFINE:
        assert 'conv1_gn_s' in tp and not any('_bn_' in k for k in tp)
        assert ts == {}
    else:
        assert sorted(ts) == ['pps_bn_riv', 'pps_bn_rm']


def test_gn_model_train_forward_matches():
    """The GN body and ConvGN head in train mode: no BN updates, the same
    losses as pps_tpu's (forward values only)."""
    jm = jax_model(R50, cut(extra=GN))
    params, state = numpy_params(jm, seed=53, gamma=0.01)
    x = images(8, seed=54)
    labels = (np.repeat(np.arange(4), 2) * 2 + 1).astype(np.int32)
    oh = np.eye(10, dtype=np.float32)[labels]
    rng = jax.random.PRNGKey(3)
    total, (updates, logs) = jax.jit(jm.train_forward)(
        params, state, {'data': x, 'labels_int32': labels, 'labels_oh': oh},
        rng, jnp.float32(1.0))
    mask = np.asarray(jax.random.bernoulli(
        rng, 0.8, (8, jm.num_combos, jm.head_spec['bpm_dim'])))
    tm = port_model(R50, cut(extra=GN))
    tp, ts = params_from_numpy(tm, params, state)
    got, (gupd, glogs) = tm.train_forward(
        tp, ts, {'data': torch.tensor(x), 'labels_int32': torch.tensor(labels),
                 'labels_oh': torch.tensor(oh)}, None, 1.0,
        dropout_mask=torch.tensor(mask))
    assert updates == {} and gupd == {}
    assert float(got) == pytest.approx(float(total), rel=LOSS_RTOL)
    for k in ('crm_loss', 'pps01234_loss', 'pps01234_triplet_loss'):
        assert float(glogs[k]) == pytest.approx(float(logs[k]),
                                                rel=LOSS_RTOL, abs=1e-6), k


def test_conv_gn_head_forward_and_gradient_match():
    """apply_head with the ConvGN head in train mode (dropout mask
    injected): features, logits and the gradient of a scalar of them,
    pps_tpu op by op."""
    tm = port_model(R50, cut(extra=GN + ['REID.BPM_DIM', '16',
                                         'GROUP_NORM.NUM_GROUPS', '4']))
    spec = dict(tm.head_spec)
    jspec = dict(spec)
    rng = np.random.RandomState(55)
    r, c, d, k = len(spec['combos']), 24, 16, spec['num_logits']
    hp = {'pps_conv_w': rng.randn(r, c, d) * 0.3,
          'pps_conv_b': rng.randn(r, d) * 0.1,
          'pps_gn_s': rng.rand(r, d) + 0.5, 'pps_gn_b': rng.randn(r, d) * 0.1,
          'pps_fc_w': rng.randn(r, d, k) * 0.1, 'pps_fc_b': rng.randn(r, k)}
    hp = {n: v.astype(np.float32) for n, v in hp.items()}
    feats = rng.randn(6, r, c).astype(np.float32)
    mask = rng.rand(6, r, d) < 0.8
    cot_f = rng.randn(6, r, d).astype(np.float32)
    cot_l = rng.randn(6, r, k).astype(np.float32)

    def jloss(p):
        key = jax.random.PRNGKey(0)
        f, lg, _ = jheads.apply_head(p, {}, jnp.asarray(feats), jspec,
                                     train=False, dropout_rng=key,
                                     param_prefix='pps')
        return jnp.sum(f * cot_f) + jnp.sum(lg * cot_l), (f, lg)
    (jv, (jf, jl)), jg = jax.value_and_grad(jloss, has_aux=True)(hp)
    with torch.enable_grad():
        tp = {n: torch.tensor(v, requires_grad=True) for n, v in hp.items()}
        f, lg = theads.apply_head(tp, {}, torch.tensor(feats), spec,
                                  param_prefix='pps')
        tv = torch.sum(f * torch.tensor(cot_f)) + torch.sum(
            lg * torch.tensor(cot_l))
        tg = torch.autograd.grad(tv, [tp[n] for n in sorted(tp)])
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf),
                               rtol=HEAD_RTOL, atol=HEAD_ATOL)
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jl),
                               rtol=HEAD_RTOL, atol=HEAD_ATOL)
    for n, g in zip(sorted(tp), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    # train mode: no running-stat updates, the dropout mask applied
    _, lt, upd = theads.apply_head(
        {n: v.detach() for n, v in tp.items()}, {}, torch.tensor(feats),
        spec, train=True, param_prefix='pps',
        dropout_mask=torch.tensor(mask))
    assert upd == {} and not torch.equal(lt, lg.detach())


def test_fpn_conv_gn_on_the_coarsest_level_only():
    extra = ['FPN.USE_GN', 'True']
    jm = jax_model(FPN2, cut(extra=extra))
    params, state = numpy_params(jm, seed=56)
    coarse = 'fpn_inner_res5_2_sum'
    lateral = 'fpn_inner_res4_5_sum_lateral'
    assert coarse + '_gn_s' in params and coarse + '_b' not in params
    assert lateral + '_bn_s' in params and lateral + '_gn_s' not in params
    x = images(2, seed=57)
    want = jax_extract(jm, params, state, x)
    rng = np.random.RandomState(58)
    stages = {'res5': rng.rand(2, 6, 2, 2048).astype(np.float32),
              'res4': rng.rand(2, 6, 2, 1024).astype(np.float32)}
    wpyr, _ = jfpn.apply_fpn(params, state, stages, jm.fpn_spec, train=True)
    tm = port_model(FPN2, cut(extra=extra))
    assert tm.fpn_spec == jm.fpn_spec
    tp, ts = params_from_numpy(tm, params, state)
    got = port_extract(tm, tp, ts, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXTRACT_ATOL)
    gpyr, _ = tfpn.apply_fpn(
        tp, ts, {s: torch.tensor(v).permute(0, 3, 1, 2)
                 for s, v in stages.items()}, tm.fpn_spec, train=True)
    for g, w in zip(gpyr, wpyr):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-5, atol=1e-5)


def test_gn_head_checkpoint_round_trip(tmp_path):
    """A ConvGN head's per-combo ``_gn_s/_gn_b`` blobs and no running
    stats, port -> pkl -> pps_tpu, bitwise."""
    jm = jax_model(R50, cut(extra=GN))
    params, state = numpy_params(jm, seed=65)
    tm = port_model(R50, cut(extra=GN))
    tp, ts = params_from_numpy(tm, params, state)
    path = str(tmp_path / 'gn.pkl')
    tckpt.save_checkpoint(path, tm, tp, ts)
    jm = jax_model(R50, cut(extra=GN))
    zp = {k: jnp.zeros_like(v) for k, v in params.items()}
    jp, _, _ = jckpt.load_checkpoint(path, jm, zp, {})
    for k in params:
        np.testing.assert_array_equal(np.asarray(jp[k]), params[k],
                                      err_msg=k)
