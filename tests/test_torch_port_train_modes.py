"""The train modes of the port's body and head against pps_tpu's: batch
statistics with the biased variance, running-stat updates at momentum 0.9,
the FREEZE_AT detaches, the head's dropout with an injected mask, and
CRM."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from pps_tpu.models import heads as jh
from pps_tpu.models import resnet as jres
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.models import heads as th
from pps_tpu_torch.models import resnet as tres
from pps_tpu_torch.models.model import build_model

# one BN or head pass in float32, sums over at most a few thousand terms
RTOL, ATOL = 1e-5, 1e-5
# the body in train mode: float32 on both sides through 53 convs, each BN
# normalising by its own batch stats, so rounding grows with depth; the
# res5 map of this init differs by ~5e-4 of its RMS (measured)
BODY_REL = 5e-3


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(autouse=True, scope='module')
def _grad_enabled():
    """Autograd on for this module: another test module of the suite turns
    it off for the whole process when it is imported."""
    with torch.enable_grad():
        yield


def _bn_inputs(dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 5, 3, 8) * 3 + 2).astype(np.float32)
    s = (rng.rand(8) + 0.5).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    rm = rng.randn(8).astype(np.float32)
    riv = (rng.rand(8) + 0.5).astype(np.float32)
    return x, s, b, rm, riv


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_batch_norm_train_matches(dtype):
    x, s, b, rm, riv = _bn_inputs()
    jx = jnp.asarray(x, dtype)
    want, upd = jres.batch_norm(jx, {'_s': s, '_b': b},
                                {'_rm': rm, '_riv': riv}, '', True)
    xt = torch.tensor(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    got, (nrm, nriv) = tres.batch_norm_train(
        xt, *map(torch.tensor, (s, b, rm, riv)))
    assert got.dtype == xt.dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    # bf16: the same float32 ops, then one bf16 rounding (one ulp apart
    # where FMA contraction differs)
    tol = 2 ** -8 if dtype == 'bfloat16' else RTOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=ATOL)
    np.testing.assert_allclose(nrm.numpy(), np.asarray(upd['_rm']), RTOL,
                               ATOL)
    np.testing.assert_allclose(nriv.numpy(), np.asarray(upd['_riv']), RTOL,
                               ATOL)


def test_running_var_uses_the_biased_variance():
    x, s, b, rm, riv = _bn_inputs()
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    _, (nrm, nriv) = tres.batch_norm_train(xt, *map(torch.tensor,
                                                    (s, b, rm, riv)))
    xs = x.reshape(-1, 8).astype(np.float64)
    np.testing.assert_allclose(nriv.numpy(), 0.9 * riv + 0.1 * xs.var(0),
                               rtol=1e-5)
    np.testing.assert_allclose(nrm.numpy(), 0.9 * rm + 0.1 * xs.mean(0),
                               rtol=1e-5, atol=1e-6)
    # torch's own training BN would use the unbiased variance
    rm_t, riv_t = torch.tensor(rm), torch.tensor(riv)
    torch.nn.functional.batch_norm(xt, rm_t, riv_t, training=True,
                                   momentum=0.1)
    assert not np.allclose(riv_t.numpy(), nriv.numpy(), rtol=1e-4)


@pytest.fixture(scope='module')
def body():
    cfg = _flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    spec = jres.resnet_spec(cfg, 50)
    params, state = jres.init_resnet_params(jax.random.PRNGKey(0), spec)
    params = {k: np.asarray(v) for k, v in params.items()}
    rng = np.random.RandomState(1)
    state = {k: (rng.randn(*np.shape(v)) * 0.1 if k.endswith('_rm')
                 else rng.rand(*np.shape(v)) + 0.5).astype(np.float32)
             for k, v in sorted(state.items())}
    x = np.random.RandomState(2).randn(4, 96, 32, 3).astype(np.float32) * 50
    feat, stages, upd = jax.jit(lambda p, s, im: jres.apply_resnet(
        p, s, im, spec, train=True, return_stages=True))(params, state, x)
    return {'params': params, 'state': state, 'x': x,
            'stages': {k: np.asarray(v) for k, v in stages.items()},
            'updates': {k: np.asarray(v) for k, v in upd.items()}}


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def test_body_train_stages_and_updates_match(body):
    model = build_model(flagship_cfg(scale=(32, 96), num_classes=11,
                                     dtype='float32'), device='cpu')
    p, s = params_from_numpy(model, body['params'], body['state'])
    x = torch.tensor(body['x']).permute(0, 3, 1, 2)
    feat, stages, upd = tres.apply_resnet(p, s, x, model.resnet_spec,
                                          train=True, return_stages=True)
    assert torch.equal(feat, stages['res5'])
    for k, want in body['stages'].items():
        got = stages[k].permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert _rms(got - want) <= BODY_REL * _rms(want), k
    assert sorted(upd) == sorted(body['updates'])
    assert len(upd) == 2 * 53
    for k, want in body['updates'].items():
        assert _rms(upd[k].numpy() - want) <= BODY_REL * _rms(want), k
        assert not upd[k].requires_grad


@pytest.mark.parametrize('freeze_at', [0, 1, 2, 4])
def test_freeze_at_detaches_at_the_stage_boundary(body, freeze_at):
    cfg = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    model = build_model(cfg, device='cpu')
    spec = dict(model.resnet_spec, freeze_at=freeze_at)
    p, s = params_from_numpy(model, body['params'], body['state'])
    names = ('conv1_w', 'res2_2_branch2c_w', 'res3_0_branch2a_w',
             'res4_5_branch2c_w', 'res5_0_branch2a_w')
    leaves = {k: p[k].requires_grad_(True) for k in names}
    x = torch.tensor(body['x'][:2]).permute(0, 3, 1, 2)
    feat, _ = tres.apply_resnet(dict(p, **leaves), s, x, spec, train=True)
    grads = torch.autograd.grad(feat.sum(), list(leaves.values()),
                                allow_unused=True)
    stage_of = {'conv1_w': 1, 'res2_2_branch2c_w': 2, 'res3_0_branch2a_w': 3,
                'res4_5_branch2c_w': 4, 'res5_0_branch2a_w': 5}
    for k, g in zip(names, grads):
        if stage_of[k] <= freeze_at:
            assert g is None, k
        else:
            assert g is not None and g.abs().sum() > 0, k


def _head_inputs(r=7, c=32, d=8, k=5, b=6, seed=2):
    rng = np.random.RandomState(seed)
    params = {
        'pps_conv_w': rng.randn(r, c, d).astype(np.float32) * 0.3,
        'pps_conv_b': rng.randn(r, d).astype(np.float32) * 0.1,
        'pps_bn_s': (rng.rand(r, d) + 0.5).astype(np.float32),
        'pps_bn_b': rng.randn(r, d).astype(np.float32) * 0.1,
        'pps_fc_w': rng.randn(r, d, k).astype(np.float32) * 0.1,
        'pps_fc_b': rng.randn(r, k).astype(np.float32) * 0.1,
        'crm_fc8c_w': rng.randn(d, k).astype(np.float32),
        'crm_fc8c_b': rng.randn(k).astype(np.float32) * 0.1,
        'crm_fc8d_w': rng.randn(d, k).astype(np.float32),
        'crm_fc8d_b': rng.randn(k).astype(np.float32) * 0.1,
    }
    state = {'pps_bn_rm': rng.randn(r, d).astype(np.float32) * 0.1,
             'pps_bn_riv': (rng.rand(r, d) + 0.5).astype(np.float32)}
    feats = (rng.randn(b, r, c) + 1).astype(np.float32)
    return params, state, feats


@pytest.mark.parametrize('dropout', [0.0, 0.2])
def test_head_train_matches(dropout):
    params, state, feats = _head_inputs()
    spec = {'dropout': dropout, 'use_gn': False}
    key = jax.random.PRNGKey(3)
    jf, jl, jupd = jh.apply_head(params, state, jnp.asarray(feats), spec,
                                 train=True, dropout_rng=key,
                                 param_prefix='pps')
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - dropout, jf.shape))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    tf, tl, tupd = th.apply_head(tp, ts, torch.tensor(feats), spec,
                                 train=True, param_prefix='pps',
                                 dropout_mask=torch.tensor(mask))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), RTOL, ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), RTOL, ATOL)
    assert sorted(tupd) == sorted(jupd) == ['pps_bn_riv', 'pps_bn_rm']
    for k in tupd:
        np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                   RTOL, ATOL)
    if dropout:
        assert 0 < (~mask).mean() < 0.5


def test_head_dropout_draws_from_the_generator():
    params, state, feats = _head_inputs()
    spec = {'dropout': 0.2, 'use_gn': False}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    outs = [th.apply_head(tp, ts, torch.tensor(feats), spec, train=True,
                          param_prefix='pps',
                          generator=torch.Generator().manual_seed(s))[1]
            for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match='generator'):
        th.apply_head(tp, ts, torch.tensor(feats), spec, train=True,
                      param_prefix='pps')


def test_crm_matches():
    params, _, _ = _head_inputs()
    feats = np.maximum(np.random.RandomState(4).randn(6, 7, 8), 0).astype(
        np.float32)
    want = np.asarray(jh.apply_crm(params, jnp.asarray(feats)))
    got = th.apply_crm({k: torch.tensor(v) for k, v in params.items()},
                       torch.tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, RTOL, 1e-7)
    assert ((got >= 0) & (got <= 1)).all()
