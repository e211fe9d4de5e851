"""The port's ResNet body against pps_tpu's, on the same weights and
inputs: per-stage maps in float32, the padding and pooling edge cases,
the bf16 BN op order, and the bf16 body loosely."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from pps_tpu.models import resnet as jres
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.models import resnet as tres
from pps_tpu_torch.models.model import build_model

STAGES = ('res2', 'res3', 'res4', 'res5')


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _random_state(state, seed=1):
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(state):
        shape = np.shape(state[k])
        if k.endswith('_rm'):
            out[k] = rng.randn(*shape).astype(np.float32) * 0.1
        else:
            out[k] = rng.rand(*shape).astype(np.float32) + 0.5
    return out


@pytest.fixture(scope='module')
def body():
    """JAX R-50 body (flagship geometry at 96x32, f32 and bf16) on one
    batch of 2, plus the same weights in the port's layout."""
    jcfg = _flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    spec = jres.resnet_spec(jcfg, 50)
    params, state = jres.init_resnet_params(jax.random.PRNGKey(0), spec)
    params = {k: np.asarray(v) for k, v in params.items()}
    state = _random_state(state)
    x = np.random.RandomState(2).randn(2, 96, 32, 3).astype(np.float32) * 50
    out = {}
    for dt in ('float32', 'bfloat16'):
        s = dict(spec, dtype=dt)
        fn = jax.jit(lambda p, st, im, s=s: jres.apply_resnet(
            p, st, im, s, return_stages=True)[1])
        out[dt] = {k: np.asarray(v.astype(jnp.float32))
                   for k, v in fn(params, state, x).items()}
    return {'spec': spec, 'params': params, 'state': state, 'x': x,
            'out': out}


def _port(body, dtype):
    cfg = flagship_cfg(scale=(32, 96), num_classes=11, dtype=dtype)
    model = build_model(cfg, device='cpu')
    p, s = params_from_numpy(model, body['params'], body['state'])
    x = torch.tensor(body['x']).permute(0, 3, 1, 2)
    _, stages = tres.apply_resnet(p, s, x, model.resnet_spec,
                                  return_stages=True)
    return {k: v.float().permute(0, 2, 3, 1).numpy()
            for k, v in stages.items()}


@pytest.fixture(scope='module')
def port_f32(body):
    return _port(body, 'float32')


@pytest.mark.parametrize('stage', STAGES)
def test_stages_match_f32(body, port_f32, stage):
    # float32 on both sides; only the summation order differs, and the
    # error grows through up to 16 blocks: 1e-4 of the map's scale
    want = body['out']['float32'][stage]
    got = port_f32[stage]
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_res5_bf16_loose(body):
    # bf16 rounds at the same places on both sides but the conv sums
    # differ, and each rounding can flip by one bf16 ulp (2^-8): compare
    # the maps by relative L2 error and cosine
    want = body['out']['bfloat16']['res5'].ravel()
    got = _port(body, 'bfloat16')['res5'].ravel()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert rel < 3e-2 and cos > 0.999, (rel, cos)


@pytest.mark.parametrize('k,stride,dilation,hw', [
    (7, 2, 1, (13, 9)), (7, 2, 1, (12, 8)), (1, 2, 1, (7, 5)),
    (3, 2, 1, (9, 6)), (3, 1, 2, (8, 7)), (3, 1, 1, (5, 5))])
def test_conv2d_padding_matches(k, stride, dilation, hw):
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, hw[0], hw[1], 4).astype(np.float32)
    w = rng.randn(k, k, 4, 6).astype(np.float32)
    want = np.asarray(jres.conv2d(x, w, stride=stride, dilation=dilation))
    got = tres.conv2d(torch.tensor(x).permute(0, 3, 1, 2),
                      torch.tensor(w).permute(3, 2, 0, 1),
                      stride=stride, dilation=dilation)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('hw', [(7, 5), (8, 8), (3, 4)])
def test_max_pool_pads_with_minus_inf(hw):
    x = -1.0 - np.random.RandomState(0).rand(2, hw[0], hw[1], 3)
    x = x.astype(np.float32)  # all negative: a zero pad would win
    want = np.asarray(jres.max_pool_3x3_s2(x))
    got = tres.max_pool_3x3_s2(torch.tensor(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert (got < 0).all()
    np.testing.assert_array_equal(got, want)


def test_batch_norm_bf16_op_order():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 4, 8) * 4).astype(np.float32)
    s, b = rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32)
    rm = rng.randn(8).astype(np.float32)
    riv = (rng.rand(8) + 0.5).astype(np.float32)
    want, _ = jres.batch_norm(jnp.asarray(x, jnp.bfloat16),
                              {'_s': s, '_b': b}, {'_rm': rm, '_riv': riv},
                              '', False)
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.tensor(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    got = tres.batch_norm(xt, *map(torch.tensor, (s, b, rm, riv)))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    # same float32 ops in the same order, then one bf16 rounding: equal
    # up to one bf16 ulp where float32 FMA contraction differs
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)


def test_unported_variants_raise():
    """The GroupNorm and AffineChannel bodies are ported (variants slice;
    tests/test_torch_port_gn.py holds them against pps_tpu): both init and
    run here.  An int8 body is eval-only, as in pps_tpu: in train mode it
    has no float conv weights to run."""
    cfg = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    spec = tres.resnet_spec(cfg, 50)
    x = torch.zeros(1, 3, 32, 16)
    for variant in (dict(use_gn=True), dict(use_affine=True)):
        vspec = dict(spec, **variant)
        params, state = tres.init_resnet_params(torch.Generator(), vspec,
                                                'cpu')
        assert ('conv1_gn_s' in params) == bool(variant.get('use_gn'))
        assert state == {}
        assert tres.apply_resnet(params, state, x, vspec).shape == (
            1, 2048, 2, 1)
    with pytest.raises(KeyError, match='conv1_w'):
        tres.apply_resnet({'conv1_wq': None}, {}, torch.zeros(1, 3, 8, 8),
                          spec, train=True)
