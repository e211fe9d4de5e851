"""The port's part head against pps_tpu's: the static tables exactly, the
pooling, combination, eval head and embedding closely."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from pps_tpu.models import heads as jh
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.models import heads as th

# float32 on both sides; sums of a few hundred terms in another order
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.mark.parametrize('strip_num,scale_h,spatial_scale', [
    (5, 384, 1 / 16), (5, 384, 1 / 32), (7, 384, 1 / 16), (9, 384, 1 / 16),
    (10, 384, 1 / 16), (5, 96, 1 / 16), (3, 96, 1 / 16), (6, 256, 1 / 8)])
def test_strip_splits_equal(strip_num, scale_h, spatial_scale):
    assert th.strip_splits(strip_num, scale_h, spatial_scale) == \
        jh.strip_splits(strip_num, scale_h, spatial_scale)


def test_flagship_splits_are_uneven():
    assert th.strip_splits(5, 384, 1 / 16) == [5, 5, 4, 5, 5]


@pytest.mark.parametrize('n', [1, 2, 3, 5, 6])
def test_combo_tables_equal(n):
    assert th.powerset_combos(n) == jh.powerset_combos(n)
    assert th.bpm_combos(n) == jh.bpm_combos(n)
    assert th.youtu_combos(n) == jh.youtu_combos(n)
    for combos in (th.powerset_combos(n), th.youtu_combos(n)):
        spec = {'strip_num': n, 'combos': combos}
        np.testing.assert_array_equal(th.combo_masks(spec),
                                      np.asarray(jh.combo_masks(spec)))


@pytest.mark.parametrize('scale', [(128, 384), (32, 96)])
def test_head_spec_equal(scale):
    jspec = jh.head_spec(_flagship_cfg(scale=scale, num_classes=11), 1 / 16)
    tspec = th.head_spec(flagship_cfg(scale=scale, num_classes=11), 1 / 16)
    for key, value in tspec.items():
        assert jspec[key] == value, key
    assert len(tspec['combos']) == 31


def _feat(seed=0, shape=(3, 7, 4, 16)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize('splits', [[2, 2, 1, 2, 0], [1, 1, 1, 1, 1],
                                    [5, 2]])
def test_strip_pools_close(splits):
    splits = [s for s in splits if s]
    feat = _feat()
    jave, jmx = jh.strip_pools(jnp.asarray(feat), splits)
    tave, tmx = th.strip_pools(torch.tensor(feat).permute(0, 3, 1, 2),
                               splits)
    np.testing.assert_allclose(tave.numpy(), np.asarray(jave), RTOL, ATOL)
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))


@pytest.mark.parametrize('mode', ['mean_max', 'max', 'ave'])
def test_combine_strips_close(mode):
    rng = np.random.RandomState(1)
    n = 4
    ave = rng.randn(3, n, 16).astype(np.float32) - 2  # negative: the fill
    mx = rng.randn(3, n, 16).astype(np.float32) - 2   # must not win
    combos = th.bpm_combos(n) if mode == 'ave' else th.powerset_combos(n)
    masks = th.combo_masks({'strip_num': n, 'combos': combos})
    want = np.asarray(jh.combine_strips(jnp.asarray(ave), jnp.asarray(mx),
                                        jnp.asarray(masks), mode))
    got = th.combine_strips(torch.tensor(ave), torch.tensor(mx),
                            torch.tensor(masks), mode).numpy()
    assert got.shape == want.shape == (3, len(combos), 16)
    np.testing.assert_allclose(got, want, RTOL, ATOL)


def test_combine_strips_unknown_mode():
    with pytest.raises(ValueError):
        th.combine_strips(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3),
                          torch.ones(1, 2), 'median')


def _head_inputs(r=7, c=32, d=8, k=5, b=4, seed=2):
    rng = np.random.RandomState(seed)
    params = {
        'pps_conv_w': rng.randn(r, c, d).astype(np.float32) * 0.3,
        'pps_conv_b': rng.randn(r, d).astype(np.float32) * 0.1,
        'pps_bn_s': (rng.rand(r, d) + 0.5).astype(np.float32),
        'pps_bn_b': rng.randn(r, d).astype(np.float32) * 0.1,
        'pps_fc_w': rng.randn(r, d, k).astype(np.float32) * 0.1,
        'pps_fc_b': rng.randn(r, k).astype(np.float32) * 0.1,
    }
    state = {'pps_bn_rm': rng.randn(r, d).astype(np.float32) * 0.1,
             'pps_bn_riv': (rng.rand(r, d) + 0.5).astype(np.float32)}
    feats = rng.randn(b, r, c).astype(np.float32)
    spec = {'dropout': 0.0, 'use_gn': False}
    return params, state, feats, spec


def test_apply_head_eval_and_embedding_close():
    params, state, feats, spec = _head_inputs()
    jf, jl, upd = jh.apply_head(params, state, jnp.asarray(feats), spec,
                                train=False, param_prefix='pps')
    assert upd == {}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    tf, tl = th.apply_head(tp, ts, torch.tensor(feats), spec,
                           param_prefix='pps')
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), RTOL, ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), RTOL, ATOL)
    for normalize in (True, False):
        want = np.asarray(jh.test_embedding(jf, normalize))
        got = th.test_embedding(tf, normalize).numpy()
        np.testing.assert_allclose(got, want, RTOL, ATOL)


def test_embedding_norm_clamp():
    zero = torch.zeros(2, 3, 4)
    assert torch.equal(th.test_embedding(zero), torch.zeros(2, 12))


def test_training_head_not_ported():
    """The training head is ported (tests/test_torch_port_train_modes.py),
    and since the variants slice so is its GroupNorm form: in train mode
    it equals pps_tpu's, with no running-stat updates."""
    params, state, feats, spec = _head_inputs()
    params = {k.replace('_bn_', '_gn_'): v for k, v in params.items()}
    spec = dict(spec, use_gn=True, gn_groups=2, gn_eps=1e-5)
    jf, jl, jupd = jh.apply_head(params, {}, jnp.asarray(feats), spec,
                                 train=True, param_prefix='pps')
    tf, tl, tupd = th.apply_head({k: torch.tensor(v)
                                  for k, v in params.items()}, {},
                                 torch.tensor(feats), spec, train=True,
                                 param_prefix='pps')
    assert jupd == {} and tupd == {}
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), RTOL, ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), RTOL, ATOL)
