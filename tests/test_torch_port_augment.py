"""The port's on-device augmentation against pps_tpu's: ``apply_augment``
fed the params that ``pps_tpu.data.device_augment.sample_params`` drew
(flip, random crop, horizontal crop, random erasing), and the port's own
``sample_params``: shapes, bounds and determinism for a generator."""

import numpy as np
import pytest
import torch

import jax

from pps_tpu.data import device_augment as jda
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import device_augment as tda
from pps_tpu_torch.data.device_preprocess import cv2_bicubic_matrix
from pps_tpu_torch.flagship import flagship_cfg

MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
RAW = (48, 20)            # decode (H, W)
# float32 resize products on both sides, sums of at most 2 x 4 taps x 48
# terms of |x| <= 255 in another order
RESIZE_ATOL = 2e-3


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _spec(**kw):
    base = dict(crop_prob=0.0, crop_ratio=1.0, hcrop_prob=0.0,
                hcrop_ratio=1.0, hsv_prob=0.0, sat_range=0, hue_range=0,
                val_range=0, blur_prob=0.0, blur_kernel=7, erase_prob=0.0,
                sl=0.02, sh=0.4, r1=0.3, out_hw=(96, 32))
    base.update(kw)
    return base


def _batch(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n,) + RAW + (3,)).astype(np.uint8),
            rng.rand(n) < 0.5)


def _jax_params(spec, n, seed):
    p = jda.sample_params(jax.random.PRNGKey(seed), spec, n, RAW)
    return {k: np.asarray(v) for k, v in p.items()}


def _port_apply(x, flipped, params, spec):
    return tda.apply_augment(
        torch.tensor(x), torch.tensor(flipped),
        {k: torch.tensor(v) for k, v in params.items()}, spec, MEANS).numpy()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_uint8_stage_bitwise(seed):
    """At the decode size with no crop the resize is the identity, so the
    output is the uint8 stage (flip + erasing) minus the means: equal."""
    spec = _spec(erase_prob=0.6, out_hw=RAW)
    x, flipped = _batch(seed=seed)
    params = _jax_params(spec, 8, seed)
    assert params['erase_on'].any()
    want = np.asarray(jda.apply_augment(x, flipped, params, spec, MEANS))
    got = _port_apply(x, flipped, params, spec)
    np.testing.assert_array_equal(got, want)
    # erased pixels hold the uint8 truncation of the means, less the means
    i = int(np.flatnonzero(params['erase_on'])[0])
    y, xx = params['er_y'][i], params['er_x'][i]
    means = MEANS.reshape(3)
    np.testing.assert_array_equal(
        got[i, y, xx],
        means.astype(np.uint8).astype(np.float32) - means.astype(np.float32))


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_crops_and_erasing_match(seed):
    spec = _spec(crop_prob=0.6, crop_ratio=0.7, hcrop_prob=0.5,
                 hcrop_ratio=0.8, erase_prob=0.5)
    x, flipped = _batch(seed=seed + 10)
    params = _jax_params(spec, 8, seed)
    assert (params['ch'] < RAW[0]).any()
    want = np.asarray(jda.apply_augment(x, flipped, params, spec, MEANS))
    got = _port_apply(x, flipped, params, spec)
    assert got.shape == want.shape == (8, 96, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_crop_resize_matrices_match_jax_and_cv2():
    lens = np.array([48, 40, 33], np.int32)
    starts = np.array([0, 5, 15], np.int32)
    got = tda.crop_resize_matrices(96, 48, torch.tensor(lens),
                                   torch.tensor(starts)).numpy()
    for b in range(3):
        want = np.asarray(jda.crop_resize_matrix(
            96, 48, jax.numpy.asarray(lens[b]), jax.numpy.asarray(starts[b])))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-6)
    # no crop: cv2's resize matrix (float64-built there, float32 here)
    np.testing.assert_allclose(got[0], cv2_bicubic_matrix(48, 96), atol=1e-6)


def _flagship_spec():
    return tda.augment_spec(flagship_cfg(scale=(32, 96), num_classes=11))


def test_augment_spec_matches_jax():
    from __graft_entry__ import _flagship_cfg
    want = jda.augment_spec(_flagship_cfg(scale=(32, 96), num_classes=11))
    got = _flagship_spec()
    for k, v in got.items():
        assert want[k] == v, k
    assert got['erase_prob'] == 0.4 and got['out_hw'] == (96, 32)


def test_port_sample_params_shapes_bounds_and_determinism():
    spec = _spec(crop_prob=0.7, crop_ratio=0.6, hcrop_prob=0.5,
                 hcrop_ratio=0.8, erase_prob=0.5)
    n = 256
    draws = [tda.sample_params(torch.Generator().manual_seed(s), spec, n,
                               RAW, torch.device('cpu')) for s in (3, 3, 4)]
    p = {k: v.numpy() for k, v in draws[0].items()}
    assert sorted(p) == sorted(_jax_params(spec, 4, 0))
    for k in p:
        assert p[k].shape == (n,), k
        assert torch.equal(draws[0][k], draws[1][k]), k
    assert any(not torch.equal(draws[0][k], draws[2][k]) for k in p)
    h, w = RAW
    ch, cw, y0, x0 = p['ch'], p['cw'], p['y0'], p['x0']
    assert ((ch >= int(0.6 * 0.8 * h) - 1) & (ch <= h)).all()
    assert ((cw >= int(0.6 * w) - 1) & (cw <= w)).all()
    assert ((y0 >= 0) & (y0 + ch <= h) & (x0 >= 0) & (x0 + cw <= w)).all()
    assert (ch < h).any() and (ch == h).any()
    on = p['erase_on']
    assert 0.3 < on.mean() < 0.7
    assert ((p['er_y'] >= y0) & (p['er_y'] + p['er_h'] <= y0 + ch))[on].all()
    assert ((p['er_x'] >= x0) & (p['er_x'] + p['er_w'] <= x0 + cw))[on].all()
    assert ((p['er_h'] > 0) & (p['er_w'] > 0))[on].all()


def test_port_augment_batch_draws_and_applies():
    spec = _flagship_spec()
    x, flipped = _batch()
    gen = torch.Generator().manual_seed(0)
    out = tda.augment_batch(gen, torch.tensor(x), torch.tensor(flipped),
                            spec, MEANS)
    assert out.shape == (8, 96, 32, 3) and out.dtype == torch.float32
    params = tda.sample_params(torch.Generator().manual_seed(0), spec, 8,
                               RAW, torch.device('cpu'))
    again = tda.apply_augment(torch.tensor(x), torch.tensor(flipped), params,
                              spec, MEANS)
    assert torch.equal(out, again)


@pytest.mark.parametrize('kw', [dict(hsv_prob=0.5), dict(blur_prob=0.5)])
def test_unported_ops_raise(kw):
    with pytest.raises(NotImplementedError, match='slice 3'):
        tda.sample_params(torch.Generator(), _spec(**kw), 2, RAW,
                          torch.device('cpu'))


def test_padded_wire_raises():
    with pytest.raises(NotImplementedError, match='valid_hw'):
        tda.sample_params(torch.Generator(), _spec(), 2,
                          (torch.tensor([48, 40]), torch.tensor([20, 16])),
                          torch.device('cpu'))
