"""The port's on-device augmentation against pps_tpu's: ``apply_augment``
fed the params that ``pps_tpu.data.device_augment.sample_params`` drew
(flip, random crop, horizontal crop, HSV jitter, blur, random erasing, on
the uniform and the padded wire), HSV and blur bitwise, and the port's own
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
    """HSV jitter and blur were the last ops to port: each now draws its
    params (the JAX package's keys) instead of raising, and a knob at
    probability 0 draws nothing."""
    spec = _spec(sat_range=20, hue_range=10, val_range=30, **kw)
    n = 512
    p = tda.sample_params(torch.Generator().manual_seed(0), spec, n, RAW,
                          torch.device('cpu'))
    assert sorted(p) == sorted(_jax_params(spec, 4, 0))
    if 'hsv_prob' in kw:
        on = p['hsv_on'].numpy()
        assert 0.4 < on.mean() < 0.6
        for key, r in (('d_sat', 20), ('d_hue', 10), ('d_val', 30)):
            d = p[key].numpy()
            assert (d[~on] == 0).all() and d.dtype == np.int32
            assert d.min() >= -r and d.max() < r and len(set(d[on])) > r
    else:
        taps = p['blur_taps'].numpy()
        assert taps.shape == (n, 7)
        np.testing.assert_allclose(taps.sum(1), 1.0, atol=1e-6)
        kinds = {tuple(t) for t in taps}
        assert kinds == {tuple(tda._BLUR_TAPS[k]) for k in (1, 3, 5)}
    plain = tda.sample_params(torch.Generator().manual_seed(0), _spec(), n,
                              RAW, torch.device('cpu'))
    assert sorted(plain) == ['ch', 'cw', 'x0', 'y0']


def test_padded_wire_raises():
    """The padded wire is ported: per-sample valid sizes bound the crop
    and erase draws (distributional bounds, as the JAX package's
    test_padded_draws_scale_with_valid_size)."""
    spec = _spec(crop_prob=1.0, crop_ratio=0.7, hcrop_prob=0.5,
                 hcrop_ratio=0.8, erase_prob=1.0)
    n = 600
    h = torch.tensor([64, 40, 24] * (n // 3), dtype=torch.int32)
    w = torch.tensor([32, 20, 12] * (n // 3), dtype=torch.int32)
    p = tda.sample_params(torch.Generator().manual_seed(5), spec, n, (h, w),
                          torch.device('cpu'))
    p = {k: v.numpy() for k, v in p.items()}
    h, w = h.numpy(), w.numpy()
    assert (p['y0'] >= 0).all() and (p['x0'] >= 0).all()
    assert (p['y0'] + p['ch'] <= h).all() and (p['x0'] + p['cw'] <= w).all()
    assert (p['ch'] >= (0.7 * 0.8 * h).astype(int) - 1).all()
    assert (p['cw'] >= (0.7 * w).astype(int) - 1).all()
    on = p['erase_on']
    assert on.mean() > 0.9
    assert (p['er_y'] + p['er_h'] <= p['y0'] + p['ch'])[on].all()
    assert (p['er_x'] + p['er_w'] <= p['x0'] + p['cw'])[on].all()
    # the erase area scales with each sample's crop area, as drawn
    area = (p['er_h'] * p['er_w'] / (p['ch'] * p['cw']))[on]
    assert 0.005 < area.min() and area.max() < 0.6
    for size in (64, 24):
        sel = on & (h == size)
        assert p['er_h'][sel].max() < size


# ---------------------------------------------------------------------------
# HSV jitter and Gaussian blur against pps_tpu's, bitwise.  pps_tpu's ops
# are called op by op, as its own tests call them: jitted on the CPU, XLA
# fuses HSV2RGB's float32 products and moves 675 of the 2^24 colours by
# one LSB (ROADMAP, "Noted while porting"); op by op it equals the port.
# ---------------------------------------------------------------------------

def _colours(n=1 << 16, seed=0):
    """A seeded sample of n colours of the 256^3 cube, plus its corners,
    as int32 [n, 1, 3]."""
    rng = np.random.RandomState(seed)
    c = rng.randint(0, 256, (n, 3))
    c[:8] = [[r, g, b] for r in (0, 255) for g in (0, 255) for b in (0, 255)]
    return c.reshape(n, 1, 3).astype(np.int32)


def test_hsv_round_trip_bitwise():
    c = _colours()
    want = np.asarray(jda.rgb2hsv_u8(jax.numpy.asarray(c)))
    got = tda.rgb2hsv_u8(torch.tensor(c)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tda.hsv2rgb_u8(torch.tensor(want)).numpy(),
        np.asarray(jda.hsv2rgb_u8(jax.numpy.asarray(want))))
    # any H, S, V in [0, 255]: H past 179 is the clip-at-255 quirk
    hsv = _colours(seed=1)
    np.testing.assert_array_equal(
        tda.hsv2rgb_u8(torch.tensor(hsv)).numpy(),
        np.asarray(jda.hsv2rgb_u8(jax.numpy.asarray(hsv))))


@pytest.mark.parametrize('seed', [0, 1])
def test_hsv_jitter_bitwise(seed):
    c = _colours(seed=seed + 2).reshape(64, 32, 32, 3)
    rng = np.random.RandomState(seed)
    d = [rng.randint(-60, 60, 64).astype(np.int32) for _ in range(3)]
    want = np.asarray(jda.hsv_jitter_u8(jax.numpy.asarray(c), *d))
    got = tda.hsv_jitter_u8(torch.tensor(c),
                            *[torch.tensor(v) for v in d]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('k', [1, 3, 5, 7])
@pytest.mark.parametrize('hw', [(13, 9), (4, 4), (3, 2)])
def test_blur_bitwise(k, hw):
    """Every size the blur meets; axes under 4 px reflect more than once
    (numpy's periodic 'reflect', as jnp.pad)."""
    x = np.random.RandomState(k).randint(0, 256, (2,) + hw + (3,)).astype(
        np.int32)
    taps = np.asarray([tda._BLUR_TAPS[k], tda._BLUR_TAPS[1]], np.float32)
    want = np.asarray(jda.gaussian_blur_u8(jax.numpy.asarray(x),
                                           jax.numpy.asarray(taps)))
    got = tda.gaussian_blur_u8(torch.tensor(x), torch.tensor(taps)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], x[1])  # ksize 1 is the identity


@pytest.mark.parametrize('n', [1, 2, 3, 4, 9])
@pytest.mark.parametrize('pad', [1, 2, 3, 7, 20])
def test_reflect_index_matches_numpy(n, pad):
    np.testing.assert_array_equal(tda.reflect_index(n, pad).numpy(),
                                  np.pad(np.arange(n), pad, mode='reflect'))


# ---------------------------------------------------------------------------
# the padded valid_hw wire, given pps_tpu's draws
# ---------------------------------------------------------------------------

# (H, W) decodes in a 48 x 24 bucket: pads of 0, 1, 2 and >= 3 px per axis
PAD_SIZES = [(48, 24), (47, 23), (46, 22), (40, 15), (48, 21), (44, 24),
             (33, 18), (47, 24)]
PAD_HW = (48, 24)
# the float32 output: each side sums 2 x 4 products of |x| <= 255 with
# the Keys weights (partial sums up to ~330) in another order; one float32
# ulp there is 3e-5, so a few ulps of the partial sums, 1e-4 (measured:
# 4.6e-5).  1e-5 would be below one ulp of any value above 128.
PAD_ATOL = 1e-4


def _padded_batch(seed):
    rng = np.random.RandomState(seed)
    ims = [rng.randint(0, 256, s + (3,)).astype(np.uint8) for s in PAD_SIZES]
    padded = np.stack([np.pad(im, ((0, PAD_HW[0] - im.shape[0]),
                                   (0, PAD_HW[1] - im.shape[1]), (0, 0)),
                              mode='reflect') for im in ims])
    flipped = np.arange(len(ims)) % 2 == 1
    return padded, flipped, np.asarray(PAD_SIZES, np.int32)


def _stage(module, monkeypatch, fn):
    """Run fn with ``module.crop_resize_batch`` recording its input: the
    uint8 stage after erasing, less the means, in float32."""
    seen = []
    real = module.crop_resize_batch

    def record(xf, *a):
        seen.append(np.array(xf))
        return real(xf, *a)
    monkeypatch.setattr(module, 'crop_resize_batch', record)
    out = np.asarray(fn())
    monkeypatch.setattr(module, 'crop_resize_batch', real)
    return seen[0], out


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_padded_apply_augment_matches(seed, monkeypatch):
    spec = _spec(crop_prob=0.7, crop_ratio=0.7, hcrop_prob=0.5,
                 hcrop_ratio=0.8, hsv_prob=1.0, sat_range=30, hue_range=20,
                 val_range=30, blur_prob=1.0, erase_prob=0.8)
    padded, flipped, valid = _padded_batch(seed)
    jp = jda.sample_params(jax.random.PRNGKey(seed), spec, len(valid),
                           (jax.numpy.asarray(valid[:, 0]),
                            jax.numpy.asarray(valid[:, 1])))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    assert jp['erase_on'].any() and (jp['blur_taps'][:, 3] < 1).any()
    want_stage, want = _stage(jda, monkeypatch, lambda: jda.apply_augment(
        padded, flipped, jp, spec, MEANS,
        valid_hw=jax.numpy.asarray(valid)))
    got_stage, got = _stage(tda, monkeypatch, lambda: tda.apply_augment(
        torch.tensor(padded), torch.tensor(flipped),
        {k: torch.tensor(v) for k, v in jp.items()}, spec, MEANS,
        valid_hw=torch.tensor(valid)))
    np.testing.assert_array_equal(got_stage, want_stage)
    assert got.shape == want.shape == (len(valid), 96, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PAD_ATOL)


def test_padded_augment_batch_draws_per_sample():
    """augment_batch on the padded wire draws with the valid sizes: a
    sample's crop window lies inside its valid region."""
    spec = _spec(crop_prob=1.0, crop_ratio=0.6, erase_prob=1.0)
    padded, flipped, valid = _padded_batch(3)
    gen = torch.Generator().manual_seed(0)
    out = tda.augment_batch(gen, torch.tensor(padded), torch.tensor(flipped),
                            spec, MEANS, valid_hw=torch.tensor(valid))
    params = tda.sample_params(torch.Generator().manual_seed(0), spec,
                               len(valid), (torch.tensor(valid[:, 0]),
                                            torch.tensor(valid[:, 1])),
                               torch.device('cpu'))
    assert ((params['y0'] + params['ch']).numpy() <= valid[:, 0]).all()
    assert ((params['x0'] + params['cw']).numpy() <= valid[:, 1]).all()
    again = tda.apply_augment(torch.tensor(padded), torch.tensor(flipped),
                              params, spec, MEANS,
                              valid_hw=torch.tensor(valid))
    assert torch.equal(out, again)
