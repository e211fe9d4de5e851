"""The slice as a whole: the port's extraction equals pps_tpu's on the
same weights and inputs, from the model entry point through the uint8
device-preproc wire, flip TTA and the tail-padded batch driver."""

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _flagship_cfg
from pps_tpu.models.model import build_model as jbuild
from pps_tpu.parallel import eval_step as jes
from pps_tpu.parallel import mesh as mesh_lib
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.models.model import build_model as tbuild
from pps_tpu_torch.parallel import eval_step as tes

SCALE = (32, 96)  # (width, height): flagship geometry cut to 96x32
# float32 on both sides through 53 convs and the head, sums in another
# order; unit-norm embeddings agree far inside the torch-parity bound
F32_RTOL, F32_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _jax_side(dtype):
    cfg = _flagship_cfg(scale=SCALE, num_classes=11, dtype=dtype)
    model = jbuild(cfg)
    params, state = jax.jit(model.init)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    params = {k: np.asarray(v) for k, v in params.items()}
    state = {k: (rng.randn(*np.shape(v)) * 0.1 if k.endswith('_rm')
                 else rng.rand(*np.shape(v)) + 0.5).astype(np.float32)
             for k, v in sorted(state.items())}
    return cfg, model, params, state


def _port_side(dtype, params, state):
    cfg = flagship_cfg(scale=SCALE, num_classes=11, dtype=dtype)
    model = tbuild(cfg, device='cpu')
    p, s = params_from_numpy(model, params, state)
    return cfg, model, p, s


@pytest.fixture(scope='module')
def f32():
    jcfg, jm, jp, js = _jax_side('float32')
    images = np.random.RandomState(6).randn(3, 96, 32, 3).astype(
        np.float32) * 50
    want = np.asarray(jax.jit(jm.extract_features)(jp, js, images))
    # uint8 decodes at another size: device preproc + flip TTA + the tail
    u8 = np.random.RandomState(7).randint(0, 256, (5, 48, 20, 3)).astype(
        np.uint8)
    mesh = mesh_lib.build_mesh(jcfg, mesh_shape=(1, 1))
    means = np.asarray(jcfg.PIXEL_MEANS)
    with mesh:
        fn = jes.make_extract_fn(jm, mesh, flip_tta=True,
                                 device_preproc=(means, (96, 32)))
        want_tta = jes.extract_features(fn, jp, js, u8, batch_size=2,
                                        mesh=mesh)
    return {'params': jp, 'state': js, 'images': images, 'want': want,
            'u8': u8, 'want_tta': want_tta, 'dim': jm.embedding_dim}


def test_extract_features_f32_matches(f32):
    _, model, p, s = _port_side('float32', f32['params'], f32['state'])
    got = model.extract_features(p, s, torch.tensor(f32['images'])).numpy()
    assert got.shape == (3, f32['dim']) == (3, 3968)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, f32['want'], rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_extract_pipeline_flip_tta_tail_matches(f32):
    cfg, model, p, s = _port_side('float32', f32['params'], f32['state'])
    fn = tes.make_extract_fn(model, flip_tta=True,
                             device_preproc=(cfg.PIXEL_MEANS, (96, 32)),
                             device='cpu')
    got = tes.extract_features(fn, p, s, f32['u8'], batch_size=2)
    assert got.shape == f32['want_tta'].shape == (5, 3968)
    np.testing.assert_allclose(got, f32['want_tta'], rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_extract_features_bf16_loose():
    _, jm, jp, js = _jax_side('bfloat16')
    images = np.random.RandomState(8).randn(2, 96, 32, 3).astype(
        np.float32) * 50
    want = np.asarray(jax.jit(jm.extract_features)(jp, js, images))
    _, model, p, s = _port_side('bfloat16', jp, js)
    got = model.extract_features(p, s, torch.tensor(images)).numpy()
    # same bf16 rounding points, other conv sum orders: each rounding may
    # differ by one bf16 ulp (2^-8), so compare unit-norm rows by cosine
    cos = np.sum(got * want, axis=1)
    assert cos.min() > 0.999, cos
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_extract_driver_pads_tail_and_keeps_order():
    """The batch driver on a stand-in extract fn: tail rows repeated, pad
    rows dropped, order kept."""
    seen = []

    def fn(params, state, x):
        seen.append(x.shape[0])
        return x.reshape(x.shape[0], -1)[:, :1].float()
    fn.device = torch.device('cpu')
    imgs = np.arange(7, dtype=np.float32).reshape(7, 1, 1, 1) * np.ones(
        (1, 2, 2, 3), np.float32)
    out = tes.extract_features(fn, None, None, imgs, batch_size=3)
    assert seen == [3, 3, 3]
    np.testing.assert_array_equal(out[:, 0], np.arange(7))


def test_extract_fn_device_must_match_model():
    cfg = flagship_cfg(scale=SCALE, num_classes=11, dtype='float32')
    model = tbuild(cfg, device='cpu')
    with pytest.raises((RuntimeError, ValueError)):
        tes.make_extract_fn(model, device='cuda')
