"""FPN ("scale-free") in the port against pps_tpu: the spec and the
pyramid for FPN_NUM 2, 3 and 4 (3 and 4 upsample), the FPN2 yaml's
extraction (coarsest level), REMAT and FREEZE_CONV_BODY in training, the
pkl round trip in both directions, and the FLOP count.  The FPN train
forward and every gradient against pps_tpu's are in
``test_torch_port_variants_train.py``, which shares pps_tpu's per-op
compiles with the other heads' gradients."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_variants_common import (cut, images, jax_extract,
                                         jax_model, numpy_params,
                                         port_extract, port_model,
                                         port_train, tmp_path, _two_threads)
from pps_tpu.engine import checkpoint as jckpt
from pps_tpu.models import fpn as jfpn
from pps_tpu.utils import flops as jflops
from pps_tpu.utils.io import load_object
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.models import fpn as tfpn
from pps_tpu_torch.utils import flops as tflops

FPN2 = 'market1501/pps_crm_triplet_R-50-FPN2_1x'
# float32 einsums and BN on both sides, sums in other orders
PYRAMID_RTOL, PYRAMID_ATOL = 1e-5, 1e-5
EXTRACT_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _num(n):
    return cut(extra=['REID.FPN_NUM', str(n)])


@pytest.mark.parametrize('n', [2, 3, 4])
def test_fpn_spec_matches(n):
    want = jfpn.fpn_spec(jax_model(FPN2, _num(n)).cfg)
    got = tfpn.fpn_spec(port_model(FPN2, _num(n)).cfg)
    assert got == want
    assert got['stages'] == ['res5', 'res4', 'res3', 'res2'][:n]


@pytest.mark.parametrize('n', [2, 3, 4])
def test_pyramid_matches(n):
    """apply_fpn on the same stage maps (res5/res4 at 1/16, res3 at 1/8,
    res2 at 1/4), eval and train mode; shapes coarse -> fine."""
    jm = jax_model(FPN2, _num(n))
    spec = jm.fpn_spec
    params, state = numpy_params(jm, seed=7)
    rng = np.random.RandomState(8)
    hw = {'res5': (3, 2), 'res4': (3, 2), 'res3': (6, 4), 'res2': (12, 8)}
    dims = {'res5': 2048, 'res4': 1024, 'res3': 512, 'res2': 256}
    stages = {s: np.maximum(rng.randn(2, *hw[s], dims[s]), 0).astype(
        np.float32) for s in dims}
    tm = port_model(FPN2, _num(n))
    tp, ts = params_from_numpy(tm, params, state)
    tstages = {s: torch.tensor(v).permute(0, 3, 1, 2)
               for s, v in stages.items()}
    for train in (False, True):
        want, wupd = jfpn.apply_fpn(params, state, stages, spec, train=train)
        got = tfpn.apply_fpn(tp, ts, tstages, tm.fpn_spec, train=train)
        got, gupd = got if train else (got, {})
        assert len(got) == len(want) == n
        for lvl, (g, w) in enumerate(zip(got, want)):
            g = g.permute(0, 2, 3, 1).numpy()
            assert g.shape == w.shape == (2,) + hw[spec['stages'][lvl]] + (
                256,)
            np.testing.assert_allclose(g, np.asarray(w), rtol=PYRAMID_RTOL,
                                       atol=PYRAMID_ATOL)
        assert sorted(gupd) == sorted(wupd)
        for k in wupd:
            np.testing.assert_allclose(gupd[k].numpy(), np.asarray(wupd[k]),
                                       rtol=PYRAMID_RTOL, atol=PYRAMID_ATOL)


@pytest.mark.parametrize('n', [2, 4])
def test_fpn_extraction_matches(n):
    jm = jax_model(FPN2, _num(n))
    params, state = numpy_params(jm, seed=3)
    x = images(2, seed=4)
    want = jax_extract(jm, params, state, x)
    tm = port_model(FPN2, _num(n))
    assert tm.level_splits == jm.level_splits
    got = port_extract(tm, params, state, x)
    assert got.shape == want.shape == (2, 3968)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXTRACT_ATOL)


def test_fpn_remat_and_freeze_conv_body():
    """TPU.REMAT checkpoints the body with its stages (same loss and
    gradients, bit for bit on the CPU); FREEZE_CONV_BODY detaches the
    pyramid (no gradient reaches the body or the FPN convs)."""
    jm = jax_model(FPN2, _num(3))
    params, state = numpy_params(jm, seed=1, gamma=0.01)
    x = images(jm.cfg.TRAIN.IMS_PER_BATCH, seed=2)
    mask = np.random.RandomState(3).rand(
        24, jm.num_combos, jm.head_spec['bpm_dim']) < 0.8
    plain = port_train(port_model(FPN2, _num(3)), params, state, x, mask)
    remat = port_train(port_model(FPN2, _num(3) + ['TPU.REMAT', 'True']),
                       params, state, x, mask)
    assert remat['total'] == plain['total']
    for k, g in plain['grads'].items():
        np.testing.assert_array_equal(remat['grads'][k], g, err_msg=k)
    frozen = port_train(
        port_model(FPN2, _num(3) + ['TRAIN.FREEZE_CONV_BODY', 'True']),
        params, state, x, mask)
    for k, g in frozen['grads'].items():
        if k.startswith(('fpn_', 'res', 'conv1')):
            assert not np.any(g), k
    assert np.any(frozen['grads']['pps_conv_w'])


def test_fpn_pkl_round_trip_both_ways(tmp_path):
    """Port -> pkl -> pps_tpu and pps_tpu -> pkl -> port, bitwise; the FPN
    1x1 weights are OIHW [C_out, C_in, 1, 1] in the file."""
    jm = jax_model(FPN2, cut())
    params, state = numpy_params(jm, seed=5)
    tm = port_model(FPN2, cut())
    tp, ts = params_from_numpy(tm, params, state)
    port_pkl = str(tmp_path / 'port.pkl')
    tckpt.save_checkpoint(port_pkl, tm, tp, ts)
    blobs = load_object(port_pkl)['blobs']
    fpn_w = [k for k in blobs if k.startswith('fpn_') and k.endswith('_w')]
    assert len(fpn_w) == 2
    for k in fpn_w:
        assert blobs[k].shape == (256, params[k].shape[0], 1, 1), k
    jm = jax_model(FPN2, cut())
    zp = {k: jnp.zeros_like(v) for k, v in params.items()}
    zs = {k: jnp.zeros_like(v) for k, v in state.items()}
    jp, js, _ = jckpt.load_checkpoint(port_pkl, jm, zp, zs)
    for k in params:
        np.testing.assert_array_equal(np.asarray(jp[k]), params[k],
                                      err_msg=k)
    for k in state:
        np.testing.assert_array_equal(np.asarray(js[k]), state[k],
                                      err_msg=k)
    jax_pkl = str(tmp_path / 'jax.pkl')
    jckpt.save_checkpoint(jax_pkl, jm, params, state)
    tm = port_model(FPN2, cut())
    z = tm.init(torch.Generator().manual_seed(0))
    gp, gs, _ = tckpt.load_checkpoint(jax_pkl, tm, *z)
    for k in tp:
        assert torch.equal(gp[k], tp[k]), k
    for k in ts:
        assert torch.equal(gs[k], ts[k]), k


@pytest.mark.parametrize('n', [2, 4])
def test_fpn_flops_match(n):
    want = jflops.model_fwd_flops(jax_model(FPN2, _num(n)).cfg)
    got = tflops.model_fwd_flops(port_model(FPN2, _num(n)).cfg)
    assert got == want
    assert got > tflops.model_fwd_flops(port_model(
        'market1501/pps_crm_triplet_R-50_1x', cut()).cfg)
