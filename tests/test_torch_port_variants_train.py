"""The training forward of the head variants against pps_tpu: on the
youtu (with triplet), bpm, PPS and PPS + CRM yamls, and on the FPN2 yaml
at FPN_NUM 3 (one upsample, the levels batch-concatenated, the labels
tiled), ``train_forward``'s losses, logs, BN updates and every
parameter's gradient, on the same numpy-made weights (each residual
branch's last BN scale at 0.01, where the float32 gradient is well
conditioned), batch and dropout mask, in float32 at 96x32.  pps_tpu runs
op by op (``_torch_port_variants_common.jax_train``); its per-op compiles
(~25 s for an R-50) are shared by every test of this module."""

import numpy as np
import pytest

from _torch_port_variants_common import (assert_trees_close, cut, images,
                                         jax_model, jax_train, numpy_params,
                                         port_model, port_train, _two_threads)
from pps_tpu_torch import config as tcfg

HEADS = ['market1501/youtu_triplet_R-50_1x', 'market1501/bpm_R-50_1x',
         'market1501/pps_R-50_1x', 'market1501/pps_crm_R-50_1x']
FPN2 = 'market1501/pps_crm_triplet_R-50-FPN2_1x'
RESIDUAL_GAMMA = 0.01
# the total loss: float32 forward values, sums in other orders (measured
# ~1e-7 relative); every log within LOG_RTOL (+ LOG_ATOL for logs near 0)
LOSS_RTOL = 1e-6
LOG_RTOL, LOG_ATOL = 1e-5, 1e-6
# each gradient within 2% of its RMS, plus 2% of the RMS over all
# gradients for the few that are zero by an invariance (a conv bias ahead
# of a batch-stat BN, CRM's fc8d bias under its softmax over combos);
# measured up to ~1.1%
GRAD_REL, GRAD_FLOOR = 0.02, 0.02
# BN running stats: forward values after one step
STATE_REL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _both(yaml, opts):
    jm = jax_model(yaml, opts)
    params, state = numpy_params(jm, seed=1, gamma=RESIDUAL_GAMMA)
    x = images(jm.cfg.TRAIN.IMS_PER_BATCH, seed=2)
    want = jax_train(jm, params, state, x)
    tm = port_model(yaml, opts)
    got = port_train(tm, params, state, x, want['mask'])
    return want, got


@pytest.fixture(scope='module', params=HEADS)
def both(request):
    return _both(request.param, cut())


@pytest.fixture(scope='module')
def train3():
    """FPN_NUM 3 (one upsample, 3 levels concatenated)."""
    return _both(FPN2, cut(extra=['REID.FPN_NUM', '3']))


def test_train_forward_losses_match(both):
    want, got = both
    assert got['total'] == pytest.approx(want['total'], rel=LOSS_RTOL)
    assert sorted(got['logs']) == sorted(want['logs'])
    for k, v in want['logs'].items():
        assert got['logs'][k] == pytest.approx(v, rel=LOG_RTOL,
                                               abs=LOG_ATOL), k


def test_train_forward_state_updates_match(both):
    want, got = both
    assert_trees_close(got['updates'], want['updates'], STATE_REL)


def test_train_forward_every_gradient_matches(both):
    want, got = both
    assert_trees_close(got['grads'], want['grads'], GRAD_REL, GRAD_FLOOR)
    assert np.isfinite(sum(np.sum(g) for g in got['grads'].values()))


def test_fpn_train_forward_losses_match(train3):
    want, got = train3
    assert got['total'] == pytest.approx(want['total'], rel=LOSS_RTOL)
    assert sorted(got['logs']) == sorted(want['logs'])
    for k, v in want['logs'].items():
        assert got['logs'][k] == pytest.approx(v, rel=LOG_RTOL,
                                               abs=LOG_ATOL), k
    assert_trees_close(got['updates'], want['updates'], STATE_REL)
    assert any(k.startswith('fpn_') for k in got['updates'])


def test_fpn_train_forward_every_gradient_matches(train3):
    want, got = train3
    assert any(k.startswith('fpn_') for k in want['grads'])
    assert_trees_close(got['grads'], want['grads'], GRAD_REL, GRAD_FLOOR)
