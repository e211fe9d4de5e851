"""The GN int8 path in the port against pps_tpu: on a ResNeXt GN body,
``quantize_body``'s per-input-channel scales absorbed into the weights
(block-diagonally for the grouped convs) bitwise, and int8 extraction on
the same quantized params."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_variants_common import (cut, images, jax_model,
                                         numpy_params, port_extract,
                                         port_model, _two_threads)
from pps_tpu.models import quantize as jq
from pps_tpu.models.folding import fold_conv_bn as jfold
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.models import quantize as tq

R50 = 'market1501/pps_crm_triplet_R-50_1x'
RESNEXT_GN = ['MODEL.USE_GN', 'True', 'MODEL.USE_BN', 'False',
              'GROUP_NORM.NUM_GROUPS', '4', 'RESNETS.NUM_GROUPS', '4',
              'RESNETS.WIDTH_PER_GROUP', '4']
# int8 extraction on the same quantized params (pps_tpu op by op): each
# GN between two int8 convs reduces in float32 in another order, so its
# output moves by ulps and flips some of the next conv's quantization
# boundaries, conv after conv (measured 0.99947 at the worst of 3 rows)
INT8_COS = 0.999
# int8 against float32: the port loses what pps_tpu loses on the same
# model (random weights, GN scales spread over [0.1, 2.1): ~0.989)
QUANT_COS_DELTA = 2e-3


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _cos(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) *
                                    np.linalg.norm(b, axis=1))


@pytest.fixture(scope='module')
def gn_int8():
    """A ResNeXt GN body (4 groups of 4 channels in each 3x3): every conv
    has per-input-channel scales, the grouped ones absorb them
    block-diagonally."""
    extra = RESNEXT_GN
    jm = jax_model(R50, cut(extra=extra))
    params, state = numpy_params(jm, seed=61)
    # per-channel GN scales spread wide, as trained GN bodies have
    rng = np.random.RandomState(62)
    for k in params:
        if k.endswith('_gn_s'):
            params[k] = (rng.rand(*params[k].shape) * 2 + 0.1).astype(
                np.float32)
    calib = images(4, seed=63)
    jf = jfold(params, state)
    amax = jq.calibrate_amax(jf, state, jm.resnet_spec, [calib])
    jqp = {k: np.asarray(v) for k, v in
           jq.quantize_body(jf, amax, use_gn=True).items()}
    x = images(3, seed=64)
    want_q = np.asarray(jm.extract_features(jqp, state, jnp.asarray(x)))
    want_f = np.asarray(jm.extract_features(params, state, jnp.asarray(x)))
    tm = port_model(R50, cut(extra=extra))
    tp, ts = params_from_numpy(tm, params, state)
    tqp = tq.quantize_body(tp, amax, use_gn=True)
    qp, _ = params_from_numpy(tm, jqp, state)
    return {'jqp': jqp, 'tqp': tqp, 'want_q': want_q, 'want_f': want_f,
            'got_q': port_extract(tm, qp, ts, x),
            'got_f': port_extract(tm, tp, ts, x),
            'groups': tm.resnet_spec['num_groups']}


def test_gn_quantize_body_bitwise(gn_int8):
    jqp, tqp = gn_int8['jqp'], gn_int8['tqp']
    assert sorted(tqp) == sorted(jqp)
    for k, w in jqp.items():
        if k.endswith(('_wq', '_xinv', '_osc', '_fb')):
            g = tqp[k].numpy()
            if k.endswith('_wq'):
                w = w.transpose(3, 0, 1, 2)
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
    # per-input-channel scales; a grouped 3x3 sees C_in / groups inputs
    assert tqp['res3_0_branch2b_xinv'].shape == (
        tqp['res3_0_branch2b_wq'].shape[3] * gn_int8['groups'],)
    assert not torch.any(tqp['res2_0_branch2a_fb'])


def test_gn_int8_extraction(gn_int8):
    got, want, base = gn_int8['got_q'], gn_int8['want_q'], gn_int8['got_f']
    assert _cos(got, want).min() >= INT8_COS, _cos(got, want)
    np.testing.assert_allclose(_cos(got, base),
                               _cos(want, gn_int8['want_f']), rtol=0,
                               atol=QUANT_COS_DELTA)
