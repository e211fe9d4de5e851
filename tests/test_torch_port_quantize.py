"""int8 PTQ in the port against pps_tpu: ``quantize_body`` bitwise on the
same absmax, ``calibrate_amax``, ``conv2d_int8_plain`` (the int8 kernel's
plain version) against pps_tpu's ``conv2d_int8`` on the same input, int8
extraction on the same quantized params, the raises, the FPN body, and
``TPU.INT8_EVAL`` through ``test_net`` on a tiny roidb."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_variants_common import (cut, images, jax_model, numpy_params,
                                         port_model, tmp_path, _two_threads)
from pps_tpu.models import quantize as jq
from pps_tpu.models import resnet as jres
from pps_tpu.models.folding import fold_conv_bn as jfold
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine import test as ttest_engine
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.kernels import conv2d_int8 as ck
from pps_tpu_torch.models import quantize as tq
from pps_tpu_torch.models.folding import fold_conv_bn as tfold

from test_torch_port_data import decoder, write_coco

R50 = 'market1501/pps_crm_triplet_R-50_1x'
INT8 = 'market1501/pps_crm_triplet_R-50_1x_int8'
FPN2 = 'market1501/pps_crm_triplet_R-50-FPN2_1x'
GAMMA = 0.01
# calibrate_amax: each conv's per-channel input absmax, held against that
# conv's largest (the scale quantize_body takes): float32 conv sums in
# other orders through up to 53 convs move it by up to ~1.3e-6 of it
# (measured), so 1e-5
AMAX_REL = 1e-5
# int8 extraction on the same quantized params: the int8 body is exact
# integer arithmetic plus the same float32 epilogue, so the embeddings
# agree unless a float32 ulp upstream flips a quantization boundary
INT8_COS = 0.9999


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(scope='module')
def quant():
    """pps_tpu's fold, calibration and quantization of an R-50, and the
    port's on the same weights and calibration images."""
    jm = jax_model(R50, cut())
    params, state = numpy_params(jm, seed=21, gamma=GAMMA)
    calib = images(4, seed=22)
    jf = jfold(params, state)
    amax = jq.calibrate_amax(jf, state, jm.resnet_spec, [calib])
    jqp = {k: np.asarray(v) for k, v in jq.quantize_body(jf, amax).items()}
    x = images(3, seed=23)
    # pps_tpu op by op: jitted, XLA contracts the dequant epilogue into an
    # FMA, which moves its int8 body by quantization-boundary flips
    want_x = np.asarray(jm.extract_features(jqp, state, jnp.asarray(x)))
    tm = port_model(R50, cut())
    tp, ts = params_from_numpy(tm, params, state)
    tf = tfold(tp, ts)
    tamax = tq.calibrate_amax(tf, ts, tm.resnet_spec, [calib])
    tqp = tq.quantize_body(tf, amax)
    qp, qs = params_from_numpy(tm, jqp, state)
    got_x = tm.extract_features(qp, qs, torch.tensor(x)).numpy()
    return {'amax': amax, 'tamax': tamax, 'jqp': jqp, 'tqp': tqp,
            'want_x': want_x, 'got_x': got_x, 'qp': qp}


def test_quantize_body_bitwise(quant):
    jqp, tqp = quant['jqp'], quant['tqp']
    assert sorted(tqp) == sorted(jqp)
    n = 0
    for k, w in jqp.items():
        if not k.endswith(('_wq', '_xinv', '_osc', '_fb')):
            continue
        g = tqp[k].numpy()
        if k.endswith('_wq'):
            w = w.transpose(3, 0, 1, 2)  # HWIO -> OHWI
            n += 1
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert n == 53
    assert tqp['conv1_xinv'].shape == () and tqp['conv1_wq'].shape == (
        64, 7, 7, 3)


def test_params_from_numpy_carries_quantized_params(quant):
    qp = quant['qp']
    for k, v in quant['tqp'].items():
        assert qp[k].dtype == v.dtype and torch.equal(qp[k], v), k


def test_calibrate_amax_matches(quant):
    amax, tamax = quant['amax'], quant['tamax']
    assert sorted(tamax) == sorted(amax) and len(amax) == 53
    for k, want in amax.items():
        got = tamax[k]
        assert got.shape == want.shape, k
        assert np.abs(got - want).max() <= AMAX_REL * want.max(), k
    np.testing.assert_array_equal(tamax['conv1'], amax['conv1'])


def test_int8_extraction_matches_pps_tpu(quant):
    got, want = quant['got_x'], quant['want_x']
    assert np.isfinite(got).all()
    cos = np.sum(got * want, axis=1) / (
        np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= INT8_COS, cos
    assert ck.launches == 0  # the CPU never launches the kernel


CONVS = [  # (n, c_in, h, w, c_out, k, stride, dilation, groups, per_chan)
    (2, 3, 20, 12, 64, 7, 2, 1, 1, False),    # the stem
    (2, 64, 10, 6, 64, 3, 1, 1, 1, False),
    (2, 64, 10, 6, 96, 1, 2, 1, 1, False),
    (2, 32, 9, 7, 40, 3, 1, 2, 1, False),
    (2, 32, 9, 7, 48, 3, 2, 1, 4, True),      # grouped, per-channel xinv
]


@pytest.mark.parametrize('x_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', CONVS)
def test_conv2d_int8_plain_matches_pps_tpu(case, x_dtype):
    n, cin, h, w, cout, k, s, d, g, per_chan = case
    rng = np.random.RandomState(hash(case) % 2 ** 31)
    x = (rng.randn(n, h, w, cin) * 3).astype(np.float32)
    if x_dtype == 'bfloat16':  # the same bf16 values on both sides
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    # at xinv 16, 0.5 / 16 and 2.5 / 16 land on .5: rounded half to even
    x[0, 0, 0, :2] = [0.5 / 16, 2.5 / 16]
    wq = rng.randint(-127, 128, (k, k, cin // g, cout)).astype(np.int8)
    xinv = (rng.rand(cin) * 20 + 1).astype(np.float32) if per_chan \
        else np.float32(16.0)
    osc = (rng.rand(cout) * 1e-4).astype(np.float32)
    fb = rng.randn(cout).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    q_j = jnp.clip(jnp.round(jx.astype(jnp.float32) * xinv), -127, 127)
    pad = ((k - 1) * d) // 2
    acc_j = jax.lax.conv_general_dilated(
        q_j.astype(jnp.int8), jnp.asarray(wq), (s, s), ((pad, pad),) * 2,
        rhs_dilation=(d, d), dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        feature_group_count=g, preferred_element_type=jnp.int32)
    y_j = jres.conv2d_int8(jx, jnp.asarray(wq), jnp.asarray(xinv),
                           jnp.asarray(osc), jnp.asarray(fb), stride=s,
                           dilation=d, groups=g, dtype=jnp.float32)
    tx = torch.tensor(x).to(getattr(torch, x_dtype)).permute(0, 3, 1, 2)
    twq = torch.tensor(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
    args = (tx, twq, torch.tensor(xinv), torch.tensor(osc), torch.tensor(fb))
    q_t = ck.quantize_input(tx, args[2])
    np.testing.assert_array_equal(q_t.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(q_j))
    acc_t = ck.conv2d_int8(*args, stride=s, dilation=d, groups=g,
                           accumulators=True)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(acc_j))
    y_t = ck.conv2d_int8(*args, stride=s, dilation=d, groups=g,
                         out_dtype=torch.float32).permute(0, 2, 3, 1)
    y_j = np.asarray(y_j)
    ulps = np.abs(y_t.numpy().view(np.int32).astype(np.int64) -
                  y_j.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # the plain version is the op's CPU path
    np.testing.assert_array_equal(
        ck.conv2d_int8_plain(*args, stride=s, dilation=d, groups=g,
                             out_dtype=torch.float32).numpy(),
        y_t.permute(0, 3, 1, 2).numpy())


def test_conv2d_int8_refuses_bad_arguments():
    x = torch.zeros(1, 8, 4, 4)
    wq = torch.zeros(4, 3, 3, 8, dtype=torch.int8)
    xinv, osc, fb = torch.tensor(1.0), torch.ones(4), torch.zeros(4)
    with pytest.raises(TypeError, match='int8'):
        ck.conv2d_int8(x, wq.float(), xinv, osc, fb)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        ck.conv2d_int8(x.half(), wq, xinv, osc, fb)
    with pytest.raises(ValueError, match='xinv'):
        ck.conv2d_int8(x, wq, torch.ones(3), osc, fb)
    with pytest.raises(ValueError, match='osc'):
        ck.conv2d_int8(x, wq, xinv, torch.ones(5), fb)
    with pytest.raises(ValueError, match='groups'):
        ck.conv2d_int8(x, wq, xinv, osc, fb, groups=2)


def test_missing_calibration_raises():
    tm = port_model(R50, cut())
    params, state = tm.init(torch.Generator().manual_seed(0))
    folded = tfold(params, state)
    with pytest.raises(KeyError, match='no calibration record'):
        tq.quantize_body(folded, {'conv1': np.ones(3, np.float32)})
    with pytest.raises(AssertionError, match='no body convs'):
        tq.quantize_body(params, {})


def test_fpn_quantizes_the_body_only():
    jm = jax_model(FPN2, cut())
    params, state = numpy_params(jm, seed=31)
    calib = images(2, seed=32)
    want = jq.quantize_for_eval(jm, params, state, calib)
    tm = port_model(FPN2, cut())
    tp, ts = params_from_numpy(tm, params, state)
    got = tq.quantize_for_eval(tm, tp, ts, calib)
    assert sorted(got) == sorted(want)
    assert sum(k.endswith('_wq') for k in got) == 53
    fpn = [k for k in got if k.startswith('fpn_') and k.endswith('_w')]
    assert len(fpn) == 2
    for k in fpn:  # folded, float32, still 2-d
        assert got[k].dtype == torch.float32 and got[k].ndim == 2
        assert k[:-2] + '_fb' in got
    out = tm.extract_features(got, ts, torch.tensor(images(2, seed=33)))
    assert torch.isfinite(out).all()


N_IDS = 4


def test_int8_eval_through_test_net(tmp_path):
    """``TPU.INT8_EVAL`` in ``test_net`` on a tiny roidb from one weights
    pkl: the body quantized after calibrating on the first
    ``TPU.INT8_CALIB_IMAGES`` images, the features those of the quantized
    params and close to the float32 run's."""
    imdir, ann = write_coco(tmp_path, 'test', N_IDS, 4, hw=(48, 20),
                            with_marks=True)
    tcatalog.register_dataset('port_int8_test', imdir, ann)
    opts = cut(extra=['TEST.DATASETS', "('port_int8_test',)",
                      'TEST.IMS_PER_BATCH', '8', 'TPU.INT8_CALIB_IMAGES',
                      '12'])
    jm = jax_model(R50, opts)
    params, state = numpy_params(jm, seed=41, gamma=GAMMA)
    tm = port_model(R50, opts)
    tp, ts = params_from_numpy(tm, params, state)
    weights = str(tmp_path / 'w.pkl')
    tckpt.save_checkpoint(weights, tm, tp, ts)
    dec = decoder((48, 20))
    base, roidb = ttest_engine.test_net(tcfg.cfg, weights, 'port_int8_test',
                                        decode_fn=dec, device='cpu')
    tcfg.merge_cfg_from_list(['TPU.INT8_EVAL', 'True'])
    got, _ = ttest_engine.test_net(tcfg.cfg, weights, 'port_int8_test',
                                   output_dir=str(tmp_path / 't'),
                                   decode_fn=dec, device='cpu')
    calib = ttest_engine.preprocess_images(roidb[:12], tcfg.cfg,
                                           decode_fn=dec)
    qp = tq.quantize_for_eval(tm, tp, ts, calib)
    want = ttest_engine.extract_dataset_features(tcfg.cfg, tm, qp, ts, roidb,
                                                 decode_fn=dec)
    assert got.shape == (len(roidb), 3968)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, base)
    assert np.sum(got * base, axis=1).min() > 0.99
