"""The port's evaluation against pps_tpu's: the numpy metrics (a copy),
the card's ``cmc_map_device`` (run here on the CPU) against the JAX one
and against the numpy metrics on distance matrices with forced ties,
+inf and NaN (CMC exact, mAP within 1e-6), ``evaluate``'s results and
printed lines, the EXPECTED_RESULTS harness, and the test driver end to
end: ``run_inference`` on both sides from one weights pkl, and the port's
features.pkl scored by pps_tpu's evaluator."""

import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from pps_tpu import config as jconfig
from pps_tpu.data import catalog as jcatalog
from pps_tpu.engine import test as jtest_engine
from pps_tpu.evaluation import device_eval as jdev
from pps_tpu.evaluation import evaluator as jeval
from pps_tpu.evaluation import expected_results as jexp
from pps_tpu.evaluation import metrics as jmetrics
from pps_tpu.utils.io import load_object
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine import test as ttest_engine
from pps_tpu_torch.evaluation import device_eval as tdev
from pps_tpu_torch.evaluation import evaluator as teval
from pps_tpu_torch.evaluation import expected_results as texp
from pps_tpu_torch.evaluation import metrics as tmetrics
from pps_tpu_torch.models.model import build_model as tbuild

from test_torch_port_data import both_cfgs, decoder, write_coco

MAP_ATOL = 1e-6   # mAP: float64 (port, numpy) vs float32 (JAX) AP sums
CMC_KW = dict(separate_camera_set=False, single_gallery_shot=False,
              first_match_break=True)
# features from the same weights: float32 on both sides through 53 convs,
# sums in another order (tests/test_torch_port_model.py's bound)
F32_RTOL, F32_ATOL = 1e-4, 1e-5


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's checkpoints (~100-250 MB each) are freed when it ends:
    pytest keeps every test's directory until the session ends, and the
    suite's later tests need that disk."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads: the suite runs six workers on one host, and
    each worker's default of one thread per core oversubscribes it (these
    R-50 runs measured up to 20x slower there than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _synthetic(seed, nq=40, ng=200, n_ids=15, n_cams=4, d=32, sep=1.0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_ids, d) * sep
    q_ids = rng.randint(0, n_ids, nq)
    g_ids = rng.randint(0, n_ids, ng)
    q_cams = rng.randint(0, n_cams, nq)
    g_cams = rng.randint(0, n_cams, ng)
    qf = (centers[q_ids] + rng.randn(nq, d)).astype(np.float32)
    gf = (centers[g_ids] + rng.randn(ng, d)).astype(np.float32)
    return jmetrics.compute_dist(qf, gf), q_ids, g_ids, q_cams, g_cams


def _tied(seed):
    """Duplicated gallery rows (zero-distance ties) and distances rounded
    to 0.1 (unrelated entries tie too)."""
    dist, q_ids, g_ids, q_cams, g_cams = _synthetic(seed, sep=0.5)
    dist[:, 1::2] = dist[:, 0::2]
    g_ids[1::2] = g_ids[0::2]
    return np.round(dist, 1), q_ids, g_ids, q_cams, g_cams


def _non_finite(seed):
    """+inf, -inf and NaN on valid and excluded entries."""
    dist, q_ids, g_ids, q_cams, g_cams = _synthetic(seed)
    rng = np.random.RandomState(seed + 100)
    flat = dist.reshape(-1)
    for v in (np.inf, np.nan, -np.inf):
        flat[rng.choice(flat.size, 60, replace=False)] = v
    return dist, q_ids, g_ids, q_cams, g_cams


def _as_the_device_reads(dist):
    """NaN and +-inf mapped as the device maps valid entries (the numpy
    path has no defined order for NaN)."""
    return np.clip(np.nan_to_num(dist, nan=3e38, posinf=3e38, neginf=-3e38),
                   -3e38, 3e38).astype(np.float32)


CASES = [('random', 0), ('random', 1), ('random', 2), ('tied', 3),
         ('tied', 4), ('non_finite', 5), ('non_finite', 6)]


@pytest.mark.parametrize('kind,seed', CASES)
def test_cmc_map_device_matches(kind, seed):
    make = {'random': _synthetic, 'tied': _tied, 'non_finite': _non_finite}
    dist, q_ids, g_ids, q_cams, g_cams = make[kind](seed)
    m, c = tdev.cmc_map_device(dist, q_ids, g_ids, q_cams, g_cams, topk=10,
                               device='cpu')
    assert m.dtype == c.dtype == torch.float64 and c.shape == (10,)
    # against the JAX package's device path, on the same raw matrix
    jm, jc = jdev.cmc_map_device(dist, q_ids, g_ids, q_cams, g_cams, topk=10)
    np.testing.assert_allclose(float(m), float(jm), rtol=0, atol=MAP_ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6)
    # against the numpy golden path: CMC exact, mAP within 1e-6
    host = _as_the_device_reads(dist)
    want_map = tmetrics.mean_ap(host, q_ids, g_ids, q_cams, g_cams)
    want_cmc = tmetrics.cmc(host, q_ids, g_ids, q_cams, g_cams, topk=10,
                            **CMC_KW)
    np.testing.assert_array_equal(c.numpy(), want_cmc)
    np.testing.assert_allclose(float(m), want_map, rtol=0, atol=MAP_ATOL)


def test_cmc_map_device_hand_cases():
    # tie group by hand: distances [1,1,2,2,3], matches at 0, 2, 3
    m, _ = tdev.cmc_map_device(np.array([[1.0, 1.0, 2.0, 2.0, 3.0]]),
                               np.array([5]), np.array([5, 9, 5, 5, 9]),
                               np.array([0]), np.ones(5, int), topk=5,
                               device='cpu')
    want = (1 / 3) * (1 + 0.5) / 2 + (2 / 3) * (0.5 + 0.75) / 2
    np.testing.assert_allclose(float(m), want, rtol=1e-12)
    # query 0's only match sits at +inf: it stays inside the scored
    # prefix, ahead of the excluded same-camera entry (rank 1); query 1
    # matches at rank 0; query 2's only match shares its camera, so it has
    # no valid match and is left out of both metrics
    dist = torch.tensor([[np.inf, 0.0, 0.5], [0.3, 0.2, 0.1],
                         [0.1, 0.2, 0.3]])
    q_ids, g_ids = np.array([1, 7, 7]), np.array([1, 1, 7])
    q_cams, g_cams = np.array([1, 0, 2]), np.array([2, 1, 2])
    m, c = tdev.cmc_map_device(dist, q_ids, g_ids, q_cams, g_cams, topk=3)
    want_map = jmetrics.mean_ap(dist.numpy(), q_ids, g_ids, q_cams, g_cams)
    np.testing.assert_allclose(float(m), want_map, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(c.numpy(), [0.5, 1.0, 1.0])


def test_metrics_copy_matches():
    dist, q_ids, g_ids, q_cams, g_cams = _tied(8)
    assert tmetrics.mean_ap(dist, q_ids, g_ids, q_cams, g_cams) == \
        jmetrics.mean_ap(dist, q_ids, g_ids, q_cams, g_cams)
    for sep, sgs, fmb in ((False, False, True), (True, False, False),
                          (False, True, False), (True, True, True)):
        kw = dict(topk=8, separate_camera_set=sep, single_gallery_shot=sgs,
                  first_match_break=fmb)
        np.random.seed(0)
        got = tmetrics.cmc(dist, q_ids, g_ids, q_cams, g_cams, **kw)
        np.random.seed(0)
        want = jmetrics.cmc(dist, q_ids, g_ids, q_cams, g_cams, **kw)
        np.testing.assert_array_equal(got, want)
    a = np.random.RandomState(1).randn(5, 7).astype(np.float32)
    b = np.random.RandomState(2).randn(9, 7).astype(np.float32)
    for kind in ('euclidean', 'cosine'):
        np.testing.assert_array_equal(tmetrics.compute_dist(a, b, kind),
                                      jmetrics.compute_dist(a, b, kind))
    with pytest.raises(ValueError):
        tmetrics.compute_dist(a, b, 'manhattan')


def _eval_set(seed, with_mq):
    rng = np.random.RandomState(seed)
    n_ids = 6
    centers = rng.randn(n_ids, 12) * 2
    ids, cams, marks, feats = [], [], [], []
    for pid in range(n_ids):
        for j in range(8):
            ids.append(pid + 1)
            cams.append(j % 3 + 1)
            marks.append(0 if j == 0 else (2 if with_mq and j >= 6 else 1))
            feats.append(centers[pid] + rng.randn(12) * 0.8)
    feats = np.stack(feats).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return feats, np.array(ids), np.array(cams), np.array(marks)


def _assert_results_close(got, want, atol):
    assert sorted(got) == sorted(want)
    for block in want:
        assert sorted(got[block]) == sorted(want[block])
        for key in ('mAP', 'cmc1', 'cmc5', 'cmc10'):
            np.testing.assert_allclose(got[block][key], want[block][key],
                                       rtol=0, atol=atol)
        np.testing.assert_allclose(got[block]['cmc'], want[block]['cmc'],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize('device_single_query', [False, True])
def test_evaluate_matches(capsys, device_single_query):
    feats, ids, cams, marks = _eval_set(4, with_mq=True)
    want = jeval.evaluate(feats, ids, cams, marks, to_re_rank=False)
    want_out = capsys.readouterr().out
    got = teval.evaluate(feats, ids, cams, marks,
                         device_single_query=device_single_query,
                         device='cpu')
    got_out = capsys.readouterr().out
    _assert_results_close(got, want, 0 if not device_single_query
                          else MAP_ATOL)
    assert got_out == want_out
    assert got_out.startswith('Single Query:') and 'Multi Query:' in got_out
    # re-ranking (ported) adds its blocks and leaves the others as they were
    rr = teval.evaluate(feats, ids, cams, marks, to_re_rank=True,
                        device_single_query=device_single_query,
                        device='cpu')
    rr_out = capsys.readouterr().out
    assert sorted(rr) == ['multi', 'multi_rerank', 'single', 'single_rerank']
    _assert_results_close({b: rr[b] for b in got}, got, 0)
    assert rr_out.startswith(got_out)
    assert 'Re-ranked Single Query:' in rr_out


def test_parse_im_name_and_expected_results():
    for name in ('00000012_0003_00000045.jpg', '00001501_0006_00000001.png'):
        for kind in ('id', 'cam'):
            assert teval.parse_im_name(name, kind) == \
                jeval.parse_im_name(name, kind)
    results = {'ds': {'single': {'mAP': 0.5, 'cmc1': 0.7}}}
    expected = [['ds', 'single', 'mAP', 0.52], ['ds', 'single', 'cmc1', 0.9],
                ['ds', 'single', 'mAP', [0.6, 0.01]]]
    jc, tc = both_cfgs(['EXPECTED_RESULTS', repr(expected)])
    got = texp.check_expected_results(tc, results)
    assert got == jexp.check_expected_results(jc, results)
    assert len(got) == 2
    with pytest.raises(texp.ExpectedResultsError):
        texp.check_expected_results(tc, results, raise_on_fail=True)


# ---------------------------------------------------------------------------
# the test driver end to end, from one weights pkl
# ---------------------------------------------------------------------------

N_IDS = 6
TINY = ['MODEL.TYPE', 'generalized_reid',
        'MODEL.CONV_BODY', 'ResNet.add_ResNet50_conv5_body',
        'MODEL.NUM_CLASSES', str(N_IDS + 1), 'MODEL.USE_BN', 'True',
        'MODEL.DTYPE', 'float32',
        'FAST_RCNN.ROI_BOX_HEAD', 'pps_heads.add_pps_part_head',
        'RESNETS.RES5_STRIDE', '1', 'REID.SCALE', '(32, 96)',
        'REID.BPM_STRIP_NUM', '5', 'REID.BPM_DIM', '128',
        'REID.CRM', 'True', 'REID.NORMALIZE_FEATURE', 'True',
        'REID.MAX_AVE_FEATURE', 'True', 'REID.RERANK', 'False',
        'TEST.DATASETS', "('port_eval_test',)", 'TEST.IMS_PER_BATCH', '8',
        'TPU.NUM_DEVICES', '1']


def test_run_inference_matches(tmp_path, capsys):
    """Both packages' run_inference from the same weights pkl: features,
    results and printed lines agree, and the port's features.pkl, scored
    by pps_tpu's evaluator, gives pps_tpu's own results."""
    imdir, ann = write_coco(tmp_path, 'test', N_IDS, 5, hw=(48, 20),
                            with_marks=True, n_cams=3)
    for cat in (jcatalog, tcatalog):
        cat.register_dataset('port_eval_test', imdir, ann)
    jc, tc = both_cfgs(TINY)
    model = tbuild(tc, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(5)  # non-trivial eval BN statistics
    state = {k: torch.tensor((rng.randn(*v.shape) * 0.1 if k.endswith('_rm')
                              else rng.rand(*v.shape) + 0.5)
                             .astype(np.float32))
             for k, v in sorted(state.items())}
    weights = str(tmp_path / 'weights.pkl')
    tckpt.save_checkpoint(weights, model, params, state)
    dec = decoder((48, 20))

    want = jtest_engine.run_inference(jc, weights, str(tmp_path / 'j'),
                                      decode_fn=dec)['port_eval_test']
    want_out = capsys.readouterr().out
    got = ttest_engine.run_inference(tc, weights, str(tmp_path / 't'),
                                     decode_fn=dec,
                                     device='cpu')['port_eval_test']
    got_out = capsys.readouterr().out

    jf = load_object(str(tmp_path / 'j' / 'features.pkl'))['all_feats']
    tpkl = load_object(str(tmp_path / 't' / 'features.pkl'))
    assert sorted(tpkl) == ['all_feats', 'cfg']
    assert tpkl['all_feats'].shape == jf.shape == (N_IDS * 5, 3968)
    np.testing.assert_allclose(tpkl['all_feats'], jf, rtol=F32_RTOL,
                               atol=F32_ATOL)
    plain = yaml.safe_load(tpkl['cfg'])
    assert plain['REID']['SCALE'] == [32, 96]
    assert plain['TEST']['DATASETS'] == ['port_eval_test']

    _assert_results_close(got, want, MAP_ATOL)
    assert [ln for ln in got_out.splitlines() if 'Query:' in ln] == \
        [ln for ln in want_out.splitlines() if 'Query:' in ln]
    # the stacked (non-streaming) extraction path gives the same features
    roidb = jtest_engine.roidb_for_test('port_eval_test')
    stacked = ttest_engine.extract_dataset_features(
        tc, model, params, state, roidb, decode_fn=dec, streaming=False)
    np.testing.assert_array_equal(stacked, tpkl['all_feats'])
    # the port's container through pps_tpu's own evaluation tooling
    scored = jtest_engine.evaluate_dataset(jc, tpkl['all_feats'], roidb)
    _assert_results_close(scored, want, MAP_ATOL)
    assert os.path.getsize(str(tmp_path / 't' / 'features.pkl')) > 0


def test_engine_refuses_unported_paths(tmp_path):
    # (REID.RERANK and REID.VIS are ported: slice 5; TPU.INT8_EVAL: the
    # variants slice, tests/test_torch_port_quantize.py)
    # (.dcp weights are ported: slice 9; pps_tpu's .orbax directories
    # need orbax's storage layer, and the message names pkl)
    _, tc = both_cfgs(TINY)
    with pytest.raises(ValueError, match='pkl is the format both'):
        ttest_engine.test_net(tc, str(tmp_path / 'w.orbax'),
                              'port_eval_test', device='cpu')
    # mixed sizes and host preprocessing are ported (slice 3b): the
    # padded bucket comes from the metadata, and no decode is refused
    _, tc = both_cfgs(TINY)
    roidb = [{'image': 'a', 'height': 48, 'width': 20},
             {'image': 'b', 'height': 40, 'width': 20}]
    assert ttest_engine._pad_bucket(roidb) == (48, 20)
    assert ttest_engine._pad_bucket(roidb[:1]) is None
    assert ttest_engine.decode_uint8_stack(
        roidb, decode_fn=lambda p: np.zeros(
            (48 if p == 'a' else 40, 20, 3), np.uint8)) is None
    assert ttest_engine.default_eval_batch(tc) == 8
    assert ttest_engine.default_eval_batch(tc, 3, 16) == 15
