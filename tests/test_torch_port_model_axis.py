"""The model axis: the port's train step on a (1, 2) and a (2, 2) mesh of
gloo ranks (one process each, on the CPU), the classifier FCs
class-sharded over the model group, against the port's one-rank step
(the loss, the updates with the class slices gathered), on the tiny
config of tests/test_parallel.py (against pps_tpu's own (4, 2) step:
tests/test_torch_port_model_axis_pps.py).

Two traps are held here:

* 17 logits (18 classes) do not divide by a model axis of 2, so the FCs
  stay replicated there, as pps_tpu's rule keeps them (Market's 751 and
  CUHK03's 767 logits likewise); the model group then computes identical
  class terms, which must count once;
* "global" means over the data group: the global batch is n_data x the
  local rows, and the triplet term sees each row once.

The planted fault (``chip_smoke.class_terms_not_over_model``: the class
terms' 1/n_model undone, so each model rank's share of the feature
gradient doubles) must fail the update rule.  Then ``run_inference`` under
a (1, 2) mesh (the model axis folded into data) against one process."""

import shutil

import numpy as np
import pytest

import jax
import torch

from pps_tpu import config as jconfig
from pps_tpu.models.model import build_model as jbuild
from pps_tpu.parallel import mesh as jmesh
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.engine import test as ttest
from pps_tpu_torch.parallel import mesh as tmesh
from pps_tpu_torch.utils.io import load_object

from _torch_port_dist import Ranks, decoder
from test_torch_port_dp import _assert_trees_close
from _torch_port_variants_common import numpy_params
from test_torch_port_data import write_coco

P, K = 4, 2
B = P * K
H, W = 96, 32
LR = 0.01
RESIDUAL_GAMMA = 0.01
LOSS_RTOL = 1e-5               # against the port's one-rank step
E2E_REL, FLOOR = 0.05, 0.02    # train_agree's rule (test_torch_port_dp)
FEAT_ATOL = 1e-5               # run_inference, 2 ranks vs one process
RAW_HW = (48, 20)


def tiny(num_classes):
    """tests/test_parallel.py's tiny config (triplet on, CRM on)."""
    return [
        'MODEL.TYPE', 'generalized_reid',
        'MODEL.CONV_BODY', 'ResNet.add_ResNet50_conv5_body',
        'MODEL.NUM_CLASSES', str(num_classes),
        'MODEL.USE_BN', 'True',
        'FAST_RCNN.ROI_BOX_HEAD', 'pps_heads.add_pps_part_head',
        'RESNETS.RES5_STRIDE', '1',
        'TRAIN.FREEZE_AT', '0',
        'TRAIN.IMS_PER_BATCH', str(B),
        'REID.SCALE', '(32, 96)',
        'REID.BPM_STRIP_NUM', '3',
        'REID.BPM_DIM', '16',
        'REID.CRM', 'True',
        'REID.TRIPLET_LOSS', 'True',
        'REID.TRIPLET_LOSS_CROSS', 'True',
        'REID.NORMALIZE_FEATURE', 'True',
        'REID.MAX_AVE_FEATURE', 'True',
        'REID.P', str(P), 'REID.K', str(K)]


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _jax_model(num_classes):
    jconfig.merge_cfg_from_list(tiny(num_classes))
    jconfig.assert_and_infer_cfg(make_immutable=False)
    return jconfig.cfg, jbuild(jconfig.cfg)


def _case(num_classes, seed):
    """Weights, a host-chain batch and the dropout mask pps_tpu's step
    draws from its key."""
    cfg, jm = _jax_model(num_classes)
    params, state = numpy_params(jm, seed=seed, gamma=RESIDUAL_GAMMA)
    rng = np.random.RandomState(seed + 1)
    labels = (np.repeat(np.arange(P), K) * 3 + 1).astype(np.int32)
    oh = np.zeros((B, num_classes - 1), np.float32)
    oh[np.arange(B), labels] = 1.0
    batch = {'data': rng.randn(B, H, W, 3).astype(np.float32) * 50,
             'labels_int32': labels, 'labels_oh': oh}
    key = jax.random.PRNGKey(seed + 2)
    mask = np.asarray(jax.random.bernoulli(
        key, 0.8, (B, jm.num_combos, jm.head_spec['bpm_dim'])))
    return {'cfg_list': tiny(num_classes), 'params': params, 'state': state,
            'batch': batch, 'draws': {'dropout_mask': mask}, 'lr': LR,
            'key': key}


def _write_data(root):
    imdir, ann = write_coco(root / 'test', 'test', 5, 2, hw=RAW_HW,
                            with_marks=True)
    tcatalog.register_dataset('port_mp_test', imdir, ann)
    return {'port_mp_test': (imdir, ann)}


def _test_opts(weights):
    return tiny(17) + ['MODEL.DTYPE', 'float32',
                       'TEST.DATASETS', "('port_mp_test',)",
                       'TEST.IMS_PER_BATCH', '4', 'TEST.WEIGHTS', weights]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Start the (1, 2) and (2, 2) ranks and the one-rank reference, then
    run one process's run_inference while they run."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp('model_axis')
    shard, rep = _case(17, seed=0), _case(18, seed=3)
    strip = [{k: v for k, v in c.items() if k != 'key'}
             for c in (shard, rep)]
    data = _write_data(root)
    tcfg.merge_cfg_from_list(tiny(17) + ['MODEL.DTYPE', 'float32'])
    from pps_tpu_torch.engine import checkpoint as tckpt
    from pps_tpu_torch.models.model import build_model
    model = build_model(tcfg.cfg, device='cpu')
    params, state = tckpt.params_from_numpy(model, shard['params'],
                                            shard['state'])
    weights = str(root / 'weights.pkl')
    tckpt.save_checkpoint(weights, model, params, state)
    tcfg.reset_cfg()
    two = Ranks('step', 2, str(root / 'one_two'), {
        'mesh_shape': (1, 2), 'common': strip[0],
        'steps': [{}, dict(planted_model=True), strip[1]],
        'infer': {'datasets': data, 'hw': RAW_HW,
                  'opts': _test_opts(weights) + ['TPU.MESH_SHAPE',
                                                 '(1, 2)'],
                  'out': str(root / 'infer_two')}},
        timeout=150)
    four = Ranks('step', 4, str(root / 'two_two'), {
        'mesh_shape': (2, 2), 'common': strip[0], 'steps': [{}]},
        timeout=150)
    solo = Ranks('step_one', 1, str(root / 'one'), {
        'common': strip[0], 'steps': [{}, strip[1]]}, timeout=150)
    try:
        tcfg.reset_cfg()
        tcfg.merge_cfg_from_list(_test_opts(weights))
        ttest.run_inference(tcfg.cfg, output_dir=str(root / 'infer_one'),
                            decode_fn=decoder(RAW_HW), device='cpu')
        feats_one = load_object(str(root / 'infer_one' /
                                    'features.pkl'))['all_feats']
        out = {'two': two.results(), 'four': four.results(),
               'one': solo.results()[0],
               'start': {'shard': shard['params'], 'rep': rep['params']},
               'feats_one': feats_one,
               'feats_two': load_object(str(root / 'infer_two' /
                                            'features.pkl'))['all_feats']}
    finally:
        for r in (two, four, solo):
            r.kill()
        shutil.rmtree(str(root), ignore_errors=True)
        torch.set_num_threads(n_threads)
    return out


def _assert_updates_close(got, want, start):
    """train_agree's rule on the displacement and the momentum (the
    class-sharded params gathered; pps_tpu's HWIO start in OIHW)."""
    start = {k: (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
             for k, v in start.items()}
    _assert_trees_close({k: v - start[k] for k, v in got['params'].items()},
                        {k: v - start[k] for k, v in want['params'].items()},
                        E2E_REL, FLOOR)
    _assert_trees_close(got['momentum'], want['momentum'], E2E_REL, FLOOR)


@pytest.mark.parametrize('mesh', ['1x2', '2x2'])
def test_model_axis_step_matches_one_rank(runs, mesh):
    got = runs['two'][0][0] if mesh == '1x2' else runs['four'][0][0]
    one = runs['one'][0]
    assert got['logs']['loss'] == pytest.approx(one['logs']['loss'],
                                                rel=LOSS_RTOL)
    for k, want in one['logs'].items():
        assert got['logs'][k] == pytest.approx(want, rel=LOSS_RTOL,
                                               abs=1e-6), k
    _assert_updates_close(got, one, runs['start']['shard'])


def test_every_rank_holds_the_same_gathered_state(runs):
    for ranks in (runs['two'], runs['four']):
        rank0 = ranks[0][0]['params']
        for r in ranks[1:]:
            for k, v in rank0.items():
                assert r[0]['digest'][k] == float(
                    np.sum(v, dtype=np.float64)), k


def test_odd_class_count_stays_replicated_and_equal(runs):
    """17 logits under a model axis of 2: pps_tpu's rule keeps every FC
    replicated; the model group's identical class terms count once."""
    mesh = tmesh.build_mesh(devices=['cpu'] * 2, mesh_shape=(1, 2))
    shapes = {n: np.zeros(s.shape) for n, s in
              runs['start']['rep'].items()}
    rules = tmesh.param_shardings(mesh, shapes)
    assert not any(isinstance(r, tmesh.ClassSharding)
                   for r in rules.values())
    got, one = runs['two'][0][2], runs['one'][1]
    assert got['params']['pps_fc_w'].shape[-1] == 17
    assert got['logs']['loss'] == pytest.approx(one['logs']['loss'],
                                                rel=LOSS_RTOL)
    _assert_updates_close(got, one, runs['start']['rep'])


def test_class_sharded_names_follow_pps_tpu(runs):
    mesh = tmesh.build_mesh(devices=['cpu'] * 8, mesh_shape=(4, 2))
    shapes = {n: np.zeros(s.shape) for n, s in
              runs['start']['shard'].items()}
    rules = tmesh.param_shardings(mesh, shapes)
    sharded = sorted(n for n, r in rules.items()
                     if isinstance(r, tmesh.ClassSharding))
    assert sharded == ['crm_fc8c_b', 'crm_fc8c_w', 'crm_fc8d_b',
                       'crm_fc8d_w', 'pps_fc_b', 'pps_fc_w']
    jm = jmesh.build_mesh(devices=jax.devices()[:8], mesh_shape=(4, 2))
    jrules = jmesh.param_shardings(jm, shapes)
    for n, r in jrules.items():
        assert (r.spec[-1:] == ('model',)) == (n in sharded), n


def test_planted_fault_is_refused(runs):
    """The class terms counted twice (their 1/n_model undone) fail the
    update rule against the sound one-rank step."""
    with pytest.raises(AssertionError, match='rms err'):
        _assert_updates_close(runs['two'][0][1], runs['one'][0],
                              runs['start']['shard'])


def test_run_inference_under_a_model_axis_matches_one_process(runs):
    assert runs['feats_two'].shape == runs['feats_one'].shape == (10, 112)
    np.testing.assert_allclose(runs['feats_two'], runs['feats_one'],
                               atol=FEAT_ATOL)
