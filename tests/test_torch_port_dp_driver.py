"""The drivers over two gloo ranks (one process each, on the CPU):
``train_model`` (rank 0 alone writes the checkpoints and the json_stats
lines, one rank's preemption stops both at the same step with one resume
point, and the resumed run ends bitwise where the continuous run ends)
and ``run_inference`` in float32 and int8 (the ranks split every global
batch, the tail batch padded; rank 0's features and metrics against one
process's)."""

import shutil

import numpy as np
import pytest
import torch

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine import test as ttest
from pps_tpu_torch.models.model import build_model as tbuild
from pps_tpu_torch.utils.io import load_object

from _torch_port_dist import Ranks, decoder
from test_torch_port_data import write_coco

WORLD = 2
RAW_HW = (48, 20)
MODEL = [
    'MODEL.TYPE', 'generalized_reid',
    'MODEL.CONV_BODY', 'ResNet.add_ResNet50_conv5_body',
    'MODEL.NUM_CLASSES', '9', 'MODEL.USE_BN', 'True',
    'MODEL.DTYPE', 'float32',
    'FAST_RCNN.ROI_BOX_HEAD', 'pps_heads.add_pps_part_head',
    'RESNETS.RES5_STRIDE', '1', 'TRAIN.FREEZE_AT', '0',
    'REID.SCALE', '(32, 96)', 'REID.BPM_STRIP_NUM', '5',
    'REID.BPM_DIM', '128', 'REID.CRM', 'True',
    'REID.TRIPLET_LOSS', 'True', 'REID.TRIPLET_LOSS_CROSS', 'True',
    'REID.NORMALIZE_FEATURE', 'True', 'REID.MAX_AVE_FEATURE', 'True']
# 16 images, a global batch of 4 x 2 ranks: epoch 0 (2 steps) then the
# P x K epoch 1 (2 x 2 ranks identities, 2 steps)
TRAIN = MODEL + [
    'TRAIN.DATASETS', "('port_dp_trainval',)", 'TRAIN.IMS_PER_BATCH', '4',
    'NUM_GPUS', str(WORLD), 'TRAIN.SNAPSHOT_ITERS', '1',
    'TRAIN.USE_FLIPPED', 'False',
    'SOLVER.BASE_LR', '0.002', 'SOLVER.MAX_ITER', '2',
    'REID.TRIPLET_LOSS_START', '0', 'REID.P', '2', 'REID.K', '2']
# 10 test images: the global batch of 4 x 2 ranks leaves a tail of 2
TEST = MODEL + ['TEST.DATASETS', "('port_dp_test',)",
                'TEST.IMS_PER_BATCH', '4']
INT8 = ['TPU.INT8_EVAL', 'True', 'TPU.INT8_CALIB_IMAGES', '8']
# two ranks against one process: the same float32 extraction, each image
# embedded in a batch of another size
FEAT_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield _runs(tmp_path_factory)
    finally:
        torch.set_num_threads(n)


def _runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('dp_driver')
    data = {}
    for split, n_ids, per_id, marks in (('trainval', 8, 2, False),
                                        ('test', 5, 2, True)):
        imdir, ann = write_coco(root / split, split, n_ids, per_id,
                                hw=RAW_HW, with_marks=marks)
        data['port_dp_' + split] = (imdir, ann)
        tcatalog.register_dataset('port_dp_' + split, imdir, ann)
    weights = str(root / 'weights.pkl')
    tcfg.merge_cfg_from_list(TRAIN)
    model = tbuild(tcfg.cfg, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    tckpt.save_checkpoint(weights, model, params, state)
    test_opts = {'f32': TEST + ['TEST.WEIGHTS', weights],
                 'int8': TEST + ['TEST.WEIGHTS', weights] + INT8}
    ranks = Ranks('driver', WORLD, str(root / 'ranks'), {
        'datasets': data, 'hw': RAW_HW, 'root': str(root / 'out'),
        'train': TRAIN + ['TRAIN.WEIGHTS', weights], 'preempt_at': 3,
        'test': test_opts,
        'model_axis': test_opts['f32'] + ['TPU.MESH_SHAPE', '(-1, 2)']},
        timeout=170, threads=2)
    try:
        one = {}
        for name, opts in test_opts.items():
            tcfg.reset_cfg()
            tcfg.merge_cfg_from_list(opts)
            one[name] = ttest.run_inference(
                tcfg.cfg, output_dir=str(root / 'one' / name),
                decode_fn=decoder(RAW_HW), device='cpu')
            one[name + '_feats'] = load_object(
                str(root / 'one' / name / 'features.pkl'))['all_feats']
        two = ranks.results()
        logs = []
        for r in range(WORLD):
            with open(str(root / 'ranks' / 'rank{}.log'.format(r))) as f:
                logs.append(f.read())
    finally:
        ranks.kill()
        shutil.rmtree(str(root), ignore_errors=True)
    return {'one': one, 'two': two, 'logs': logs}


def test_rank_zero_alone_writes_and_logs(runs):
    r0, r1 = runs['two']
    assert r0['cont'] == r1['cont'] == ['model_epoch1.pkl',
                                        'model_final.pkl']
    assert r0['cont_ckpts'] == r1['cont_ckpts'] == [0, 'final']
    assert 'json_stats:' in runs['logs'][0]
    assert 'json_stats:' not in runs['logs'][1]


def test_one_ranks_preemption_stops_both_and_resume_is_bitwise(runs):
    r0, r1 = runs['two']
    # rank 1's flag after its third step: both stop after global step 3
    assert r0['preempted'] == r1['preempted'] == (
        1, 1, 'model_preempt_epoch1_step1.pkl')
    assert r0['pre'] == ['model_epoch1.pkl',
                         'model_preempt_epoch1_step1.pkl']
    got, want = r0['final'], r0['cont_final']
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('name', ['f32', 'int8'])
def test_run_inference_on_two_ranks_matches_one(runs, name):
    r0, r1 = runs['two']
    feats = r0[name + '_feats']
    assert feats.shape == runs['one'][name + '_feats'].shape == (10, 3968)
    np.testing.assert_allclose(feats, runs['one'][name + '_feats'],
                               atol=FEAT_ATOL)
    # rank 0 evaluates; the other ranks return nothing
    assert r1[name] == {}
    got, want = r0[name]['port_dp_test'], runs['one'][name]['port_dp_test']
    assert sorted(got) == sorted(want)


def test_run_inference_refuses_a_model_axis(runs):
    """TPU.MESH_SHAPE (-1, 2) over two ranks: a (1, 2) mesh.  Extraction
    folds the model axis into data (pps_tpu's batch_sharding(fold_model=
    True)), so each rank embeds its own rows, not the whole global batch
    twice: the features equal one process's."""
    feats = runs['two'][0]['model_axis_feats']
    assert feats.shape == runs['one']['f32_feats'].shape == (10, 3968)
    np.testing.assert_allclose(feats, runs['one']['f32_feats'],
                               atol=FEAT_ATOL)
