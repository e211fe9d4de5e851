"""``train_model`` on a (1, 2) mesh of two gloo ranks (one process each,
on the CPU) under ``TPU.CKPT_FORMAT orbax``: the epoch snapshots and the
preemption checkpoint are ``torch.distributed.checkpoint`` directories
(``*.dcp``, one shard set per rank, the class-sharded FCs carrying their
placement); rank 1's preemption flag stops both ranks after the same
step, and the run resumed from the ``.dcp`` directory ends bitwise where
a continuous run ends, its ``model_final.pkl`` holding the whole
classifier (the class slices gathered).  The counterpart of
tests/test_multihost.py's two-process preempt and resume."""

import shutil

import numpy as np
import pytest
import torch

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog

from _torch_port_dist import Ranks
from test_torch_port_ckpt_sharded import RAW_HW, TINY
from test_torch_port_data import write_coco

# 16 images, a global batch of 8 on a (1, 2) mesh (both ranks take the 8
# rows, 8 logits split 4 + 4): epoch 0 (2 steps), then the P x K epoch 1
TRAIN = TINY + [
    'TRAIN.DATASETS', "('port_dcp_trainval',)", 'TRAIN.IMS_PER_BATCH', '4',
    'NUM_GPUS', '2', 'TPU.MESH_SHAPE', '(1, 2)', 'TPU.CKPT_FORMAT', 'orbax',
    'TRAIN.SNAPSHOT_ITERS', '1', 'TRAIN.USE_FLIPPED', 'False',
    'SOLVER.BASE_LR', '0.002', 'SOLVER.MAX_ITER', '2',
    'REID.TRIPLET_LOSS_START', '0', 'REID.P', '4', 'REID.K', '2']


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(scope='module')
def driver(tmp_path_factory):
    """train_model on a (1, 2) mesh under TPU.CKPT_FORMAT orbax: a
    continuous run, a run preempted by rank 1's flag, its resume."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp('dcp_driver')
    imdir, ann = write_coco(root / 'trainval', 'trainval', 8, 2, hw=RAW_HW)
    tcatalog.register_dataset('port_dcp_trainval', imdir, ann)
    try:
        two = Ranks('driver', 2, str(root / 'ranks'), {
            'datasets': {'port_dcp_trainval': (imdir, ann)}, 'hw': RAW_HW,
            'root': str(root / 'out'), 'train': TRAIN, 'preempt_at': 3},
            timeout=150, threads=2).results()
    finally:
        shutil.rmtree(str(root), ignore_errors=True)
        torch.set_num_threads(n)
    return two


def test_two_rank_preempt_and_resume_from_dcp_is_bitwise(driver):
    r0, r1 = driver
    assert r0['cont'] == ['model_epoch1.dcp', 'model_epoch1.dcp.cfg.yaml',
                          'model_final.pkl']
    assert r0['preempted'] == r1['preempted'] == (
        1, 1, 'model_preempt_epoch1_step1.dcp')
    assert r0['pre'] == ['model_epoch1.dcp', 'model_epoch1.dcp.cfg.yaml',
                         'model_preempt_epoch1_step1.dcp',
                         'model_preempt_epoch1_step1.dcp.cfg.yaml']
    got, want = r0['final'], r0['cont_final']
    assert sorted(got) == sorted(want)
    # the pkl holds the whole classifier: the class slices gathered
    assert want['pps0_fc_w'].shape == (8, 16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


