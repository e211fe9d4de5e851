"""The port's data mesh against pps_tpu's: ``build_mesh``'s shapes and the
rows each shard owns (``batch_sharding`` / ``replicated`` against
pps_tpu's ``NamedSharding`` index maps, ``shard_batch`` against pps_tpu's
placement), the collectives' values and adjoints on two gloo ranks, the
global BN statistics of the body and the head, the host-side agreement,
the store barrier, and what refuses to run."""

import numpy as np
import pytest
import torch

import jax

from pps_tpu.parallel import mesh as jmesh
from pps_tpu.parallel import train_step as jts
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.parallel import eval_step as tes
from pps_tpu_torch.parallel import mesh as tmesh
from pps_tpu_torch.parallel import train_step as tts

from _torch_port_dist import (check_collectives, collectives_payload,
                              free_port, run_ranks)

WORLD = 2


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.mark.parametrize('n,shape', [(8, (-1, 1)), (8, (4, 2)), (8, (2, 1)),
                                     (4, (-1, 2)), (1, (-1, 1))])
def test_build_mesh_shapes_and_rows_match_pps_tpu(n, shape):
    jm = jmesh.build_mesh(devices=jax.devices()[:n], mesh_shape=shape)
    tm = tmesh.build_mesh(devices=['cpu'] * n, mesh_shape=shape)
    assert tm.devices.shape == jm.devices.shape
    assert tm.axis_names == tuple(jm.axis_names)
    rows = 16
    arr = np.zeros((rows, 3), np.float32)
    for fold in (True, False):
        want = jmesh.batch_sharding(jm, fold_model=fold) \
            .devices_indices_map(arr.shape)
        got = tmesh.batch_sharding(tm, fold_model=fold).rows(rows)
        for d, (lo, hi) in zip(jm.devices.flat, got):
            s = want[d][0]
            assert (s.start or 0, rows if s.stop is None else s.stop) == \
                (lo, hi)
    rep = tmesh.replicated(tm).rows(rows)
    assert rep == [(0, rows)] * tm.size


def test_build_mesh_follows_num_devices_and_cfg_axes():
    cfg = tcfg.cfg
    cfg.immutable(False)
    cfg.TPU.NUM_DEVICES = 4
    cfg.TPU.MESH_SHAPE = (-1, 2)
    tm = tmesh.build_mesh(cfg, devices=['cpu'] * 8)
    assert tm.devices.shape == (2, 2) and tm.shape == {'data': 2, 'model': 2}
    # a model axis above 1: the classifier FCs whose class count divides
    # by it are class-sharded, everything else replicated (pps_tpu's rule)
    rules = tmesh.param_shardings(tm, {'w': torch.zeros(2),
                                       'pps_fc_w': torch.zeros(3, 4, 6),
                                       'crm_fc8c_b': torch.zeros(7)})
    assert rules['pps_fc_w'] == tmesh.ClassSharding(2)
    assert rules['w'].n_parts == rules['crm_fc8c_b'].n_parts == 1
    cfg.TPU.NUM_DEVICES = 9
    with pytest.raises(ValueError, match='NUM_DEVICES'):
        tmesh.build_mesh(cfg, devices=['cpu'] * 8)
    with pytest.raises(ValueError):
        tmesh.build_mesh(devices=['cpu'] * 3, mesh_shape=(-1, 2))
    # without a process group the mesh is this process's one device
    one = tmesh.build_mesh(device='cpu')
    assert one.size == 1 and not one.distributed and one.world_size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            tmesh.build_mesh()  # the default device is the card


def test_shard_batch_rows_match_pps_tpu():
    batch = {'a': np.arange(24, dtype=np.float32).reshape(8, 3),
             'b': np.arange(8, dtype=np.int32)}
    jm = jmesh.build_mesh(devices=jax.devices()[:WORLD],
                          mesh_shape=(WORLD, 1))
    placed = jts.shard_batch(jm, batch)
    shards = {k: [np.asarray(s.data) for s in v.addressable_shards]
              for k, v in placed.items()}

    class Rank(object):  # the rows rank r owns, as a mesh of WORLD ranks
        def __init__(self, r):
            self.rank, self.world_size, self.distributed = r, WORLD, True
            self.devices = np.empty((WORLD, 1), object)
            self.size = WORLD

    for r in range(WORLD):
        got = tts.shard_batch(Rank(r), batch)
        for k in batch:
            np.testing.assert_array_equal(got[k], shards[k][r])
        np.testing.assert_array_equal(tes.put_global_batch(Rank(r),
                                                           batch['a']),
                                      shards['a'][r])
    with pytest.raises(ValueError, match='divisible'):
        tes.put_global_batch(Rank(0), np.zeros((7, 2)))


def test_collectives_and_global_bn_on_two_ranks(tmp_path):
    """all_gather / all_reduce and their adjoints; the body's and the
    head's train-mode BN statistics (and the body's gradient) over the
    global batch; a flag raised on one rank seen by all; two store
    barriers of one name."""
    payload = collectives_payload(WORLD)
    check_collectives(run_ranks('collectives', WORLD, str(tmp_path),
                                payload, timeout=90), payload)


def test_nccl_on_shared_or_cpu_devices_raises():
    """NCCL needs one CUDA device per rank: asked for on the CPU (or, on
    the card, for ranks that share one) it raises before any collective,
    instead of hanging."""
    with pytest.raises(ValueError, match='NCCL'):
        tmesh.init_distributed(device='cpu', backend='nccl', rank=0,
                               world_size=1, master_addr='localhost',
                               master_port=free_port(), timeout_s=30)
    assert not tmesh.process_group_active()


def test_barrier_is_a_no_op_without_a_process_group():
    tmesh.coordination_barrier('nothing', timeout_s=1)
