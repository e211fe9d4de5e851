"""The model axis against pps_tpu's own: the port's step on a (1, 2) and
a (2, 2) mesh of gloo ranks (one process each, on the CPU), the
classifier FCs class-sharded, against pps_tpu's step on its (4, 2) mesh
of 8 CPU devices (tests/test_parallel.py's test_model_axis_sharding), on
the same weights, batch and dropout mask: the loss within that test's
rtol 1e-4.  A file of its own: compiling pps_tpu's step takes most of its
time."""

import shutil

import jax.numpy as jnp
import pytest
import torch

from pps_tpu.parallel import mesh as jmesh
from pps_tpu.parallel import train_step as jts
from pps_tpu.solver import optimizer as jopt
from pps_tpu_torch import config as tcfg

from _torch_port_dist import Ranks
from test_torch_port_model_axis import LR, _case, _jax_model

MESH_LOSS_RTOL = 1e-4          # tests/test_parallel.py's bound


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _jax_mesh_loss(case):
    """pps_tpu's step on its (4, 2) mesh of the 8 CPU devices."""
    cfg, jm = _jax_model(int(case['batch']['labels_oh'].shape[1]) + 1)
    mesh = jmesh.build_mesh(cfg, mesh_shape=(4, 2))
    step = jts.make_train_step(jm, cfg, mesh,
                               meta=jopt.make_param_meta(case['params'], cfg),
                               donate=False)
    with mesh:
        ts = jts.place_train_state(
            mesh, {'params': case['params'], 'state': case['state'],
                   'opt': jopt.init_opt_state(case['params'])})
        _, logs = step(ts, jts.shard_batch(mesh, case['batch']),
                       jnp.float32(LR), jnp.float32(1.0), case['key'])
    return float(logs['loss'])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp('model_axis_pps')
    shard = _case(17, seed=0)
    strip = {k: v for k, v in shard.items() if k != 'key'}
    two = Ranks('step', 2, str(root / 'one_two'), {
        'mesh_shape': (1, 2), 'common': strip, 'steps': [{}]}, timeout=150)
    four = Ranks('step', 4, str(root / 'two_two'), {
        'mesh_shape': (2, 2), 'common': strip, 'steps': [{}]}, timeout=150)
    try:
        mesh_loss = _jax_mesh_loss(shard)
        out = {'two': two.results(), 'four': four.results(),
               'mesh_loss': mesh_loss}
    finally:
        two.kill()
        four.kill()
        shutil.rmtree(str(root), ignore_errors=True)
        torch.set_num_threads(n_threads)
    return out


def test_model_axis_loss_matches_pps_tpu_4x2_mesh(runs):
    got = runs['two'][0][0]['logs']['loss']
    assert got == pytest.approx(runs['mesh_loss'], rel=MESH_LOSS_RTOL)
    assert runs['four'][0][0]['logs']['loss'] == pytest.approx(
        runs['mesh_loss'], rel=MESH_LOSS_RTOL)
