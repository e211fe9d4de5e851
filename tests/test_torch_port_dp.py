"""The data-parallel train step: the port's step on two gloo ranks (one
process each, on the CPU) against pps_tpu's step over a 2-device data
mesh (the loss) and against the port's own one-rank step (the loss, the
BN state, the updates and the augmented rows), from the same weights and
global batch.

pps_tpu's jitted gradient differs from its own op-by-op one (ROADMAP,
"Noted while porting"), so against its mesh step only the loss is held;
the port's one-rank step is held against pps_tpu op by op in
``test_torch_port_train_step.py``."""

import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from pps_tpu.models.model import build_model as jbuild
from pps_tpu.parallel import mesh as jmesh
from pps_tpu.parallel import train_step as jts
from pps_tpu.solver import optimizer as jopt
from pps_tpu_torch import config as tcfg

from _torch_port_dist import Ranks
from _torch_port_variants_common import numpy_params

SCALE = (32, 96)
P, K = 4, 2
B = P * K
WORLD = 2
NUM_CLASSES = 11
RAW_HW = (48, 20)
LR = 0.01
# the residual branches' last BN scale, as in test_torch_port_train_step
# (from the plain init this R-50's float32 gradient is chaotic)
RESIDUAL_GAMMA = 0.01
# against pps_tpu's 2-device mesh step: tests/test_parallel.py's own bound
MESH_LOSS_RTOL = 1e-4
# the port on two ranks against one: the same float32 math, summed in
# another order
LOSS_RTOL = 1e-5
# the tolerances of test_torch_port_train_step.py: updates by RMS (5% of
# each tensor's + 2% of the RMS over all), BN state 1e-3 of its RMS
E2E_REL, FLOOR, STATE_REL = 0.05, 0.02, 1e-3
CFG = dict(scale=SCALE, num_classes=NUM_CLASSES, ims_per_batch=B, p=P, k=K,
           dtype='float32')


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _assert_trees_close(got, want, rel, floor=0.0):
    total = sum(np.size(w) for w in want.values())
    rms_all = float(np.sqrt(sum(np.sum(np.square(w, dtype=np.float64))
                                for w in want.values()) / total))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = _rms(got[k] - w)
        assert err <= rel * _rms(w) + floor * rms_all, \
            '{}: rms err {} vs rms {}'.format(k, err, _rms(w))


def _jax_model():
    cfg = _flagship_cfg(**CFG)
    return cfg, jbuild(cfg)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Start the two ranks and the port's one-rank reference, then compute
    pps_tpu's mesh step while they run."""
    _, jm = _jax_model()
    params, state = numpy_params(jm, seed=0, gamma=RESIDUAL_GAMMA)
    rng = np.random.RandomState(1)
    labels = np.repeat(np.arange(P), K).astype(np.int32) * 2 + 1
    oh = np.zeros((B, NUM_CLASSES - 1), np.float32)
    oh[np.arange(B), labels] = 1.0
    u8 = {'data_u8': rng.randint(0, 256, (B,) + RAW_HW + (3,)).astype(
              np.uint8),
          'flipped': np.arange(B) % 2 == 0,
          'labels_int32': labels, 'labels_oh': oh}
    # the host chain's wire for pps_tpu's step: no augmentation in its
    # compiled graph, the dropout mask drawn from the step's key
    f32 = {'data': rng.randn(B, SCALE[1], SCALE[0], 3).astype(
               np.float32) * 50,
           'labels_int32': labels, 'labels_oh': oh}
    key = jax.random.PRNGKey(5)
    mask = np.asarray(jax.random.bernoulli(
        key, 0.8, (B, jm.num_combos, jm.head_spec['bpm_dim'])))
    common = {'cfg': CFG, 'params': params, 'state': state, 'lr': LR}
    steps = [
        {'batch': u8, 'seed': 3},                                   # full
        {'batch': u8, 'seed': 4, 'triplet_only': True,
         'opts': ['REID.CRM', 'False']},
        {'batch': f32, 'draws': {'dropout_mask': mask}},             # mesh
    ]
    workdir = tmp_path_factory.mktemp('dp')
    # the triplet-only step with a planted fault (its 1/world undone):
    # the gate of test_two_ranks_match_one_rank must refuse it
    planted = dict(steps[1], planted=True)
    ranks = Ranks('step', WORLD, str(workdir / 'two'), {
        'common': common,
        'steps': steps[:2] + [dict(steps[2], logs_only=True), planted]},
        timeout=150)
    # the one-rank reference in a process of its own, beside the ranks
    solo = Ranks('step_one', 1, str(workdir / 'one'),
                 {'common': common, 'steps': steps}, timeout=150, threads=2)
    try:
        cfg, jm = _jax_model()
        mesh = jmesh.build_mesh(cfg, devices=jax.devices()[:WORLD],
                                mesh_shape=(WORLD, 1))
        step = jts.make_train_step(jm, cfg, mesh,
                                   meta=jopt.make_param_meta(params, cfg),
                                   donate=False)
        with mesh:
            ts = jts.place_train_state(
                mesh, {'params': params, 'state': state,
                       'opt': jopt.init_opt_state(params)})
            _, logs = step(ts, jts.shard_batch(mesh, f32), jnp.float32(LR),
                           jnp.float32(1.0), key)
        mesh_loss = float(logs['loss'])
        two = ranks.results()
        one = solo.results()[0]
    finally:
        ranks.kill()
        solo.kill()
        shutil.rmtree(str(workdir), ignore_errors=True)
    return {'one': one, 'two': two, 'mesh_loss': mesh_loss,
            'params': params}


def test_loss_matches_pps_tpu_two_device_mesh(runs):
    got = runs['two'][0][2]['logs']['loss']
    assert got == pytest.approx(runs['mesh_loss'], rel=MESH_LOSS_RTOL)
    # and every rank logs the global value
    assert runs['two'][1][2]['logs']['loss'] == pytest.approx(got,
                                                              rel=1e-7)


@pytest.mark.parametrize('case', [0, 1, 2], ids=['full', 'triplet_only',
                                                 'host_chain'])
def test_two_ranks_match_one_rank_logs(runs, case):
    one, two = runs['one'][case], runs['two'][0][case]
    assert sorted(two['logs']) == sorted(one['logs'])
    for k, want in one['logs'].items():
        assert two['logs'][k] == pytest.approx(want, rel=LOSS_RTOL,
                                               abs=1e-6), k


def _assert_updates_close(two, one, start):
    """The updates: the displacement and the momentum; a doubled gradient
    (a gather whose backward sums without the 1/world) doubles both."""
    _assert_trees_close(
        {k: v - start[k] for k, v in _jax_layout(two['params']).items()},
        {k: v - start[k] for k, v in _jax_layout(one['params']).items()},
        E2E_REL, FLOOR)
    _assert_trees_close(_jax_layout(two['momentum']),
                        _jax_layout(one['momentum']), E2E_REL, FLOOR)


@pytest.mark.parametrize('case', [0, 1], ids=['full', 'triplet_only'])
def test_two_ranks_match_one_rank(runs, case):
    one, two = runs['one'][case], runs['two'][0][case]
    _assert_updates_close(two, one, runs['params'])
    _assert_trees_close(two['state'], one['state'], STATE_REL)


def test_triplet_gate_refuses_a_doubled_gradient(runs):
    """The planted fault (the triplet term's 1/world undone) fails the
    triplet-only comparison of test_two_ranks_match_one_rank."""
    with pytest.raises(AssertionError, match='rms err'):
        _assert_updates_close(runs['two'][0][3], runs['one'][1],
                              runs['params'])


def test_every_rank_holds_the_same_state(runs):
    for case in range(2):
        rank0 = runs['two'][0][case]['params']
        digest = runs['two'][1][case]['digest']
        for k, v in rank0.items():
            assert digest[k] == float(np.sum(v, dtype=np.float64)), k


def test_ranks_augmented_rows_are_the_one_rank_batch(runs):
    """The global draws sliced per rank: the ranks' augmented rows put
    together are the one-rank batch, bitwise."""
    for case in (0, 1):
        got = np.concatenate([runs['two'][r][case]['data']
                              for r in range(WORLD)])
        np.testing.assert_array_equal(got, runs['one'][case]['data'])


def _jax_layout(tree):
    return {k: (v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
            for k, v in tree.items()}
