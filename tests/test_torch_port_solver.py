"""The port's solver against pps_tpu's: the LR policies, the param LR
groups, ``sgd_update`` in all three flavors, the trainable pass-through
and ``correct_momentum``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from pps_tpu.solver import lr_policy as jlr
from pps_tpu.solver import optimizer as jopt
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.solver import lr_policy as tlr
from pps_tpu_torch.solver import optimizer as topt

# one update of float32 values on both sides: products and sums of three
# terms, rounded in the same order up to FMA contraction
RTOL, ATOL = 1e-6, 1e-8

NAMES = ('conv1_w', 'res2_0_branch2a_bn_b', 'res3_1_branch2b_w',
         'pps_conv_w', 'pps_conv_b', 'pps_fc_w', 'pps_fc_b', 'crm_fc8c_w',
         'crm_fc8d_b', 'res_conv1_bn_s')


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _cfgs(opts=()):
    """The flagship cfg on both sides, with the same overrides."""
    jc = _flagship_cfg(scale=(32, 96), num_classes=11)
    tc = flagship_cfg(scale=(32, 96), num_classes=11)
    for c in (jc, tc):
        c.immutable(False)
        for key, value in opts:
            node = c
            *path, leaf = key.split('.')
            for p in path:
                node = node[p]
            node[leaf] = value
        c.immutable(True)
    return jc, tc


@pytest.mark.parametrize('opts', [
    (('SOLVER.LR_POLICY', 'steps_with_decay'), ('SOLVER.STEPS', [0, 3, 6]),
     ('SOLVER.MAX_ITER', 10), ('SOLVER.WARM_UP_ITERS', 2)),
    (('SOLVER.LR_POLICY', 'steps_with_lrs'), ('SOLVER.STEPS', [0, 4]),
     ('SOLVER.LRS', [0.1, 0.01]), ('SOLVER.MAX_ITER', 10),
     ('SOLVER.WARM_UP_METHOD', 'constant')),
    (('SOLVER.LR_POLICY', 'step'), ('SOLVER.STEP_SIZE', 3),
     ('SOLVER.WARM_UP_ITERS', 0)),
    (('SOLVER.LR_POLICY', 'cosine_decay'), ('SOLVER.MAX_ITER', 9)),
    (('SOLVER.LR_POLICY', 'exp_decay'), ('SOLVER.MAX_ITER', 9),
     ('SOLVER.GAMMA', 0.5)),
])
def test_lr_policy_values_equal(opts):
    jc, tc = _cfgs(opts)
    for ep in range(9):
        for it in (0, 7, 40):
            want = jlr.get_lr_at_iter(jc, it, ep, 20)
            got = tlr.get_lr_at_iter(tc, it, ep, 20)
            assert got == want and got.dtype == np.float32, (ep, it)


def test_unknown_lr_policy_raises():
    _, tc = _cfgs((('SOLVER.LR_POLICY', 'nope'),))
    with pytest.raises(NotImplementedError):
        tlr.get_lr_at_iter(tc, 0, 0, 1)


def _tree(seed, shapes):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _shapes():
    return {k: (3, 4) if k.endswith('_w') else (4,) for k in NAMES}


def test_param_groups_equal():
    jc, tc = _cfgs()
    params = _tree(0, _shapes())
    assert topt.make_param_meta(params, tc) == jopt.make_param_meta(params,
                                                                    jc)
    for name in NAMES + ('fpn_inner_w', 'bpm0_fc_b'):
        assert topt.classify_param(name, 10.0, 20.0) == \
            jopt.classify_param(name, 10.0, 20.0)


@pytest.mark.parametrize('flavor,iter_size,num_devices', [
    ('standard', 1, 1), ('pt', 1, 1), ('iter', 2, 1), ('iter', 3, 2)])
@pytest.mark.parametrize('frozen', [False, True])
def test_sgd_update_matches(flavor, iter_size, num_devices, frozen):
    jc, tc = _cfgs()
    params = _tree(1, _shapes())
    meta = jopt.make_param_meta(params, jc)
    trainable = ({k: not k.startswith(('conv1', 'res2_')) for k in params}
                 if frozen else None)
    jstate = jopt.init_opt_state(params, flavor, iter_size)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = topt.init_opt_state(tp, flavor, iter_size)
    jp = params
    for step in range(2 * iter_size):
        grads = _tree(10 + step, _shapes())
        lr = 0.01 * (step + 1)
        jp, jstate = jopt.sgd_update(jp, grads, jstate, jnp.float32(lr),
                                     meta, momentum=0.9, flavor=flavor,
                                     iter_size=iter_size,
                                     num_devices=num_devices,
                                     trainable=trainable)
        before = dict(tp), {k: v for k, v in tstate['momentum'].items()}
        tp, tstate = topt.sgd_update(
            tp, {k: torch.tensor(v) for k, v in grads.items()}, tstate, lr,
            topt.make_param_meta(tp, tc), momentum=0.9, flavor=flavor,
            iter_size=iter_size, num_devices=num_devices,
            trainable=trainable)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
            np.testing.assert_allclose(
                tstate['momentum'][k].numpy(),
                np.asarray(jstate['momentum'][k]), rtol=RTOL, atol=ATOL,
                err_msg=k)
            if trainable is not None and not trainable[k]:
                # frozen: the very same tensors pass through
                assert tp[k] is before[0][k]
                assert tstate['momentum'][k] is before[1][k]
        if flavor == 'iter':
            assert int(tstate['count']) == int(jstate['count'])
            for k in params:
                np.testing.assert_allclose(
                    tstate['acmgrad'][k].numpy(),
                    np.asarray(jstate['acmgrad'][k]), rtol=RTOL, atol=ATOL)


def test_sgd_update_leaves_inputs_and_takes_tensor_lr():
    _, tc = _cfgs()
    params = {k: torch.tensor(v) for k, v in _tree(2, _shapes()).items()}
    grads = {k: torch.tensor(v) for k, v in _tree(3, _shapes()).items()}
    copy = {k: v.clone() for k, v in params.items()}
    state = topt.init_opt_state(params)
    meta = topt.make_param_meta(params, tc)
    a, sa = topt.sgd_update(params, grads, state, 0.05, meta)
    b, sb = topt.sgd_update(params, grads, state, torch.tensor(0.05), meta)
    for k in params:
        assert torch.equal(params[k], copy[k])
        assert not state['momentum'][k].any()
        assert torch.equal(a[k], b[k])
        assert not a[k].requires_grad


def test_correct_momentum_and_lr_change_ratio():
    mom = _tree(4, _shapes())
    want = jopt.correct_momentum({'momentum': mom}, 0.1)
    got = topt.correct_momentum(
        {'momentum': {k: torch.tensor(v) for k, v in mom.items()}}, 0.1)
    for k in mom:
        np.testing.assert_allclose(got['momentum'][k].numpy(),
                                   np.asarray(want['momentum'][k]),
                                   rtol=RTOL)
    for a, b in ((0.01, 0.001), (0.001, 0.01), (0.0, 0.0)):
        assert topt.get_lr_change_ratio(a, b) == \
            jopt.get_lr_change_ratio(a, b)


@pytest.mark.parametrize('opts', [
    (), (('TRAIN.FREEZE_AT', 2),), (('TRAIN.FREEZE_AT', 5),),
    (('TRAIN.FREEZE_CONV_BODY', True),)])
def test_trainable_and_flavor_from_cfg_equal(opts):
    jc, tc = _cfgs(opts)
    params = _tree(5, _shapes())
    assert topt.trainable_from_cfg(tc, params) == \
        jopt.trainable_from_cfg(jc, params)
    assert topt.flavor_from_cfg(tc) == jopt.flavor_from_cfg(jc)
