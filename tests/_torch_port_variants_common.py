"""Shared set-up of the port's model-variant tests: a yaml cut to a test
size on both sides, weights made with numpy from a seed, and both
packages' extraction and training forward on them.

The JAX package's cfg is one global object, reset around every test by
``tests/conftest.py``, and the port's is reset by each test module, so a
model is used inside the function that builds it.  A test module imports
the fixtures ``_two_threads`` and ``tmp_path`` from here to use them."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pps_tpu import config as jcfg
from pps_tpu.models.model import build_model as jbuild
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.models.model import build_model as tbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = (32, 96)          # (width, height)
NUM_CLASSES = 11
P, K = 4, 2
B = P * K


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads: the suite runs six workers on one host, and
    each worker's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's files (R-50 pkls of ~100 MB) are freed when it ends:
    pytest keeps every test's directory until the session ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def cut(dtype='float32', extra=()):
    """The test-size overrides merged after a yaml."""
    return ['MODEL.NUM_CLASSES', str(NUM_CLASSES),
            'REID.SCALE', str(SCALE), 'MODEL.DTYPE', dtype,
            'TRAIN.IMS_PER_BATCH', str(B), 'REID.P', str(P), 'REID.K', str(K),
            'TRAIN.WEIGHTS', ''] + list(extra)


def yaml_path(name):
    return os.path.join(ROOT, 'configs', name + '.yaml')


def jax_model(yaml=None, opts=()):
    """The JAX package's model of ``yaml`` (a name under configs/) with
    ``opts`` merged after it."""
    jcfg.reset_cfg()
    if yaml:
        jcfg.merge_cfg_from_file(yaml_path(yaml))
    jcfg.merge_cfg_from_list(list(opts))
    jcfg.assert_and_infer_cfg(make_immutable=False)
    return jbuild(jcfg.cfg)


def port_model(yaml=None, opts=()):
    """The port's model of the same, on the CPU."""
    tcfg.reset_cfg()
    if yaml:
        tcfg.merge_cfg_from_file(yaml_path(yaml))
    tcfg.merge_cfg_from_list(list(opts))
    tcfg.assert_and_infer_cfg(make_immutable=False)
    return tbuild(tcfg.cfg, device='cpu')


def numpy_params(jm, seed=0, gamma=1.0):
    """(params, state) in the JAX package's layout, made with numpy: conv
    weights at their init's scale, scales 1 (``gamma`` on each residual
    branch's last norm), biases ~N(0, 0.05), running means ~N(0, 0.1),
    variances in [0.5, 1.5)."""
    shapes, state_shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = {}
    for k in sorted(shapes):
        shape = shapes[k].shape
        if k.endswith('_w'):
            if len(shape) == 4:  # HWIO
                std = np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
                a = rng.randn(*shape) * std
            elif k.endswith('_fc_w') and len(shape) == 3:
                a = rng.randn(*shape) * 0.001
            elif len(shape) == 3:  # stacked head conv [R, C, D]
                a = rng.randn(*shape) * np.sqrt(2.0 / shape[2])
            else:  # FPN [C_in, C_out], CRM [D, K]: Xavier
                lim = np.sqrt(3.0 / shape[0])
                a = rng.uniform(-lim, lim, shape)
        elif k.endswith('_s'):
            a = np.ones(shape) * (gamma if '_branch2c_' in k else 1.0)
        elif k.endswith('_b'):
            a = rng.randn(*shape) * 0.05
        else:
            raise AssertionError('unexpected param {}'.format(k))
        params[k] = a.astype(np.float32)
    state = {}
    for k in sorted(state_shapes):
        shape = state_shapes[k].shape
        state[k] = (rng.randn(*shape) * 0.1 if k.endswith('_rm')
                    else rng.rand(*shape) + 0.5).astype(np.float32)
    return params, state


def images(n, seed):
    return np.random.RandomState(seed).randn(
        n, SCALE[1], SCALE[0], 3).astype(np.float32) * 50


def jax_extract(jm, params, state, x, op_by_op=False):
    """pps_tpu's extraction, jitted, or op by op: then models that share
    conv and norm shapes share their per-op compiles in one process."""
    fn = jm.extract_features if op_by_op else jax.jit(jm.extract_features)
    return np.asarray(fn(params, state, jnp.asarray(x)))


def port_extract(tm, params, state, x):
    """The port's extraction, ``params`` / ``state`` as numpy in the JAX
    package's layout or already the port's tensors."""
    if not torch.is_tensor(next(iter(params.values()))):
        params, state = params_from_numpy(tm, params, state)
    return tm.extract_features(params, state, torch.tensor(x)).numpy()


def labels_batch():
    labels = (np.repeat(np.arange(P), K) * 2 + 1).astype(np.int32)
    oh = np.zeros((B, NUM_CLASSES - 1), np.float32)
    oh[np.arange(B), labels] = 1.0
    return labels, oh


def jax_train(jm, params, state, x):
    """pps_tpu's ``train_forward`` and its gradient, op by op (not jitted:
    jitted as one graph on the CPU its gradient differs from its own op-by-
    op one; ROADMAP "Noted while porting").  Returns a dict of numpy
    results and the dropout mask it drew."""
    labels, oh = labels_batch()
    batch = {'data': jnp.asarray(x), 'labels_int32': jnp.asarray(labels),
             'labels_oh': jnp.asarray(oh)}
    rng = jax.random.PRNGKey(7)
    fn = jax.value_and_grad(jm.train_forward, has_aux=True)
    (total, (updates, logs)), grads = fn(params, state, batch, rng,
                                         jnp.float32(1.0))
    levels = jm.fpn_spec['fpn_num'] if jm.fpn_spec is not None else 1
    mask = np.asarray(jax.random.bernoulli(
        rng, 0.8, (B * levels, jm.num_combos, jm.head_spec['bpm_dim'])))
    return {'total': float(total), 'mask': mask,
            'updates': {k: np.asarray(v) for k, v in updates.items()},
            'logs': {k: float(v) for k, v in logs.items()},
            'grads': {k: np.asarray(v) for k, v in grads.items()}}


def _jax_layout(name, t):
    a = t.detach().cpu().numpy()
    if a.ndim == 4 and name.endswith('_w'):
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return a


def port_train(tm, params, state, x, mask):
    """The port's ``train_forward`` and its gradient on the same weights,
    batch and dropout mask (results in the JAX package's layout; a param
    the loss does not reach gets a zero gradient)."""
    labels, oh = labels_batch()
    p, s = params_from_numpy(tm, params, state)
    with torch.enable_grad():
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        batch = {'data': torch.tensor(x), 'labels_int32': torch.tensor(labels),
                 'labels_oh': torch.tensor(oh)}
        total, (updates, logs) = tm.train_forward(
            leaves, s, batch, None, 1.0, dropout_mask=torch.tensor(mask))
        names = sorted(leaves)
        grads = torch.autograd.grad(total, [leaves[k] for k in names],
                                    allow_unused=True)
    grads = [torch.zeros_like(p[k]) if g is None else g
             for k, g in zip(names, grads)]
    return {'total': float(total.detach()),
            'updates': {k: v.detach().numpy() for k, v in updates.items()},
            'logs': {k: float(v.detach()) for k, v in logs.items()},
            'grads': {k: _jax_layout(k, g) for k, g in zip(names, grads)}}


def rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def assert_trees_close(got, want, rel, floor=0.0):
    """Per tensor: RMS(got - want) <= rel * RMS(want) + floor * the RMS over
    all of ``want`` (the floor covers tensors that are zero by an
    invariance, e.g. a bias ahead of a batch-stat BN)."""
    assert sorted(got) == sorted(want)
    total = sum(np.size(w) for w in want.values())
    rms_all = float(np.sqrt(sum(np.sum(np.square(w, dtype=np.float64))
                                for w in want.values()) / total))
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = rms(got[k] - w)
        assert err <= rel * rms(w) + floor * rms_all, \
            '{}: rms err {} vs rms {}'.format(k, err, rms(w))
