"""Checkpoints cross between pps_tpu and the port bit for bit, in both
directions, preserved blobs included."""

import shutil

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _flagship_cfg
from pps_tpu.engine import checkpoint as jck
from pps_tpu.models.model import build_model as jbuild
from pps_tpu.utils.io import load_object as jload_object
from pps_tpu.utils.io import save_object as jsave_object
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine import checkpoint as tck
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.models.model import build_model as tbuild
from pps_tpu_torch.utils.io import load_object


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's checkpoints (~90 MB each, ~250 MB with momentum) are
    freed when it ends: pytest keeps every test's directory until the
    session ends, and the suite's later tests need that disk."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope='module')
def models():
    jcfg = _flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    jm = jbuild(jcfg)
    jp, js = jax.jit(jm.init)(jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    js = {k: (rng.randn(*np.shape(v)) * 0.1 if k.endswith('_rm')
              else rng.rand(*np.shape(v)) + 0.5).astype(np.float32)
          for k, v in js.items()}
    tcfg_ = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    tm = tbuild(tcfg_, device='cpu')
    return jm, jp, js, tm


def _zeros_like(tree):
    return {k: np.zeros_like(v) for k, v in tree.items()}


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_params_from_numpy_layout(models):
    jm, jp, js, tm = models
    tp, ts = tck.params_from_numpy(tm, jp, js)
    assert tp['conv1_w'].shape == (64, 3, 7, 7)           # OIHW
    assert tp['pps_conv_w'].shape == jp['pps_conv_w'].shape  # [R, C, D]
    assert tp['crm_fc8c_w'].shape == jp['crm_fc8c_w'].shape  # [D, K]
    np.testing.assert_array_equal(
        tp['res3_0_branch2b_w'].numpy(),
        jp['res3_0_branch2b_w'].transpose(3, 2, 0, 1))
    _assert_trees_equal(ts, js)
    # the port's own init draws the same names and shapes
    ip, is_ = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in ip.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert sorted(is_) == sorted(ts)


def test_jax_save_port_load_bitwise(models, tmp_path):
    jm, jp, js, tm = models
    path = str(tmp_path / 'jax.pkl')
    jck.save_checkpoint(path, jm, jp, js)
    p0, s0 = tm.init(torch.Generator().manual_seed(1))
    tp, ts, _ = tck.load_checkpoint(path, tm, p0, s0)
    want_p, want_s = tck.params_from_numpy(tm, jp, js)
    _assert_trees_equal(tp, want_p)
    _assert_trees_equal(ts, want_s)
    assert tm._preserved_blobs == {}


def test_port_save_jax_load_bitwise(models, tmp_path):
    jm, jp, js, tm = models
    tp, ts = tck.params_from_numpy(tm, jp, js)
    path = str(tmp_path / 'port.pkl')
    tck.save_checkpoint(path, tm, tp, ts, cfg=tm.cfg)
    jp0, js0 = _zeros_like(jp), _zeros_like(js)
    lp, ls, _ = jck.load_checkpoint(path, jm, jp0, js0)
    _assert_trees_equal(lp, jp)
    _assert_trees_equal(ls, js)
    # the blob dicts are the same on both sides, name by name
    want = jck.params_to_blobs(jm, jp, js)
    got = load_object(path)
    _assert_trees_equal(got['blobs'], want)
    assert 'REID' in got['cfg']


def test_preserved_blobs_survive_round_trip(models, tmp_path):
    jm, jp, js, tm = models
    src = str(tmp_path / 'src.pkl')
    jck.save_checkpoint(src, jm, jp, js)
    payload = jload_object(src)
    extra = np.arange(6, dtype=np.float32).reshape(2, 3)
    payload['blobs']['aux_unused_w'] = extra
    payload['blobs']['res2_0_branch2a_w_momentum'] = np.zeros(1, np.float32)
    jsave_object(payload, src)

    p0, s0 = tm.init(torch.Generator().manual_seed(1))
    tp, ts, _ = tck.load_checkpoint(src, tm, p0, s0)
    assert list(tm._preserved_blobs) == ['aux_unused_w']
    mid = str(tmp_path / 'mid.pkl')
    tck.save_checkpoint(mid, tm, tp, ts)
    blobs = load_object(mid)['blobs']
    np.testing.assert_array_equal(blobs['aux_unused_w'], extra)
    assert 'res2_0_branch2a_w_momentum' not in blobs

    # and the JAX package keeps it on its next save
    jp0, js0 = _zeros_like(jp), _zeros_like(js)
    lp, ls, _ = jck.load_checkpoint(mid, jm, jp0, js0)
    out = str(tmp_path / 'out.pkl')
    jck.save_checkpoint(out, jm, lp, ls)
    np.testing.assert_array_equal(jload_object(out)['blobs']['aux_unused_w'],
                                  extra)


def test_partial_load_keeps_other_values(models, tmp_path):
    """A backbone-only pkl (the ImageNet bootstrap case) loads by name;
    the head keeps its current values."""
    jm, jp, js, tm = models
    blobs = jck.params_to_blobs(jm, jp, js)
    body = {k: v for k, v in blobs.items() if k.startswith(('conv1', 'res'))}
    path = str(tmp_path / 'body.pkl')
    jsave_object({'blobs': body}, path)
    p0, s0 = tm.init(torch.Generator().manual_seed(1))
    tp, ts, _ = tck.load_checkpoint(path, tm, p0, s0)
    np.testing.assert_array_equal(tp['conv1_w'].numpy(), body['conv1_w'])
    assert torch.equal(tp['pps_conv_w'], p0['pps_conv_w'])


def test_shape_mismatch_raises(models):
    jm, jp, js, tm = models
    p0, s0 = tm.init(torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match='Shape mismatch'):
        tck.blobs_to_params(tm, {'conv1_w': np.zeros((2, 2), np.float32)},
                            p0, s0)


def _jax_momentum(jp, seed=6):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*np.shape(v)).astype(np.float32)
            for k, v in jp.items()}


def test_momentum_port_save_jax_load_bitwise(models, tmp_path):
    jm, jp, js, tm = models
    jopt = {'momentum': _jax_momentum(jp)}
    tp, ts, topt = tck.params_from_numpy(tm, jp, js, jopt)
    path = str(tmp_path / 'port_mom.pkl')
    tck.save_checkpoint(path, tm, tp, ts, opt_state=topt)
    blobs = load_object(path)['blobs']
    assert 'pps01234_conv_w_momentum' in blobs
    assert 'conv1_w_momentum' in blobs and 'crm_fc8c_w_momentum' in blobs
    zeros = {'momentum': _zeros_like(jp)}
    lp, ls, lopt = jck.load_checkpoint(path, jm, _zeros_like(jp),
                                       _zeros_like(js), opt_state=zeros)
    _assert_trees_equal(lp, jp)
    _assert_trees_equal(ls, js)
    _assert_trees_equal(lopt['momentum'], jopt['momentum'])


def test_momentum_jax_save_port_load_bitwise(models, tmp_path):
    jm, jp, js, tm = models
    jopt = {'momentum': _jax_momentum(jp, seed=7)}
    path = str(tmp_path / 'jax_mom.pkl')
    jck.save_checkpoint(path, jm, jp, js, opt_state=jopt)
    p0, s0 = tm.init(torch.Generator().manual_seed(1))
    o0 = {'momentum': {k: torch.zeros_like(v) for k, v in p0.items()}}
    tp, ts, topt = tck.load_checkpoint(path, tm, p0, s0, opt_state=o0)
    want_p, want_s, want_o = tck.params_from_numpy(tm, jp, js, jopt)
    _assert_trees_equal(tp, want_p)
    _assert_trees_equal(ts, want_s)
    _assert_trees_equal(topt['momentum'], want_o['momentum'])
    # without an opt_state the momentum blobs are skipped, never preserved
    _, _, none = tck.load_checkpoint(path, tm, p0, s0)
    assert none is None and tm._preserved_blobs == {}


def test_params_from_numpy_carries_the_iter_opt_state(models):
    jm, jp, js, tm = models
    jopt = {'momentum': _jax_momentum(jp), 'acmgrad': _jax_momentum(jp, 8),
            'count': np.int32(5)}
    _, _, topt = tck.params_from_numpy(tm, jp, js, jopt)
    assert topt['count'].dtype == torch.int32 and int(topt['count']) == 5
    assert topt['acmgrad']['conv1_w'].shape == (64, 3, 7, 7)  # OIHW
    np.testing.assert_array_equal(
        topt['momentum']['res2_0_branch2b_w'].numpy(),
        jopt['momentum']['res2_0_branch2b_w'].transpose(3, 2, 0, 1))
