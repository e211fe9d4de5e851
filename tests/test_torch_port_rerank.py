"""k-reciprocal re-ranking of the port (``evaluation/rerank.py``, the C++
engine ``native.py`` + ``csrc/rerank.cc`` and the evaluator's re-ranked
blocks) against pps_tpu's on the same numpy-seeded inputs.

Tolerances.
* numpy ``re_ranking``: a copy of pps_tpu's, so bitwise.
* the C++ engine against numpy: the same algorithm with sums in another
  order (sparse rows, OpenMP), within ``NATIVE_ATOL`` (1e-5).
* the card formulation ``rerank_distmat_device`` (run here on the CPU)
  against pps_tpu's ``rerank_distmat_jax`` and against numpy: entries
  agree to float32 rounding except where a k-th-neighbour distance is a
  near-tie and set membership flips; the JAX docstring reports ~0.1% of
  entries.  The rule: at most ``FLIP_SHARE`` (0.5%) of the entries apart
  by more than ``ENTRY_ATOL`` (1e-5), and the rest within it.
* the evaluator's result dicts: within ``METRIC_ATOL`` (1e-6) of
  pps_tpu's.  pps_tpu's evaluator is run with its C++ engine switched off
  (its numpy path), so no test here builds or loads pps_tpu's library.
"""

import os

import numpy as np
import pytest
import torch

import pps_tpu.native
from pps_tpu.evaluation import evaluator as jeval
from pps_tpu.evaluation import rerank as jrr
from pps_tpu_torch import native as tnative
from pps_tpu_torch.evaluation import evaluator as teval
from pps_tpu_torch.evaluation import rerank as trr
from pps_tpu_torch.evaluation.metrics import compute_dist
from pps_tpu_torch.kernels import build

NATIVE_ATOL = 1e-5
ENTRY_ATOL = 1e-5
FLIP_SHARE = 0.005
METRIC_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _no_pps_tpu_native(monkeypatch):
    monkeypatch.setattr(pps_tpu.native, 'available', lambda: False)


def _feats(seed, n, d=24, n_ids=12, noise=0.7):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_ids, d)
    f = centers[rng.randint(0, n_ids, n)] + noise * rng.randn(n, d)
    f = f.astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _dists(seed, nq=30, ng=120):
    f = _feats(seed, nq + ng)
    q, g = f[:nq], f[nq:]
    return compute_dist(q, g), compute_dist(q, q), compute_dist(g, g)


def assert_near_tie_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    far = np.abs(got - want) > ENTRY_ATOL
    assert far.mean() <= FLIP_SHARE, far.mean()


@pytest.mark.parametrize('seed', [0, 1])
def test_numpy_re_ranking_bitwise(seed):
    qg, qq, gg = _dists(seed)
    np.testing.assert_array_equal(trr.re_ranking(qg, qq, gg),
                                  jrr.re_ranking(qg, qq, gg))
    np.testing.assert_array_equal(
        trr.re_ranking(qg, qq, gg, k1=7, k2=1, lambda_value=0.5),
        jrr.re_ranking(qg, qq, gg, k1=7, k2=1, lambda_value=0.5))


@pytest.mark.parametrize('k1,k2,lam', [(20, 6, 0.3), (10, 3, 0.5),
                                       (6, 1, 0.2)])
def test_native_engine_matches_numpy(k1, k2, lam):
    qg, qq, gg = _dists(2)
    want = trr.re_ranking(qg, qq, gg, k1=k1, k2=k2, lambda_value=lam)
    got = tnative.rerank_native(qg, qq, gg, k1=k1, k2=k2, lambda_value=lam)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=NATIVE_ATOL)
    # by engine name: 'auto' is the C++ engine, 'numpy' the golden path
    np.testing.assert_array_equal(
        tnative.rerank(qg, qq, gg, k1=k1, k2=k2, lambda_value=lam), got)
    np.testing.assert_array_equal(
        tnative.rerank(qg, qq, gg, k1=k1, k2=k2, lambda_value=lam,
                       engine='numpy'), want)
    with pytest.raises(ValueError, match='engine'):
        tnative.rerank(qg, qq, gg, engine='fast')


@pytest.mark.parametrize('nq,ng', [(1, 2), (3, 5), (4, 8), (7, 19)])
def test_tiny_sets_clamp(nq, ng):
    """Sets smaller than k1 + 1: every engine clamps the neighbourhoods
    to the set, as the numpy slices do."""
    f = _feats(nq * 100 + ng, nq + ng, d=16)
    qg = compute_dist(f[:nq], f[nq:])
    qq = compute_dist(f[:nq], f[:nq])
    gg = compute_dist(f[nq:], f[nq:])
    want = trr.re_ranking(qg, qq, gg)
    np.testing.assert_allclose(tnative.rerank_native(qg, qq, gg), want,
                               rtol=0, atol=NATIVE_ATOL)
    got = trr.rerank_distmat_device(qg, qq, gg, device='cpu')
    assert got.shape == (nq, ng)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENTRY_ATOL)


@pytest.mark.parametrize('seed,k1,k2', [(3, 20, 6), (4, 20, 6), (5, 8, 3),
                                        (6, 5, 1)])
def test_device_formulation_matches_pps_tpu(seed, k1, k2):
    qg, qq, gg = _dists(seed, nq=40, ng=200)
    want = np.asarray(jrr.rerank_distmat_jax(qg, qq, gg, k1=k1, k2=k2))
    got = trr.rerank_distmat_device(torch.tensor(qg), torch.tensor(qq),
                                    torch.tensor(gg), k1=k1, k2=k2)
    assert got.dtype == torch.float32 and got.device.type == 'cpu'
    assert_near_tie_close(got.numpy(), want)
    assert_near_tie_close(got.numpy(),
                          trr.re_ranking(qg, qq, gg, k1=k1, k2=k2))


def test_device_formulation_duplicate_rows_stay_finite():
    """More exact duplicates than k1: a row tie-broken out of every
    neighbour list has an empty set and stays finite (no 0/0)."""
    f = _feats(7, 40, d=8)
    f[5:30] = f[4]
    qg = compute_dist(f[:10], f[10:])
    qq = compute_dist(f[:10], f[:10])
    gg = compute_dist(f[10:], f[10:])
    got = trr.rerank_distmat_device(qg, qq, gg, k1=6, device='cpu').numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jrr.rerank_distmat_jax(qg, qq, gg, k1=6))
    np.testing.assert_allclose(got, want, rtol=0, atol=ENTRY_ATOL)


def _eval_set(seed, with_mq):
    rng = np.random.RandomState(seed)
    n_ids = 8
    centers = rng.randn(n_ids, 16) * 2
    ids, cams, marks, feats = [], [], [], []
    for pid in range(n_ids):
        for j in range(10):
            ids.append(pid + 1)
            cams.append(j % 3 + 1)
            marks.append(0 if j < 2 else (2 if with_mq and j >= 8 else 1))
            feats.append(centers[pid] + rng.randn(16) * 1.2)
    feats = np.stack(feats).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return feats, np.array(ids), np.array(cams), np.array(marks)


def _assert_dicts_close(got, want):
    assert sorted(got) == sorted(want)
    for block in want:
        for key in ('mAP', 'cmc1', 'cmc5', 'cmc10'):
            np.testing.assert_allclose(got[block][key], want[block][key],
                                       rtol=0, atol=METRIC_ATOL)
        np.testing.assert_allclose(got[block]['cmc'], want[block]['cmc'],
                                   rtol=0, atol=METRIC_ATOL)


@pytest.mark.parametrize('with_mq', [False, True])
@pytest.mark.parametrize('device', [False, True])
def test_evaluate_rerank_matches_pps_tpu(capsys, with_mq, device):
    """Single-query and multi-query re-ranked blocks: the port's host C++
    engine and its card formulation (on the CPU) against pps_tpu's numpy
    path and its card formulation."""
    feats, ids, cams, marks = _eval_set(0, with_mq)
    want = jeval.evaluate(feats, ids, cams, marks, to_re_rank=True,
                          device_rerank=device)
    want_out = capsys.readouterr().out
    got = teval.evaluate(feats, ids, cams, marks, to_re_rank=True,
                         device='cpu', device_rerank=device)
    got_out = capsys.readouterr().out
    blocks = ['single', 'single_rerank'] + (
        ['multi', 'multi_rerank'] if with_mq else [])
    assert sorted(got) == sorted(blocks)
    _assert_dicts_close(got, want)
    assert got_out == want_out
    assert 'Re-ranked Single Query:' in got_out
    assert ('Re-ranked Multi Query:' in got_out) == with_mq


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No host compiler -> a clear error, never a quiet numpy fallback."""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(tnative, '_LIB', None)
    monkeypatch.setattr(build, '_LIBS', {})
    monkeypatch.setattr(build, '_CXX', None)
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.delenv('CXX', raising=False)
    qg, qq, gg = _dists(0, nq=3, ng=9)
    with pytest.raises(RuntimeError, match='C\\+\\+ compiler'):
        tnative.rerank_native(qg, qq, gg)
    with pytest.raises(RuntimeError, match='C\\+\\+ compiler'):
        teval.evaluate(*_eval_set(0, False), to_re_rank=True)


def test_host_compiler_needs_openmp(monkeypatch, tmp_path):
    """A $CXX that cannot link OpenMP is passed over for the next one."""
    fake = tmp_path / 'bad-cxx'
    fake.write_text('#!/bin/sh\necho "cannot read spec file libgomp.spec" >&2\n'
                    'exit 1\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_CXX', None)
    monkeypatch.setenv('CXX', str(fake))
    found = build._host_cxx()
    assert found != str(fake) and os.path.basename(found) in ('c++', 'g++')
    monkeypatch.setattr(build, '_CXX', None)
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='libgomp.spec'):
        build._host_cxx()


def test_native_library_is_built_once_per_source(monkeypatch, tmp_path):
    """The host library goes to the build directory under a name hashed
    from the source and flags, written through a temporary name; a
    second build reuses it."""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    assert 'rerank' in build.sources()
    path = build.library_path('rerank')
    assert path.parent == tmp_path and path.name.startswith('rerank-')
    first = build.build_all(['rerank'])
    assert path.exists() and first['rerank']['seconds'] > 0
    assert build.build_all(['rerank'])['rerank']['seconds'] == 0.0
    assert sorted(p.name for p in tmp_path.glob('*.so*')) == [path.name]
