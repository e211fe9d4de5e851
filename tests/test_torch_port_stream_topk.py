"""The port's chunked top-k scan (``ops/topk.streaming_topk``) against
pps_tpu's on the same numpy-seeded inputs.

Tolerances.  Both sides form d^2 = |q|^2 + |g|^2 - 2 q.g in float32 with
the products summed in other orders, so squared distances of O(1) agree
to a few ulps (``DIST2_ATOL``).  Indices must be equal wherever the
reference's neighbouring distances differ by more than ``TIE_EPS``;
inside a closer pair the order can flip with the rounding.  Where rows
are exact duplicates both sides compute bit-equal distances for them, and
the lowest index must come first, so indices are held exactly there.
"""

import numpy as np
import pytest
import torch

from pps_tpu.ops import topk as jtopk
from pps_tpu_torch.ops import topk as ttopk

DIST2_ATOL = 1e-5
TIE_EPS = 1e-5


def _unit(n, d, seed):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def assert_same_topk(got_d, got_i, want_d, want_i, eps=TIE_EPS):
    """Indices equal wherever the reference's neighbouring distances
    differ by more than ``eps``; squared distances within DIST2_ATOL;
    the -1/inf slots equal.  Returns the share of the finite slots that
    were held index for index."""
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    assert got_i.shape == want_i.shape
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want_d))
    np.testing.assert_array_equal(got_i == -1, want_i == -1)
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin] ** 2, want_d[fin] ** 2,
                               rtol=0, atol=DIST2_ATOL)
    gap = np.diff(np.where(fin, want_d, 1e30), axis=1)
    clear = np.ones(want_d.shape, bool)
    clear[:, 1:] &= gap > eps
    clear[:, :-1] &= gap > eps
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
    return clear[fin].mean()


def _run(q, g, k, chunk, g_scale=None, **kw):
    want = jtopk.streaming_topk(q, g, k=k, chunk=chunk, g_scale=g_scale,
                                **kw)
    got = ttopk.streaming_topk(
        torch.tensor(q), torch.tensor(g), k=k, chunk=chunk,
        g_scale=None if g_scale is None else torch.tensor(g_scale), **kw)
    assert got[1].dtype == torch.int32
    return got, want


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('k,chunk', [(10, 64), (7, 1000), (33, 50)])
def test_streaming_matches_pps_tpu(int8, k, chunk):
    g = _unit(700, 48, 0)
    q = _unit(19, 48, 1)
    g_scale = None
    if int8:
        g, g_scale = jtopk.quantize_gallery(g)
        g, g_scale = np.asarray(g), np.asarray(g_scale)
    got, want = _run(q, g, k, chunk, g_scale)
    assert assert_same_topk(*got, *want) > 0.99


@pytest.mark.parametrize('int8', [False, True])
def test_n_valid_and_index_offset(int8):
    g = _unit(300, 32, 2)
    q = _unit(6, 32, 3)
    g_scale = None
    if int8:
        g, g_scale = (np.asarray(a) for a in jtopk.quantize_gallery(g))
    # fewer valid rows than k: the unfilled slots are -1 / inf
    for n_valid, k in ((250, 10), (4, 9)):
        got, want = _run(q, g, k, 64, g_scale, n_valid=n_valid,
                         index_offset=1000)
        assert_same_topk(*got, *want)
        i = got[1].numpy()
        assert ((i == -1) | ((i >= 1000) & (i < 1000 + n_valid))).all()
    assert (got[1].numpy()[:, 4:] == -1).all()
    assert np.isinf(got[0].numpy()[:, 4:]).all()


@pytest.mark.parametrize('k,chunk', [(64, 64), (100, 16), (300, 128)])
def test_k_at_least_chunk(k, chunk):
    """k >= chunk keeps k of (k + chunk) candidates per merge; k larger
    than the gallery is clamped to it."""
    g = _unit(200, 16, 4)
    q = _unit(5, 16, 5)
    got, want = _run(q, g, k, chunk)
    assert got[1].shape == (5, min(k, 200))
    assert_same_topk(*got, *want)


def test_recall_target_equals_exact():
    """JAX routes recall_target through lax.approx_min_k, exact off a TPU;
    the port's selection is exact, so both equal the exact scan."""
    g = _unit(500, 32, 6)
    q = _unit(8, 32, 7)
    exact = ttopk.streaming_topk(torch.tensor(q), torch.tensor(g), k=20,
                                 chunk=128)
    got, want = _run(q, g, 20, 128, recall_target=0.95)
    for a, b in zip(got, exact):
        assert torch.equal(a, b)
    assert_same_topk(*got, *want)
    with pytest.raises(ValueError, match='recall_target'):
        ttopk.streaming_topk(torch.tensor(q), torch.tensor(g), k=5,
                             recall_target=1.5)


@pytest.mark.parametrize('int8', [False, True])
def test_duplicate_rows_lowest_index_first(int8):
    """Exact duplicates (ties) across and inside chunks: the lowest
    index first, on both sides, index for index."""
    g = _unit(120, 24, 8)
    g[[7, 40, 41, 95, 119]] = g[3]
    g[[60, 61]] = g[20]
    q = np.stack([g[3], g[20], g[3] + 1e-3]).astype(np.float32)
    g_scale = None
    if int8:
        g, g_scale = (np.asarray(a) for a in jtopk.quantize_gallery(g))
    got, want = _run(q, g, 8, 32, g_scale)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy()[0, :6],
                                  [3, 7, 40, 41, 95, 119])
    np.testing.assert_array_equal(got[1].numpy()[1, :3], [20, 60, 61])


def test_streaming_equals_flat():
    """The two exact routes of the index agree (the flat route's int8
    product is the hi/lo split, the scan dequantizes per chunk)."""
    g = _unit(900, 40, 9)
    q = _unit(12, 40, 10)
    g8, s = ttopk.quantize_gallery(torch.tensor(g))
    for gg, ss in ((torch.tensor(g), None), (g8, s)):
        sd, si = ttopk.streaming_topk(torch.tensor(q), gg, k=25, chunk=100,
                                      g_scale=ss)
        fd, fi = ttopk.flat_topk(torch.tensor(q), gg, k=25, g_scale=ss)
        assert_same_topk(sd, si, fd, fi)


def test_keys_order_distance_then_index():
    d2 = torch.tensor([[0.5, -1e-7, 0.0, -0.0, 0.5, float('inf'), 0.25]])
    idx = torch.arange(7)[None, :]
    keys = ttopk.sq_keys(d2, idx)
    top = ttopk.merge_keys(None, keys, 7)
    np.testing.assert_array_equal(ttopk.key_index(top).numpy()[0],
                                  [1, 2, 3, 6, 0, 4, 5])
    got = ttopk.key_dist2(top).numpy()[0]
    np.testing.assert_array_equal(got, [0, 0, 0, 0.25, 0.5, 0.5, np.inf])
    assert not np.signbit(got).any()   # negatives and -0.0 clamp to +0.0


def test_quantize_tensor_and_numpy_same_bytes():
    g = _unit(64, 33, 11) * 3.0
    g[5] = 0.0
    a8, a_s = ttopk.quantize_gallery(g)
    b8, b_s = ttopk.quantize_gallery(torch.tensor(g))
    j8, j_s = jtopk.quantize_gallery(g)
    np.testing.assert_array_equal(b8.numpy(), a8)
    np.testing.assert_array_equal(b_s.numpy(), a_s)
    np.testing.assert_array_equal(a8, np.asarray(j8))
    np.testing.assert_array_equal(a_s, np.asarray(j_s))
    with pytest.raises(TypeError, match='int8'):
        ttopk.streaming_topk(torch.tensor(g), torch.tensor(g), k=3,
                             g_scale=b_s)
