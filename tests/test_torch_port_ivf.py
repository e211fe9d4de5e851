"""The port's IVF (``ops/ivf.py``) against pps_tpu's on the same
numpy-seeded inputs.

Tolerances.  k-means starts from the same rows (the same RandomState
draws) and runs the same Lloyd steps; its products sum in other orders,
so centroids agree to float32 rounding (``CENT_ATOL``) on clustered data,
where no row sits near a cell boundary.  Assignments, the inverted file
and probe totals are integers and must be equal.  ``ivf_topk`` indices
are held with the near-tie rule of the streaming tests.
"""

import numpy as np
import pytest
import torch

from pps_tpu.ops import ivf as jivf
from pps_tpu.ops import topk as jtopk
from pps_tpu_torch.ops import ivf as tivf

from test_torch_port_stream_topk import assert_same_topk

CENT_ATOL = 1e-5


def _clustered(n_cent, per, d, seed, noise=0.05):
    rng = np.random.RandomState(seed)
    cent = rng.randn(n_cent, d)
    x = np.repeat(cent, per, axis=0) + noise * rng.randn(n_cent * per, d)
    x = x.astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope='module')
def data():
    g = _clustered(24, 40, 32, 0)
    q = _clustered(24, 1, 32, 0, noise=0.08)[:10]
    cent = np.asarray(jivf.kmeans(g, 24, iters=6, seed=3, sample=600))
    return g, q, cent


@pytest.mark.parametrize('sample', [600, None])
@pytest.mark.parametrize('int8', [False, True])
def test_kmeans_matches(data, sample, int8):
    g, _, _ = data
    s = None
    if int8:
        g, s = (np.asarray(a) for a in jtopk.quantize_gallery(g))
    want = np.asarray(jivf.kmeans(g, 24, iters=6, seed=3, g_scale=s,
                                  sample=sample, chunk=256))
    got = tivf.kmeans(g, 24, iters=6, seed=3, g_scale=s, sample=sample,
                      chunk=256, device='cpu')
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CENT_ATOL)
    # nlist is clamped to the rows used; a tensor gallery gives the same
    small = tivf.kmeans(torch.tensor(g[:10]), 50, iters=2,
                        g_scale=None if s is None else torch.tensor(s[:10]))
    assert small.shape == (10, 32)


def test_assign_and_build_ivf_equal(data):
    g, _, cent = data
    want = np.asarray(jivf.assign_clusters(g, cent, chunk=128))
    got = tivf.assign_clusters(g, cent, chunk=128, device='cpu')
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    g8, s = (np.asarray(a) for a in jtopk.quantize_gallery(g))
    np.testing.assert_array_equal(
        tivf.assign_clusters(torch.tensor(g8), torch.tensor(cent),
                             g_scale=torch.tensor(s)),
        np.asarray(jivf.assign_clusters(g8, cent, g_scale=s)))
    for got_a, want_a in zip(tivf.build_ivf(got, 30),
                             jivf.build_ivf(want, 30)):
        assert got_a.dtype == want_a.dtype
        np.testing.assert_array_equal(got_a, want_a)


def test_argmin_keeps_the_first_on_ties():
    cent = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    g = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    np.testing.assert_array_equal(
        tivf.assign_clusters(g, cent, device='cpu'), [0, 2])
    np.testing.assert_array_equal(
        np.asarray(jivf.assign_clusters(g, cent)), [0, 2])


@pytest.mark.parametrize('nprobe', [1, 3, 24, 40])
def test_probe_totals_equal(data, nprobe):
    g, q, cent = data
    assign = np.asarray(jivf.assign_clusters(g, cent))
    _, starts = jivf.build_ivf(assign, 24)
    np.testing.assert_array_equal(
        tivf.probe_totals(q, cent, starts, nprobe, device='cpu'),
        np.asarray(jivf.probe_totals(q, cent, starts, nprobe)))


def _sorted_index(g, cent, nlist):
    assign = np.asarray(jivf.assign_clusters(g, cent))
    perm, starts = jivf.build_ivf(assign, nlist)
    return g[perm], starts


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('nprobe,budget,chunk,k', [
    (3, 400, 64, 20),     # every probed row fits the budget
    (4, 70, 32, 20),      # budget truncation from the last probed cells
    (1, 1000, 1000, 60),  # fewer candidates than k: unfilled -1 / inf
    (24, 2000, 256, 30),  # a full probe
])
def test_ivf_topk_matches(data, int8, nprobe, budget, chunk, k):
    g, q, cent = data
    gs, starts = _sorted_index(g, cent, 24)
    s = None
    if int8:
        gs, s = (np.asarray(a) for a in jtopk.quantize_gallery(gs))
    want = jivf.ivf_topk(q, gs, cent, starts, k=k, nprobe=nprobe,
                         budget=budget, chunk=chunk, g_scale=s)
    got = tivf.ivf_topk(
        torch.tensor(q), torch.tensor(gs), torch.tensor(cent),
        torch.tensor(starts), k=k, nprobe=nprobe, budget=budget,
        chunk=chunk, g_scale=None if s is None else torch.tensor(s))
    assert got[1].dtype == torch.int32
    # tight clusters put ~40 rows within 0.02 of each other, so a few
    # percent of neighbouring pairs are closer than the tie rule's eps
    assert assert_same_topk(*got, *want) > 0.95
    if nprobe == 1:
        assert (got[1].numpy() == -1).any()


def test_ivf_topk_empty_cells_and_full_probe_equals_exact(data):
    """Centroids that own no row (empty cells, zero-size slices) are
    probed harmlessly; with every cell probed and a budget >= N the
    result is the exact scan's."""
    g, q, cent = data
    far = np.full((6, cent.shape[1]), 50.0, np.float32)
    cent2 = np.concatenate([cent, far])
    gs, starts = _sorted_index(g, cent2, 30)
    assert (np.diff(starts)[24:] == 0).all()
    want = jivf.ivf_topk(q, gs, cent2, starts, k=15, nprobe=30,
                         budget=len(g), chunk=128)
    got = tivf.ivf_topk(torch.tensor(q), torch.tensor(gs),
                        torch.tensor(cent2), torch.tensor(starts), k=15,
                        nprobe=30, budget=len(g), chunk=128)
    assert_same_topk(*got, *want)
    exact = jtopk.streaming_topk(q, gs, k=15, chunk=128)
    assert_same_topk(*got, *exact)


def test_ivf_query_blocks(data, monkeypatch):
    """Queries go through in blocks bounded by the gather size; the
    blocking changes only the products' shapes (so their rounding)."""
    g, q, cent = data
    gs, starts = _sorted_index(g, cent, 24)
    args = (torch.tensor(q), torch.tensor(gs), torch.tensor(cent),
            torch.tensor(starts))
    whole = tivf.ivf_topk(*args, k=10, nprobe=2, budget=200, chunk=50)
    monkeypatch.setattr(tivf, '_GATHER_ELEMS', 50 * 32 * 3)
    blocked = tivf.ivf_topk(*args, k=10, nprobe=2, budget=200, chunk=50)
    assert_same_topk(*blocked, *whole)


@pytest.mark.parametrize('ng', [0, 10, 1000, 100000, 10 ** 7])
def test_default_nlist(ng):
    assert tivf.default_nlist(ng) == jivf.default_nlist(ng)
