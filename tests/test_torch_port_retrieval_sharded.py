"""The port's sharded-gallery retrieval against pps_tpu's, case by case as
``tests/test_retrieval_sharded.py`` runs pps_tpu's on its 8-device CPU
mesh: the port's mesh is ``['cpu'] * 8`` in one process (each shard its
own tensor), on the same numpy gallery, queries, centroids and cell
assignments.  The exact routes return pps_tpu's indices and distances
within 1e-5; IVF probes the same cells.  Then ``RetrievalIndex(shard=
True)`` (search, add, remove, save, load, IVF) against pps_tpu's."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from pps_tpu.engine import serving as jserv
from pps_tpu.ops.ivf import assign_clusters, kmeans
from pps_tpu.ops.topk import quantize_gallery
from pps_tpu.parallel import retrieval as jret
from pps_tpu_torch.engine import serving as tserv
from pps_tpu_torch.ops.topk import streaming_topk
from pps_tpu_torch.parallel import mesh as tmesh
from pps_tpu_torch.parallel import retrieval as tret

DIST_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_native(monkeypatch):
    """pps_tpu's serving never builds its own C++ engine here."""
    from pps_tpu import native
    monkeypatch.setattr(native, 'available', lambda: False)


def _meshes(shape=(4, 2)):
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return (Mesh(devs, ('data', 'model')),
            tmesh.build_mesh(devices=['cpu'] * devs.size, mesh_shape=shape))


def _rand(ng, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(7, d).astype(np.float32),
            rng.randn(ng, d).astype(np.float32))


def _both_topk(q, g, int8, k, chunk, shape=(4, 2), recall_target=None):
    jm, tm = _meshes(shape)
    gd, sd, n = jret.shard_gallery(g, jm, int8=int8)
    jd, ji = jret.sharded_topk(q, gd, ng_total=n, k=k, chunk=chunk,
                               g_scale=sd, mesh=jm,
                               recall_target=recall_target)
    tg, ts, tn = tret.shard_gallery(g, tm, int8=int8)
    assert tn == n and len(tg) == tm.size
    assert (ts is None) == (sd is None)
    td, ti = tret.sharded_topk(q, tg, ng_total=tn, k=k, chunk=chunk,
                               g_scale=ts, recall_target=recall_target)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize('ng,d,int8,k,chunk,seed', [
    (1024, 32, False, 10, 128, 0),   # an even split
    (1003, 32, False, 10, 128, 0),   # uneven
    (1003, 48, True, 10, 256, 1),    # int8
    (64, 16, False, 20, 8, 2),       # k above a shard's 8 rows
    (5, 16, False, 5, 4, 3),         # fewer rows than shards
], ids=['even', 'uneven', 'int8', 'k_above_shard', 'k_is_gallery'])
def test_sharded_topk_matches_pps_tpu(ng, d, int8, k, chunk, seed):
    q, g = _rand(ng, d, seed)
    if int8:
        g /= np.linalg.norm(g, axis=1, keepdims=True)
    (jd, ji), (td, ti) = _both_topk(q, g, int8, k, chunk)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, **DIST_TOL)
    assert ti.max() < ng
    # and the port's streaming scan over the whole gallery
    g_in = quantize_gallery(g) if int8 else (g, None)
    sd, si = streaming_topk(torch.tensor(q), torch.tensor(np.asarray(
        g_in[0])), k=k, chunk=chunk, g_scale=None if g_in[1] is None
        else torch.tensor(np.asarray(g_in[1])))
    np.testing.assert_array_equal(ti, si.numpy())


def test_recall_target_and_one_axis_mesh():
    q, g = _rand(4096, 24, seed=4)
    (jd, ji), (td, ti) = _both_topk(q, g, False, 10, 512,
                                    recall_target=0.95)
    # pps_tpu's approx_min_k is exact off a TPU; the port's scan is exact
    np.testing.assert_array_equal(ti, ji)
    q, g = _rand(777, 16, seed=5)
    (jd, ji), (td, ti) = _both_topk(q, g, True, 7, 4096, shape=(8, 1))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, **DIST_TOL)


def _clustered(n_ids=24, per=20, d=32, seed=5):
    rng = np.random.RandomState(seed)
    ids = rng.randn(n_ids, d).astype(np.float32)
    g = (np.repeat(ids, per, axis=0) +
         0.05 * rng.randn(n_ids * per, d)).astype(np.float32)
    nq = min(7, n_ids)
    q = (ids[:nq] + 0.05 * rng.randn(nq, d)).astype(np.float32)
    return q, g


def _both_ivf(q, g, nlist, iters, k, nprobe, budget, exact=False,
              int8=False, normalize=False):
    if normalize:
        g = g / np.linalg.norm(g, axis=1, keepdims=True)
    cent = np.asarray(kmeans(g, nlist, iters=iters, seed=0))
    assign = np.asarray(assign_clusters(g, cent))
    scale = None
    if int8:
        g, scale = (np.asarray(a) for a in quantize_gallery(g))
    jm, tm = _meshes()
    jp = jret.shard_ivf_gallery(g, assign, nlist, jm, g_scale=scale)
    jd, ji = jret.sharded_ivf_topk(q, cent, jp, k=k, nprobe=nprobe,
                                   budget=budget, mesh=jm, exact=exact)
    tp = tret.shard_ivf_gallery(g, assign, nlist, tm, g_scale=scale)
    assert tp['rows'] == jp['rows']
    np.testing.assert_array_equal(
        np.concatenate([p.numpy() for p in tp['perm']]),
        np.asarray(jp['perm']))
    td, ti = tret.sharded_ivf_topk(q, cent, tp, k=k, nprobe=nprobe,
                                   budget=budget, exact=exact)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize('case', ['full_probe', 'int8_nprobe4',
                                  'k_above_candidates', 'exact_scan'])
def test_sharded_ivf_matches_pps_tpu(case):
    if case == 'full_probe':
        q, g = _clustered()
        out = _both_ivf(q, g, 24, 6, 10, 24, len(g))
    elif case == 'int8_nprobe4':
        q, g = _clustered(n_ids=32, per=30, seed=6)
        out = _both_ivf(q, g, 32, 8, 10, 4, 2048, int8=True,
                        normalize=True)
    elif case == 'k_above_candidates':
        q, g = _clustered(n_ids=4, per=8, seed=7)
        out = _both_ivf(q[:2], g, 4, 4, 50, 1, 64)
    else:
        q, g = _clustered(n_ids=16, per=13, seed=8)
        out = _both_ivf(q, g, 16, 5, 9, 2, 64, exact=True)
    (jd, ji), (td, ti) = out
    assert td.shape == jd.shape
    # the same candidates; the order differs only among equal distances
    np.testing.assert_array_equal(np.sort(ti, axis=1), np.sort(ji, axis=1))
    np.testing.assert_allclose(np.sort(td, axis=1), np.sort(jd, axis=1),
                               atol=2e-4)
    assert np.all(np.isinf(td[ti < 0]))
    if case != 'k_above_candidates':
        np.testing.assert_array_equal(ti, ji)


def test_sharded_retrieval_index_matches_pps_tpu(tmp_path):
    """``RetrievalIndex(shard=True)``: search, add, remove, save and load
    (into a sharded and an unsharded index), and sharded IVF, against
    pps_tpu's on its 8-device mesh."""
    rng = np.random.RandomState(11)
    g = rng.randn(203, 24).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[:6] + 0.01 * rng.randn(6, 24).astype(np.float32)
    paths = ['p{}'.format(i) for i in range(len(g))]
    jm, tm = _meshes()
    ji = jserv.RetrievalIndex(g, paths, mesh=jm, int8=True, shard=True)
    ti = tserv.RetrievalIndex(g, paths, mesh=tm, int8=True, shard=True,
                              device='cpu')
    assert ti.shard and len(ti._g) == tm.size

    def same(k=5):
        jd, jj = ji.search(q, k)
        td, tj = ti.search(q, k)
        np.testing.assert_array_equal(tj, jj)
        np.testing.assert_allclose(td, jd, **DIST_TOL)

    same()
    extra = rng.randn(9, 24).astype(np.float32)
    ji.add(extra, ['x{}'.format(i) for i in range(9)])
    ti.add(extra, ['x{}'.format(i) for i in range(9)])
    same(12)
    drop = ['p1', 'p7', 'x3']
    assert ti.remove(drop) == ji.remove(drop) == 3
    same(12)
    path = str(tmp_path / 'idx.npz')
    ti.save(path)
    for shard in (True, False):
        back = tserv.RetrievalIndex.load(path, mesh=tm if shard else None,
                                         shard=shard, device='cpu')
        assert back.shard == shard and back.paths == ji.paths
        bd, bj = back.search(q, 7)
        jd, jj = ji.search(q, 7)
        np.testing.assert_array_equal(bj, jj)
    ji.enable_ivf(nlist=8, nprobe=8, budget=len(ji), iters=4)
    ti.enable_ivf(nlist=8, nprobe=8, budget=len(ti), iters=4)
    assert ti._ivf['placed']['rows'] > 0
    same(10)
    # exact=True: the full scan over the IVF placement
    jd, jj = ji.search(q, 10, exact=True)
    td, tj = ti.search(q, 10, exact=True)
    np.testing.assert_array_equal(np.sort(tj, 1), np.sort(jj, 1))
    with pytest.raises(ValueError, match='mesh'):
        tserv.RetrievalIndex(g, paths, shard=True, device='cpu')
