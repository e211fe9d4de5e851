"""Preprocessing, distances, exact top-k and the serving objects of the
port against pps_tpu on the same inputs: indices exactly (ties
included), distances and embeddings within stated tolerances."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from pps_tpu.data import device_preprocess as jpre
from pps_tpu.engine import serving as jserv
from pps_tpu.models.model import build_model as jbuild
from pps_tpu.ops import distance as jdist
from pps_tpu.ops import topk as jtopk
from pps_tpu.parallel import mesh as mesh_lib
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import device_preprocess as tpre
from pps_tpu_torch.engine import serving as tserv
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.models.model import build_model as tbuild
from pps_tpu_torch.ops import distance as tdist
from pps_tpu_torch.ops import topk as ttopk

# float32 expand formula on both sides, sums in another order: distances
# of O(1) agree to a few float32 ulps
DIST_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('in_size,out_size', [
    (128, 384), (64, 128), (48, 96), (20, 32), (384, 128), (7, 7)])
def test_cv2_bicubic_matrix_bitwise(in_size, out_size):
    np.testing.assert_array_equal(
        tpre.cv2_bicubic_matrix(in_size, out_size),
        jpre.cv2_bicubic_matrix(in_size, out_size))


@pytest.mark.parametrize('raw_hw,out_hw', [((128, 64), (384, 128)),
                                           ((48, 20), (96, 32))])
def test_preprocess_on_device_close(raw_hw, out_hw):
    u8 = np.random.RandomState(0).randint(
        0, 256, (2,) + raw_hw + (3,)).astype(np.uint8)
    means = np.array([[[102.9801, 115.9465, 122.7717]]])
    want = np.asarray(jpre.preprocess_on_device(jnp.asarray(u8), means,
                                                out_hw))
    got = tpre.preprocess_on_device(torch.tensor(u8), means, out_hw).numpy()
    assert got.shape == want.shape == (2,) + out_hw + (3,)
    # pixel values up to ~255 through two float32 products
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------


def _unit_rows(n, d, seed):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_pairwise_sq_dist_close():
    x, y = _unit_rows(9, 16, 1), _unit_rows(11, 16, 2)
    np.testing.assert_allclose(
        tdist.pairwise_sq_dist(torch.tensor(x), torch.tensor(y)).numpy(),
        np.asarray(jdist.pairwise_sq_dist(x, y)), atol=DIST_ATOL)
    np.testing.assert_allclose(
        tdist.pairwise_sq_dist(torch.tensor(x)).numpy(),
        np.asarray(jdist.pairwise_sq_dist(x)), atol=DIST_ATOL)


@pytest.mark.parametrize('blocked', [False, True])
def test_euclidean_distmat_close(blocked, monkeypatch):
    if blocked:  # force the query-blocked path at a small size
        monkeypatch.setattr(tdist, 'SINGLE_BLOCK_MAX_ELEMS', 10)
    q, g = _unit_rows(13, 16, 3), _unit_rows(21, 16, 4)
    g[5] = q[2]  # a zero distance: the clamp keeps the sqrt real
    want = np.asarray(jdist.euclidean_distmat(q, g))
    got = tdist.euclidean_distmat(torch.tensor(q), torch.tensor(g),
                                  block_q=4).numpy()
    assert np.isfinite(got).all()
    # sqrt near 0 magnifies the d^2 ulps
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got[want > 0.1], want[want > 0.1],
                               atol=DIST_ATOL)


# ---------------------------------------------------------------------------
# exact top-k
# ---------------------------------------------------------------------------


def _gallery(seed=5, ng=50, d=16):
    g = _unit_rows(ng, d, seed)
    g[17] = g[3]  # duplicate rows: equal distances to every query
    g[40] = g[3]
    g[41] = g[8]
    q = _unit_rows(4, d, seed + 1)
    q[1] = g[3]   # ties at distance 0 for rows 3, 17, 40
    return q, g


def test_quantize_gallery_bitwise():
    _, g = _gallery()
    for a, b in zip(ttopk.quantize_gallery(g), jtopk.quantize_gallery(g)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize('int8', [False, True])
def test_gallery_norms_close(int8):
    _, g = _gallery()
    if int8:
        g8, sc = jtopk.quantize_gallery(g)
        want = jtopk.gallery_norms(g8, sc)
        got = ttopk.gallery_norms(torch.tensor(g8), torch.tensor(sc))
    else:
        want = jtopk.gallery_norms(g)
        got = ttopk.gallery_norms(torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


CASES = {
    'basic': dict(k=5),
    'ties_cut_at_k': dict(k=2),
    'n_valid': dict(k=40, n_valid=30),
    'index_offset': dict(k=6, index_offset=100),
    'k_over_ng': dict(k=80),
    'n_valid_and_offset': dict(k=8, n_valid=7, index_offset=1000),
}


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
def test_flat_topk_matches(case, int8):
    kw = CASES[case]
    q, g = _gallery()
    jkw = dict(kw)
    tkw = dict(kw)
    gj, gt = g, torch.tensor(g)
    if int8:
        g8, sc = jtopk.quantize_gallery(g)
        gj, jkw['g_scale'] = g8, sc
        gt, tkw['g_scale'] = torch.tensor(g8), torch.tensor(sc)
    wd, wi = jtopk.flat_topk(jnp.asarray(q), jnp.asarray(gj), **jkw)
    gd, gi = ttopk.flat_topk(torch.tensor(q), gt, **tkw)
    wd, wi = np.asarray(wd), np.asarray(wi)
    gd, gi = gd.numpy(), gi.numpy()
    assert gi.dtype == np.int32 and gi.shape == wi.shape
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    # the zero-distance ties sit under a sqrt: compare there in d^2
    np.testing.assert_allclose(gd[fin] ** 2, wd[fin] ** 2, atol=DIST_ATOL)


def test_flat_topk_ties_take_lowest_index():
    q, g = _gallery()
    _, i = ttopk.flat_topk(torch.tensor(q), torch.tensor(g), k=3)
    assert i[1].tolist() == [3, 17, 40]


def test_flat_topk_int8_needs_int8_gallery():
    q, g = _gallery()
    with pytest.raises(TypeError):
        ttopk.flat_topk(torch.tensor(q), torch.tensor(g), k=3,
                        g_scale=torch.ones(len(g)))


# ---------------------------------------------------------------------------
# RetrievalIndex
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('int8', [False, True])
def test_retrieval_index_search_matches(int8):
    q, g = _gallery()
    paths = ['img%02d.jpg' % j for j in range(len(g))]
    jidx = jserv.RetrievalIndex(g, paths, mesh=None, int8=int8)
    tidx = tserv.RetrievalIndex(g, paths, int8=int8, device='cpu')
    assert len(tidx) == len(jidx) and tidx.dim == jidx.dim
    extra = _unit_rows(6, 16, 9)
    for step in range(2):
        wd, wi, wp = jidx.search(q, 7, return_paths=True)
        gd, gi, gp = tidx.search(q, 7, return_paths=True)
        assert gi.shape == (len(q), 7)
        np.testing.assert_array_equal(gi, wi)
        assert gp == wp
        np.testing.assert_allclose(gd ** 2, wd ** 2, atol=DIST_ATOL)
        if step == 0:  # grow both, then search again
            new = ['new%d.jpg' % j for j in range(len(extra))]
            jidx.add(extra, new)
            tidx.add(extra, new)
            q = np.concatenate([q, extra[2:3]])
    assert gi[-1, 0] == len(g) + 2


def test_retrieval_index_k_clamps_and_1d_query():
    g = _unit_rows(5, 16, 7)
    idx = tserv.RetrievalIndex(g, list('abcde'), int8=False, device='cpu')
    d, i = idx.search(g[2], 10)
    assert d.shape == (1, 5) and i[0, 0] == 2


def test_retrieval_index_gates():
    with pytest.raises(ValueError):
        tserv.RetrievalIndex(np.zeros((0, 4), np.float32), [],
                             device='cpu')
    _, g = _gallery()
    idx = tserv.RetrievalIndex(g, list(range(len(g))), int8=True,
                               device='cpu')
    flat = idx.search(g[:2], 3)
    # above the flat route's gate the search streams (ported), with the
    # same result
    idx.FLAT_SCAN_MAX_ELEMS = 10
    streamed = idx.search(g[:2], 3)
    np.testing.assert_array_equal(streamed[1], flat[1])
    np.testing.assert_allclose(streamed[0] ** 2, flat[0] ** 2, atol=DIST_ATOL)


# ---------------------------------------------------------------------------
# QueryEmbedder
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def embedders():
    jcfg = _flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    jm = jbuild(jcfg)
    jp, js = jax.jit(jm.init)(jax.random.PRNGKey(1))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    js = {k: np.asarray(v) for k, v in js.items()}
    mesh = mesh_lib.build_mesh(jcfg, mesh_shape=(1, 1))
    jq = jserv.QueryEmbedder(jcfg, jm, jp, js, mesh, max_batch=4)
    tcfg_ = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    tm = tbuild(tcfg_, device='cpu')
    tp, ts = params_from_numpy(tm, jp, js)
    tq = tserv.QueryEmbedder(tcfg_, tm, tp, ts, max_batch=4, device='cpu')
    decodes = np.random.RandomState(3).randint(
        0, 256, (6, 48, 20, 3)).astype(np.uint8)
    return jq, tq, mesh, decodes, tm


def test_query_embedder_matches(embedders):
    jq, tq, mesh, decodes, _ = embedders
    assert tq.ladder == jq.ladder == (1, 4)
    paths = [4, 0, 2]  # padded to ladder size 4
    with mesh:
        want = jq.embed(paths, decode_fn=lambda p: decodes[p])
    got = tq.embed(paths, lambda p: decodes[p])
    assert got.shape == want.shape == (3, 3968)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # over the cap: chunks of the top ladder size, same rows
    got6 = tq.embed([4, 0, 2, 1, 3, 5], lambda p: decodes[p])
    np.testing.assert_allclose(got6[:3], got, rtol=1e-5, atol=1e-6)
    assert tq.embed([], lambda p: decodes[p]).shape == (0, 3968)


def test_query_embedder_ladder_and_mixed_sizes(embedders):
    """A mixed-size group is embedded through host preprocessing (slice
    3b), as pps_tpu's embedder does it."""
    jq, tq, mesh, decodes, _ = embedders
    assert [tq._ladder_pad(n) for n in (1, 2, 4, 9)] == [1, 4, 4, 4]
    small = decodes[0, :40]

    def dec(p):
        return decodes[0] if p == 0 else small
    with mesh:
        want = jq.embed([0, 1], decode_fn=dec)
    got = tq.embed([0, 1], dec)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('max_batch,ladder', [
    (1, (1,)), (16, (1, 4, 16)), (64, (1, 4, 16, 64)),
    (100, (1, 4, 16, 64, 100))])
def test_ladder_sizes(embedders, max_batch, ladder):
    _, tq, _, _, tm = embedders
    q = tserv.QueryEmbedder(tcfg.cfg, tm, tq._params, tq._state,
                            max_batch=max_batch, device='cpu')
    assert q.ladder == ladder
