"""The port's ``RetrievalIndex`` (every search route, the IVF lifecycle,
remove/add renumbering, save/load across packages, re-ranked search),
its batchers and its gallery cache, against pps_tpu's on the same
numpy-seeded inputs.

Tolerances.  Indices follow the near-tie rule of the streaming tests
(``assert_same_topk``: equal wherever neighbouring distances differ by
more than 1e-5; squared distances within 1e-5).  Re-ranked search with
the numpy engine runs the same float32 numpy code on the same candidate
rows, so it is held exactly; the C++ engine within 1e-5.  The batchers
and the cache are pure host code, held on their observable behaviour.
"""

import contextlib
import os
import threading
import time

import numpy as np
import pytest

import pps_tpu.native
from pps_tpu.engine import serving as jserv
from pps_tpu_torch.engine import serving as tserv

from test_torch_port_stream_topk import assert_same_topk


@pytest.fixture(autouse=True)
def _no_pps_tpu_native(monkeypatch):
    monkeypatch.setattr(pps_tpu.native, 'available', lambda: False)


def _gallery(n=800, d=32, n_ids=40, seed=0, noise=0.3):
    rng = np.random.RandomState(seed)
    cent = rng.randn(n_ids, d)
    g = cent[rng.randint(0, n_ids, n)] + noise * rng.randn(n, d)
    g = g.astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[rng.choice(n, 6, replace=False)] + 0.05 * rng.randn(6, d)
    return g, q.astype(np.float32)


def _pair(g, int8, paths=None):
    paths = paths or ['g%05d.jpg' % i for i in range(len(g))]
    return (jserv.RetrievalIndex(g, paths, int8=int8),
            tserv.RetrievalIndex(g, paths, int8=int8, device='cpu'))


def _same_search(jidx, tidx, q, k, **kw):
    jd, ji, jp = jidx.search(q, k, return_paths=True, **kw)
    td, ti, tp = tidx.search(q, k, return_paths=True, **kw)
    assert_same_topk(td, ti, jd, ji)
    clear = ti == ji
    assert [[p for p, c in zip(r, cr) if c] for r, cr in zip(tp, clear)] \
        == [[p for p, c in zip(r, cr) if c] for r, cr in zip(jp, clear)]
    return td, ti


@pytest.mark.parametrize('int8', [False, True])
def test_every_search_route(int8):
    g, q = _gallery()
    jidx, tidx = _pair(g, int8)
    _same_search(jidx, tidx, q, 10)                      # flat
    for idx in (jidx, tidx):
        idx.FLAT_SCAN_MAX_ELEMS = 8
    _same_search(jidx, tidx, q, 10, chunk=256)           # streaming
    _same_search(jidx, tidx, q, 5, recall_target=0.95)   # (exact here)
    for idx in (jidx, tidx):
        idx.enable_ivf(nlist=24, nprobe=4, iters=4, sample=1000)
    np.testing.assert_array_equal(tidx._ivf['assign'], jidx._ivf['assign'])
    _same_search(jidx, tidx, q, 10)                      # IVF
    _same_search(jidx, tidx, q, 10, exact=True)          # exact under IVF
    for idx in (jidx, tidx):
        idx.FLAT_SCAN_MAX_ELEMS = 1 << 30
    _same_search(jidx, tidx, q, 10, exact=True)          # flat, cell-sorted
    d, i = tidx.search(q[0], 3)                          # 1-d query, k=3
    assert d.shape == (1, 3)


def test_ivf_lifecycle_spill_fold_disable():
    g, q = _gallery(1200)
    extra, _ = _gallery(300, seed=5)
    jidx, tidx = _pair(g[:1000], True)
    for idx in (jidx, tidx):
        idx.enable_ivf(nlist=16, nprobe=3, iters=4, spill_limit=150)
        assert idx.ivf_staleness == 0.0
    # appended rows join the spill tail (scanned exactly, merged)
    new = ['n%d.jpg' % i for i in range(100)]
    for idx in (jidx, tidx):
        idx.add(extra[:100], new)
        assert len(idx._ivf['spill_ids']) == 100
        assert idx.ivf_staleness == pytest.approx(100 / 1100)
    _same_search(jidx, tidx, q, 10)
    # past spill_limit the tail folds into the sorted layout
    for idx in (jidx, tidx):
        idx.add(extra[100:200], ['m%d.jpg' % i for i in range(100)])
        assert len(idx._ivf['spill_ids']) == 0
        assert len(idx._ivf['perm']) == 1200
    np.testing.assert_array_equal(tidx._ivf['perm'], jidx._ivf['perm'])
    np.testing.assert_array_equal(tidx._ivf['starts'], jidx._ivf['starts'])
    _same_search(jidx, tidx, q, 10)
    for idx in (jidx, tidx):
        idx.disable_ivf()
        assert idx.ivf_staleness is None and not idx.ivf_enabled
    _same_search(jidx, tidx, q, 10)


def test_auto_retrain_in_the_background():
    g, q = _gallery(1000)
    extra, _ = _gallery(600, seed=6)
    jidx, tidx = _pair(g[:600], False)
    for idx in (jidx, tidx):
        idx.enable_ivf(nlist=16, nprobe=3, iters=3)
        idx.enable_auto_retrain(threshold=0.25)
        idx.add(extra[:100], ['a%d' % i for i in range(100)])
        assert idx.wait_retrain(60) == 0          # 100/700 < 0.25
        idx.add(extra[100:400], ['b%d' % i for i in range(300)])
        assert idx.wait_retrain(60) == 1          # 400/1000 >= 0.25
        assert not idx.retraining
        assert idx.ivf_staleness == 0.0
        assert idx._ivf['trained_n'] == 1000
    np.testing.assert_array_equal(tidx._ivf['assign'], jidx._ivf['assign'])
    _same_search(jidx, tidx, q, 10)
    tidx.disable_auto_retrain()
    assert tidx.retrain_count == 0
    with pytest.raises(RuntimeError, match='enable_ivf'):
        tserv.RetrievalIndex(g[:5], list('abcde'),
                             device='cpu').enable_auto_retrain()


@pytest.mark.parametrize('ivf', [False, True])
def test_remove_renumbers_and_add_appends(ivf):
    g, q = _gallery(800)
    jidx, tidx = _pair(g, True)
    if ivf:
        for idx in (jidx, tidx):
            idx.enable_ivf(nlist=12, nprobe=12, iters=3)
    drop = ['g%05d.jpg' % i for i in (0, 5, 6, 400, 799)] + ['absent']
    for idx in (jidx, tidx):
        assert idx.remove(drop) == 5
        assert len(idx) == 795 and idx.paths[0] == 'g00001.jpg'
        assert idx.remove(['absent']) == 0
    _, ti = _same_search(jidx, tidx, q, 10)
    # renumbered: every returned index names the row's path
    _, ti2, tp = tidx.search(q, 10, return_paths=True)
    assert all(tidx.paths[j] == p for r, pr in zip(ti2, tp)
               for j, p in zip(r, pr))
    for idx in (jidx, tidx):
        idx.add(g[[5, 6]], ['back5', 'back6'])
        assert idx.paths[-2:] == ['back5', 'back6']
    _same_search(jidx, tidx, g[[5, 6]], 3)
    assert tidx.search(g[[5]], 1, return_paths=True)[2][0][0] == 'back5'
    with pytest.raises(ValueError, match='empty'):
        tidx.remove(list(tidx.paths))


@pytest.mark.parametrize('ivf', [False, True])
@pytest.mark.parametrize('int8', [False, True])
def test_save_load_across_packages(tmp_path, int8, ivf):
    g, q = _gallery(700)
    jidx, tidx = _pair(g, int8)
    if ivf:
        for idx in (jidx, tidx):
            idx.enable_ivf(nlist=10, nprobe=4, iters=3)
    tidx.save(str(tmp_path / 'port.npz'))
    jidx.save(str(tmp_path / 'jax.npz'))
    port_file = np.load(str(tmp_path / 'port.npz'), allow_pickle=True)
    jax_file = np.load(str(tmp_path / 'jax.npz'), allow_pickle=True)
    assert sorted(port_file.files) == sorted(jax_file.files)
    for key in port_file.files:
        a, b = port_file[key], jax_file[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key != 'ivf_cent':
            np.testing.assert_array_equal(a, b)
    # the port's file in pps_tpu, and pps_tpu's in the port
    j_from_t = jserv.RetrievalIndex.load(str(tmp_path / 'port.npz'))
    t_from_j = tserv.RetrievalIndex.load(str(tmp_path / 'jax.npz'),
                                         device='cpu')
    assert j_from_t.ivf_enabled == t_from_j.ivf_enabled == ivf
    assert j_from_t.int8 == t_from_j.int8 == int8
    _same_search(j_from_t, tidx, q, 10)
    _same_search(jidx, t_from_j, q, 10)
    assert not (tmp_path / 'port.npz.tmp.npz').exists()


@pytest.mark.parametrize('ivf', [False, True])
def test_search_reranked_matches(ivf):
    g, q = _gallery(400)
    jidx, tidx = _pair(g, True)
    if ivf:
        for idx in (jidx, tidx):
            idx.enable_ivf(nlist=10, nprobe=10, iters=3)
    jd, ji, jp = jidx.search_reranked(q, 7, shortlist=40, engine='numpy',
                                      return_paths=True)
    td, ti, tp = tidx.search_reranked(q, 7, shortlist=40, engine='numpy',
                                      return_paths=True)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert tp == jp
    nd, ni = tidx.search_reranked(q, 7, shortlist=40)   # the C++ engine
    np.testing.assert_allclose(nd, jd, rtol=0, atol=1e-5)
    # bucket padding rows never reach the host re-rank
    pd, pi = tidx.search_reranked(np.concatenate([q, q[:3]]), 7,
                                  shortlist=40, engine='numpy', n_valid=6)
    np.testing.assert_array_equal(pi, ti)
    # a shortlist holding the whole gallery is the global re-ranking
    full = tidx.search_reranked(q[:2], 5, shortlist=len(g), engine='numpy')
    want = jidx.search_reranked(q[:2], 5, shortlist=len(g), engine='numpy')
    np.testing.assert_array_equal(full[1], want[1])


def test_sharding_and_bad_inputs_raise():
    # sharding is ported (tests/test_torch_port_retrieval_sharded.py); it
    # needs a mesh, and the serving CLIs' bootstrap builds one
    g, _ = _gallery(20)
    with pytest.raises(ValueError, match='mesh'):
        tserv.RetrievalIndex(g, list(range(20)), shard=True, device='cpu')
    with pytest.raises(ValueError, match='mesh'):
        tserv.RetrievalIndex.load('x.npz', shard=True)
    with pytest.raises(ValueError, match='required'):
        tserv.build_index_from_args(None, None, None, None, shard=True,
                                    device='cpu')
    idx = tserv.RetrievalIndex(g, list(range(20)), device='cpu')
    with pytest.raises(ValueError, match='width'):
        idx.search(np.zeros((1, 7), np.float32), 3)
    with pytest.raises(ValueError):
        idx.add(g[:2], ['one'])
    with pytest.raises(ValueError, match='required'):
        tserv.build_index_from_args(None, None, None, None)


# ---------------------------------------------------------------------------
# the batchers, held with a stub index / embed fn on both packages
# ---------------------------------------------------------------------------


class StubIndex:
    """Per-row answers from the query value; records every dispatch."""

    def __init__(self):
        self.calls = []
        self.gate = threading.Event()
        self.hold_first = False

    @contextlib.contextmanager
    def snapshot(self):
        yield

    def _answer(self, q, k):
        d = np.tile(q[:, :1], (1, k)).astype(np.float32)
        i = np.tile(np.round(q[:, :1]).astype(np.int64), (1, k))
        return d, i, [['p%d' % int(round(r[0]))] * k for r in q]

    def _hold(self):
        if self.hold_first and len(self.calls) == 1:
            self.gate.wait(20)

    def search(self, q, k, recall_target=None, exact=False,
               return_paths=False, chunk=4096):
        q = np.asarray(q)
        self.calls.append(('search', q.shape[0], k))
        self._hold()
        if np.any(q < 0):
            raise ValueError('poison query')
        d, i, p = self._answer(q, k)
        return (d, i, p) if return_paths else (d, i)

    def search_reranked(self, q, k, n_valid=None, return_paths=False,
                        **kw):
        q = np.asarray(q)
        nv = q.shape[0] if n_valid is None else int(n_valid)
        self.calls.append(('rerank', q.shape[0], k, nv))
        self._hold()
        d, i, p = self._answer(q[:nv], k)
        return (d, i, p) if return_paths else (d, i)


def _burst(batcher_call, first_arg, args, gate):
    """One request that holds the dispatcher, then ``args`` queued behind
    it, then release; returns {arg: result or exception}."""
    out = {}

    def run(a):
        try:
            out[a] = batcher_call(a)
        except Exception as e:  # noqa: BLE001
            out[a] = e
    first = threading.Thread(target=run, args=(first_arg,))
    first.start()
    time.sleep(0.3)
    rest = [threading.Thread(target=run, args=(a,)) for a in args]
    for t in rest:
        t.start()
    time.sleep(0.3)
    gate.set()
    for t in [first] + rest:
        t.join(20)
    return out


@pytest.mark.parametrize('mod', [jserv, tserv], ids=['pps_tpu', 'port'])
def test_search_batcher_coalesces_into_buckets(mod):
    idx = StubIndex()
    idx.hold_first = True
    b = mod.SearchBatcher(idx, max_batch=16)
    try:
        assert b.buckets() == [1, 4, 16]
        out = _burst(lambda v: b.search(np.full((1, 4), float(v),
                                                np.float32), k=3),
                     99, list(range(6)), idx.gate)
        for v in [99] + list(range(6)):
            d, i, p = out[v]
            assert d.shape == (1, 3) and int(i[0, 0]) == v
            assert p[0][0] == 'p%d' % v
        # the 6 queued rode ONE scan, padded to the bucket above 6
        assert idx.calls == [('search', 1, 3), ('search', 16, 3)]
        assert b.dispatches == 2 and b.queries == 7 and b.device_scans == 2
    finally:
        b.close()


@pytest.mark.parametrize('mod', [jserv, tserv], ids=['pps_tpu', 'port'])
def test_search_batcher_keys_oversize_and_poison(mod):
    idx = StubIndex()
    idx.hold_first = True
    b = mod.SearchBatcher(idx, max_batch=4)
    try:
        kinds = {'warm': dict(k=2), 'k3a': dict(k=3), 'k3b': dict(k=3),
                 'k5': dict(k=5), 'rr': dict(k=3, rerank={'shortlist': 8}),
                 'bad': dict(k=3)}

        def call(name):
            v = -1.0 if name == 'bad' else 1.0
            return b.search(np.full((1, 4), v, np.float32), **kinds[name])
        out = _burst(call, 'warm', ['k3a', 'k3b', 'k5', 'rr', 'bad'],
                     idx.gate)
        assert isinstance(out['bad'], ValueError)
        assert out['k5'][0].shape == (1, 5) and out['rr'][0].shape == (1, 3)
        assert int(out['k3a'][1][0, 0]) == 1
        # k=3 coalesced (then retried alone around the poison row); k=5
        # and the rerank group ran on their own
        assert ('search', 1, 5) in idx.calls
        assert ('rerank', 1, 3, 1) in idx.calls
        # an oversized request goes through in max_batch chunks
        idx.calls.clear()
        d, i, p = b.search(np.arange(10, dtype=np.float32)[:, None]
                           * np.ones((1, 4), np.float32), k=2)
        assert [int(r) for r in i[:, 0]] == list(range(10))
        assert [c[1] for c in idx.calls] == [4, 4, 4]
    finally:
        b.close()


@pytest.mark.parametrize('mod', [jserv, tserv], ids=['pps_tpu', 'port'])
def test_batchers_shed_and_close(mod):
    gate = threading.Event()

    def slow(paths):
        gate.wait(20)
        return np.ones((len(paths), 2), np.float32)
    eb = mod.EmbedBatcher(slow, max_batch=1, max_pending=1)
    idx = StubIndex()
    idx.hold_first = True
    sb = mod.SearchBatcher(idx, max_batch=1, max_pending=1)
    try:
        errs = []

        def embed(p):
            try:
                eb.embed([p])
            except mod.Overloaded as e:
                errs.append(e)
        ts = [threading.Thread(target=embed, args=(str(i),))
              for i in range(4)]
        for t in ts:
            t.start()
            time.sleep(0.1)
        gate.set()
        for t in ts:
            t.join(20)
        assert len(errs) >= 1 and eb.shed == len(errs)
        def search():
            try:
                sb.search(np.ones((1, 4), np.float32), k=1)
            except mod.Overloaded:
                pass
        ts = [threading.Thread(target=search) for _ in range(3)]
        for t in ts:
            t.start()
            time.sleep(0.1)
        with pytest.raises(mod.Overloaded):
            sb.search(np.ones((1, 4), np.float32), k=1)
        assert sb.shed >= 1
        idx.gate.set()
        for t in ts:
            t.join(20)
    finally:
        eb.close()
        sb.close()
    with pytest.raises(mod.Overloaded, match='closed'):
        eb.embed(['x'])
    with pytest.raises(mod.Overloaded, match='closed'):
        sb.search(np.ones((1, 4), np.float32), k=1)


@pytest.mark.parametrize('mod', [jserv, tserv], ids=['pps_tpu', 'port'])
def test_embed_batcher_coalesces_and_isolates_poison(mod):
    calls = []
    gate = threading.Event()

    def fake(paths):
        calls.append(list(paths))
        if len(calls) == 1:
            gate.wait(20)
        if 'bad' in paths:
            raise IOError('undecodable')
        return np.array([[float(p), 0.5] for p in paths], np.float32)
    b = mod.EmbedBatcher(fake, max_batch=16)
    try:
        out = _burst(lambda p: b.embed([p]), '99',
                     ['0', '1', 'bad', '2'], gate)
        assert isinstance(out['bad'], IOError)
        for p in ('99', '0', '1', '2'):
            np.testing.assert_array_equal(out[p], [[float(p), 0.5]])
        assert sorted(len(c) for c in calls[:2]) == [1, 4]
        assert b.images == 5 + 3 + 1 - 4  # 1 + 4 coalesced, then 4 alone
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the gallery cache
# ---------------------------------------------------------------------------


def _fake_embed(calls):
    def embed(cfg, model, params, state, paths, *a, **kw):
        calls.append(list(paths))
        return np.array([[float(len(p)), float(i)] for i, p in
                         enumerate(paths)], np.float32)
    return embed


def test_gallery_cache_shared_with_pps_tpu(tmp_path, monkeypatch):
    gal = tmp_path / 'gal'
    gal.mkdir()
    for name in ('b.png', 'a.jpg', 'c.jpg', 'notes.txt'):
        (gal / name).write_bytes(b'x')
    w = tmp_path / 'w.pkl'
    w.write_bytes(b'weights')
    paths = tserv.list_gallery_images(str(gal))
    assert paths == jserv.list_gallery_images(str(gal))
    assert [os.path.basename(p) for p in paths] == ['a.jpg', 'b.png',
                                                    'c.jpg']
    assert tserv.weights_cache_key(str(w)) == \
        jserv.weights_cache_key(str(w))
    assert tserv.weights_cache_key(str(tmp_path / 'none')) == ''
    tcalls, jcalls = [], []
    monkeypatch.setattr(tserv, 'embed_paths', _fake_embed(tcalls))
    monkeypatch.setattr(jserv, 'embed_paths', _fake_embed(jcalls))
    f1, p1 = tserv.embed_gallery_cached(None, None, None, None, str(gal),
                                        weights_path=str(w))
    assert p1 == paths and len(tcalls) == 1
    # pps_tpu reads the port's cache without embedding, and vice versa
    f2, p2 = jserv.embed_gallery_cached(None, None, None, None, str(gal),
                                        None, weights_path=str(w))
    assert jcalls == [] and p2 == paths
    np.testing.assert_array_equal(f1, f2)
    tserv.embed_gallery_cached(None, None, None, None, str(gal),
                               weights_path=str(w))
    assert len(tcalls) == 1
    # other weights re-embed; so does refresh
    w.write_bytes(b'other weights!')
    tserv.embed_gallery_cached(None, None, None, None, str(gal),
                               weights_path=str(w))
    assert len(tcalls) == 2


def test_gallery_cache_resumes_chunks(tmp_path, monkeypatch):
    gal = tmp_path / 'gal'
    gal.mkdir()
    for i in range(7):
        (gal / ('%02d.jpg' % i)).write_bytes(b'x')
    calls = []
    embed = _fake_embed(calls)
    state = {'fail_at': 2}

    def flaky(*a, **kw):
        if len(calls) == state['fail_at']:
            raise RuntimeError('interrupted')
        return embed(*a, **kw)
    monkeypatch.setattr(tserv, 'embed_paths', flaky)
    with pytest.raises(RuntimeError, match='interrupted'):
        tserv.embed_gallery_cached(None, None, None, None, str(gal),
                                   chunk=3)
    assert len(calls) == 2
    state['fail_at'] = -1
    feats, paths = tserv.embed_gallery_cached(None, None, None, None,
                                              str(gal), chunk=3)
    assert len(calls) == 3 and [len(c) for c in calls] == [3, 3, 1]
    assert feats.shape == (7, 2) and len(paths) == 7
    assert not [d for d in os.listdir(str(gal)) if d.startswith('.gal')]
    with pytest.raises(ValueError, match='no images'):
        tserv.embed_gallery_cached(None, None, None, None,
                                   str(tmp_path / 'w'))
