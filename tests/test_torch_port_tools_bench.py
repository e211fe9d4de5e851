"""The port's retrieval benchmarks (``tools/bench_exact_scan``,
``bench_rerank``, ``bench_ivf_recall``, ``bench_serving``) against the
JAX package on the same numpy inputs, and each run through ``main`` on
the CPU at a tiny size.

Tolerances.
* The exact-scan variants (``flat-bf16`` with the query's hi/lo bf16
  split, ``flat-int8+ref`` rescoring a shortlist in float32) against
  pps_tpu's ``streaming_topk`` on an int8 gallery: indices equal wherever
  the reference's neighbouring distances differ by more than ``TIE_EPS``
  (1e-5; float32 sums in another order may swap closer ranks), distances
  within ``DIST_ATOL`` (1e-4: |q|^2 + |g|^2 - 2 q.g cancels O(1) terms,
  and the sides sum 3968 products in other orders).
* The card's re-ranking formulation (run on the CPU) against pps_tpu's
  numpy ``re_ranking``: the port's existing rule (tests/
  test_torch_port_rerank.py): at most 0.5% of the entries apart by more
  than 1e-5 (a near-tie k-th neighbour flips a set's membership).
* The IVF recall is a count: equal to a numpy recount exactly.
"""

import http.server
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pps_tpu.evaluation import rerank as jrr
from pps_tpu.ops.topk import streaming_topk as jstreaming_topk
from pps_tpu_torch.engine.serving import RetrievalIndex
from pps_tpu_torch.evaluation.rerank import rerank_distmat_device
from pps_tpu_torch.tools import (bench_exact_scan, bench_ivf_recall,
                                 bench_rerank, bench_serving)

from _torch_port_tools_common import (  # noqa: F401 (fixtures)
    DIM, _fresh_port_cfg, _grad_enabled, _two_threads, narrow, tmp_path)

TIE_EPS = 1e-5
DIST_ATOL = 1e-4
ENTRY_ATOL, FLIP_SHARE = 1e-5, 0.005

# tools/bench_exact_scan.py:226-235
EXACT_SCAN_KEYS = {'gallery_size', 'dim', 'topk', 'nq', 'bandwidth_bound_ms',
                   'measured_read_GBps', 'latency_ms', 'checks',
                   'device_kind'}
EXACT_SCAN_CHECK_KEYS = {'flat_bf16_topk_agree', 'flat_bf16_dist_maxdiff',
                         'flat_int8_topk_agree', 'flat_int8_refined_agree'}
# tools/bench_serving.py:466-472, :510-512 (--rerank), :603-614 (--ivf)
SERVING_KEYS = {'single_query_latency_ms', 'gallery_size', 'dim', 'topk',
                'gallery_dtype', 'embed', 'device_kind'}
SERVING_RERANK_KEYS = {'rerank_host_ms', 'rerank_engine',
                       'reranked_total_ms'}
SERVING_IVF_KEYS = {'nlist', 'nprobe', 'budget', 'build_kmeans_s',
                    'build_assign_s', 'recall_sweep_nprobe', 'exact_scan_ms',
                    'ivf_scan_ms', 'scan_speedup', 'single_query_e2e_ivf_ms'}
# tools/bench_serving.py:283-297 (a load row), :305 (the last line)
LOAD_ROW_KEYS = {'mode', 'concurrency', 'qps', 'p50_ms', 'p95_ms', 'p99_ms',
                 'n', 'shed', 'errors', 'error_kinds', 'embed_dispatches',
                 'embed_images', 'search_dispatches', 'search_queries'}
# tools/bench_ivf_recall.py:246-255
IVF_RECALL_KEYS = {'metric', 'gallery', 'dim', 'n_ids', 'train_steps',
                   'final_loss', 'nlist', 'k', 'recall_sweep_nprobe',
                   'train_s', 'embed_s', 'device_kind'}


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith('{')]


def assert_same_topk(got_d, got_i, want_d, want_i):
    """Indices equal where ``want``'s neighbouring distances differ by more
    than TIE_EPS; distances within DIST_ATOL."""
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=DIST_ATOL)
    gap = np.diff(want_d, axis=1)
    clear = np.ones(want_d.shape, bool)
    clear[:, 1:] &= gap > TIE_EPS
    clear[:, :-1] &= gap > TIE_EPS
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(got_i)[clear],
                                  np.asarray(want_i)[clear])


@pytest.fixture(scope='module')
def int8_scan():
    """A 4,096 x 3,968 int8 gallery, 8 unit queries (numpy, seeded) and
    pps_tpu's exact top-100 of them."""
    rng = np.random.RandomState(0)
    ng, d = 4096, 3968
    g8 = rng.randint(-127, 128, size=(ng, d)).astype(np.int8)
    sc = (1.0 / (127.0 * np.sqrt(d)) * (1.0 + 0.1 * rng.rand(ng))).astype(
        np.float32)
    q = rng.randn(8, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    wd, wi = jstreaming_topk(jnp.asarray(q), jnp.asarray(g8), k=100,
                             chunk=4096, g_scale=jnp.asarray(sc))
    return g8, sc, q, np.asarray(wd), np.asarray(wi)


def _port_inputs(g8, sc, q):
    from pps_tpu_torch.ops.topk import gallery_norms
    g, s = torch.tensor(g8), torch.tensor(sc)
    return torch.tensor(q), g, s, gallery_norms(g, s)


def test_flat_bf16_matches_pps_tpu_streaming(int8_scan):
    g8, sc, q, wd, wi = int8_scan
    qt, g, s, gn = _port_inputs(g8, sc, q)
    d2, idx = bench_exact_scan.topk_rows(bench_exact_scan.flat_bf16(
        qt, g, s, gn), 100)
    assert_same_topk(np.sqrt(d2.numpy()), idx.numpy(), wd, wi)


def test_flat_int8_refined_matches_pps_tpu_streaming(int8_scan):
    g8, sc, q, wd, wi = int8_scan
    qt, g, s, gn = _port_inputs(g8, sc, q)
    d2, idx = bench_exact_scan.flat_int8_refined(qt, g, s, gn, 100)
    assert_same_topk(np.sqrt(d2.numpy()), idx.numpy(), wd, wi)
    # the int8 cross term alone is approximate: most of the top-k survives
    _, approx = bench_exact_scan.topk_rows(
        bench_exact_scan.flat_int8(qt, g, s, gn), 100)
    overlap = np.mean([len(set(approx[r].tolist()) & set(wi[r].tolist()))
                       / 100 for r in range(8)])
    assert overlap > 0.8


def test_flat_int8_scores_are_the_int8_product(int8_scan):
    g8, sc, q, _, _ = int8_scan
    qt, g, s, _ = _port_inputs(g8, sc, q[:3])
    got = bench_exact_scan.flat_int8_scores(qt, g, s).numpy()
    qs = np.maximum(np.abs(q[:3]).max(axis=1, keepdims=True), 1e-12) / 127
    q8 = np.clip(np.round(q[:3] / qs), -127, 127).astype(np.int64)
    want = (q8 @ g8.astype(np.int64).T).astype(np.float32) * qs * sc[None]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bench_exact_scan_main_on_the_cpu(capsys):
    results = {}
    out = bench_exact_scan.main(
        ['--device', 'cpu', '--gallery-size', '2048', '--dim', '256',
         '--chunks', '512,2048', '--iters', '2', '--nq', '2'],
        results=results)
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == EXACT_SCAN_KEYS == set(out)
    assert set(out['checks']) == EXACT_SCAN_CHECK_KEYS
    assert set(out['latency_ms']) == {'stream512', 'stream2048', 'flat_bf16',
                                      'flat_int8', 'flat_int8_refined',
                                      'pure_read'}
    assert out['checks']['flat_bf16_topk_agree'] == 1.0
    ref_d2, ref_i = results['stream512']
    for name in ('stream2048', 'flat_bf16', 'flat_int8_refined'):
        d2, ii = results[name]
        assert_same_topk(np.sqrt(d2), ii, np.sqrt(ref_d2), ref_i)


def test_rerank_card_path_matches_pps_tpu_numpy():
    qg, qq, gg = bench_rerank.inputs(64, 256, 256)
    got = rerank_distmat_device(torch.tensor(qg), torch.tensor(qq),
                                torch.tensor(gg)).numpy()
    want = jrr.re_ranking(qg, qq, gg)
    far = np.abs(got - want) > ENTRY_ATOL
    assert far.mean() <= FLIP_SHARE, far.mean()


def test_bench_rerank_main_on_the_cpu(capsys):
    out = bench_rerank.main(['--device', 'cpu', '--nq', '64', '--ng', '256',
                             '--check-numpy'])
    text = capsys.readouterr().out
    for line in ('device sparse-set:', 'native C++/OpenMP:',
                 'numpy golden:'):
        assert line in text
    assert out['share_apart_dev_native'] <= FLIP_SHARE
    assert out['share_apart_dev_numpy'] <= FLIP_SHARE
    assert out['max_abs_diff_dev_native'] < 1e-3


def _recount(pos, perm, exact):
    """Recall@k by hand: each query's IVF hits (-1 slots dropped) against
    its exact top-k."""
    total = 0.0
    for r in range(exact.shape[0]):
        hits = {int(perm[p]) for p in pos[r] if p >= 0}
        total += len(hits & set(exact[r].tolist())) / exact.shape[1]
    return total / exact.shape[0]


def test_ivf_recall_recount():
    rng = np.random.RandomState(3)
    ng, nq, k = 500, 12, 20
    perm = rng.permutation(ng).astype(np.int32)
    exact = np.stack([rng.choice(ng, k, replace=False) for _ in range(nq)])
    inv = np.argsort(perm)
    # each query: some true hits, some misses, some unfilled slots
    pos = np.full((nq, k), -1, np.int64)
    for r in range(nq):
        n_hit, n_miss = rng.randint(0, k + 1), rng.randint(0, 3)
        hit = inv[exact[r][:n_hit]]
        miss = inv[rng.choice(np.setdiff1d(np.arange(ng), exact[r]), n_miss,
                              replace=False)]
        row = np.concatenate([hit, miss])[:k]
        pos[r, :row.size] = row
    got = bench_ivf_recall.recall_at_k(pos, perm, exact)
    assert got == _recount(pos, perm, exact)
    # a full probe finds every exact row
    assert bench_ivf_recall.recall_at_k(inv[exact], perm, exact) == 1.0
    # an unfilled slot is no hit, even where perm[0] is an exact row
    exact0 = exact.copy()
    exact0[:, 0] = perm[0]
    assert bench_ivf_recall.recall_at_k(np.full((nq, k), -1), perm,
                                        exact0) == 0.0


def test_bench_ivf_recall_main_on_the_cpu(narrow, tmp_path, capsys):
    from pps_tpu_torch.ops.ivf import default_nlist
    nlist = default_nlist(8 * 4)
    probes = {}
    out = bench_ivf_recall.main(
        ['--device', 'cpu', '--n-ids', '8', '--per-id', '4', '--queries', '4',
         '--train-steps', '1', '--topk', '5', '--embed-batch', '16',
         '--nprobes', '1,{}'.format(nlist), '--workdir', str(tmp_path)],
        results=probes)
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == IVF_RECALL_KEYS == set(out)
    assert out['dim'] == DIM and out['nlist'] == nlist
    assert out['recall_sweep_nprobe'][nlist] == 1.0
    assert line['recall_sweep_nprobe'][str(nlist)] == 1.0
    # every cell probed: the exact scan's rows and distances
    (ed, ei), (fd, fi) = probes['exact'], probes[nlist]
    assert ei.shape == (4, 6) and fi.shape == (4, 5)
    assert_same_topk(fd, fi, ed[:, :5], ei[:, :5])


def test_bench_serving_main_on_the_cpu(narrow, capsys):
    results = {}
    argv = ['--device', 'cpu', '--gallery-size', '2048', '--dim', str(DIM),
            '--iters', '1', '--topk', '10']
    out = bench_serving.main(argv + ['--rerank'], results=results)
    out_ivf = bench_serving.main(argv + ['--ivf', '--ivf-nprobe', '2'])
    lines = _json_lines(capsys.readouterr().out)
    assert [set(ln) for ln in lines] == [
        SERVING_KEYS | SERVING_RERANK_KEYS, SERVING_KEYS | {'ivf'}]
    assert set(out) == set(lines[0]) and set(out_ivf) == set(lines[1])
    assert set(out_ivf['ivf']) == SERVING_IVF_KEYS | {'recall_at_10'}
    assert out['rerank_engine'] == 'native'
    # the timed query's top-k is RetrievalIndex.search's on the same rows
    rows = torch.cat([r for _, r in bench_serving.gallery_rows(
        2048, DIM, torch.device('cpu'))])
    index = RetrievalIndex(rows, list(range(2048)), int8=True, device='cpu')
    wd, wi = index.search(results['query'], 10)
    assert_same_topk(results['dists'], results['indices'], wd, wi)


def test_int8_gallery_is_what_an_index_stores():
    dev = torch.device('cpu')
    g8, sc = bench_serving.int8_gallery(300, 24, dev)
    rows = torch.cat([r for _, r in bench_serving.gallery_rows(300, 24, dev)])
    index = RetrievalIndex(rows, list(range(300)), int8=True, device='cpu')
    assert np.array_equal(index._host_g, g8.numpy())
    assert np.array_equal(index._host_s, sc.numpy())


class _Stub(http.server.BaseHTTPRequestHandler):
    """/search answers in turn 200, 200, 503, 500; /stats counts."""
    calls = 0
    lock = threading.Lock()

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers['Content-Length']))
        with _Stub.lock:
            _Stub.calls += 1
            n = _Stub.calls
        code = {0: 200, 1: 200, 2: 503, 3: 500}[n % 4]
        body = b'{}'
        self.send_response(code)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        body = json.dumps({'embed': {'dispatches': _Stub.calls,
                                     'images': 2 * _Stub.calls},
                           'search': {'dispatches': 0}}).encode()
        self.send_response(200)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_load_level_arithmetic_against_a_stub_server():
    httpd = http.server.ThreadingHTTPServer(('127.0.0.1', 0), _Stub)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        host, port = httpd.server_address[:2]
        s0 = bench_serving._http_json('http://%s:%d/stats' % (host, port))
        lats, qps, shed, errs = bench_serving.run_level(
            host, port, 3, 0.6, 0.0, [b'png'], '')
        s1 = bench_serving._http_json('http://%s:%d/stats' % (host, port))
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(10)
    assert not th.is_alive()
    calls = s1['embed']['dispatches'] - s0['embed']['dispatches']
    assert lats == sorted(lats) and len(lats) > 0
    # every fourth answer a 503 (shed), every fourth a 500 (an error)
    assert abs(shed - calls / 4) <= 3
    assert abs(errs['http_status'] - calls / 4) <= 3
    assert len(lats) + shed + errs['http_status'] == calls
    assert qps == len(lats) / 0.6
    row = bench_serving.level_row('exact', 3, lats, qps, shed, errs, s0, s1)
    assert set(row) == LOAD_ROW_KEYS
    assert row['n'] == len(lats) and row['errors'] == errs['http_status']
    assert row['embed_dispatches'] == calls
    assert row['embed_images'] == 2 * calls
    assert row['search_queries'] is None  # a counter the server lacks
    for p, key in ((0.50, 'p50_ms'), (0.95, 'p95_ms'), (0.99, 'p99_ms')):
        assert row[key] == round(lats[min(len(lats) - 1,
                                          int(p * len(lats)))], 1)


@pytest.mark.parametrize('n', [1, 7, 100, 1001])
def test_percentile_is_the_rank_formula(n):
    lats = sorted(np.random.RandomState(n).rand(n) * 100)
    for p in (0.5, 0.95, 0.99):
        assert bench_serving.percentile(lats, p) == round(
            lats[min(n - 1, int(p * n))], 1)
    assert bench_serving.percentile([], 0.5) is None


NARROW_YAML = '''MODEL:
  TYPE: generalized_reid
  CONV_BODY: ResNet.add_ResNet50_conv5_body
  NUM_CLASSES: 5
  USE_BN: True
  DTYPE: float32
FAST_RCNN:
  ROI_BOX_HEAD: pps_heads.add_pps_part_head
RESNETS:
  RES5_STRIDE: 1
  WIDTH_PER_GROUP: 8
REID:
  SCALE: (32, 96)
  BPM_STRIP_NUM: 3
  BPM_DIM: 16
  CRM: True
  NORMALIZE_FEATURE: True
  MAX_AVE_FEATURE: True
TEST:
  IMS_PER_BATCH: 4
'''


def test_bench_serving_load_main_against_the_daemon(tmp_path, capsys):
    """--load on the CPU: fabricates weights, an index and query PNGs,
    starts ``python -m pps_tpu_torch.tools.serve --device cpu`` and
    drives it; every row with the JAX tool's keys."""
    (tmp_path / 'cfg.yaml').write_text(NARROW_YAML)
    out = bench_serving.main(
        ['--device', 'cpu', '--load', '--gallery-size', '256',
         '--load-concurrency', '1', '--load-duration', '0.7',
         '--load-warmup', '0.2', '--load-modes', 'exact',
         '--load-cfg', str(tmp_path / 'cfg.yaml'),
         '--load-workdir', str(tmp_path / 'work')])
    lines = _json_lines(capsys.readouterr().out)
    assert set(lines[-1]) == {'loadbench', 'rows'} == set(out)
    assert out['rows'] == 1 and len(lines) == 2
    row = lines[0]
    assert set(row) == LOAD_ROW_KEYS
    assert row['mode'] == 'exact' and row['n'] > 0 and row['errors'] == 0
    assert row['embed_dispatches'] >= 1 and row['search_queries'] >= 1
    with open(out['loadbench']) as f:
        assert json.load(f)['results'] == [row]
