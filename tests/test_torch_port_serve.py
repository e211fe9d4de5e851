"""The port's serving daemon (``python -m pps_tpu_torch.tools.serve``) as a
``--device cpu`` subprocess on a tiny yaml, and ``tools.retrieve`` (plain
and with ``--shard-gallery``).

Held: every endpoint answers with pps_tpu's JSON keys (the sets below are
those of ``tools/serve.py``); /search equals an in-process port
``RetrievalIndex.search`` of the same image; /add then /remove leaves the
answers as they were; SIGTERM saves the index, a ``--load-index``
restart and ``retrieve`` answer as before, and pps_tpu loads the saved
file; the 413 / 404 / 400 paths.

Tolerance.  The daemon and this process embed the same decodes with the
same weights but other thread counts, so features agree to float32
rounding: paths are held equal wherever neighbouring distances differ by
more than ``TIE_EPS`` and distances within ``DIST_ATOL``.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from pps_tpu.engine import serving as jserv
from pps_tpu_torch import config as tcfg
from pps_tpu_torch import kernels
from pps_tpu_torch.data.transforms import _cv2
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine import serving as tserv
from pps_tpu_torch.kernels import conv2d_int8, zero_even
from pps_tpu_torch.models.model import build_model

REPO = Path(__file__).resolve().parents[1]
TIE_EPS = 1e-4
DIST_ATOL = 1e-4

# the JSON keys of tools/serve.py's answers
HEALTHZ_KEYS = {'status', 'gallery_size', 'dim', 'int8', 'sharded', 'ivf'}
SEARCH_KEYS = {'results', 'reranked', 'latency_ms'}
RESULT_KEYS = {'rank', 'path', 'distance'}
ADD_KEYS = {'added', 'gallery_size'}
REMOVE_KEYS = {'removed', 'gallery_size'}
STATS_KEYS = {'requests', 'errors', 'adds', 'removes', 'gallery_size',
              'embed', 'search', 'latency_ms'}
STATS_EMBED_KEYS = {'dispatches', 'images', 'avg_batch', 'pending', 'shed'}
STATS_SEARCH_KEYS = {'dispatches', 'queries', 'device_scans', 'avg_batch',
                     'pending', 'shed'}
STATS_LATENCY_KEYS = {'mean', 'p50', 'p90', 'p99', 'count'}

YAML = '''MODEL:
  TYPE: generalized_reid
  CONV_BODY: ResNet.add_ResNet50_conv5_body
  NUM_CLASSES: 5
  USE_BN: True
  DTYPE: float32
FAST_RCNN:
  ROI_BOX_HEAD: pps_heads.add_pps_part_head
RESNETS:
  RES5_STRIDE: 1
REID:
  SCALE: (32, 96)
  BPM_STRIP_NUM: 5
  BPM_DIM: 128
  CRM: True
  NORMALIZE_FEATURE: True
  MAX_AVE_FEATURE: True
TEST:
  IMS_PER_BATCH: 8
'''


@pytest.fixture(scope='module')
def site(tmp_path_factory):
    """A yaml, a weights pkl, 10 gallery and 3 query images on disk."""
    root = tmp_path_factory.mktemp('serve')
    (root / 'cfg.yaml').write_text(YAML)
    tcfg.reset_cfg()
    tcfg.merge_cfg_from_file(str(root / 'cfg.yaml'))
    tcfg.assert_and_infer_cfg(make_immutable=False)
    cfg = tcfg.cfg
    model = build_model(cfg, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    tckpt.save_checkpoint(str(root / 'w.pkl'), model, params, state)
    cv2 = _cv2()
    rng = np.random.RandomState(0)
    (root / 'gal').mkdir()
    (root / 'q').mkdir()
    for i in range(13):
        blocks = rng.randint(0, 256, (8, 4, 3))
        im = np.kron(blocks, np.ones((6, 5, 1))) + rng.randn(48, 20, 3) * 8
        im = np.clip(im, 0, 255).astype(np.uint8)
        path = (root / 'gal' / ('%08d_0001_%08d.png' % (i // 2, i))
                if i < 10 else root / 'q' / ('q%d.png' % (i - 10)))
        cv2.imwrite(str(path), im)
    # the in-process reference: the same embedding and index
    qe = tserv.QueryEmbedder(cfg, model, params, state, max_batch=8,
                             device='cpu')
    gal = tserv.list_gallery_images(str(root / 'gal'))
    index = tserv.RetrievalIndex(qe.embed(gal), gal, int8=True,
                                 device='cpu')
    queries = sorted(str(p) for p in (root / 'q').iterdir())
    yield {'root': root, 'qe': qe, 'index': index, 'queries': queries}
    tcfg.reset_cfg()


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='2')


class Daemon:
    def __init__(self, site, *extra):
        root = site['root']
        self.ready = root / 'ready'
        if self.ready.exists():
            self.ready.unlink()
        cmd = [sys.executable, '-m', 'pps_tpu_torch.tools.serve',
               '--device', 'cpu', '--cfg', str(root / 'cfg.yaml'),
               '--weights', str(root / 'w.pkl'), '--port', '0',
               '--ready-file', str(self.ready), '--max-body-mb', '1',
               '--save-index', str(root / 'idx.npz'), *extra]
        self.log = open(str(root / 'serve.log'), 'a')
        self.proc = subprocess.Popen(cmd, cwd=str(root), env=_env(),
                                     stdout=self.log, stderr=self.log)
        t0 = time.time()
        while not self.ready.exists():
            if self.proc.poll() is not None or time.time() - t0 > 120:
                raise AssertionError((root / 'serve.log').read_text())
            time.sleep(0.1)
        host, port = self.ready.read_text().split()
        self.base = 'http://{}:{}'.format(host, port)

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            body = r.read()
        return body if path == '/metrics' else json.loads(body)

    def post(self, path, data, ctype='application/json'):
        if not isinstance(data, bytes):
            data = json.dumps(data).encode()
        req = urllib.request.Request(self.base + path, data=data,
                                     headers={'Content-Type': ctype})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def stop(self):
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(60)
        self.log.close()
        return rc


def _ranked(results):
    return ([r['path'] for r in results],
            np.array([r['distance'] for r in results]))


def _assert_same_ranking(paths, dists, want_paths, want_d):
    """``want`` may hold one more rank than ``paths``: it tells whether the
    last rank could trade places with the next row outside the list."""
    k = len(paths)
    gap = np.diff(want_d)
    clear = np.ones(len(want_d), bool)
    clear[1:] &= gap > TIE_EPS
    clear[:-1] &= gap > TIE_EPS
    clear, want_paths, want_d = clear[:k], want_paths[:k], want_d[:k]
    assert len(want_paths) == k
    np.testing.assert_allclose(dists, want_d, rtol=0, atol=DIST_ATOL)
    assert [p for p, c in zip(paths, clear) if c] == \
        [p for p, c in zip(want_paths, clear) if c]


def _search_all(d, site, k=4):
    out = []
    for q in site['queries']:
        code, body = d.post('/search?k=%d' % k, Path(q).read_bytes(),
                            'image/png')
        assert code == 200 and set(body) == SEARCH_KEYS
        assert all(set(r) == RESULT_KEYS for r in body['results'])
        out.append(_ranked(body['results']))
    return out


def test_daemon_endpoints_restart_and_retrieve(site):
    root = site['root']
    d = Daemon(site, '--gallery', str(root / 'gal'), '--int8-gallery')
    try:
        health = d.get('/healthz')
        assert set(health) == HEALTHZ_KEYS
        assert health['gallery_size'] == 10 and health['int8']
        assert not health['sharded'] and not health['ivf']
        before = _search_all(d, site)
        want_d, want_i, want_p = site['index'].search(
            site['qe'].embed(site['queries']), 5, return_paths=True)
        for (paths, dists), wp, wd in zip(before, want_p, want_d):
            _assert_same_ranking(paths, dists, wp, wd)
        # re-ranked and multi-query searches by path
        code, rr = d.post('/search?k=3&rerank=1',
                          Path(site['queries'][0]).read_bytes(), 'image/png')
        assert code == 200 and rr['reranked'] and len(rr['results']) == 3
        want_rr = site['index'].search_reranked(
            site['qe'].embed(site['queries'][:1]), 4, return_paths=True)
        _assert_same_ranking(*_ranked(rr['results']), want_rr[2][0],
                             want_rr[0][0])
        code, multi = d.post('/search_path', {
            'paths': site['queries'][:2], 'multi': True, 'k': 2,
            'rerank': True})
        assert code == 200 and set(multi) == SEARCH_KEYS
        assert len(multi['results']) == 1 and len(multi['results'][0]) == 2
        # /add then /remove leaves the answers as they were
        code, add = d.post('/add', {'paths': site['queries']})
        assert code == 200 and set(add) == ADD_KEYS
        assert add['gallery_size'] == 13
        code, rem = d.post('/remove', {'paths': site['queries']})
        assert code == 200 and set(rem) == REMOVE_KEYS
        assert rem == {'removed': 3, 'gallery_size': 10}
        for (p, dd), (p0, d0) in zip(_search_all(d, site), before):
            assert p == p0
            np.testing.assert_allclose(dd, d0, rtol=0, atol=1e-6)
        # refusals
        assert d.post('/search', b'x' * (2 << 20), 'image/png')[0] == 413
        code, body = d.post('/search_path', {'path': '/no/such.png'})
        assert code == 404 and body['paths'] == ['/no/such.png']
        assert d.post('/search_path', {'paths': 'a'})[0] == 400
        stats = d.get('/stats')
        assert set(stats) == STATS_KEYS
        assert set(stats['embed']) == STATS_EMBED_KEYS
        assert set(stats['search']) == STATS_SEARCH_KEYS
        assert set(stats['latency_ms']) == STATS_LATENCY_KEYS
        assert stats['adds'] == 1 and stats['removes'] == 1
        assert stats['errors'] == 3
        metrics = d.get('/metrics').decode()
        assert 'pps_serve_requests_total' in metrics
        assert 'pps_serve_search_latency_ms_p50' in metrics
    finally:
        assert d.stop() == 0
    assert (root / 'idx.npz').exists()

    # the saved index: pps_tpu loads it, a restart answers as before
    loaded = jserv.RetrievalIndex.load(str(root / 'idx.npz'))
    assert loaded.paths == site['index'].paths and loaded.int8
    d = Daemon(site, '--load-index', str(root / 'idx.npz'))
    try:
        for (p, dd), (p0, d0) in zip(_search_all(d, site), before):
            assert p == p0
            np.testing.assert_allclose(dd, d0, rtol=0, atol=1e-6)
    finally:
        assert d.stop() == 0

    # retrieve, and retrieve with the gallery row-sharded (one shard per
    # card it sees; the CPU's one here), answer as the daemon did
    for extra in ([], ['--shard-gallery']):
        r = subprocess.run(
            [sys.executable, '-m', 'pps_tpu_torch.tools.retrieve',
             '--device', 'cpu', '--cfg', str(root / 'cfg.yaml'),
             '--weights', str(root / 'w.pkl'), '--load-index',
             str(root / 'idx.npz'), '--topk', '4'] + extra +
            ['--query', *site['queries']],
            cwd=str(root), env=dict(_env(), **{
                kernels.LAUNCH_COUNTS_ENV: str(root /
                                               'retrieve.launches.json')}),
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-3000:]
        # the entry point reports its own kernel launches at exit: none on
        # the CPU, where every wrapper runs its plain version
        counts = json.loads((root / 'retrieve.launches.json').read_text())
        assert counts == {'conv2d_int8': 0, 'zero_even': 0}
        blocks = r.stdout.split('query: ')[1:]
        assert len(blocks) == 3
        for block, (p0, d0) in zip(blocks, before):
            rows = [ln.split() for ln in block.splitlines()[1:]]
            dists = np.array([float(row[1][2:]) for row in rows])
            _assert_same_ranking([row[2] for row in rows], dists, p0, d0)


def test_write_launch_counts(monkeypatch, tmp_path):
    """An entry point's launch counts go to the file the environment names,
    and nowhere when it names none."""
    monkeypatch.setattr(zero_even, 'launches', 3)
    monkeypatch.setattr(conv2d_int8, 'launches', 5)
    monkeypatch.delenv(kernels.LAUNCH_COUNTS_ENV, raising=False)
    kernels.write_launch_counts()
    assert list(tmp_path.iterdir()) == []
    path = tmp_path / 'counts.json'
    monkeypatch.setenv(kernels.LAUNCH_COUNTS_ENV, str(path))
    kernels.write_launch_counts()
    assert json.loads(path.read_text()) == {'conv2d_int8': 5,
                                            'zero_even': 3}
    assert [p.name for p in tmp_path.iterdir()] == ['counts.json']
