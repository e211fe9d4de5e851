"""Retrieval serving daemon: an HTTP/JSON endpoint over the
device-resident gallery index (counterpart of ``tools/serve.py``).

Loads a trained checkpoint once, embeds (or cache-loads) a gallery
directory or loads a saved index, places it on the device
(``RetrievalIndex``, float32 or int8), warms up, then answers queries
until stopped.  stdlib HTTP only.  Concurrent query embeds coalesce into
one device dispatch (``EmbedBatcher``), and concurrent gallery scans
coalesce the same way (``SearchBatcher``).

    python -m pps_tpu_torch.tools.serve --cfg <yaml> --weights <pkl> \
        (--gallery DIR | --load-index idx.npz) [--port 8080] \
        [--int8-gallery] [--ivf] [--ready-file FILE] \
        [--save-index idx.npz] [--device cuda|cpu]

--save-index/--load-index persist the PLACED index (the stored int8 rows
and scales, not float32 features).  The save happens after warmup and
again on graceful shutdown (SIGTERM/ctrl-C), so rows appended through
/add survive a restart.

Bodies over --max-body-mb are refused with 413 (drained in bounded
chunks, keep-alive preserved); when a backlog passes --max-pending,
requests shed with 503; GET /metrics serves the counters in Prometheus
text format.

Endpoints (all JSON unless noted):
  GET  /healthz      liveness + gallery size/dim/placement
  GET  /stats        request counters + latency percentiles (ms)
  GET  /metrics      the same counters, Prometheus text exposition
  POST /search       body = raw jpg/png bytes; ?k=10 -> ranked matches
                     (?rerank=1 [&shortlist=100] applies k-reciprocal
                     re-ranking to the device-retrieved shortlist)
  POST /search_path  {"path": "/img.jpg", "k": 10} or {"paths": [...]}
                     -> ranked matches per query (server-local files);
                     {"rerank": true, "shortlist": 100} as for /search;
                     {"multi": true [, "pool": "average"|"max"]} pools
                     all paths into ONE query (the evaluator's
                     multi-query protocol: pool features, no renorm)
                     -> a single ranked list
  POST /add          {"paths": [...]} -> embed + append to the gallery
  POST /remove       {"paths": [...]} -> drop those gallery rows
"""

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import numpy as np

from pps_tpu_torch.engine.serving import Overloaded


class _BodyTooLarge(ValueError):
    pass


class _ChunkedBody(ValueError):
    pass


class ServerState(object):
    """Everything a request needs: the embed batcher, the search
    batcher, the index, stats."""

    def __init__(self, batcher, index, default_k, search_batcher=None):
        self.batcher = batcher            # EmbedBatcher (serializes +
        self.index = index                # coalesces device embeds)
        self.search_batcher = search_batcher  # SearchBatcher (coalesces
        self.default_k = default_k            # device gallery scans)
        self.stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_errors = 0
        self.latencies_ms = []            # last 1024 SEARCH latencies only
        self.n_adds = 0
        self.n_removes = 0

    def record(self, ms, error=False, kind='search'):
        """Count a request; only non-error *search* latencies feed the
        /stats percentiles (an /add takes seconds in the embed pipeline
        and would poison the search-latency monitoring signal)."""
        with self.stats_lock:
            self.n_requests += 1
            if error:
                self.n_errors += 1
            elif kind == 'search':
                self.latencies_ms.append(ms)
                if len(self.latencies_ms) > 1024:
                    self.latencies_ms = self.latencies_ms[-1024:]
            elif kind == 'add':
                self.n_adds += 1
            else:
                self.n_removes += 1

    def metrics_text(self):
        """Prometheus text exposition of the same counters /stats
        serves as JSON (scrapers point at GET /metrics)."""
        s = self.stats()
        lines = []

        def emit(name, kind, value, help_text):
            if value is None:
                return
            lines.append('# HELP pps_serve_{} {}'.format(name, help_text))
            lines.append('# TYPE pps_serve_{} {}'.format(name, kind))
            lines.append('pps_serve_{} {}'.format(name, value))

        emit('requests_total', 'counter', s['requests'], 'HTTP requests')
        emit('errors_total', 'counter', s['errors'], 'failed requests')
        emit('adds_total', 'counter', s['adds'], 'gallery /add requests')
        emit('removes_total', 'counter', s['removes'],
             'gallery /remove requests')
        emit('gallery_size', 'gauge', s['gallery_size'], 'index rows')
        e = s['embed']
        emit('embed_dispatches_total', 'counter', e['dispatches'],
             'device embed dispatches')
        emit('embed_images_total', 'counter', e['images'],
             'images embedded')
        emit('embed_pending', 'gauge', e['pending'],
             'embed requests queued')
        emit('embed_shed_total', 'counter', e['shed'],
             'requests refused at max_pending')
        se = s.get('search')
        if se:
            emit('search_dispatches_total', 'counter', se['dispatches'],
                 'logical gallery-scan dispatches (coalesced groups)')
            emit('search_device_scans_total', 'counter',
                 se['device_scans'],
                 'real device gallery scans (>= dispatches: oversized '
                 'groups chunk)')
            emit('search_queries_total', 'counter', se['queries'],
                 'query rows scanned')
            emit('search_pending', 'gauge', se['pending'],
                 'search requests queued')
            emit('search_shed_total', 'counter', se['shed'],
                 'search requests refused at max_pending')
        lat = s.get('latency_ms')
        if lat:
            for q in ('p50', 'p90', 'p99'):
                emit('search_latency_ms_{}'.format(q), 'gauge', lat[q],
                     'search latency {} (last {} searches)'.format(
                         q, lat['count']))
        return '\n'.join(lines) + '\n'

    def stats(self):
        with self.stats_lock:
            lat = np.asarray(self.latencies_ms, np.float64)
            out = {'requests': self.n_requests, 'errors': self.n_errors,
                   'adds': self.n_adds, 'removes': self.n_removes,
                   'gallery_size': len(self.index)}
            stale = self.index.ivf_staleness
            if stale is not None:
                # operators watch this for the retrain policy
                # (engine/serving.py RetrievalIndex.ivf_staleness)
                out['ivf_staleness'] = round(stale, 4)
                out['ivf_retrains'] = self.index.retrain_count
                out['ivf_retraining'] = self.index.retraining
            nd, ni = self.batcher.dispatches, self.batcher.images
            out['embed'] = {'dispatches': nd, 'images': ni,
                            'avg_batch': round(ni / nd, 2) if nd else None,
                            'pending': self.batcher.pending(),
                            'shed': self.batcher.shed}
            sb = self.search_batcher
            if sb is not None:
                sd, sq = sb.dispatches, sb.queries
                out['search'] = {
                    'dispatches': sd, 'queries': sq,
                    'device_scans': sb.device_scans,
                    'avg_batch': round(sq / sd, 2) if sd else None,
                    'pending': sb.pending(), 'shed': sb.shed}
            if lat.size:
                out['latency_ms'] = {
                    'mean': round(float(lat.mean()), 2),
                    'p50': round(float(np.percentile(lat, 50)), 2),
                    'p90': round(float(np.percentile(lat, 90)), 2),
                    'p99': round(float(np.percentile(lat, 99)), 2),
                    'count': int(lat.size)}
            return out


def make_handler(state, recall_target, rerank_cfg=None,
                 max_body_bytes=32 * 1024 * 1024):
    # rerank_cfg: dict(shortlist, k1, k2, lam) server defaults for
    # per-request k-reciprocal re-ranking (requests opt in / override)
    rerank_cfg = rerank_cfg or {}

    class Handler(BaseHTTPRequestHandler):
        server_version = 'pps-tpu-torch-serve/1.0'
        protocol_version = 'HTTP/1.1'

        def log_message(self, fmt, *args):  # route access log to stderr
            sys.stderr.write('%s - %s\n' % (self.address_string(),
                                             fmt % args))

        def _json(self, code, obj):
            body = json.dumps(obj).encode('utf-8')
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            if self.close_connection:
                # tell the peer we will close (e.g. an undrainable
                # chunked body) instead of silently dropping keep-alive
                self.send_header('Connection', 'close')
            self.end_headers()
            self.wfile.write(body)

        def _try_json(self, code, obj):
            """Best-effort error reply: the peer may already be gone."""
            try:
                self._json(code, obj)
            except OSError:
                self.close_connection = True

        def _results(self, dists, idxs, paths):
            # paths were resolved inside the index lock (race-safe vs a
            # concurrent /remove renumbering the rows); never re-resolve
            # indices against the live state.index.paths here
            out = []
            for qi in range(dists.shape[0]):
                ranked = [
                    {'rank': r + 1,
                     'path': paths[qi][r],
                     'distance': round(float(dists[qi, r]), 6)}
                    for r in range(dists.shape[1])
                    if int(idxs[qi, r]) >= 0 and paths[qi][r] is not None]
                out.append(ranked)
            return out

        def _read_body(self):
            te = (self.headers.get('Transfer-Encoding') or '').lower()
            if 'chunked' in te:
                # no chunked decoding here: the frames can't be drained
                # by Content-Length, so replying while they sit in rfile
                # would poison the keep-alive stream (the next request
                # would parse a chunk-size line as its request line).
                # Refuse with 411 and close THIS connection instead.
                self.close_connection = True
                raise _ChunkedBody('chunked Transfer-Encoding not '
                                   'supported; send Content-Length')
            length = int(self.headers.get('Content-Length', 0))
            if length > max_body_bytes:
                # drain in bounded chunks (keep-alive stays usable),
                # then refuse: an oversized POST must not allocate its
                # own Content-Length on the server
                left = length
                while left > 0:
                    chunk = self.rfile.read(min(left, 1 << 20))
                    if not chunk:
                        # client hung up mid-body: read() returns b''
                        # forever at EOF — stop draining or this loop
                        # spins at 100% CPU on a dead socket
                        self.close_connection = True
                        break
                    left -= len(chunk)
                raise _BodyTooLarge(
                    'body {} bytes exceeds limit {}'.format(
                        length, max_body_bytes))
            return self.rfile.read(length) if length else b''

        def _search(self, q, k, opts):
            """Route a query batch through plain or re-ranked retrieval.

            ``opts`` carries per-request overrides (query params for
            /search, JSON keys for /search_path); server flags provide
            the defaults.  Returns ((dists, idxs, paths), reranked_flag)
            with paths resolved under the index lock.
            """
            if str(opts.get('rerank', '')).lower() in ('1', 'true', 'yes'):
                rk = {'shortlist': int(opts.get(
                          'shortlist', rerank_cfg.get('shortlist', 100))),
                      'k1': int(opts.get('k1', rerank_cfg.get('k1', 20))),
                      'k2': int(opts.get('k2', rerank_cfg.get('k2', 6))),
                      'lam': float(opts.get(
                          'lambda', rerank_cfg.get('lam', 0.3)))}
                if state.search_batcher is not None:
                    d, i, p = state.search_batcher.search(
                        q, k, recall_target=recall_target, rerank=rk)
                else:
                    d, i, p = state.index.search_reranked(
                        q, k, shortlist=rk['shortlist'], k1=rk['k1'],
                        k2=rk['k2'], lambda_value=rk['lam'],
                        recall_target=recall_target, return_paths=True)
                return (d, i, p), True
            if state.search_batcher is not None:
                d, i, p = state.search_batcher.search(
                    q, k, recall_target=recall_target)
            else:
                d, i, p = state.index.search(
                    q, k, recall_target=recall_target, return_paths=True)
            return (d, i, p), False

        def do_GET(self):
            path = urlparse(self.path).path
            if path == '/healthz':
                self._json(200, {
                    'status': 'ok',
                    'gallery_size': len(state.index),
                    'dim': state.index.dim,
                    'int8': state.index.int8,
                    'sharded': state.index.shard,
                    'ivf': state.index.ivf_enabled})
            elif path == '/stats':
                self._json(200, state.stats())
            elif path == '/metrics':
                body = state.metrics_text().encode('utf-8')
                self.send_response(200)
                self.send_header('Content-Type',
                                 'text/plain; version=0.0.4')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {'error': 'unknown path {}'.format(path)})

        def do_POST(self):
            url = urlparse(self.path)
            t0 = time.perf_counter()
            # drain the body FIRST, unconditionally: under HTTP/1.1
            # keep-alive, replying without reading Content-Length bytes
            # leaves them in the socket and the next request on the
            # connection parses the leftover body as its request line
            try:
                raw = self._read_body()
            except _BodyTooLarge as e:
                state.record(0.0, error=True)
                self._try_json(413, {'error': str(e)})
                return
            except _ChunkedBody as e:
                state.record(0.0, error=True)
                self._try_json(411, {'error': str(e)})
                return
            try:
                if url.path == '/search':
                    opts = {kk: vv[0]
                            for kk, vv in parse_qs(url.query).items()}
                    k = int(opts.get('k', state.default_k))
                    if not raw:
                        raise ValueError('empty body; POST image bytes')
                    ctype = self.headers.get('Content-Type', 'image/jpeg')
                    suffix = '.png' if 'png' in ctype else '.jpg'
                    fd, tmp = tempfile.mkstemp(suffix=suffix)
                    try:
                        with os.fdopen(fd, 'wb') as f:
                            f.write(raw)
                        q = state.batcher.embed([tmp])
                    finally:
                        os.unlink(tmp)
                    (d, i, p), reranked = self._search(q, k, opts)
                    ms = (time.perf_counter() - t0) * 1e3
                    state.record(ms)
                    self._json(200, {'results': self._results(d, i, p)[0],
                                     'reranked': reranked,
                                     'latency_ms': round(ms, 2)})
                elif url.path == '/search_path':
                    req = json.loads(raw or '{}')
                    paths = req.get('paths') or (
                        [req['path']] if 'path' in req else None)
                    if not paths:
                        raise ValueError('need "path" or "paths"')
                    if not isinstance(paths, list) or not all(
                            isinstance(p, str) for p in paths):
                        raise ValueError('"paths" must be a list of '
                                         'strings')
                    missing = [p for p in paths if not os.path.exists(p)]
                    if missing:
                        self._json(404, {'error': 'no such file',
                                         'paths': missing})
                        state.record(0.0, error=True)
                        return
                    k = int(req.get('k', state.default_k))
                    multi = str(req.get('multi', '')).lower() in (
                        '1', 'true', 'yes')
                    pool_type = req.get('pool', 'average')
                    if multi and pool_type not in ('average', 'max'):
                        raise ValueError('"pool" must be "average" '
                                         'or "max"')
                    q = state.batcher.embed(paths)
                    if multi:
                        # the evaluator's multi-query pooling: mean/max
                        # over the feature rows, NO re-normalization
                        # (evaluation/evaluator.py:114-116)
                        q = np.asarray(q)
                        q = (q.mean(axis=0) if pool_type == 'average'
                             else q.max(axis=0))[None]
                    (d, i, p), reranked = self._search(q, k, req)
                    ms = (time.perf_counter() - t0) * 1e3
                    state.record(ms)
                    self._json(200, {'results': self._results(d, i, p),
                                     'reranked': reranked,
                                     'latency_ms': round(ms, 2)})
                elif url.path == '/add':
                    req = json.loads(raw or '{}')
                    paths = req.get('paths')
                    if not paths:
                        raise ValueError('need "paths": [...]')
                    if not isinstance(paths, list) or not all(
                            isinstance(p, str) for p in paths):
                        raise ValueError('"paths" must be a list of '
                                         'strings')
                    missing = [p for p in paths if not os.path.exists(p)]
                    if missing:
                        self._json(404, {'error': 'no such file',
                                         'paths': missing})
                        state.record(0.0, error=True)
                        return
                    feats = state.batcher.embed(paths)
                    state.index.add(feats, paths)
                    state.record((time.perf_counter() - t0) * 1e3,
                                 kind='add')
                    self._json(200, {'added': len(paths),
                                     'gallery_size': len(state.index)})
                elif url.path == '/remove':
                    req = json.loads(raw or '{}')
                    paths = req.get('paths')
                    if not isinstance(paths, list) or not paths or not all(
                            isinstance(p, str) for p in paths):
                        raise ValueError('need "paths": [non-empty list '
                                         'of strings]')
                    n = state.index.remove(paths)
                    state.record((time.perf_counter() - t0) * 1e3,
                                 kind='remove')
                    self._json(200, {'removed': n,
                                     'gallery_size': len(state.index)})
                else:
                    self._json(404,
                               {'error': 'unknown path {}'.format(url.path)})
                    state.record(0.0, error=True)
            except Overloaded as e:
                # shed load: the embed backlog is past max_pending —
                # a bounded 503 beats queueing into lost tail latency
                state.record((time.perf_counter() - t0) * 1e3, error=True)
                self._try_json(503, {'error': str(e), 'retry': True})
            except OSError:
                # the socket died (client disconnect / broken pipe) —
                # usually while WRITING a response whose request already
                # succeeded and was recorded.  Don't double-count it as
                # an error and don't write into the dead socket.
                self.close_connection = True
            except Exception as e:  # noqa: BLE001 - report, keep serving
                state.record((time.perf_counter() - t0) * 1e3, error=True)
                self._try_json(400, {'error': '{}: {}'.format(
                    type(e).__name__, e)})

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description='Serve gallery retrieval')
    parser.add_argument('--cfg', dest='cfg_file', required=True)
    parser.add_argument('--weights', required=True)
    parser.add_argument('--gallery', default=None,
                        help='directory of gallery jpgs/pngs (required '
                             'unless --load-index)')
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8080,
                        help='0 picks a free port (printed + ready-file)')
    parser.add_argument('--topk', type=int, default=10,
                        help='default k when the request does not set one')
    parser.add_argument('--int8-gallery', action='store_true',
                        help='hold the gallery int8 on the device (4x '
                             'fewer bytes than float32)')
    parser.add_argument('--shard-gallery', action='store_true',
                        help='row-shard the gallery over every card this '
                             'process sees (one shard each), merged exactly')
    parser.add_argument('--approx-recall', type=float, default=None,
                        help='accepted for compatibility: the selection '
                             'on this device is exact whatever the value')
    parser.add_argument('--ready-file', default=None,
                        help='write "<host> <port>" here once warmed up '
                             '(for supervisors / tests)')
    parser.add_argument('--refresh-cache', action='store_true')
    parser.add_argument('--rerank-shortlist', type=int, default=100,
                        help='candidate-set size for per-request '
                             'k-reciprocal re-ranking (rerank=1 requests)')
    parser.add_argument('--rerank-k1', type=int, default=20)
    parser.add_argument('--rerank-k2', type=int, default=6)
    parser.add_argument('--rerank-lambda', type=float, default=0.3)
    parser.add_argument('--max-embed-batch', type=int, default=None,
                        help='cap for coalescing concurrent query embeds '
                             'into one device dispatch (default: the '
                             'extraction batch, TEST.IMS_PER_BATCH)')
    parser.add_argument('--max-pending', type=int, default=256,
                        help='shed load (HTTP 503) when this many embed '
                             'requests are already queued')
    parser.add_argument('--max-search-batch', type=int, default=64,
                        help='cap for coalescing concurrent gallery '
                             'scans into one device dispatch; 1 disables '
                             'search coalescing')
    parser.add_argument('--no-warm-buckets', action='store_true',
                        help='skip running each coalesced-scan bucket '
                             'size once at startup')
    parser.add_argument('--max-body-mb', type=int, default=32,
                        help='refuse request bodies larger than this '
                             '(HTTP 413)')
    parser.add_argument('--load-index', default=None, metavar='NPZ',
                        help='start from a RetrievalIndex.save file '
                             'instead of embedding --gallery (int8-ness '
                             'travels with the file)')
    parser.add_argument('--save-index', default=None, metavar='NPZ',
                        help='persist the built index after warmup and '
                             'again on graceful shutdown (so /add rows '
                             'survive a restart)')
    parser.add_argument('--ivf', action='store_true',
                        help='cluster the gallery and probe only the '
                             'nearest cells per query; persisted by '
                             '--save-index, and a --load-index file that '
                             'carries an IVF keeps it without this flag')
    parser.add_argument('--ivf-nlist', type=int, default=None,
                        help='IVF cell count (default ~4*sqrt(N))')
    parser.add_argument('--ivf-nprobe', type=int, default=8,
                        help='cells scanned per query')
    parser.add_argument('--ivf-auto-retrain', type=float, default=None,
                        metavar='THRESHOLD',
                        help='re-train the IVF clustering in the '
                             'background once ivf_staleness crosses '
                             'THRESHOLD (e.g. 0.25): k-means off the '
                             'index lock, atomic centroid swap under '
                             'it. /stats reports ivf_retrains and '
                             'ivf_retraining.')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('opts', nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from pps_tpu_torch.engine.serving import (
        EmbedBatcher, QueryEmbedder, SearchBatcher, build_index_from_args)
    from pps_tpu_torch.engine.test import default_eval_batch
    from pps_tpu_torch.tools.retrieve import load_model
    from pps_tpu_torch.utils.logging import setup_logging

    logger = setup_logging(__name__)
    cfg, model, params, state = load_model(args)
    try:
        index = build_index_from_args(
            cfg, model, params, state,
            gallery=args.gallery, load_index=args.load_index,
            int8=args.int8_gallery, shard=args.shard_gallery,
            weights_path=args.weights, refresh=args.refresh_cache,
            device=args.device)
    except ValueError as e:
        parser.error(str(e))

    if args.ivf and not index.ivf_enabled:
        t0 = time.time()
        index.enable_ivf(nlist=args.ivf_nlist, nprobe=args.ivf_nprobe)
        logger.info('IVF build took %.1f s', time.time() - t0)
    if args.ivf_auto_retrain is not None:
        if not index.ivf_enabled:
            parser.error('--ivf-auto-retrain needs --ivf (or a '
                         '--load-index file that carries an IVF)')
        index.enable_auto_retrain(threshold=args.ivf_auto_retrain)

    # the persistent query embedder: each coalesced group goes at the
    # smallest padded batch of its ladder (1, 4, 16, ...)
    embedder = QueryEmbedder(cfg, model, params, state,
                             max_batch=args.max_embed_batch or
                             default_eval_batch(cfg), device=args.device)
    batcher = EmbedBatcher(embedder.embed,
                           max_batch=embedder.ladder[-1],
                           max_pending=args.max_pending)

    # warm up before accepting traffic: every ladder size of both wires,
    # the uint8 wire pinned at the gallery's own raw geometry (the shape
    # real queries from the same cameras arrive in); a loaded index whose
    # paths do not resolve here pins the network input size
    t0 = time.time()
    raw_hw = None
    if len(index.paths):
        try:
            from pps_tpu_torch.data.transforms import decode_image
            raw_hw = decode_image(index.paths[0]).shape[:2]
        except Exception:  # noqa: BLE001 - an unresolvable path
            raw_hw = None
    embedder.warmup(raw_hw=raw_hw)
    logger.info('embed ladder %s warmed in %.1f s (u8 raw %s)',
                embedder.ladder, time.time() - t0,
                raw_hw or embedder._out_hw)
    if args.load_index:
        from pps_tpu_torch.data.transforms import _cv2
        cv2 = _cv2()
        h, w = cfg.REID.SCALE[1], cfg.REID.SCALE[0]
        fd, tmp = tempfile.mkstemp(suffix='.jpg')
        try:
            with os.fdopen(fd, 'wb'):
                pass
            cv2.imwrite(tmp, np.zeros((h, w, 3), np.uint8))
            q = batcher.embed([tmp])
        finally:
            os.unlink(tmp)
    else:
        q = batcher.embed(list(index.paths[:1]))
    index.search(q, min(args.topk, len(index)),
                 recall_target=args.approx_recall)
    if min(args.rerank_shortlist, len(index)) != min(args.topk,
                                                     len(index)):
        index.search(q, min(args.rerank_shortlist, len(index)),
                     recall_target=args.approx_recall)

    search_batcher = None
    if args.max_search_batch > 1:
        search_batcher = SearchBatcher(index,
                                       max_batch=args.max_search_batch,
                                       max_pending=args.max_pending)
        if not args.no_warm_buckets:
            # each bucket size once, for the plain k and the shortlist k,
            # so the first contended burst pays no set-up
            for b in search_batcher.buckets()[1:]:
                qb = np.repeat(q, b, axis=0)
                for kk in {min(args.topk, len(index)),
                           min(args.rerank_shortlist, len(index))}:
                    index.search(qb, kk, recall_target=args.approx_recall)
            logger.info('warmed scan buckets %s',
                        search_batcher.buckets())
    logger.info('warmup done in %.1f s (gallery %d x %d, int8=%s)',
                time.time() - t0, len(index), index.dim, index.int8)
    if args.save_index:
        index.save(args.save_index)

    state_obj = ServerState(batcher, index, args.topk,
                            search_batcher=search_batcher)
    rerank_cfg = {'shortlist': args.rerank_shortlist, 'k1': args.rerank_k1,
                  'k2': args.rerank_k2, 'lam': args.rerank_lambda}
    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(state_obj, args.approx_recall, rerank_cfg,
                     max_body_bytes=args.max_body_mb * 1024 * 1024))
    host, port = httpd.server_address[:2]
    logger.info('serving on http://%s:%d', host, port)
    print('serving on http://{}:{}'.format(host, port), flush=True)
    if args.ready_file:
        tmp = args.ready_file + '.tmp'
        with open(tmp, 'w') as f:
            f.write('{} {}\n'.format(host, port))
        os.replace(tmp, args.ready_file)

    # SIGTERM -> a clean serve_forever exit, so the finally block below
    # re-saves the index with any /add'ed rows.  shutdown() blocks until
    # the serve loop stops, so it runs off the thread in serve_forever
    def _graceful(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()
    signal.signal(signal.SIGTERM, _graceful)

    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.close()
        if search_batcher is not None:
            search_batcher.close()
        if args.save_index:
            index.save(args.save_index)


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    try:
        main()
    finally:
        write_launch_counts()
