"""Single-query serving latency: embed one image + top-k against a
device-resident million-entry gallery (counterpart of
``tools/bench_serving.py``).

The interactive-retrieval metric (the throughput benchmarks measure
batched offline extraction; this measures what one user waits): one query
is the int8 PTQ flagship's embedding of one image, the exact top-k
(``ops/topk.streaming_topk``) and the result on the host.  Slope timing
(``utils/timer.slope_time``) of whole queries.  The gallery is made on the
card from a seed: unit rows quantized per row to int8 (default), float32
(--f32-gallery), or clustered identities (--ivf).

    python -m pps_tpu_torch.tools.bench_serving [--gallery-size 1000000]
        [--dim 3968] [--f32-gallery] [--topk 100] [--rerank] [--ivf]
        [--device cuda|cpu]

`--load` switches to the daemon load bench: closed-loop HTTP client pools
against the real ``python -m pps_tpu_torch.tools.serve`` (an int8 gallery
fabricated at the flagship embedding dim), recording QPS + p50/p95/p99 per
concurrency level and per mode (exact / rerank=1 / IVF), plus the
embed/search batchers' dispatch counters that evidence continuous
batching.

    python -m pps_tpu_torch.tools.bench_serving --load
        [--load-concurrency 1,4,16,64] [--load-modes exact,rerank,ivf]
        [--load-duration 15]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# gallery rows made per step on the card (131072 x 3968 float32 = 2 GB)
MAKE_BLOCK = 131072


def gallery_rows(ng, d, dev, seed=0):
    """Yield (start, unit float32 rows) blocks of an [ng, d] gallery made
    on ``dev`` from ``seed``: the same rows whatever consumes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for a in range(0, ng, MAKE_BLOCK):
        x = torch.randn(min(MAKE_BLOCK, ng - a), d, generator=gen,
                        device=dev)
        yield a, x / torch.linalg.norm(x, dim=1, keepdim=True)


def int8_gallery(ng, d, dev, seed=0):
    """(g8 [ng, d] int8, scales [ng]) on ``dev``: ``gallery_rows``
    quantized per row (``ops/topk.quantize_gallery``, as a
    ``RetrievalIndex`` built from those rows stores them)."""
    from pps_tpu_torch.ops.topk import quantize_gallery
    g8 = torch.empty((ng, d), dtype=torch.int8, device=dev)
    sc = torch.empty((ng,), dtype=torch.float32, device=dev)
    for a, rows in gallery_rows(ng, d, dev, seed):
        g8[a:a + rows.shape[0]], sc[a:a + rows.shape[0]] = \
            quantize_gallery(rows)
    return g8, sc


def clustered_gallery(ng, d, dev, seed=0):
    """(g8, scales) of clustered identities (~100 rows per identity, the
    regime IVF exploits): int8 centres plus small int8 noise, made on
    ``dev`` a block at a time."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_ids = max(1, ng // 100)
    centers = torch.randint(-100, 101, (n_ids, d), generator=gen,
                            device=dev, dtype=torch.int16)
    owner = torch.randint(n_ids, (ng,), generator=gen, device=dev)
    g8 = torch.empty((ng, d), dtype=torch.int8, device=dev)
    for a in range(0, ng, MAKE_BLOCK):
        e = min(a + MAKE_BLOCK, ng)
        noise = torch.randint(-6, 7, (e - a, d), generator=gen, device=dev,
                              dtype=torch.int16)
        g8[a:e] = torch.clamp(centers[owner[a:e]] + noise, -127,
                              127).to(torch.int8)
    sc = torch.full((ng,), 1.0 / (127.0 * np.sqrt(d)), dtype=torch.float32,
                    device=dev)
    return g8, sc


# ---------------------------------------------------------------------------
# --load: the daemon under concurrent HTTP load
# ---------------------------------------------------------------------------


def _http_json(url, timeout=120):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode('utf-8'))


def fabricate(args, dev, ckpt, npz, qdir):
    """Seeded weights (a pkl), a clustered int8 index file at the model's
    embedding width, and 16 query PNGs at the network input size."""
    import cv2
    from pps_tpu_torch.config import (cfg, merge_cfg_from_file,
                                      assert_and_infer_cfg, reset_cfg)
    from pps_tpu_torch.engine.checkpoint import save_checkpoint
    reset_cfg()
    merge_cfg_from_file(args.load_cfg)
    assert_and_infer_cfg(make_immutable=False)
    model, params, state = common.seeded_model(cfg, dev)
    save_checkpoint(ckpt, model, params, state)
    w, h = cfg.REID.SCALE
    with torch.no_grad():
        d = int(model.extract_features(
            params, state, torch.zeros((1, h, w, 3), device=dev)).shape[1])
    del model, params, state
    g8, sc = clustered_gallery(args.gallery_size, d, dev)
    paths = np.array(['row%07d' % i for i in range(args.gallery_size)],
                     dtype=object)
    tmp = npz + '.tmp.npz'
    with open(tmp, 'wb') as f:
        np.savez(f, gallery=g8.cpu().numpy(), paths=paths,
                 int8=np.array(True), scale=sc.cpu().numpy())
    os.replace(tmp, npz)
    del g8, sc
    # query images (PNG; the daemon decodes + resizes + embeds them per
    # request)
    rng = np.random.RandomState(0)
    os.makedirs(qdir, exist_ok=True)
    for j in range(16):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(qdir, 'q%02d.png' % j), img)


def _launch_server(args, mode, npz, extra):
    """Start the serving daemon on ``--device`` (not yet ready): (process,
    its log, its ready file)."""
    work = args.load_workdir
    ready = os.path.join(work, 'ready_%s' % mode)
    if os.path.exists(ready):
        os.unlink(ready)
    logf = open(os.path.join(work, 'serve_%s.log' % mode), 'w')
    cmd = [sys.executable, '-m', 'pps_tpu_torch.tools.serve',
           '--cfg', args.load_cfg, '--weights',
           os.path.join(work, 'model.pkl'), '--load-index', npz,
           '--port', '0', '--ready-file', ready,
           '--topk', str(args.topk), '--max-body-mb', '8',
           '--device', args.device] + extra
    proc = subprocess.Popen(cmd, stdout=logf, stderr=logf, cwd=ROOT)
    return proc, logf, ready


def _wait_ready(args, mode, proc, logf, ready):
    """(host, port) of a launched daemon once it is ready."""
    deadline = time.time() + args.load_startup_timeout
    while not os.path.exists(ready):
        if proc.poll() is not None:
            logf.close()
            raise RuntimeError('server (%s) died; see %s' %
                               (mode, logf.name))
        if time.time() > deadline:
            proc.terminate()
            proc.wait(timeout=60)
            logf.close()
            raise RuntimeError('server (%s) never became ready' % mode)
        time.sleep(0.2)
    with open(ready) as f:
        host, port = f.read().split()
    return host, int(port)


def percentile(lats, p):
    """The p-quantile of sorted latencies (ms) by rank, one decimal."""
    if not lats:
        return None
    return round(lats[min(len(lats) - 1, int(p * len(lats)))], 1)


def run_level(host, port, conc, duration, warmup, pngs, qparam):
    """Closed-loop client pool: ``conc`` keep-alive HTTP clients post to
    /search for ``duration`` seconds; samples inside the warmup window are
    discarded.  Returns (latencies_ms sorted, qps, n_shed, err_kinds),
    where err_kinds counts client-side exceptions by class (each one also
    forces a reconnect), apart from HTTP-status errors, so a contended
    client pool is told apart from server failures."""
    import http.client
    import threading
    t_start = time.time()
    stop_at = t_start + warmup + duration
    lock = threading.Lock()
    samples, shed, http_errs = [], [0], [0]
    err_kinds = {}

    def worker(tid):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        body = pngs[tid % len(pngs)]
        while time.time() < stop_at:
            t0 = time.perf_counter()
            ts = time.time()
            try:
                conn.request('POST', '/search?k=10' + qparam, body=body,
                             headers={'Content-Type': 'image/png'})
                resp = conn.getresponse()
                resp.read()
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    if resp.status == 503:
                        shed[0] += 1
                    elif resp.status != 200:
                        http_errs[0] += 1
                    elif ts >= t_start + warmup:
                        samples.append(ms)
            except (OSError, http.client.HTTPException) as e:
                kind = type(e).__name__
                with lock:
                    err_kinds[kind] = err_kinds.get(kind, 0) + 1
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.close()

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(conc)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    samples.sort()
    if http_errs[0]:
        err_kinds['http_status'] = http_errs[0]
    return samples, len(samples) / duration, shed[0], err_kinds


def level_row(mode, conc, lats, qps, n_shed, err_kinds, s0, s1):
    """One JSON row of the load bench; ``s0``/``s1`` the daemon's /stats
    before and after the level."""
    def delta(section, key):
        a = s0.get(section) or {}
        b = s1.get(section) or {}
        if key not in b:
            return None
        return b[key] - a.get(key, 0)

    return {
        'mode': mode, 'concurrency': conc,
        'qps': round(qps, 1),
        'p50_ms': percentile(lats, 0.50), 'p95_ms': percentile(lats, 0.95),
        'p99_ms': percentile(lats, 0.99), 'n': len(lats),
        'shed': n_shed,
        'errors': sum(err_kinds.values()),
        'error_kinds': err_kinds or None,
        'embed_dispatches': delta('embed', 'dispatches'),
        'embed_images': delta('embed', 'images'),
        'search_dispatches': delta('search', 'dispatches'),
        'search_queries': delta('search', 'queries'),
    }


def load_files(args, dev):
    """(weights pkl, index npz, query dir) of the load bench under
    --load-workdir, fabricated first when any is missing."""
    work = args.load_workdir
    os.makedirs(work, exist_ok=True)
    npz = os.path.join(work, 'index_%d.npz' % args.gallery_size)
    ckpt = os.path.join(work, 'model.pkl')
    qdir = os.path.join(work, 'queries')
    if not (os.path.exists(npz) and os.path.exists(ckpt)
            and os.path.isdir(qdir)):
        print('fabricating weights + %d-row index (one-off)...'
              % args.gallery_size, file=sys.stderr, flush=True)
        fabricate(args, dev, ckpt, npz, qdir)
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    return ckpt, npz, qdir


def mode_plan(args, npz):
    """[(modes, index file, extra daemon flags)]: one daemon per group;
    exact and rerank share one."""
    plan = []
    modes = args.load_modes.split(',')
    if 'exact' in modes or 'rerank' in modes:
        plan.append(([m for m in ('exact', 'rerank') if m in modes], npz,
                     []))
    if 'ivf' in modes:
        ivf_npz = os.path.join(args.load_workdir,
                               'index_%d_ivf.npz' % args.gallery_size)
        if os.path.exists(ivf_npz):
            plan.append((['ivf'], ivf_npz, []))
        else:
            plan.append((['ivf'], npz,
                         ['--ivf', '--ivf-nprobe', str(args.ivf_nprobe),
                          '--save-index', ivf_npz]))
    return plan


def start_first_daemon(args, dev):
    """Make the files and start the first mode group's daemon without
    waiting for it: ``run_load(..., first=)`` takes it, so a caller can
    overlap the daemon's start-up with other work."""
    _, npz, _ = load_files(args, dev)
    group, use_npz, extra = mode_plan(args, npz)[0]
    return _launch_server(args, group[0], use_npz, extra)


def run_load(args, dev, first=None):
    """The real daemon under concurrent load: closed-loop client pools at
    each concurrency, in each mode (exact scan, rerank=1, IVF probe),
    recording QPS, p50/p95/p99 and the embed/search batchers' dispatch
    counts (aggregate throughput should grow with concurrency while
    latency stays bounded, as concurrent embeds and scans coalesce into
    single dispatches).  The client pool shares the host's cores with the
    daemon's HTTP and decode path; the dispatch counters separate the
    host's ceiling from the card's.  ``first``: the first group's daemon
    from ``start_first_daemon``."""
    work = args.load_workdir
    _, npz, qdir = load_files(args, dev)
    pngs = []
    for f in sorted(os.listdir(qdir)):
        with open(os.path.join(qdir, f), 'rb') as fh:
            pngs.append(fh.read())

    levels = [int(c) for c in args.load_concurrency.split(',')]
    results = []
    out_path = os.path.join(work, 'LOADBENCH.json')
    for i, (group, use_npz, extra) in enumerate(mode_plan(args, npz)):
        proc, logf, ready = (first if i == 0 and first is not None else
                             _launch_server(args, group[0], use_npz, extra))
        host, port = _wait_ready(args, group[0], proc, logf, ready)
        base = 'http://%s:%d' % (host, port)
        try:
            for mode in group:
                qparam = '&rerank=1' if mode == 'rerank' else ''
                for conc in levels:
                    s0 = _http_json(base + '/stats')
                    lats, qps, n_shed, err_kinds = run_level(
                        host, port, conc, args.load_duration,
                        args.load_warmup, pngs, qparam)
                    s1 = _http_json(base + '/stats')
                    row = level_row(mode, conc, lats, qps, n_shed,
                                    err_kinds, s0, s1)
                    results.append(row)
                    print(json.dumps(row), flush=True)
        finally:
            proc.terminate()
            try:
                # a server started with --save-index re-saves the placed
                # rows on graceful shutdown: GBs of npz for a 1M gallery
                proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                print('server (%s) still saving after 600 s; killing'
                      % group[0], file=sys.stderr)
                proc.kill()
                proc.wait(timeout=60)
            logf.close()
            # collected rows survive a teardown failure: the artifact is
            # rewritten after every mode group
            with open(out_path, 'w') as f:
                json.dump({'gallery_size': args.gallery_size,
                           'duration_s': args.load_duration,
                           'levels': levels, 'results': results},
                          f, indent=1)

    out = {'loadbench': out_path, 'rows': len(results)}
    print(json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# one query: embed -> top-k
# ---------------------------------------------------------------------------


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--gallery-size', type=int, default=1_000_000)
    ap.add_argument('--dim', type=int, default=3968)
    ap.add_argument('--topk', type=int, default=100)
    ap.add_argument('--chunk', type=int, default=4096)
    ap.add_argument('--f32-gallery', action='store_true',
                    help='hold the gallery float32 (default int8)')
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--rerank', action='store_true',
                    help='also time the per-query k-reciprocal re-rank '
                         'of the top-k shortlist (a HOST stage after the '
                         'scan: gather + dequant k rows, euclidean, the '
                         'C++ engine) and report the combined latency')
    ap.add_argument('--ivf', action='store_true',
                    help='also benchmark the IVF index (ops/ivf): build '
                         'time, probe-scan latency vs the exact scan, '
                         'recall@k, on a CLUSTERED synthetic gallery (the '
                         're-ID regime IVF exploits) for both paths')
    ap.add_argument('--ivf-nprobe', type=int, default=8)
    ap.add_argument('--load', action='store_true',
                    help='closed-loop load bench against the real serving '
                         'daemon over localhost HTTP: QPS + p50/p95/p99 '
                         'vs concurrency, per mode, plus batcher dispatch '
                         'counts')
    ap.add_argument('--load-concurrency', default='1,4,16,64')
    ap.add_argument('--load-duration', type=float, default=15.0,
                    help='measured seconds per (mode, concurrency) cell')
    ap.add_argument('--load-warmup', type=float, default=4.0,
                    help='seconds discarded at the start of each cell')
    ap.add_argument('--load-modes', default='exact,rerank,ivf')
    ap.add_argument('--load-cfg',
                    default=os.path.join(
                        ROOT, 'configs', 'market1501',
                        'pps_crm_triplet_R-50_1x_int8.yaml'))
    ap.add_argument('--load-workdir',
                    default=os.path.join(ROOT, 'build', 'loadbench'),
                    help='fabricated index/weights/queries cache (the '
                         'index file is reused across runs)')
    ap.add_argument('--load-startup-timeout', type=float, default=2400,
                    help='seconds to wait for daemon readiness')
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, results=None):
    """``results``: an optional dict filled with the timed query's
    embedding and its top-k (numpy), for a caller's own checks."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.load:
        return run_load(args, dev)

    from pps_tpu_torch.models.quantize import quantize_for_eval
    from pps_tpu_torch.ops.topk import streaming_topk
    from pps_tpu_torch.parallel.eval_step import make_extract_fn
    from pps_tpu_torch.utils.timer import slope_time

    cfg = common.tool_cfg()
    model, params, state = common.seeded_model(cfg, dev)
    rng = np.random.RandomState(0)
    w, h = cfg.REID.SCALE

    # int8 body for the embed step (the serving configuration)
    calib = (rng.randn(64, h, w, 3) * 50).astype(np.float32)
    qparams = quantize_for_eval(model, params, state, calib)
    extract = make_extract_fn(model, device=dev)

    ng, d = args.gallery_size, args.dim
    if args.f32_gallery:
        gd = torch.empty((ng, d), dtype=torch.float32, device=dev)
        for a, rows in gallery_rows(ng, d, dev):
            gd[a:a + rows.shape[0]] = rows
        sd = None
    elif args.ivf:
        gd, sd = clustered_gallery(ng, d, dev)
    else:
        gd, sd = int8_gallery(ng, d, dev)
    img = torch.from_numpy(
        rng.randn(1, h, w, 3).astype(np.float32) * 50).to(dev)

    def embed(x):
        f = extract(qparams, state, x)
        if f.shape[1] > d:
            f = f[:, :d]
        elif f.shape[1] < d:
            f = torch.nn.functional.pad(f, (0, d - f.shape[1]))
        return f

    def one_query():
        """What one user waits for: the embedding, the exact top-k and
        the answer on the host."""
        dist, idx = streaming_topk(embed(img), gd, k=args.topk,
                                   chunk=args.chunk, g_scale=sd)
        return dist.cpu(), idx.cpu()

    lat = slope_time(one_query, iters=args.iters, warmup=2)
    if results is not None:
        dist, idx = one_query()
        results.update(query=embed(img).cpu().numpy(),
                       dists=dist.numpy(), indices=idx.numpy())

    out = {
        'single_query_latency_ms': round(lat * 1e3, 2),
        'gallery_size': ng, 'dim': d, 'topk': args.topk,
        'gallery_dtype': 'float32' if args.f32_gallery else 'int8',
        'embed': 'int8-ptq flagship ({}x{})'.format(h, w),
        'device_kind': common.device_kind(dev),
    }

    if args.rerank:
        # the re-rank increment is host work on the k-row shortlist
        # (``RetrievalIndex.search_reranked``): gather + dequant the
        # candidate rows, two small euclidean matrices, then the C++
        # k-reciprocal engine on a (k+1)-set; timed alone, as it overlaps
        # nothing on the card
        from pps_tpu_torch import native
        from pps_tpu_torch.evaluation.metrics import compute_dist
        qv = rng.randn(1, d).astype(np.float32)
        qv /= np.linalg.norm(qv)
        cand = torch.from_numpy(
            rng.choice(ng, size=args.topk, replace=False)).to(dev)

        def host_stage():
            rows = gd[cand].float()
            if sd is not None:
                rows = rows * sd[cand][:, None]
            rows = rows.cpu().numpy()
            qg = compute_dist(qv, rows, 'euclidean')
            gg = compute_dist(rows, rows, 'euclidean')
            rr = native.rerank(qg, np.zeros((1, 1), np.float32), gg,
                               k1=20, k2=6, lambda_value=0.3)[0]
            return np.argsort(rr, kind='stable')

        host_stage()  # build / load the engine
        t0 = time.perf_counter()
        reps = 50
        for _ in range(reps):
            host_stage()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        out['rerank_host_ms'] = round(host_ms, 2)
        out['rerank_engine'] = 'native'
        out['reranked_total_ms'] = round(lat * 1e3 + host_ms, 2)

    if args.ivf:
        if args.f32_gallery:
            raise SystemExit('--ivf bench assumes the int8 path')
        out['ivf'] = _ivf_bench(args, dev, gd, sd, embed, img, rng)

    print(json.dumps(out), flush=True)
    return out


def _ivf_bench(args, dev, gd, sd, embed, img, rng):
    """Build the IVF index over the resident gallery; its recall against
    the exact scan and its latency beside the exact scan's."""
    from pps_tpu_torch.ops import ivf as ivf_ops
    from pps_tpu_torch.ops.topk import streaming_topk
    from pps_tpu_torch.tools.bench_ivf_recall import recall_at_k
    from pps_tpu_torch.utils.timer import slope_time
    ng, d = gd.shape
    nlist = ivf_ops.default_nlist(ng)
    t0 = time.perf_counter()
    cent = ivf_ops.kmeans(gd, nlist, iters=10, seed=0, g_scale=sd,
                          sample=131072, device=dev)
    common.synchronize(dev)
    t_kmeans = time.perf_counter() - t0
    t0 = time.perf_counter()
    assign = ivf_ops.assign_clusters(gd, cent, g_scale=sd)
    perm, starts = ivf_ops.build_ivf(assign, nlist)
    t_assign = time.perf_counter() - t0

    # recall queries near identity centres (the serving regime)
    qn = 64
    rows = torch.from_numpy(rng.randint(ng, size=qn)).to(dev)
    noise = torch.from_numpy(rng.randn(qn, d).astype(np.float32)).to(dev)
    qd = (gd[rows].float() + noise * 2.0) * sd[0]
    ei = streaming_topk(qd, gd, k=args.topk, chunk=args.chunk,
                        g_scale=sd)[1].cpu().numpy()

    # the cell sort on the card (a gather, not a host round trip)
    perm_dev = torch.from_numpy(perm.astype(np.int64)).to(dev)
    gd_sorted, sd_sorted = gd[perm_dev], sd[perm_dev]
    starts_dev = torch.from_numpy(starts).to(dev)
    per_cell = ng // max(nlist, 1)
    budget = max(4096, 4 * args.ivf_nprobe * per_cell)

    def recall_at(nprobe):
        _, pos = ivf_ops.ivf_topk(
            qd, gd_sorted, cent, starts_dev, k=args.topk, nprobe=nprobe,
            budget=max(4096, 4 * nprobe * per_cell), chunk=1024,
            g_scale=sd_sorted)
        return recall_at_k(pos.cpu().numpy(), perm, ei)

    recall_sweep = {
        np_: round(recall_at(np_), 4)
        for np_ in sorted({args.ivf_nprobe, 2 * args.ivf_nprobe,
                           4 * args.ivf_nprobe})}
    recall = recall_sweep[args.ivf_nprobe]
    q1 = qd[:1]

    def exact_one():
        return streaming_topk(q1, gd_sorted, k=args.topk, chunk=args.chunk,
                              g_scale=sd_sorted)[1].cpu()

    def ivf_one(q):
        return ivf_ops.ivf_topk(q, gd_sorted, cent, starts_dev, k=args.topk,
                                nprobe=args.ivf_nprobe, budget=budget,
                                g_scale=sd_sorted)[1].cpu()

    exact_ms = slope_time(exact_one, iters=args.iters, warmup=1) * 1e3
    # sub-ms probes: more iterations, out of the host timer's noise
    ivf_ms = slope_time(lambda: ivf_one(q1), iters=args.iters * 25,
                        warmup=1) * 1e3
    e2e_ivf_ms = slope_time(lambda: ivf_one(embed(img)), iters=args.iters,
                            warmup=1) * 1e3
    return {
        'nlist': nlist, 'nprobe': args.ivf_nprobe, 'budget': budget,
        'build_kmeans_s': round(t_kmeans, 2),
        'build_assign_s': round(t_assign, 2),
        'recall_at_%d' % args.topk: round(recall, 4),
        'recall_sweep_nprobe': recall_sweep,
        'exact_scan_ms': round(exact_ms, 3),
        'ivf_scan_ms': round(ivf_ms, 3),
        'scan_speedup': round(exact_ms / max(ivf_ms, 1e-9), 1),
        'single_query_e2e_ivf_ms': round(e2e_ivf_ms, 2),
    }


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    try:
        main()
    finally:
        write_launch_counts()
