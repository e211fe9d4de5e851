"""Kind ``open_loop_search``: person search as an operator serves it, under
an open loop of Poisson arrivals at the mix's fixed rate.

Each request is one uint8 crop asking for its ``k`` nearest gallery rows:
``EmbedBatcher`` over ``QueryEmbedder.embed`` (the configuration's body,
int8 for the serving variant), then ``SearchBatcher`` over
``RetrievalIndex`` on the exact route, as ``tools/serve.py`` drives them.
The index holds a gallery of ``gallery_rows`` rows made on the card from
the seed (L2-normalised non-negative rows, as the embeddings are, stored
int8 by the index).  The batchers get a proxy of the index that wraps each
scan in a benchmark span and counts its rows.

A request is timed from when it was due, not from when the generator
sent it; requests due in the window are waited for up to a minute after
it closes, and one that fails or never completes counts as failed.

The check, after the window: a sample of the finished requests drawn from
the seed.  The plain reference embeds each crop again (the int8 body
worked out from the float weights and the same calibration crops) and
scans its own int8 quantization of the same float gallery.  Compared: the
served embedding's distance to the reference's, and by how much each
served neighbour lies farther from the reference query than the
reference's neighbour of the same rank, and the served distances against
the reference's distances to the same rows.
"""

import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch
from torch.profiler import record_function

from portbench import core, synth
from portbench.reference import pps, retrieval


class ScanProxy:
    """The index as the search batcher sees it: every scan in a
    ``portbench.scan`` span, its padded query rows counted; with ``timed``
    each scan also between two CUDA events on its stream.  (The profiler
    records host spans of the thread that started it alone, so the
    batcher thread's kernels cannot be tied to this span in its trace.)"""

    def __init__(self, index, timed=False):
        self.index = index
        self.rows = []
        self.events = [] if timed else None

    def search(self, q, k, **kw):
        ev = None
        if self.events is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        with record_function('portbench.scan'):
            out = self.index.search(q, k, **kw)
        rows = int(np.asarray(q).shape[0])
        if ev is not None:
            ev[1].record()
            self.events.append((rows,) + ev)
        self.rows.append(rows)
        return out

    def timed_scans(self):
        """(scans, their query rows, device seconds between their events)
        over the timed scans since the last call."""
        torch.cuda.synchronize()
        ev, self.events = self.events, []
        return (len(ev), sum(r for r, _, _ in ev),
                sum(a.elapsed_time(b) for _, a, b in ev) * 1e-3)

    def __getattr__(self, name):
        return getattr(self.index, name)


class Setup:

    def __init__(self, run):
        from pps_tpu_torch.engine import serving
        from pps_tpu_torch.engine import test as test_lib
        from pps_tpu_torch.models.model import build_model

        t, dev = run.traffic, run.device
        self.t, self.dev = t, dev
        self.cfg = cfg = core.program_cfg(run.config, run.bench.root)
        self.spec = core.reference_spec(run.config)
        self.seeds = core.sub_seeds(run.seed, ['weights', 'crops', 'gallery',
                                               'arrivals', 'picks',
                                               'sample'])
        self.params, self.state = synth.make_weights(
            self.spec, self.seeds['weights'], dev,
            run.config.get('branch_scale', 1.0))
        self.crops = synth.decodes(t['crops'], tuple(t['decode_hw']),
                                   self.seeds['crops'], dev)
        self.model = build_model(cfg, device=dev)
        run_params = self.params
        if cfg.TPU.INT8_EVAL:
            calib = [{'image': str(i)} for i in
                     range(int(cfg.TPU.INT8_CALIB_IMAGES))]
            run_params = test_lib.quantize_params_for_dataset(
                cfg, self.model, self.params, self.state, calib,
                decode_fn=self.decode)
        self.index = None
        for rows in retrieval.gallery(t['gallery_rows'],
                                      self.spec.embedding_dim,
                                      self.seeds['gallery'], dev):
            n0 = 0 if self.index is None else len(self.index)
            keys = range(n0, n0 + rows.shape[0])
            if self.index is None:
                self.index = serving.RetrievalIndex(rows, keys, int8=True,
                                                    device=dev)
            else:
                self.index.add(rows, keys)
            del rows
        self.embedder = serving.QueryEmbedder(cfg, self.model, run_params,
                                              self.state,
                                              max_batch=t['max_batch'],
                                              device=dev)
        self.embedder.warmup(raw_hw=tuple(t['decode_hw']))
        self.proxy = ScanProxy(self.index, timed=run.trace and
                               dev.type == 'cuda')
        self.embed = serving.EmbedBatcher(
            lambda keys: self.embedder.embed(keys, decode_fn=self.decode),
            max_batch=t['max_batch'])
        self.search = serving.SearchBatcher(self.proxy,
                                            max_batch=t['max_batch'])
        # every scan shape the batcher pads to, and the gallery's norms
        q = np.zeros((1, self.spec.embedding_dim), np.float32)
        for b in self.search.buckets():
            self.index.search(np.repeat(q, b, axis=0), t['k'], exact=True)
        self.pool = ThreadPoolExecutor(t['workers'])
        # one request through the whole path, and one per worker at once
        list(self.pool.map(lambda i: self.request(str(i)),
                           range(t['workers'])))

    def decode(self, key):
        return self.crops[int(key)]

    def request(self, key):
        with record_function('portbench.request'):
            f = self.embed.embed([key])
            d, i, _ = self.search.search(f, self.t['k'], exact=True)
        return f[0], d[0], i[0]

    def counters(self):
        return {'images': self.embed.images,
                'dispatches': self.embed.dispatches,
                'queries': self.search.queries,
                'scans': self.search.device_scans,
                'scan_rows': sum(self.proxy.rows)}


def setup(run):
    return Setup(run)


def arrivals(rate, seconds, seed):
    """Due times in [0, seconds) of ``rate * seconds`` requests whose gaps
    are the quantiles of the exponential distribution at ``rate`` (a
    Poisson process's gaps), in an order drawn from the seed: every seed
    offers the same gaps, in another order."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    rng = np.random.RandomState(seed % 2 ** 31)
    return np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))[:-1]])


def lateness(due, sent, done):
    """(latency from due, generator lag) per request, seconds; a request
    that did not complete has latency inf."""
    lat = [(d1 - d0) if d1 is not None else float('inf')
           for d0, d1 in zip(due, done)]
    lag = [s - d0 for d0, s in zip(due, sent)]
    return lat, lag


def serve(st, rate, seconds, tracer=None, trace_seconds=0.0, drain=60.0):
    """The open loop at ``rate`` for ``seconds``: returns a dict of the
    schedule, each request's times and answers, and the counters."""
    t = st.t
    due = arrivals(rate, seconds, st.seeds['arrivals'])
    picks = np.random.RandomState(st.seeds['picks'] % 2 ** 31).randint(
        0, t['crops'], size=len(due))
    n = len(due)
    sent, done, answers, errors = [None] * n, [None] * n, {}, []
    # the requests the check compares, drawn from the seed beforehand, so
    # that no other answer is kept
    keep = set(np.random.RandomState(st.seeds['sample'] % 2 ** 31).choice(
        n, min(t['check_requests'], n), replace=False).tolist())
    c0 = st.counters()
    traced = None
    if st.proxy.events:
        st.proxy.timed_scans()  # the set-up's scans are not the window's

    def one(i, t0):
        try:
            answer = st.request(str(picks[i]))
            done[i] = time.perf_counter() - t0
            if i in keep:
                answers[i] = answer
        except Exception as e:  # noqa: BLE001 - a failed request counts
            errors.append(repr(e))

    futs = []
    t0 = time.perf_counter() + 0.05
    for i in range(n):
        now = time.perf_counter() - t0
        if due[i] > now:
            time.sleep(due[i] - now)
        if tracer is not None and traced is None and \
                due[i] >= seconds - trace_seconds:
            traced = (time.perf_counter() - t0, st.counters())
            tracer.start(sync=False)
        sent[i] = time.perf_counter() - t0
        futs.append(st.pool.submit(one, i, t0))
    left = seconds - (time.perf_counter() - t0)
    if left > 0:
        time.sleep(left)
    if tracer is not None and tracer.active:
        tracer.stop()
    wait(futs, timeout=drain)
    return {'due': due, 'sent': sent, 'done': done, 'answers': answers,
            'picks': picks, 'errors': errors, 'c0': c0, 'c1': st.counters(),
            'traced': traced, 'seconds': seconds}


def window(run, st):
    t = run.traffic
    out = serve(st, t['rate'], run.seconds, run.tracer,
                t['trace_seconds'])
    st.out = out
    lat, lag = lateness(out['due'], out['sent'], out['done'])
    run.attempted = len(lat)
    run.failed = sum(1 for x in lat if x == float('inf'))
    ok = [x for x in lat if x != float('inf')]
    run.e2e['query_p95_ms'] = 1e3 * core.percentile(lat, 95)
    c0, c1 = out['c0'], out['c1']
    run.record.update(
        rate=t['rate'], requests=len(lat), errors=out['errors'][:3],
        p50_ms=1e3 * core.percentile(ok, 50) if ok else None,
        p95_ms=run.e2e['query_p95_ms'],
        p99_ms=1e3 * core.percentile(lat, 99),
        lag_p95_ms=1e3 * core.percentile(lag, 95),
        **{k: c1[k] - c0[k] for k in c1})
    if out['traced'] is not None:
        ts, c = out['traced']
        run.record['untraced'] = {'seconds': ts,
                                  **{k: c[k] - c0[k] for k in c}}
    if st.proxy.events:
        run.record['timed_scans'] = st.proxy.timed_scans()
    run.record.update(embed_flops=run.yard_flops, k=t['k'],
                      gallery_rows=t['gallery_rows'],
                      dim=st.spec.embedding_dim)


def reading_window(run, st):
    """A short open loop at the mix's rate, for the readings: as many
    requests to compare as a run has."""
    st.out = serve(st, run.traffic['rate'], run.traffic['reading_seconds'])


def free(st):
    st.embed.close()
    st.search.close()
    st.pool.shutdown(wait=True)
    st.index = st.proxy = st.embed = st.search = st.embedder = None
    st.model = None


def _reference(st, crops_idx, bits):
    """Reference embeddings of crops ``crops_idx`` (the int8 or int4 body
    worked out from the float weights and the calibration crops)."""
    out_hw = (st.spec.height, st.spec.width)

    def images(rows):
        return pps.preprocess(torch.as_tensor(st.crops[rows], device=st.dev),
                              synth.MEANS, out_hw)
    calib = images(np.arange(st.cfg.TPU.INT8_CALIB_IMAGES))
    p = pps.quantize_body(st.spec, st.params, st.state, calib, bits=bits)
    b = st.t['max_batch']
    return torch.cat([pps.embed(st.spec, p, st.state,
                                images(crops_idx[i:i + b]), 'int8')
                      for i in range(0, len(crops_idx), b)])


def _numbers(st, q_served, d_served, i_served, q_ref):
    """emb_gap, rank_gap, dist_gap of served (embedding, distances,
    indices) against the reference query embeddings over the reference
    gallery."""
    k = st.t['k']
    ref_d, ref_i, served = retrieval.scan(
        q_ref, st.t['gallery_rows'], st.spec.embedding_dim,
        st.seeds['gallery'], st.dev, k, torch.as_tensor(i_served,
                                                        device=st.dev))
    served = served.cpu().numpy()
    ref_d = ref_d.cpu().numpy()
    emb = float(np.max(np.linalg.norm(
        np.asarray(q_served, np.float64) - q_ref.double().cpu().numpy(),
        axis=1)))
    return {'emb_gap': emb,
            'rank_gap': float(np.max(served - ref_d)),
            'dist_gap': float(np.max(np.abs(np.asarray(d_served) - served)))}


def judge(run, st):
    pps.strict_float32()
    # the sample's requests that finished (one that did not is failed)
    pick = sorted(st.out['answers'])
    if not pick:
        return {'emb_gap': float('inf'), 'rank_gap': float('inf'),
                'dist_gap': float('inf')}
    a = st.out['answers']
    q = np.stack([a[i][0] for i in pick])
    d = np.stack([a[i][1] for i in pick])
    idx = np.stack([a[i][2] for i in pick])
    ref = _reference(st, st.out['picks'][pick], 8)
    return _numbers(st, q, d, idx, ref)


def control(run, st):
    """The control in the program's place: the int4 body's embeddings
    (the step below the configuration's int8), scanned exactly over the
    reference gallery, against the int8 reference."""
    pps.strict_float32()
    crops = np.arange(st.t['check_requests']) % st.t['crops']
    ref = _reference(st, crops, 8)
    low = _reference(st, crops, 4)
    d, i = retrieval.scan(low, st.t['gallery_rows'], st.spec.embedding_dim,
                          st.seeds['gallery'], st.dev, st.t['k'])[:2]
    return _numbers(st, low.cpu().numpy(), d.cpu().numpy(), i.cpu().numpy(),
                    ref)
