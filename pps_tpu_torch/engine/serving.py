"""Serving: query embedding, a device-resident gallery you can search and
grow, and the request batchers (counterpart of
``pps_tpu/engine/serving.py``).

* ``QueryEmbedder`` embeds a request's decoded images over the uint8
  device-preprocessing wire, padded to the smallest size of a geometric
  batch ladder (1, 4, 16, ... capped at ``max_batch``) so a single query
  ships one image, not a full eval batch;
* ``RetrievalIndex`` keeps the gallery on the device (float32, or int8
  with per-row scales) and answers top-k queries: one product over the
  whole gallery for small batches (``ops/topk.flat_topk``), the chunked
  scan above ``FLAT_SCAN_MAX_ELEMS`` (``ops/topk.streaming_topk``), an IVF
  probe once ``enable_ivf`` has clustered it (``ops/ivf``), and
  k-reciprocal re-ranking of a shortlist (``search_reranked``).  It grows
  (``add``), shrinks (``remove``) and persists (``save``/``load``, an
  ``.npz`` in the JAX package's keys and layout, so either package loads
  the other's file);
* ``EmbedBatcher`` and ``SearchBatcher`` coalesce concurrent requests into
  one device dispatch, and shed load (``Overloaded``) past
  ``max_pending``;
* ``embed_gallery_cached`` and ``build_index_from_args`` bootstrap the
  serving CLIs (``tools/serve.py``, ``tools/retrieve.py``).

A group of mixed decode sizes, or of another size than the one pinned,
is preprocessed on the host (float32) and embedded by the same model on
the device.

``RetrievalIndex(shard=True, mesh=...)`` row-shards the gallery over the
shards of a single-process mesh (``parallel/mesh.build_mesh(devices=
[...])``, one shard per card, or several on one card) and searches through
``parallel/retrieval.py``'s exact cross-shard merge; IVF composes with it
(every cell dealt round-robin over the shards).  An ``add`` or ``remove``
re-places the shards from the host mirror.
"""

import glob
import hashlib
import logging
import os
import queue
import shutil
import threading

import numpy as np
import torch

from pps_tpu_torch import native
from pps_tpu_torch.data import transforms
from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.ops import ivf as ivf_ops
from pps_tpu_torch.ops.topk import (flat_topk, gallery_norms,
                                    quantize_gallery, streaming_topk)
from pps_tpu_torch.parallel import eval_step as es_lib
from pps_tpu_torch.parallel import retrieval as ret_lib

logger = logging.getLogger(__name__)

GALLERY_CACHE_NAME = 'gallery_features.npz'



def _euclidean(a, b):
    """Evaluator-exact euclidean all-pairs (the clamped-sqrt math the
    re-rank goldens were validated against)."""
    from pps_tpu_torch.evaluation.metrics import compute_dist
    return compute_dist(a, b, 'euclidean')


def list_gallery_images(gallery_dir):
    """Sorted jpg/png paths under ``gallery_dir`` (the serving contract:
    deterministic order so cached features stay aligned)."""
    return sorted(
        glob.glob(os.path.join(gallery_dir, '*.jpg')) +
        glob.glob(os.path.join(gallery_dir, '*.png')))


def weights_cache_key(weights_path):
    """Identity of the embedding model for gallery-cache validity:
    switching --weights must re-embed, or queries embedded with the new
    model would be matched against stale gallery embeddings."""
    if weights_path and os.path.exists(weights_path):
        st = os.stat(weights_path)
        return '%s:%d:%d' % (os.path.abspath(weights_path),
                             st.st_size, int(st.st_mtime))
    return ''


def embed_paths(cfg, model, params, state, paths):
    """Embed image files through the batched extraction engine on the
    model's device ([len(paths), D] float32)."""
    from pps_tpu_torch.engine.test import extract_dataset_features
    roidb = [{'image': p, 'im_name': os.path.basename(p)} for p in paths]
    return extract_dataset_features(cfg, model, params, state, roidb)


class QueryEmbedder:
    """Low-latency query embedding over the uint8 device-preproc wire.

    Each request's images are stacked and padded (repeating the last
    image) to the smallest ladder size that holds them; requests larger
    than the cap go through the top size in chunks.  ``warmup`` runs every
    ladder size of both wires once before traffic.  One raw size rides the
    uint8 wire per lifetime, the first one seen (or the one warmed), as in
    the JAX package, where each raw shape compiles a graph; any other
    group, and a group of mixed sizes, is preprocessed on the host and
    rides the float32 wire.  Feature semantics match the gallery path: the
    same preprocessing and the same flip-TTA flag (TEST.BBOX_AUG.ENABLED
    and H_FLIP).
    """

    def __init__(self, cfg, model, params, state, max_batch=64, device=None):
        self._params = params
        self._state = state
        w, h = cfg.REID.SCALE
        self._out_hw = (h, w)
        self._means = np.asarray(cfg.PIXEL_MEANS)
        flip = bool(cfg.TEST.BBOX_AUG.ENABLED and cfg.TEST.BBOX_AUG.H_FLIP)
        self.device = resolve_device(device)
        self._fn_u8 = es_lib.make_extract_fn(
            model, flip_tta=flip, device_preproc=(self._means, self._out_hw),
            device=self.device)
        self._fn_f32 = es_lib.make_extract_fn(model, flip_tta=flip,
                                              device=self.device)
        sizes, s = [], 1
        cap = max(1, int(max_batch))
        while s < cap:
            sizes.append(s)
            s *= 4
        sizes.append(cap)
        self.ladder = tuple(sizes)
        self._u8_shape = None  # the raw shape of the uint8 wire, once seen
        self._dim = None  # embedding width, learned at first dispatch

    def _ladder_pad(self, n):
        for s in self.ladder:
            if n <= s:
                return s
        return self.ladder[-1]

    def warmup(self, raw_hw=None):
        """Run every ladder size of both wires once, on zero images, so
        first requests do not pay for allocator growth and cuDNN set-up;
        pin the uint8 wire to raw size ``raw_hw`` (default: the network
        input size)."""
        h, w = raw_hw if raw_hw is not None else self._out_hw
        img8 = np.zeros((1, h, w, 3), np.uint8)
        img32 = np.zeros((1,) + self._out_hw + (3,), np.float32)
        for s in self.ladder:
            self._dispatch(self._fn_u8, np.repeat(img8, s, axis=0), s)
            self._dispatch(self._fn_f32, np.repeat(img32, s, axis=0), s)
        self._u8_shape = (h, w, 3)

    def _dispatch(self, fn, stack, padded):
        n = stack.shape[0]
        if padded > n:
            stack = np.concatenate(
                [stack, np.repeat(stack[-1:], padded - n, axis=0)], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(stack)).to(self.device)
        feats = fn(self._params, self._state, x)
        feats = feats.cpu().numpy().astype(np.float32, copy=False)
        self._dim = feats.shape[1]
        return feats[:n]

    def embed(self, paths, decode_fn=None):
        """[len(paths), D] float32 embeddings of the images behind
        ``paths`` (blocking).  ``decode_fn(path)`` returns a uint8
        [H, W, 3] BGR decode; by default ``transforms.decode_image``
        (cv2)."""
        if not paths:
            return np.zeros((0, self._dim or 0), np.float32)
        decode = decode_fn or transforms.decode_image
        ims = [decode(p) for p in paths]
        cap = self.ladder[-1]
        return np.concatenate(
            [self._embed_ims(ims[s:s + cap])
             for s in range(0, len(ims), cap)], axis=0)

    def _embed_ims(self, ims):
        padded = self._ladder_pad(len(ims))
        if all(im.shape == ims[0].shape for im in ims):
            if self._u8_shape is None:
                self._u8_shape = ims[0].shape
            if ims[0].shape == self._u8_shape:
                return self._dispatch(self._fn_u8, np.stack(ims), padded)
        h, w = self._out_hw
        out = np.empty((len(ims), h, w, 3), np.float32)
        for i, im in enumerate(ims):
            out[i] = transforms.prep_im_for_blob(im, self._means, (w, h))
        return self._dispatch(self._fn_f32, out, padded)


def embed_gallery_cached(cfg, model, params, state, gallery_dir,
                         weights_path=None, refresh=False, chunk=8192):
    """(features [N, D] float32, paths) for a gallery directory, cached to
    ``<gallery_dir>/gallery_features.npz`` (the JAX package's file).

    The cache is keyed on the exact path list AND the weights file
    (path, size, mtime): either changing forces a re-embed.

    Galleries larger than ``chunk`` embed in resumable chunks: each chunk
    lands in ``.gallery_partial_<key>/`` as it finishes (atomic rename),
    so a restart part-way through a large build re-embeds only the
    missing tail.  The partial dir is keyed like the cache and deleted
    once the single-file cache is written.
    """
    paths = list_gallery_images(gallery_dir)
    if not paths:
        raise ValueError('no images in {}'.format(gallery_dir))
    cache = os.path.join(gallery_dir, GALLERY_CACHE_NAME)
    wkey = weights_cache_key(weights_path)
    if os.path.exists(cache) and not refresh:
        feats = None
        try:
            data = np.load(cache, allow_pickle=True)
            cached_paths = list(data['paths'])
            cached_wkey = str(data['wkey']) if 'wkey' in data else ''
            if cached_paths == paths and cached_wkey == wkey:
                # npz members decompress lazily: the features read can
                # fail even when paths/wkey loaded, so it is guarded too
                feats = np.asarray(data['features'], np.float32)
            else:
                logger.info('gallery or weights changed; re-embedding')
        except Exception:  # noqa: BLE001 - a corrupt cache re-embeds
            logger.warning('corrupt gallery cache %s; re-embedding', cache)
        if feats is not None:
            return feats, paths

    part_dir = None
    if len(paths) <= chunk:
        feats = np.asarray(embed_paths(cfg, model, params, state, paths),
                           np.float32)
    else:
        key = hashlib.md5(
            ('\n'.join(paths) + '|' + wkey).encode()).hexdigest()[:12]
        part_dir = os.path.join(gallery_dir, '.gallery_partial_' + key)
        os.makedirs(part_dir, exist_ok=True)
        parts, resumed = [], 0
        for start in range(0, len(paths), chunk):
            sub = paths[start:start + chunk]
            pf = os.path.join(part_dir, '%09d.npy' % start)
            if os.path.exists(pf) and not refresh:
                arr = np.load(pf)
                if arr.ndim == 2 and arr.shape[0] == len(sub):
                    parts.append(np.asarray(arr, np.float32))
                    resumed += len(sub)
                    continue
            arr = np.asarray(embed_paths(cfg, model, params, state, sub),
                             np.float32)
            tmp = pf + '.tmp.npy'
            np.save(tmp, arr)  # np.save appends .npy only to bare names
            os.replace(tmp, pf)
            parts.append(arr)
            logger.info('embedded gallery chunk %d-%d / %d',
                        start, start + len(sub), len(paths))
        if resumed:
            logger.info('resumed %d previously-embedded gallery rows '
                        'from %s', resumed, part_dir)
        feats = np.concatenate(parts)

    # publish atomically, and only then drop the resume chunks
    tmp_cache = cache + '.tmp.npz'
    with open(tmp_cache, 'wb') as f:
        np.savez(f, features=feats, paths=np.array(paths),
                 wkey=np.array(wkey))
    os.replace(tmp_cache, cache)
    if part_dir is not None:
        shutil.rmtree(part_dir, ignore_errors=True)
    logger.info('cached %d gallery embeddings to %s', len(paths), cache)
    return feats, paths


def build_index_from_args(cfg, model, params, state, *, gallery=None,
                          load_index=None, int8=False, shard=False,
                          weights_path=None, refresh=False, device=None,
                          mesh=None):
    """The load-index-vs-embed-gallery bootstrap shared by the serving
    CLIs.  Raises ValueError when neither source is given (the CLIs map
    that to parser.error()).  ``shard``: row-shard the gallery over
    ``mesh``, default one shard per card this process sees."""
    if shard and mesh is None:
        mesh = default_shard_mesh(device)
    if load_index:
        if int8:
            logger.warning('--int8-gallery is ignored with --load-index: '
                           'the stored rows carry their own precision')
        return RetrievalIndex.load(load_index, mesh=mesh, shard=shard,
                                   device=device)
    if not gallery:
        raise ValueError('--gallery is required unless --load-index')
    g_feats, g_paths = embed_gallery_cached(
        cfg, model, params, state, gallery, weights_path=weights_path,
        refresh=refresh)
    return RetrievalIndex(g_feats, g_paths, mesh=mesh, int8=int8,
                          shard=shard, device=device)


def default_shard_mesh(device=None):
    """A single-process mesh with one shard per card this process sees
    (the CPU's one shard when ``device`` is the CPU)."""
    from pps_tpu_torch.parallel import mesh as mesh_lib
    device = resolve_device(device)
    if device.type == 'cuda':
        devices = ['cuda:{}'.format(i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    return mesh_lib.build_mesh(devices=devices)


class Overloaded(RuntimeError):
    """Raised by the batchers when the pending queue exceeds
    ``max_pending`` or they are closed: the server sheds load (HTTP 503)
    instead of building an unbounded backlog."""


class EmbedBatcher:
    """Adaptive micro-batching for query embedding: concurrent requests
    coalesce into ONE device dispatch.

    Continuous batching, no timers: while one dispatch runs, arrivals
    queue; the dispatcher then takes everything waiting (up to
    ``max_batch`` images) in one call.  Batching happens exactly when
    there is contention and adds no latency when there is none.

    A failing coalesced dispatch (e.g. one undecodable image) retries
    each request alone so the poison request fails alone.
    """

    _STOP = object()

    def __init__(self, embed_fn, max_batch=64, max_pending=None):
        self._embed = embed_fn                # list[path] -> [N, D] f32
        self.max_batch = max(1, int(max_batch))
        self.max_pending = (None if max_pending is None
                            else max(1, int(max_pending)))
        self._q = queue.Queue()
        self._closed = False
        self.dispatches = 0                   # device calls issued
        self.images = 0                       # images embedded
        self.shed = 0                         # requests refused (overload)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='embed-batcher')
        self._thread.start()

    def pending(self):
        """Requests queued behind the running dispatch (approximate)."""
        return self._q.qsize()

    def close(self):
        self._closed = True
        self._q.put(self._STOP)
        self._thread.join(timeout=60)

    def embed(self, paths):
        """Blocking: returns [len(paths), D] f32 (raises on bad input;
        raises Overloaded without queueing when the backlog exceeds
        ``max_pending`` or the batcher was closed)."""
        if self._closed:
            raise Overloaded('embed batcher closed (shutting down)')
        if self.max_pending is not None and \
                self._q.qsize() >= self.max_pending:
            self.shed += 1
            raise Overloaded(
                'embed backlog at {} requests (max_pending={})'.format(
                    self._q.qsize(), self.max_pending))
        box = {'feats': None, 'err': None}
        done = threading.Event()
        self._q.put((list(paths), box, done))
        # the poll guards the enqueue-vs-close race: a request put after
        # the dispatcher consumed _STOP would otherwise wait forever
        while not done.wait(1.0):
            if self._closed and not self._thread.is_alive():
                raise Overloaded('embed batcher closed while queued')
        if box['err'] is not None:
            raise box['err']
        return box['feats']

    def _fail_queued(self):
        """Fail every request still queued at shutdown."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is self._STOP:
                continue
            _, box, done = item
            box['err'] = Overloaded('embed batcher closed (shutting down)')
            done.set()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is self._STOP:
                self._fail_queued()
                return
            batch = [item]
            n = len(item[0])
            while n < self.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._q.put(nxt)  # handle shutdown after this batch
                    break
                batch.append(nxt)
                n += len(nxt[0])
            all_paths = [p for req in batch for p in req[0]]
            try:
                feats = np.asarray(self._embed(all_paths))
                self.dispatches += 1
                off = 0
                for paths, box, _ in batch:
                    box['feats'] = feats[off:off + len(paths)]
                    off += len(paths)
            except Exception as e:  # noqa: BLE001 - isolate the poison req
                if len(batch) == 1:
                    batch[0][1]['err'] = e
                else:
                    for paths, box, _ in batch:
                        try:
                            box['feats'] = np.asarray(self._embed(paths))
                            self.dispatches += 1
                        except Exception as e2:  # noqa: BLE001
                            box['err'] = e2
            finally:
                self.images += len(all_paths)
                for _, _, done in batch:
                    done.set()


class SearchBatcher:
    """Coalesces concurrent index searches into ONE device scan.

    A scan's cost is the gallery read, about flat in the number of query
    rows, so N concurrent searches coalesced cost about one.  The same
    continuous batching as EmbedBatcher.

    Requests coalesce only within a group key (k, recall_target, exact,
    rerank params).  Coalesced rows are padded up to a bucket size (1, 4,
    16, ..., max_batch), and a group larger than ``max_batch`` goes
    through in chunks under one index snapshot, so a remove() between
    chunks cannot renumber rows mid-response.  For re-ranked groups only
    the device phase runs under the snapshot; the host k-reciprocal math
    runs after its release.
    """

    _STOP = object()

    def __init__(self, index, max_batch=64, max_pending=None):
        self.index = index
        self.max_batch = max(1, int(max_batch))
        self.max_pending = (None if max_pending is None
                            else max(1, int(max_pending)))
        self._q = queue.Queue()
        self._closed = False
        self.dispatches = 0     # logical dispatches (one per group)
        self.device_scans = 0   # device scans (>= dispatches: chunks)
        self.queries = 0        # query rows scanned
        self.shed = 0           # requests refused
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='search-batcher')
        self._thread.start()

    def buckets(self):
        """The nq padding buckets: 1, 4, 16, ... capped at max_batch."""
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 4
        out.append(self.max_batch)
        return out

    def _bucket(self, n):
        for b in self.buckets():
            if n <= b:
                return b
        return self.max_batch

    def pending(self):
        return self._q.qsize()

    def close(self):
        self._closed = True
        self._q.put(self._STOP)
        self._thread.join(timeout=60)

    def search(self, q, k, recall_target=None, exact=False, rerank=None):
        """Blocking: (dists, indices, paths) for THIS request's query
        rows; coalesced with concurrent compatible requests.

        rerank: None for the plain scan, or a dict with keys
        shortlist/k1/k2/lam/engine to route through search_reranked.
        Raises Overloaded past ``max_pending`` (the daemon sheds 503).
        """
        if self._closed:
            raise Overloaded('search batcher closed (shutting down)')
        if self.max_pending is not None and \
                self._q.qsize() >= self.max_pending:
            self.shed += 1
            raise Overloaded(
                'search backlog at {} requests (max_pending={})'.format(
                    self._q.qsize(), self.max_pending))
        q = np.asarray(q, np.float32)
        if q.ndim == 1:
            q = q[None]
        key = (int(k), recall_target, bool(exact),
               None if rerank is None else tuple(sorted(rerank.items())))
        box = {'out': None, 'err': None}
        done = threading.Event()
        self._q.put((key, q, rerank, box, done))
        while not done.wait(1.0):
            if self._closed and not self._thread.is_alive():
                raise Overloaded('search batcher closed while queued')
        if box['err'] is not None:
            raise box['err']
        return box['out']

    def _fail_queued(self):
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is self._STOP:
                continue
            item[3]['err'] = Overloaded(
                'search batcher closed (shutting down)')
            item[4].set()

    def _dispatch(self, key, group):
        k, recall_target, exact, _ = key
        rows = np.concatenate([req[1] for req in group], axis=0)
        n = rows.shape[0]
        if n > self.max_batch:
            spans = range(0, n, self.max_batch)
            if key[3] is not None:
                rk = dict(key[3])
                s_len = max(int(rk.get('shortlist', 100)), int(k))
                with self.index.snapshot():
                    preps = [self._rerank_prepare(
                        rows[a:a + self.max_batch], s_len, recall_target)
                        for a in spans]
                chunks = [self.index.rerank_from_snapshot(
                    p_, k, k1=rk.get('k1', 20), k2=rk.get('k2', 6),
                    lambda_value=rk.get('lam', 0.3),
                    engine=rk.get('engine', 'auto'), return_paths=True)
                    for p_ in preps]
            else:
                with self.index.snapshot():
                    chunks = [self._scan(key, rows[a:a + self.max_batch])
                              for a in spans]
            d = np.concatenate([c[0] for c in chunks], axis=0)
            i = np.concatenate([c[1] for c in chunks], axis=0)
            p = [row for c in chunks for row in c[2]]
        else:
            d, i, p = self._scan(key, rows)
        self.dispatches += 1
        off = 0
        for _, qr, _, box, _ in group:
            m = qr.shape[0]
            box['out'] = (d[off:off + m], i[off:off + m],
                          p[off:off + m])
            off += m

    def _rerank_prepare(self, rows, shortlist, recall_target):
        """Bucket-padded phase-1 shortlist scan for one chunk of an
        oversized rerank group (the caller holds the index snapshot)."""
        self.device_scans += 1
        n = rows.shape[0]
        b = self._bucket(n)
        if b > n:
            rows = np.concatenate(
                [rows, np.repeat(rows[-1:], b - n, axis=0)], axis=0)
        return self.index.rerank_shortlist_snapshot(
            rows, shortlist, recall_target=recall_target,
            return_paths=True, n_valid=n)

    def _scan(self, key, rows):
        """One device scan at a bucket shape; returns results for the
        real rows only (pad rows never reach the host rerank)."""
        k, recall_target, exact, rerank_key = key
        self.device_scans += 1
        n = rows.shape[0]
        b = self._bucket(n)
        if b > n:  # pad to the bucket: scan cost is bytes, not rows
            rows = np.concatenate(
                [rows, np.repeat(rows[-1:], b - n, axis=0)], axis=0)
        if rerank_key is not None:
            rerank = dict(rerank_key)
            return self.index.search_reranked(
                rows, k, shortlist=rerank.get('shortlist', 100),
                k1=rerank.get('k1', 20), k2=rerank.get('k2', 6),
                lambda_value=rerank.get('lam', 0.3),
                recall_target=recall_target,
                engine=rerank.get('engine', 'auto'), return_paths=True,
                n_valid=n)
        d, i, p = self.index.search(rows, k, recall_target=recall_target,
                                    exact=exact, return_paths=True)
        return d[:n], i[:n], p[:n]

    def _loop(self):
        while True:
            item = self._q.get()
            if item is self._STOP:
                self._fail_queued()
                return
            batch = [item]
            n = item[1].shape[0]
            while n < self.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._q.put(nxt)
                    break
                batch.append(nxt)
                n += nxt[1].shape[0]
            groups = {}
            for req in batch:
                groups.setdefault(req[0], []).append(req)
            for key, group in groups.items():
                try:
                    self._dispatch(key, group)
                except Exception as e:  # noqa: BLE001 - isolate poison
                    if len(group) == 1:
                        group[0][3]['err'] = e
                    else:
                        for req in group:
                            try:
                                self._dispatch(key, [req])
                            except Exception as e2:  # noqa: BLE001
                                req[3]['err'] = e2
                finally:
                    self.queries += sum(r[1].shape[0] for r in group)
                    for req in group:
                        req[4].set()


class RetrievalIndex:
    """Device-resident top-k retrieval over an appendable gallery.

    feats: [N, D] float embeddings (numpy, or a float tensor, which is
    quantized where it lies); paths: the per-row identities the caller
    resolves results against.  int8: store rows int8-quantized on the
    device (per-row symmetric scale; the math of the float path over the
    dequantized rows).  A host mirror of the stored rows, in original row
    order, backs remove/save and the re-rank shortlist.

    Thread-safe: search/add/remove serialize on an internal re-entrant
    lock (one device stream; concurrency belongs in the batch dimension).
    """

    # exact scans whose [Nq, Ng] distance row fits this many elements
    # take the flat route (few large blocks, the int8 product on the
    # query's hi/lo split); bigger batches stream.  64M elements: 64
    # queries at a 1M gallery, the SearchBatcher's default coalescing cap.
    # At 1M x 3968 int8 on an H100 (chip_smoke.py's retrieval_scale) flat
    # is the faster at one query and streaming at 3,368 (PERF.md).
    FLAT_SCAN_MAX_ELEMS = 64 * 1024 * 1024

    def __init__(self, feats, paths, mesh=None, int8=True, shard=False,
                 device=None):
        if shard and mesh is None:
            raise ValueError('shard=True needs a mesh')
        self.device = resolve_device(device)
        if not torch.is_tensor(feats):
            feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[0] != len(paths):
            raise ValueError('feats {} for {} paths'.format(
                tuple(feats.shape), len(paths)))
        if feats.shape[0] == 0:
            raise ValueError('RetrievalIndex needs at least one row; '
                             'build it from a non-empty gallery and '
                             'grow it with add()')
        self.paths = list(paths)
        self.int8 = bool(int8)
        self.shard = bool(shard)
        self.mesh = mesh
        g, s = self._stored(feats)
        self._host_g = g.cpu().numpy()
        self._host_s = None if s is None else s.cpu().numpy()
        self._ivf = None
        self._auto_retrain = None
        # bumped on every IVF install/disable: a background re-train
        # aborts its install if the IVF state changed during its k-means
        self._ivf_gen = 0
        # re-entrant: search_reranked / search(return_paths=True) hold it
        # across the scan and the row/path resolution so a concurrent
        # remove() (which renumbers rows) cannot interleave
        self._lock = threading.RLock()
        self._g, self._s = g, s
        self._gn = None
        self._n = len(self.paths)
        if self.shard:
            self._place()

    def _stored(self, feats):
        """(rows, scales or None) as stored, tensors on the device; int8
        rows are quantized on the device (the same bytes as numpy)."""
        f = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        if self.int8:
            return quantize_gallery(f)
        return f, None

    def __len__(self):
        return len(self.paths)

    def snapshot(self):
        """Context manager pinning the index state (row numbering,
        centroids, paths) for a multi-call read.  Re-entrant with the
        internal lock the individual calls take."""
        return self._lock

    @property
    def dim(self):
        return int(self._host_g.shape[1])

    def _place(self):
        self._gn = None        # row norms follow the device layout
        if self.shard and self._ivf is not None:
            self._place_ivf_sharded()
        elif self.shard:
            self._g, self._s, self._n = ret_lib.shard_gallery(
                self._host_g, self.mesh, int8=self.int8,
                g_scale=self._host_s)
        elif self._ivf is not None:
            self._place_ivf()
        else:
            self._g = torch.as_tensor(self._host_g, device=self.device)
            self._s = (None if self._host_s is None
                       else torch.as_tensor(self._host_s,
                                            device=self.device))
            self._n = len(self.paths)

    # ------------------------------------------------------------------
    # IVF.  Device layout while enabled: rows [0, n_sorted) are the host
    # gallery permuted cell by cell (``perm`` maps device position back
    # to the original row id); rows [n_sorted, N) are the SPILL, appended
    # since the last (re)build, scanned exactly and merged, and folded
    # into the sorted layout once it outgrows ``spill_limit``.  The host
    # mirror stays in original row order.
    # ------------------------------------------------------------------

    def _place_ivf(self, device_layout=None):
        """(Re)build the cell-sorted device placement from per-row cell
        assignments (folds any spill).  ``device_layout``: original row id
        per CURRENT device position; when given (and complete) the re-sort
        is a gather of the resident rows on the device instead of a
        transfer of the host mirror."""
        self._gn = None
        ivf = self._ivf
        perm, starts = ivf_ops.build_ivf(ivf['assign'], ivf['nlist'])
        if device_layout is not None and len(device_layout) == len(perm):
            inv = np.empty(len(device_layout), np.int64)
            inv[device_layout] = np.arange(len(device_layout))
            dev_perm = torch.as_tensor(inv[perm], device=self.device)
            self._g = self._g[dev_perm]
            if self._s is not None:
                self._s = self._s[dev_perm]
        else:
            self._g = torch.as_tensor(self._host_g[perm], device=self.device)
            self._s = (None if self._host_s is None else torch.as_tensor(
                self._host_s[perm], device=self.device))
        ivf['perm'], ivf['starts'] = perm, starts
        ivf['starts_dev'] = torch.as_tensor(starts.astype(np.int64),
                                            device=self.device)
        ivf['spill_ids'] = np.zeros((0,), np.int32)
        self._n = len(self.paths)

    def _place_ivf_sharded(self):
        """The sharded IVF placement: every cell's rows dealt round-robin
        over the shards (``parallel/retrieval.shard_ivf_gallery``), with
        no spill segment (an add re-places, as the sharded gallery
        does)."""
        ivf = self._ivf
        ivf['placed'] = ret_lib.shard_ivf_gallery(
            self._host_g, ivf['assign'], ivf['nlist'], self.mesh,
            g_scale=self._host_s)
        self._n = len(self.paths)

    def enable_ivf(self, nlist=None, nprobe=8, budget=None, iters=10,
                   seed=0, sample=262144, spill_limit=None):
        """Cluster the gallery and switch ``search`` to IVF probing.

        nlist: cells (default ``ivf.default_nlist``, ~4*sqrt(N)).
        nprobe: cells scanned per query.  budget: candidate-row cap per
        query (default ~4x the expected rows at this nprobe).
        spill_limit: appended rows tolerated before an automatic re-sort
        (default max(4096, N/10)).  k-means runs off the index lock on a
        snapshot of the host mirror (add() replaces, never mutates, the
        mirror arrays); only the install below holds the lock.
        """
        with self._lock:
            host_g, host_s = self._host_g, self._host_s
        n0 = len(host_g)
        cent = ivf_ops.kmeans(
            host_g, int(nlist) if nlist else ivf_ops.default_nlist(n0),
            iters=iters, seed=seed, g_scale=host_s, sample=sample,
            device=self.device)
        self._install_ivf(
            cent, nprobe=nprobe, budget=budget, spill_limit=spill_limit,
            train=dict(nlist=nlist, nprobe=int(nprobe), budget=budget,
                       iters=int(iters), seed=int(seed),
                       sample=int(sample), spill_limit=spill_limit))

    def _install_ivf(self, cent, nprobe, budget, spill_limit, train,
                     expect_gen=None):
        """Swap in a clustering atomically: assign every CURRENT row (read
        from the resident device rows) to the centroids and re-sort the
        device placement under one lock hold.  ``expect_gen``: abort
        (return False) if the IVF state changed since a background
        re-train started.  Returns True when installed."""
        cent = torch.as_tensor(cent, dtype=torch.float32, device=self.device)
        nlist = int(cent.shape[0])  # clamped by kmeans
        with self._lock:
            if expect_gen is not None and self._ivf_gen != expect_gen:
                logger.info('IVF install aborted: index IVF state '
                            'changed during training (gen %d -> %d)',
                            expect_gen, self._ivf_gen)
                return False
            ng = len(self.paths)
            cur_layout = None
            if self.shard:
                assign = np.asarray(ivf_ops.assign_clusters(
                    self._host_g, cent, g_scale=self._host_s,
                    device=self.device), np.int32)
            else:
                # device rows are in device-layout order (original order
                # when IVF is off; sorted + spill when re-training)
                if self._ivf is None:
                    cur_layout = np.arange(ng, dtype=np.int64)
                else:
                    cur_layout = np.concatenate(
                        [self._ivf['perm'],
                         self._ivf['spill_ids']]).astype(np.int64)
                a_dev = ivf_ops.assign_clusters(self._g, cent,
                                                g_scale=self._s)
                assign = np.empty(ng, np.int32)
                assign[cur_layout] = a_dev
            if budget is None:
                budget = min(ng, max(2048, 4 * nprobe * max(ng, 1)
                                     // max(nlist, 1)))
            self._ivf = {
                'cent': cent,
                'assign': assign,
                'nlist': nlist,
                'nprobe': int(nprobe),
                'budget': int(budget),
                'spill_limit': int(spill_limit if spill_limit is not None
                                   else max(4096, ng // 10)),
                'trained_n': ng,  # rows present at install
                'train': train,   # recipe for re-training
            }
            if self.shard:
                self._place_ivf_sharded()
            else:
                self._place_ivf(device_layout=cur_layout)
            self._ivf_gen += 1
            log_np, log_bg = self._ivf['nprobe'], self._ivf['budget']
        logger.info('IVF installed: %d cells, nprobe=%d, budget=%d',
                    nlist, log_np, log_bg)
        return True

    def disable_ivf(self):
        """Back to the exact scan (original row order)."""
        with self._lock:
            self._ivf = None
            self._ivf_gen += 1
            self._place()

    @property
    def ivf_enabled(self):
        return self._ivf is not None

    @property
    def ivf_staleness(self):
        """Fraction of the gallery appended since the IVF centroids were
        trained (0.0 right after ``enable_ivf``; None when IVF is off).
        Centroids are fixed after ``enable_ivf``: appended rows go to their
        nearest cell.  ``enable_auto_retrain`` re-trains in the background
        past a threshold; a re-train never runs inline inside ``add``."""
        ivf = self._ivf  # snapshot: disable_ivf may null it mid-read
        if ivf is None:
            return None
        n = len(self.paths)
        return max(0.0, (n - ivf['trained_n']) / max(n, 1))

    def enable_auto_retrain(self, threshold=0.25):
        """Re-train the IVF clustering in a daemon thread once
        ``ivf_staleness`` crosses ``threshold`` (checked after every
        ``add``; one re-train at a time; k-means off the lock, the install
        under it)."""
        if self._ivf is None:
            raise RuntimeError('enable_ivf before auto-retrain')
        self._auto_retrain = {'threshold': float(threshold),
                              'thread': None, 'count': 0}

    def disable_auto_retrain(self):
        self._auto_retrain = None

    @property
    def retrain_count(self):
        """Completed background re-trains (0 when auto-retrain is off)."""
        ar = self._auto_retrain
        return ar['count'] if ar else 0

    @property
    def retraining(self):
        """True while a background re-train is in flight."""
        ar = self._auto_retrain
        t = ar and ar.get('thread')
        return bool(t and t.is_alive())

    def wait_retrain(self, timeout=None):
        """Block until any in-flight background re-train finishes.
        Returns ``retrain_count``."""
        ar = self._auto_retrain
        t = ar and ar.get('thread')
        if t is not None:
            t.join(timeout)
        return self.retrain_count

    def _maybe_auto_retrain(self):
        ar = self._auto_retrain
        if ar is None:
            return
        with self._lock:
            s = self.ivf_staleness
            if s is None or s < ar['threshold']:
                return
            t = ar.get('thread')
            if t is not None and t.is_alive():
                return  # one re-train at a time; re-checked on next add
            logger.info('IVF staleness %.3f >= %.3f: background '
                        're-train starting', s, ar['threshold'])
            t = threading.Thread(target=self._auto_retrain_run,
                                 name='ivf-auto-retrain', daemon=True)
            ar['thread'] = t
            t.start()

    def _auto_retrain_run(self):
        try:
            with self._lock:
                if self._ivf is None:
                    return
                train = dict(self._ivf.get('train') or {})
                spill_cur = self._ivf['spill_limit']
                nprobe_cur = self._ivf['nprobe']
                budget_cur = self._ivf['budget']
                gen = self._ivf_gen
                host_g, host_s = self._host_g, self._host_s
            # an index restored by load() carries the operating knobs but
            # no train recipe: re-train with the persisted knobs verbatim
            nlist = train.get('nlist')
            cent = ivf_ops.kmeans(
                host_g,
                int(nlist) if nlist else ivf_ops.default_nlist(
                    len(host_g)),
                iters=train.get('iters', 10), seed=train.get('seed', 0),
                g_scale=host_s, sample=train.get('sample', 262144),
                device=self.device)
            installed = self._install_ivf(
                cent, nprobe=train.get('nprobe', nprobe_cur),
                budget=train.get('budget') if train else budget_cur,
                spill_limit=train.get('spill_limit', spill_cur),
                train=train or dict(nlist=None, nprobe=nprobe_cur,
                                    budget=budget_cur, iters=10, seed=0,
                                    sample=262144, spill_limit=spill_cur),
                expect_gen=gen)
            if not installed:
                return  # operator changed IVF state during training
            ar = self._auto_retrain
            if ar is not None:
                ar['count'] += 1
            logger.info('IVF auto-retrain complete (staleness reset, '
                        '%d rows)', len(self.paths))
        except Exception:  # noqa: BLE001 - a background thread reports
            logger.exception('IVF auto-retrain failed; index unchanged')

    def _to_orig(self, pos):
        """Device-layout positions -> original row ids (-1 passthrough);
        identity when IVF is off.  The perm + spill map is cached per
        placement (both arrays are replaced, never mutated)."""
        ivf = self._ivf
        if ivf is None:
            return pos
        cache = ivf.get('_orig_map')
        if (cache is None or cache[0] is not ivf['perm'] or
                cache[1] is not ivf['spill_ids']):
            cache = (ivf['perm'], ivf['spill_ids'],
                     np.concatenate([ivf['perm'], ivf['spill_ids']]))
            ivf['_orig_map'] = cache
        mapping = cache[2]
        safe = np.clip(pos, 0, max(len(mapping) - 1, 0))
        return np.where(pos >= 0, mapping[safe], -1)

    def _search_ivf(self, q, k, chunk):
        """IVF probe over the sorted region + exact scan of the spill
        tail, merged on the host.  Returns (dists, original row ids)."""
        ivf = self._ivf
        n_sorted = len(ivf['perm'])
        n_spill = len(ivf['spill_ids'])
        d, pos = ivf_ops.ivf_topk(q, self._g, ivf['cent'], ivf['starts_dev'],
                                  k=min(k, max(n_sorted, 1)),
                                  nprobe=ivf['nprobe'], budget=ivf['budget'],
                                  g_scale=self._s)
        d, pos = d.cpu().numpy(), pos.cpu().numpy()
        safe = np.clip(pos, 0, max(n_sorted - 1, 0))
        ids = np.where(pos >= 0, ivf['perm'][safe], -1)
        if n_spill:
            sp_d, sp_p = streaming_topk(
                q, self._g[n_sorted:], k=min(k, n_spill), chunk=chunk,
                g_scale=None if self._s is None else self._s[n_sorted:])
            sp_d, sp_p = sp_d.cpu().numpy(), sp_p.cpu().numpy()
            sp_ids = np.where(sp_p >= 0, ivf['spill_ids'][
                np.clip(sp_p, 0, n_spill - 1)], -1)
            d = np.concatenate([d, sp_d], axis=1)
            ids = np.concatenate([ids, sp_ids], axis=1)
        sel = np.argsort(d, axis=1, kind='stable')[:, :k]
        return (np.take_along_axis(d, sel, axis=1),
                np.take_along_axis(ids, sel, axis=1))

    def _paths_of(self, idxs):
        """[[path or None per column] per query]; call under _lock."""
        return [[self.paths[int(j)] if 0 <= int(j) < len(self.paths)
                 else None for j in row] for row in idxs]

    def search(self, q_feats, k, recall_target=None, chunk=4096,
               return_paths=False, exact=False):
        """Returns (dists [Nq, k'], indices [Nq, k']) as numpy with
        k' = min(k, len(index)); indices index into ``self.paths``.

        Routes: with IVF enabled, the IVF probe (``recall_target`` is
        ignored; ``exact=True`` forces the exact scan); otherwise the flat
        product when the [Nq, Ng] distance row fits
        ``FLAT_SCAN_MAX_ELEMS``, else the streaming scan.  Both exact
        routes give the same lowest-index-first result.

        return_paths=True also returns the matched paths, resolved under
        the index lock (the race-safe way to map indices to paths while
        another thread may remove() rows)."""
        q = np.asarray(q_feats, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise ValueError('query width {} != index width {}'.format(
                q.shape[1], self.dim))
        with self._lock:
            k_req = max(1, min(int(k), self._n))
            # k bucketed to the next power of two (clamped to the
            # gallery), as in the JAX package, whose top-k programs are
            # compiled per k; results are sliced back to k_req below
            k = min(self._n, 1 << (k_req - 1).bit_length())
            qt = torch.as_tensor(q, device=self.device)
            if self.shard and self._ivf is not None:
                ivf = self._ivf
                d, i = ret_lib.sharded_ivf_topk(
                    qt, ivf['cent'], ivf['placed'], k=k,
                    nprobe=ivf['nprobe'], budget=ivf['budget'], chunk=chunk,
                    exact=exact)
                d, i = d.cpu().numpy(), i.cpu().numpy()
            elif self.shard:
                d, i = ret_lib.sharded_topk(
                    qt, self._g, ng_total=self._n, k=k, chunk=chunk,
                    recall_target=recall_target, g_scale=self._s)
                d, i = d.cpu().numpy(), i.cpu().numpy()
            elif self._ivf is not None and not exact:
                d, i = self._search_ivf(qt, k, chunk)
            else:
                if q.shape[0] * self._n <= self.FLAT_SCAN_MAX_ELEMS:
                    if self._gn is None:
                        self._gn = gallery_norms(self._g, self._s)
                    d, i = flat_topk(qt, self._g, k=k, g_scale=self._s,
                                     g_norm=self._gn)
                else:
                    d, i = streaming_topk(qt, self._g, k=k, chunk=chunk,
                                          recall_target=recall_target,
                                          g_scale=self._s)
                # the device layout is cell-sorted under IVF: map back
                d, i = d.cpu().numpy(), self._to_orig(i.cpu().numpy())
            d, i = d[:, :k_req], i[:, :k_req]
            if return_paths:
                return d, i, self._paths_of(i)
            return d, i

    def _rows_f32(self, idx):
        """Dequantized float32 gallery rows for an index array (host)."""
        rows = self._host_g[idx].astype(np.float32)
        if self._host_s is not None:
            rows *= self._host_s[idx][:, None]
        return rows

    def search_reranked(self, q_feats, k, shortlist=100, k1=20, k2=6,
                        lambda_value=0.3, recall_target=None, chunk=4096,
                        engine='auto', return_paths=False, n_valid=None):
        """Two-stage retrieval: device top-``shortlist``, then k-reciprocal
        re-ranking of each query's candidate set on the host (engine
        'auto' = the C++ engine, 'numpy' = the golden path), returning the
        top ``k`` by blended distance (smaller = better; NOT euclidean).
        Each query is re-ranked alone.  With ``shortlist >= len(index)``
        the result is the global single-query re-ranking.

        ``n_valid``: only the first ``n_valid`` query rows are real (the
        rest is bucket padding from the SearchBatcher); the outputs have
        ``n_valid`` rows.
        """
        s = max(int(shortlist), int(k))
        prep = self.rerank_shortlist_snapshot(
            q_feats, s, recall_target=recall_target, chunk=chunk,
            return_paths=return_paths, n_valid=n_valid)
        return self.rerank_from_snapshot(
            prep, k, k1=k1, k2=k2, lambda_value=lambda_value,
            engine=engine, return_paths=return_paths)

    def rerank_shortlist_snapshot(self, q_feats, shortlist,
                                  recall_target=None, chunk=4096,
                                  return_paths=False, n_valid=None):
        """Phase 1 of ``search_reranked``, under the index lock: the device
        top-``shortlist`` scan plus a host snapshot of each query's
        candidate rows and paths.  Returns an opaque prep dict for
        ``rerank_from_snapshot``, which runs outside the lock."""
        q = np.asarray(q_feats, np.float32)
        if q.ndim == 1:
            q = q[None]
        nq_real = q.shape[0] if n_valid is None else min(int(n_valid),
                                                         q.shape[0])
        with self._lock:
            d0, i0 = self.search(q, int(shortlist),
                                 recall_target=recall_target, chunk=chunk)
            snaps = []
            for qi in range(nq_real):
                cand = i0[qi][i0[qi] >= 0]
                rows = self._rows_f32(cand) if cand.size else None
                cpaths = None
                if return_paths:
                    cpaths = [self.paths[int(j)]
                              if 0 <= int(j) < len(self.paths) else None
                              for j in cand]
                snaps.append((cand, rows, cpaths))
        return {'q': q, 'snaps': snaps, 'ncols': i0.shape[1],
                'nq_real': nq_real}

    def rerank_from_snapshot(self, prep, k, k1=20, k2=6,
                             lambda_value=0.3, engine='auto',
                             return_paths=False):
        """Phase 2 of ``search_reranked``: the per-query k-reciprocal math
        over a phase-1 snapshot (host work; call it outside the lock)."""
        q, snaps = prep['q'], prep['snaps']
        nq_real = prep['nq_real']
        kk = min(int(k), prep['ncols'])
        out_d = np.full((nq_real, kk), np.inf, np.float32)
        out_i = np.full((nq_real, kk), -1, np.int64)
        out_p = [[None] * kk for _ in range(nq_real)]
        for qi, (cand, rows, cpaths) in enumerate(snaps):
            if cand.size == 0:
                continue
            qrow = q[qi:qi + 1]
            qg = _euclidean(qrow, rows)
            gg = _euclidean(rows, rows)
            qq = np.zeros((1, 1), np.float32)
            c_k1 = min(int(k1), cand.size)
            c_k2 = max(1, min(int(k2), c_k1))
            rr = native.rerank(qg, qq, gg, k1=c_k1, k2=c_k2,
                               lambda_value=float(lambda_value),
                               engine=engine)[0]
            order = np.argsort(rr, kind='stable')[:kk]
            out_d[qi, :order.size] = rr[order]
            out_i[qi, :order.size] = cand[order]
            if return_paths:
                for r, o in enumerate(order):
                    out_p[qi][r] = cpaths[int(o)]
        if return_paths:
            return out_d, out_i, out_p
        return out_d, out_i

    def remove(self, paths):
        """Drop every row whose path is in ``paths``; returns the number
        of rows removed.  The rows after a removed one are renumbered, and
        the gallery is re-placed from the host mirror.  Refuses to empty
        the index."""
        drop = set(paths)
        with self._lock:
            keep = np.fromiter((p not in drop for p in self.paths),
                               bool, count=len(self.paths))
            removed = int((~keep).sum())
            if removed == 0:
                return 0
            if keep.sum() == 0:
                raise ValueError('remove would empty the gallery '
                                 '({} rows)'.format(removed))
            self._host_g = np.ascontiguousarray(self._host_g[keep])
            if self._host_s is not None:
                self._host_s = np.ascontiguousarray(self._host_s[keep])
            self.paths = [p for p, k in zip(self.paths, keep) if k]
            if self._ivf is not None:
                # assignments survive removal (centroids unchanged)
                self._ivf['assign'] = np.ascontiguousarray(
                    self._ivf['assign'][keep])
            self._place()
        logger.info('removed %d rows; gallery now %d', removed,
                    len(self.paths))
        return removed

    def save(self, path):
        """Persist the index to one ``.npz``: the STORED (possibly int8)
        rows, the paths, the scales and any IVF clustering, in the JAX
        package's keys and layout.  Written atomically (tmp + rename)."""
        with self._lock:
            payload = {'gallery': self._host_g,
                       'paths': np.array(self.paths, dtype=object),
                       'int8': np.array(self.int8)}
            if self._host_s is not None:
                payload['scale'] = self._host_s
            if self._ivf is not None:
                payload['ivf_cent'] = self._ivf['cent'].cpu().numpy()
                payload['ivf_assign'] = self._ivf['assign']
                payload['ivf_params'] = np.array(
                    [self._ivf['nprobe'], self._ivf['budget'],
                     self._ivf['spill_limit'],
                     self._ivf['trained_n']], np.int64)
            tmp = path + '.tmp.npz'
            with open(tmp, 'wb') as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
        logger.info('saved %d x %d index (%s) to %s', len(self.paths),
                    self.dim, 'int8' if self.int8 else 'f32', path)

    @classmethod
    def load(cls, path, mesh=None, shard=False, device=None):
        """Rebuild an index from a ``save`` file (either package's) and
        place it on ``device`` (row-sharded over ``mesh`` with ``shard``).
        int8-ness travels with the file."""
        if shard and mesh is None:
            raise ValueError('shard=True needs a mesh')
        data = np.load(path, allow_pickle=True)
        int8 = bool(data['int8'])
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.paths = list(data['paths'])
        self.int8 = int8
        self.shard = bool(shard)
        self.mesh = mesh
        self._host_g = np.ascontiguousarray(
            data['gallery'], np.int8 if int8 else np.float32)
        self._host_s = (np.ascontiguousarray(data['scale'], np.float32)
                        if int8 else None)
        if self._host_g.ndim != 2 or \
                self._host_g.shape[0] != len(self.paths):
            raise ValueError('{}: gallery {} for {} paths'.format(
                path, self._host_g.shape, len(self.paths)))
        self._ivf = None
        if 'ivf_cent' in data:
            cent = np.asarray(data['ivf_cent'], np.float32)
            iv = [int(v) for v in data['ivf_params']]
            nprobe, budget, spill_limit = iv[:3]
            # files written before the staleness metric carry 3 params:
            # their rows count as all trained
            trained_n = iv[3] if len(iv) > 3 else len(self.paths)
            self._ivf = {
                'cent': torch.as_tensor(cent, device=self.device),
                'assign': np.ascontiguousarray(data['ivf_assign'],
                                               np.int32),
                'nlist': int(cent.shape[0]),
                'nprobe': nprobe, 'budget': budget,
                'spill_limit': spill_limit,
                'trained_n': trained_n,
            }
        self._auto_retrain = None
        self._ivf_gen = 0
        self._lock = threading.RLock()
        self._place()
        logger.info('loaded %d x %d index (%s) from %s', len(self.paths),
                    self.dim, 'int8' if int8 else 'f32', path)
        return self

    def add(self, feats, paths):
        """Append rows.  Only the new rows cross to the device (quantized
        there when int8); the cached row norms grow by the new rows'
        norms.  Under IVF the new rows are assigned to their cells and
        join the spill tail, which is folded into the sorted layout once
        it outgrows ``spill_limit``.  A sharded index re-places its shards
        from the host mirror."""
        if not torch.is_tensor(feats):
            feats = np.asarray(feats, np.float32)
        if feats.ndim == 1:
            feats = feats[None]
        if feats.shape[0] != len(paths) or feats.shape[1] != self.dim:
            raise ValueError('feats {} for {} paths of width {}'.format(
                tuple(feats.shape), len(paths), self.dim))
        with self._lock:
            n_before = len(self.paths)
            new_g, new_s = self._stored(feats)
            self._host_g = np.concatenate([self._host_g,
                                           new_g.cpu().numpy()])
            if new_s is not None:
                self._host_s = np.concatenate([self._host_s,
                                               new_s.cpu().numpy()])
            self.paths.extend(paths)
            if self._ivf is not None:
                new_a = ivf_ops.assign_clusters(new_g, self._ivf['cent'],
                                                g_scale=new_s)
                self._ivf['assign'] = np.concatenate(
                    [self._ivf['assign'], new_a])
            if self.shard:
                self._place()  # the shards are re-placed from the mirror
            else:
                self._append(new_g, new_s, n_before)
        # outside the lock: may start a background re-train thread
        self._maybe_auto_retrain()

    def _append(self, new_g, new_s, n_before):
        """Append stored rows to the unsharded device placement (under the
        lock): the cached row norms grow by the new rows' norms, and under
        IVF the new rows join the spill tail, folded into the sorted
        layout once it outgrows ``spill_limit``."""
        self._g = torch.cat([self._g, new_g])
        if new_s is not None:
            self._s = torch.cat([self._s, new_s])
        if self._gn is not None:
            self._gn = torch.cat([self._gn, gallery_norms(new_g, new_s)])
        self._n = len(self.paths)
        if self._ivf is not None:
            ivf = self._ivf
            ivf['spill_ids'] = np.concatenate(
                [ivf['spill_ids'],
                 np.arange(n_before, len(self.paths), dtype=np.int32)])
            if len(ivf['spill_ids']) > ivf['spill_limit']:
                logger.info('IVF spill at %d rows; re-sorting',
                            len(ivf['spill_ids']))
                self._place_ivf(device_layout=np.concatenate(
                    [ivf['perm'], ivf['spill_ids']]))
