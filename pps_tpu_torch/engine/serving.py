"""Serving: persistent query embedding and a device-resident gallery.

Counterpart of the request path of ``pps_tpu/engine/serving.py``:

* ``QueryEmbedder`` embeds a request's decoded images over the uint8
  device-preprocessing wire, padded to the smallest size of a geometric
  batch ladder (1, 4, 16, ... capped at ``max_batch``) so a single query
  ships one image, not a full eval batch;
* ``RetrievalIndex`` keeps the gallery on the device (float32, or int8
  with per-row scales) and answers exact top-k queries with one product
  over the whole gallery (``ops/topk.flat_topk``).

A group of mixed decode sizes, or of another size than the one pinned,
is preprocessed on the host (float32) and embedded by the same model on
the device.

Not in this slice: the batchers, IVF, sharding, re-ranking, remove, save
and load, and the streaming scan above ``FLAT_SCAN_MAX_ELEMS`` (ROADMAP
slice 5).
"""

import threading

import numpy as np
import torch

from pps_tpu_torch.data import transforms
from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.ops.topk import flat_topk, gallery_norms, quantize_gallery
from pps_tpu_torch.parallel import eval_step as es_lib

_SERVING_TODO = '{} is not ported yet (ROADMAP slice 5: serving)'


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

    def embed(self, paths, decode_fn):
        """[len(paths), D] float32 embeddings of the images behind
        ``paths`` (blocking).  ``decode_fn(path)`` returns a uint8
        [H, W, 3] BGR decode; the port has no image decoder of its own."""
        if not paths:
            return np.zeros((0, self._dim or 0), np.float32)
        ims = [decode_fn(p) for p in paths]
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


class RetrievalIndex:
    """Device-resident exact top-k retrieval over an appendable gallery.

    feats: [N, D] float embeddings; paths: per-row labels the caller
    resolves results against.  int8: store rows int8-quantized with a
    per-row scale (4x fewer bytes; the same math as the float path over
    the dequantized rows).  Search and add serialize on a lock.
    """

    # exact scans whose [Nq, Ng] distance row fits this many elements use
    # the flat route (one product over the gallery); 64M elements = 256 MB
    # of float32 for the row
    FLAT_SCAN_MAX_ELEMS = 64 * 1024 * 1024

    def __init__(self, feats, paths, int8=True, device=None):
        feats = np.asarray(feats, np.float32)
        assert feats.ndim == 2 and feats.shape[0] == len(paths), \
            (feats.shape, len(paths))
        if feats.shape[0] == 0:
            raise ValueError('RetrievalIndex needs at least one row; '
                             'build it from a non-empty gallery and '
                             'grow it with add()')
        self.device = resolve_device(device)
        self.paths = list(paths)
        self.int8 = bool(int8)
        if self.int8:
            g8, sc = quantize_gallery(feats)
            self._host_g, self._host_s = g8, sc
        else:
            self._host_g, self._host_s = feats, None
        self._lock = threading.RLock()
        self._g = torch.as_tensor(self._host_g, device=self.device)
        self._s = (None if self._host_s is None
                   else torch.as_tensor(self._host_s, device=self.device))
        self._gn = None  # cached row norms, built at the first search
        self._n = len(self.paths)

    def __len__(self):
        return len(self.paths)

    @property
    def dim(self):
        return int(self._host_g.shape[1])

    def _paths_of(self, idxs):
        """[[path or None per column] per query] — call under _lock."""
        return [[self.paths[int(j)] if 0 <= int(j) < len(self.paths)
                 else None for j in row] for row in idxs]

    def search(self, q_feats, k, return_paths=False):
        """Returns (dists [Nq, k'], indices [Nq, k']) as numpy with
        k' = min(k, len(index)); indices index into ``self.paths``.
        return_paths=True also returns the matched paths, resolved under
        the index lock."""
        q = np.asarray(q_feats, np.float32)
        if q.ndim == 1:
            q = q[None]
        assert q.shape[1] == self.dim, (q.shape, self.dim)
        with self._lock:
            k_req = max(1, min(int(k), self._n))
            # k bucketed to the next power of two (clamped to the
            # gallery), as in the JAX package, whose top-k programs are
            # compiled per k; results are sliced back to k_req below
            k = min(self._n, 1 << (k_req - 1).bit_length())
            if q.shape[0] * self._n > self.FLAT_SCAN_MAX_ELEMS:
                raise NotImplementedError(_SERVING_TODO.format(
                    'the streaming scan above FLAT_SCAN_MAX_ELEMS'))
            if self._gn is None:
                self._gn = gallery_norms(self._g, self._s)
            qt = torch.as_tensor(q, device=self.device)
            d, i = flat_topk(qt, self._g, k=k, g_scale=self._s,
                             g_norm=self._gn)
            d, i = d.cpu().numpy(), i.cpu().numpy()
            d, i = d[:, :k_req], i[:, :k_req]
            if return_paths:
                return d, i, self._paths_of(i)
            return d, i

    def add(self, feats, paths):
        """Append rows.  Only the new rows cross to the device; the cached
        row norms grow by the new rows' norms."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 1:
            feats = feats[None]
        assert feats.shape[0] == len(paths) and feats.shape[1] == self.dim
        with self._lock:
            if self.int8:
                new_g, new_s = quantize_gallery(feats)
                self._host_g = np.concatenate([self._host_g, new_g])
                self._host_s = np.concatenate([self._host_s, new_s])
            else:
                new_g, new_s = feats, None
                self._host_g = np.concatenate([self._host_g, feats])
            self.paths.extend(paths)
            new_g_dev = torch.as_tensor(new_g, device=self.device)
            new_s_dev = (None if new_s is None
                         else torch.as_tensor(new_s, device=self.device))
            self._g = torch.cat([self._g, new_g_dev])
            if new_s_dev is not None:
                self._s = torch.cat([self._s, new_s_dev])
            if self._gn is not None:
                self._gn = torch.cat(
                    [self._gn, gallery_norms(new_g_dev, new_s_dev)])
            self._n = len(self.paths)
