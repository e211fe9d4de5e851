"""Sharded-gallery retrieval (counterpart of
``pps_tpu/parallel/retrieval.py``).

The gallery is row-sharded over the shards of a single-process mesh
(``mesh.build_mesh(devices=[...])``, one shard per card; a list may name
one device more than once, so one card can hold several shards).  Each
shard is its own tensor on its device; each runs the port's streaming
top-k (``ops/topk.streaming_topk``) over its rows with gallery-global
indices (``index_offset``, ``n_valid``), and the per-shard [Nq, k]
candidates go to the first shard's device for one exact merge: the ``k``
smallest int64 (distance bits, index) keys, so ties break to the lowest
index.  The merge moves O(shards x Nq x k) values, whatever the gallery
size.  Empty slots are +inf / -1.

pps_tpu runs the per-shard scan under ``shard_map`` in one program; its
``_vary_axes`` belongs to ``shard_map`` and has no counterpart here: the
shards are launched one after the other from one host thread, and on
separate cards they run concurrently.

Use ``shard_gallery`` once (placement), then ``sharded_topk`` per query
batch; ``shard_ivf_gallery`` / ``sharded_ivf_topk`` for the IVF index.
"""

import numpy as np
import torch

from pps_tpu_torch.ops import ivf as ivf_ops
from pps_tpu_torch.ops.topk import (key_dist2, key_index, quantize_gallery,
                                    sq_keys, streaming_topk)

_NO_INDEX = (1 << 31) - 1   # an empty slot's index inside a merge key


def _shard(part, device):
    """A copy of ``part`` (numpy or tensor) as its own tensor on
    ``device``."""
    return torch.as_tensor(part).to(device, copy=True)


def shard_gallery(g, mesh, int8=True, g_scale=None):
    """Pad and place a [Ng, d] gallery row-sharded over the mesh's shards.

    g: float rows (numpy or a tensor), or int8 rows with ``g_scale`` (as
    ``ops/topk.quantize_gallery`` returns them).  int8: quantize on the way
    in.  Returns (shards [tensor per shard], scales [tensor per shard] or
    None, ng_total): ``ng_total`` is the row count before padding; pass it
    to ``sharded_topk``.
    """
    devices = mesh.shard_devices()
    n = len(devices)
    ng = int(g.shape[0])
    if g_scale is None and int8:
        g, g_scale = quantize_gallery(g)
    rows = -(-ng // n)
    g_parts, s_parts = [], None if g_scale is None else []
    for s, dev in enumerate(devices):
        part = _pad_rows(g[s * rows:(s + 1) * rows], rows)
        g_parts.append(_shard(part, dev))
        if s_parts is not None:
            sp = _pad_rows(g_scale[s * rows:(s + 1) * rows], rows)
            s_parts.append(_shard(sp, dev).float())
    return g_parts, s_parts, ng


def _f32_on(x, device):
    """``x`` (numpy or a tensor) as a float32 tensor on ``device``; a
    tensor already there is not copied."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _pad_rows(a, rows):
    """``a`` with zero rows appended up to ``rows``."""
    pad = rows - a.shape[0]
    if not pad:
        return a
    if torch.is_tensor(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def merge_candidates(parts, k, device):
    """The exact merge of per-shard (dists [Nq, k_s], global indices
    [Nq, k_s]) candidates: the ``k`` smallest, ascending, ties to the
    lowest index; empty slots +inf / -1."""
    d = torch.cat([p[0].to(device) for p in parts], dim=1)
    i = torch.cat([p[1].to(device) for p in parts], dim=1).to(torch.int64)
    empty = i < 0
    d = torch.where(empty, torch.inf, d)
    keys = sq_keys(d, torch.where(empty, _NO_INDEX, i))
    best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False,
                      sorted=True).values
    out_d = key_dist2(best)
    out_i = key_index(best).to(torch.int32)
    return out_d, torch.where(torch.isinf(out_d), -1, out_i)


@torch.no_grad()
def sharded_topk(q, g, ng_total=None, k=100, chunk=4096, recall_target=None,
                 g_scale=None):
    """Global (dists, indices) top-k over a row-sharded gallery.

    q: [Nq, d] queries (numpy or a tensor; copied to each shard's device).
    g (+ g_scale): ``shard_gallery``'s shards.  ng_total: the true row
    count (indices >= it never appear).  The semantics of
    ``streaming_topk`` over the concatenated gallery; ``recall_target`` is
    passed through (the port's scan is exact).  Entries beyond the
    gallery come back as +inf / -1 (only when k > ng_total).  Unlike
    pps_tpu's, it takes no mesh: each shard carries its device.
    """
    n = len(g)
    rows = int(g[0].shape[0])
    ng_total = rows * n if ng_total is None else int(ng_total)
    k_local = min(int(k), rows)
    chunk = max(1, min(int(chunk), rows))
    parts = []
    for s, gs in enumerate(g):
        base = s * rows
        n_valid = int(np.clip(ng_total - base, 0, rows))
        qs = _f32_on(q, gs.device)
        parts.append(streaming_topk(
            qs, gs, k=k_local, chunk=chunk, recall_target=recall_target,
            g_scale=None if g_scale is None else g_scale[s],
            n_valid=n_valid, index_offset=base))
    return merge_candidates(parts, min(int(k), ng_total), g[0].device)


def shard_ivf_gallery(g, assign, nlist, mesh, g_scale=None):
    """Place a clustered gallery row-sharded for ``sharded_ivf_topk``.

    Every cell's rows are dealt round-robin across the shards, so each
    shard holds a slice of EVERY cell: a probe of the ``nprobe`` nearest
    (global) cells scans the same cell set as the single-device IVF, and
    the recall is the single-device IVF's, while each shard reads only its
    share of the probed bytes.

    g: [Ng, d] host rows (int8 with ``g_scale``, or float).  assign: [Ng]
    cell ids (``ops/ivf.assign_clusters``).  Returns a dict: 'g' / 'scale'
    / 'perm' (original row id per slot, -1 padding) / 'starts'
    ([nlist + 1] cell offsets), each a list with one tensor per shard on
    its device, plus 'rows', 'nlist', 'ng'.
    """
    devices = mesh.shard_devices()
    n_shards = len(devices)
    g = np.asarray(g)
    assign = np.asarray(assign, np.int64)
    ng, d = g.shape

    # stable cell sort, then deal each cell's run round-robin
    order = np.argsort(assign, kind='stable')
    counts = np.bincount(assign, minlength=nlist)
    shard_rows = [[] for _ in range(n_shards)]
    shard_starts = np.zeros((n_shards, nlist + 1), np.int64)
    pos = 0
    for c in range(nlist):
        run = order[pos:pos + counts[c]]
        pos += counts[c]
        for s in range(n_shards):
            shard_rows[s].append(run[s::n_shards])
        shard_starts[:, c + 1] = shard_starts[:, c] + np.array(
            [len(shard_rows[s][-1]) for s in range(n_shards)], np.int64)
    rows = int(shard_starts[:, -1].max())
    out = {'g': [], 'scale': None if g_scale is None else [], 'perm': [],
           'starts': [], 'rows': rows, 'nlist': int(nlist), 'ng': ng}
    for s, dev in enumerate(devices):
        ids = (np.concatenate(shard_rows[s]) if shard_rows[s]
               else np.zeros((0,), np.int64))
        perm = np.full((rows,), -1, np.int64)
        perm[:len(ids)] = ids
        gs = np.zeros((rows, d), g.dtype)
        gs[:len(ids)] = g[ids]
        out['g'].append(_shard(gs, dev))
        out['perm'].append(_shard(perm, dev))
        out['starts'].append(_shard(shard_starts[s], dev))
        if g_scale is not None:
            ss = np.zeros((rows,), np.float32)
            ss[:len(ids)] = np.asarray(g_scale)[ids]
            out['scale'].append(_shard(ss, dev))
    return out


@torch.no_grad()
def sharded_ivf_topk(q, cent, placed, k=100, nprobe=8, budget=8192,
                     chunk=8192, exact=False):
    """Global (dists, ORIGINAL row ids) IVF top-k over a
    ``shard_ivf_gallery`` placement.

    Every shard probes the same ``nprobe`` globally nearest cells (its
    slice of them, the candidate budget split evenly), and the per-shard
    candidates merge exactly: the recall equals the single-device IVF's at
    the same nprobe.  Unfilled slots are +inf / -1.  ``exact=True`` scans
    every valid row of the placement instead of probing.  As
    ``sharded_topk``, it takes no mesh.
    """
    n_shards = len(placed['g'])
    rows = int(placed['rows'])
    k_local = min(int(k), rows)
    nprobe = int(min(nprobe, placed['nlist']))
    budget_local = max(k_local, -(-int(budget) // n_shards))
    parts = []
    for s, gs in enumerate(placed['g']):
        dev = gs.device
        sc = None if placed['scale'] is None else placed['scale'][s]
        qs = _f32_on(q, dev)
        starts = placed['starts'][s]
        if exact:
            # every valid row of the shard (slots past starts[-1] are
            # padding outside every cell)
            d, pos = streaming_topk(qs, gs, k=k_local,
                                    chunk=max(1, min(int(chunk), rows)),
                                    g_scale=sc, n_valid=int(starts[-1]))
        else:
            d, pos = ivf_ops.ivf_topk(
                qs, gs, _f32_on(cent, dev), starts, k=k_local,
                nprobe=nprobe, budget=budget_local, chunk=chunk, g_scale=sc)
        perm = placed['perm'][s]
        ids = torch.where(pos >= 0, perm[torch.clamp(pos, 0, rows - 1).long()],
                          -1)
        parts.append((d, ids))
    k_out = min(int(k), placed['ng'], k_local * n_shards)
    return merge_candidates(parts, k_out, placed['g'][0].device)
