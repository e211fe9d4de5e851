"""IVF (inverted-file) retrieval: scan the nearest cells of a clustered
gallery instead of all of it (counterpart of ``pps_tpu/ops/ivf.py``).

* ``kmeans``          - Lloyd iterations over a seeded sample, the
                        assignment a product with the centroids and the
                        accumulation a product with the one-hot matrix;
                        the same ``np.random.RandomState`` draws as the
                        JAX package, so both start from the same rows.
* ``assign_clusters`` - nearest-centroid id of every row (the first on
                        ties, as ``argmin`` gives).
* ``build_ivf``       - host sort by cell: (perm, starts).
* ``probe_totals``    - candidate rows per query at an ``nprobe``.
* ``ivf_topk``        - probe the ``nprobe`` nearest cells, enumerate
                        their rows into a ``budget`` of candidate slots
                        (a searchsorted over the per-query prefix sums of
                        the probed cells' sizes), gather them and take an
                        exact top-k of their distances.

Distances of gathered rows use the dequantize and expand-form math of
``topk.streaming_topk``, so a row inside the probed cells ranks as in
the exact scan; the approximation is the cell selection (and the budget
truncation, see ``probe_totals``).  Ties among candidates go to the
earlier slot (probe order, then row order in the cell), as ``lax.top_k``
over the JAX package's slot-ordered candidates gives.
"""

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.ops.topk import key_dist2, sq_keys

# float32 elements of the gathered [queries, chunk, d] rows per step
_GATHER_ELEMS = 1 << 28


def _dequant_f32(rows, scale):
    """int8 rows + per-row scale -> float32 (None scale = already float)."""
    if scale is None:
        return rows.float()
    return rows.float() * scale.float()[..., None]


def _tensor(x, device, dtype=None):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if not a.flags.writeable:  # torch refuses to wrap read-only memory
        a = a.copy()
    return torch.as_tensor(a, device=device, dtype=dtype)


def _where(x, device):
    """The device of a tensor ``x``, else ``device`` (default CUDA)."""
    if torch.is_tensor(x) and device is None:
        return x.device
    return resolve_device(device)


@torch.no_grad()
def _lloyd_iter(g, s, cent, chunk):
    """One Lloyd iteration.  Returns (new centroids, counts); an empty
    cell keeps its centroid."""
    nlist = cent.shape[0]
    cn = torch.sum(cent * cent, dim=1)
    sums = torch.zeros_like(cent)
    counts = torch.zeros(nlist, dtype=torch.float32, device=cent.device)
    for a in range(0, g.shape[0], chunk):
        x = _dequant_f32(g[a:a + chunk], None if s is None else s[a:a + chunk])
        # argmin_c ||x - c||^2 == argmin_c (||c||^2 - 2 x.c)
        scores = cn[None, :] - 2.0 * (x @ cent.T)
        onehot = torch.nn.functional.one_hot(
            torch.argmin(scores, dim=1), nlist).float()
        sums += onehot.T @ x
        counts += torch.sum(onehot, dim=0)
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts, min=1.0)[:, None], cent)
    return new, counts


def kmeans(g, nlist, iters=10, seed=0, g_scale=None, sample=262144,
           chunk=65536, device=None):
    """K-means centroids of a gallery, [nlist', d] float32 on the device
    (nlist' = min(nlist, rows used)).

    g: [N, d] float or int8 (with ``g_scale``), numpy or a tensor.
    sample: cap on the rows used for training (None = all), drawn with
    ``np.random.RandomState(seed)`` as in the JAX package, which then
    draws the initial centroid rows from the same generator.
    """
    device = _where(g, device)
    ng = g.shape[0]
    rng = np.random.RandomState(seed)
    if sample is not None and ng > sample:
        take = np.sort(rng.choice(ng, size=sample, replace=False))
        ti = torch.as_tensor(take, device=g.device) if torch.is_tensor(g) \
            else take
        gs = _tensor(g[ti], device)
        ss = None if g_scale is None else _tensor(g_scale[ti], device)
    else:
        gs = _tensor(g, device)
        ss = None if g_scale is None else _tensor(g_scale, device)
    nlist = int(min(nlist, gs.shape[0]))
    init_rows = torch.as_tensor(
        rng.choice(gs.shape[0], size=nlist, replace=False), device=device)
    cent = _dequant_f32(gs[init_rows], None if ss is None else ss[init_rows])
    chunk = min(chunk, gs.shape[0])
    for _ in range(int(iters)):
        cent, _ = _lloyd_iter(gs, ss, cent, chunk)
    return cent


@torch.no_grad()
def assign_clusters(g, cent, g_scale=None, chunk=65536, device=None):
    """Nearest-centroid id per gallery row -> [N] int32 (numpy).  Runs on
    the centroids' device (a numpy gallery is moved there a chunk at a
    time)."""
    device = _where(cent, device)
    cent = _tensor(cent, device, torch.float32)
    cn = torch.sum(cent * cent, dim=1)
    out = []
    for a in range(0, g.shape[0], chunk):
        x = _dequant_f32(
            _tensor(g[a:a + chunk], device),
            None if g_scale is None else _tensor(g_scale[a:a + chunk],
                                                 device))
        scores = cn[None, :] - 2.0 * (x @ cent.T)
        out.append(torch.argmin(scores, dim=1).to(torch.int32))
    if not out:
        return np.zeros((0,), np.int32)
    return torch.cat(out).cpu().numpy()


def build_ivf(assign, nlist):
    """Host-side inverted file from per-row cell ids.

    Returns (perm [N] int32, starts [nlist+1] int32): ``perm`` lists
    original row ids sorted by cell (stable), ``starts[c]:starts[c+1]``
    is cell c's slice of the sorted layout.
    """
    assign = np.asarray(assign, np.int64)
    perm = np.argsort(assign, kind='stable').astype(np.int32)
    counts = np.bincount(assign, minlength=nlist)
    starts = np.zeros(nlist + 1, np.int32)
    np.cumsum(counts, out=starts[1:])
    return perm, starts


def _probe(q, cent, starts, nprobe):
    """(probed cells [nq, nprobe], their starts, their sizes), the
    nearest cell first."""
    cn = torch.sum(cent * cent, dim=1)
    cd = cn[None, :] - 2.0 * (q @ cent.T)
    # a stable sort: the lowest cell id first among equals (lax.top_k)
    sel = torch.sort(cd, dim=1, stable=True).indices[:, :nprobe]
    sel_start = starts[sel]
    return sel, sel_start, starts[sel + 1] - sel_start


@torch.no_grad()
def probe_totals(q, cent, starts, nprobe, device=None):
    """Host diagnostic: candidate-row count per query at this nprobe
    (compare against the search budget to size truncation)."""
    device = _where(cent, device)
    cent = _tensor(cent, device, torch.float32)
    q = _tensor(q, device, torch.float32)
    starts = _tensor(starts, device, torch.int64)
    _, _, sizes = _probe(q, cent, starts, min(int(nprobe), cent.shape[0]))
    return torch.sum(sizes, dim=1).cpu().numpy()


@torch.no_grad()
def ivf_topk(q, g, cent, starts, k, nprobe, budget, chunk=8192,
             g_scale=None):
    """Top-k nearest gallery rows per query through the IVF index.

    q: [Nq, d] queries.  g / g_scale: the CELL-SORTED gallery (rows
    permuted by ``build_ivf``'s perm; int8 + scales or float), tensors on
    one device.  cent: [nlist, d] centroids.  starts: [nlist+1] cell
    offsets.  budget: cap on candidate rows per query; candidates beyond
    it are dropped from the LAST probed cells.  The gathered rows of one
    step are [queries, chunk, d] float32; queries go through in blocks
    that keep that near 1 GB.

    Returns (dists [Nq, k'], positions [Nq, k'] int32), k' = min(k,
    budget), ascending; positions index the SORTED layout (map through
    perm for original ids); slots with no candidate have distance +inf
    and position -1.
    """
    device = g.device
    q = _tensor(q, device, torch.float32)
    cent = _tensor(cent, device, torch.float32)
    starts = _tensor(starts, device, torch.int64)
    nq, d = q.shape
    nlist = cent.shape[0]
    nprobe = min(int(nprobe), nlist)
    budget = int(budget)
    chunk = int(min(chunk, budget))
    n_steps = -(-budget // chunk)
    k = int(min(k, budget))
    block = max(1, _GATHER_ELEMS // (chunk * d))
    out_d, out_i = [], []
    for b in range(0, nq, block):
        qb = q[b:b + block]
        sel, sel_start, sizes = _probe(qb, cent, starts, nprobe)
        prefix = torch.cumsum(sizes, dim=1)                  # [nb, nprobe]
        total = prefix[:, -1:]
        qn = torch.sum(qb * qb, dim=1, keepdim=True)
        best, best_pos = None, None
        for step in range(n_steps):
            t = step * chunk + torch.arange(chunk, device=device)
            tt = t[None, :].expand(qb.shape[0], chunk).contiguous()
            # the probed cell of slot t: the count of prefix sums <= t
            j = torch.searchsorted(prefix, tt, right=True)
            j = torch.clamp(j, max=nprobe - 1)
            prev = torch.where(
                j > 0, torch.gather(prefix, 1, torch.clamp(j - 1, min=0)),
                torch.zeros_like(j))
            pos = torch.gather(sel_start, 1, j) + (tt - prev)
            valid = tt < total
            pos = torch.where(valid, pos, torch.zeros_like(pos))
            rows = _dequant_f32(g[pos],
                                None if g_scale is None else g_scale[pos])
            rn = torch.sum(rows * rows, dim=2)                # [nb, chunk]
            dots = torch.bmm(rows, qb[:, :, None])[:, :, 0]
            d2 = qn + rn - 2.0 * dots
            d2 = torch.where(valid, d2, torch.inf)
            keys = sq_keys(d2, tt)   # slot numbers break ties, as in JAX
            cat_pos = pos if best is None else torch.cat([best_pos, pos], 1)
            cat = keys if best is None else torch.cat([best, keys], 1)
            top = torch.topk(cat, min(k, cat.shape[1]), dim=1,
                             largest=False, sorted=True)
            best = top.values
            best_pos = torch.gather(cat_pos, 1, top.indices)
        d2 = key_dist2(best)
        out_d.append(torch.sqrt(d2))
        out_i.append(torch.where(torch.isinf(d2), -1,
                                 best_pos.to(torch.int32)))
    return torch.cat(out_d), torch.cat(out_i)


def default_nlist(ng):
    """FAISS-style heuristic: ~4*sqrt(N) cells, clamped to sane bounds."""
    return int(max(16, min(ng // 8, 4 * np.sqrt(max(ng, 1)))))
