"""Top-k retrieval over a resident gallery (counterpart of
``pps_tpu/ops/topk.py``: ``quantize_gallery``, ``gallery_norms``,
``flat_topk`` and ``streaming_topk``).

Contract, as in the JAX package: Euclidean distances ascending, ties
broken by the lowest global index, ``-1`` / ``inf`` in slots that saw no
valid row, ``n_valid`` masks row padding and ``index_offset`` shifts the
returned indices.

Selection.  ``torch.topk`` promises no order among equal values, and which
of several equal values it keeps at the k-th place is not defined either.
So the selection runs on a key that has no ties: a squared distance is
non-negative, and the bits of a non-negative float32 read as an int32
order the same way as the floats, so ``(bits << 32) | index`` as int64
orders by distance and then by index.  ``topk`` over those keys is exact
and gives the JAX package's lowest-index-first order; the distance and
the index come back out of the key.  Reading the bits also clamps: a
negative value (rounding in ``|q|^2 + |g|^2 - 2 q.g``, or -0.0) has the
sign bit set, and clamping the int32 at 0 turns it into +0.0.
"""

import numpy as np
import torch

# gallery rows per product in flat_topk: an int8 gallery is dequantized
# one block at a time (65536 x 3968 float32 = 1 GB), never whole
FLAT_BLOCK = 65536


def quantize_gallery(g):
    """Per-row symmetric int8 quantization of a gallery matrix.

    Returns numpy (g8 int8 [Ng, d], scale float32 [Ng]); the same bytes as
    the JAX package's ``quantize_gallery``.  A tensor input is quantized
    where it lies and gives tensors: the same float32 operations (true
    divisions, round half to even, a clip), so the same bytes."""
    if torch.is_tensor(g):
        g = g.float()
        # a tensor divisor: CUDA divides by a Python scalar as a product
        # with its float32 reciprocal, an ulp off numpy's quotient
        amax = g.abs().amax(dim=1)
        scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
        g8 = torch.clamp(torch.round(g / scale[:, None]), -127, 127)
        return g8.to(torch.int8), scale
    g = np.asarray(g, np.float32)
    scale = np.maximum(np.max(np.abs(g), axis=1) / 127.0, 1e-12)
    g8 = np.clip(np.round(g / scale[:, None]), -127, 127).astype(np.int8)
    return g8, scale.astype(np.float32)


def gallery_norms(g, g_scale=None):
    """Squared L2 norms of the (dequantized) gallery rows, [Ng] float32,
    computed one block of rows at a time."""
    out = []
    for a in range(0, g.shape[0], FLAT_BLOCK):
        rows = _dequant(g[a:a + FLAT_BLOCK],
                        None if g_scale is None else g_scale[a:a + FLAT_BLOCK])
        out.append(torch.sum(rows * rows, dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=g.device)
    return torch.cat(out)


def _dequant(rows, scale):
    if scale is None:
        return rows.float()
    return rows.float() * scale.float()[:, None]


def sq_keys(d2, idx):
    """int64 keys ordering (d2, idx) lexicographically; ``d2`` float32
    [.., m] squared distances (negative values clamp to +0.0), ``idx``
    non-negative int64 broadcastable to ``d2``."""
    bits = d2.contiguous().view(torch.int32).clamp(min=0).to(torch.int64)
    return (bits << 32) | idx


def key_dist2(keys):
    """The squared distances of ``sq_keys`` keys, float32."""
    return (keys >> 32).to(torch.int32).view(torch.float32)


def key_index(keys):
    """The indices of ``sq_keys`` keys, int64."""
    return keys & 0xFFFFFFFF


def merge_keys(best, new, k):
    """The ``k`` smallest of two key sets, ascending."""
    cat = new if best is None else torch.cat([best, new], dim=1)
    return torch.topk(cat, min(k, cat.shape[1]), dim=1, largest=False,
                      sorted=True).values


def _finish(keys, index_offset):
    """(dists, indices int32) from the selected keys: sqrt of the squared
    distance, -1 where it is inf, ``index_offset`` added elsewhere."""
    d2 = key_dist2(keys)
    out_i = key_index(keys).to(torch.int32)
    out_i = torch.where(torch.isinf(d2), -1, out_i)
    if index_offset is not None:
        out_i = torch.where(out_i >= 0, out_i + int(index_offset), out_i)
    return torch.sqrt(d2), out_i


def _masked(d2, base, n_valid):
    """``d2`` of gallery rows base.. with rows >= n_valid at +inf."""
    if n_valid is None or base + d2.shape[1] <= n_valid:
        return d2
    col = base + torch.arange(d2.shape[1], device=d2.device)
    return torch.where(col[None, :] < n_valid, d2, torch.inf)


@torch.no_grad()
def _scan(q, g, k, block, g_scale=None, g_norm=None, n_valid=None,
          index_offset=None, split=False):
    """The exact scan of both routes: ``block`` gallery rows per product,
    each block's (distance, index) keys merged into the running top-k, so
    memory is O(Nq * (block + k)) and no [Nq, Ng] matrix is made.  An int8
    block (``g_scale`` given) is dequantized, or with ``split`` multiplied
    as it is against the query's bf16 hi/lo split (see ``flat_topk``).
    ``g_norm``: the gallery's squared norms, else each block's own."""
    if g_scale is not None and g.dtype != torch.int8:
        raise TypeError(
            'g_scale is for int8 galleries; got {}'.format(g.dtype))
    nq = q.shape[0]
    ng = g.shape[0]
    k = min(k, ng)
    q = q.float()
    qn = torch.sum(q * q, dim=1, keepdim=True)
    split = split and g_scale is not None
    if split:
        qhi = q.to(torch.bfloat16)
        qlo = (q - qhi.float()).to(torch.bfloat16)
        qq = torch.cat([qhi, qlo], dim=0).float()          # [2nq, d]
    best = None
    for a in range(0, ng, block):
        gb = g[a:a + block]
        sb = None if g_scale is None else g_scale[a:a + block]
        if split:
            ss = qq @ gb.float().T                         # [2nq, B]
            scores = (ss[:nq] + ss[nq:]) * sb.float()[None, :]
        else:
            gi = _dequant(gb, sb)
            scores = q @ gi.T
        if g_norm is not None:
            gn = g_norm[a:a + block]
        elif split:
            gn = gallery_norms(gb, sb)
        else:
            gn = torch.sum(gi * gi, dim=1)
        d2 = _masked(qn + gn[None, :] - 2.0 * scores, a, n_valid)
        idx = a + torch.arange(gb.shape[0], device=q.device)
        best = merge_keys(best, sq_keys(d2, idx[None, :]), k)
    return _finish(best, index_offset)


def flat_topk(q, g, k=100, g_scale=None, g_norm=None, n_valid=None,
              index_offset=None):
    """Exact top-k of ``q`` [Nq, d] against the whole resident gallery
    ``g`` [Ng, d].  Returns (dists [Nq, k'], indices [Nq, k'] int32) with
    k' = min(k, Ng).

    int8 galleries (``g_scale`` given): the per-row scale commutes out of
    the product, q . (g8 * s) = (q . g8) * s, and the query is split into
    bfloat16 hi and lo parts (q = hi + lo) that go through the product as
    two rows, the JAX package's formulation.  A bf16 x int8 product is
    exact in float32, so a float32 product of the split sums the same
    terms in float32 as a bf16 product with float32 accumulation does.

    The product runs over blocks of ``FLAT_BLOCK`` gallery rows, so an int8
    gallery is never converted whole.  Against ``streaming_topk``: few
    large blocks, so few launches for a few queries, but the split doubles
    the product's work, which tells at many queries.
    """
    return _scan(q, g, k, FLAT_BLOCK, g_scale=g_scale, g_norm=g_norm,
                 n_valid=n_valid, index_offset=index_offset, split=True)


def streaming_topk(q, g, k=100, chunk=4096, recall_target=None,
                   g_scale=None, n_valid=None, index_offset=None):
    """Returns (dists [Nq, k'], indices [Nq, k'] int32), k' = min(k, Ng),
    of the nearest gallery rows per query (Euclidean, ascending), scanning
    the gallery ``chunk`` rows at a time.

    Each chunk's squared distances come from one product, and a running
    top-k of keys is merged with the chunk's; memory is O(Nq * (chunk +
    k)) and no [Nq, Ng] matrix is made.  An int8 gallery (``g_scale``
    given) is dequantized one chunk at a time, so the math is that of the
    float path on the dequantized gallery.  ``k >= chunk`` needs nothing
    else: the merge keeps k of (k + chunk) candidates whatever their
    sizes.

    ``recall_target``: kept for the JAX package's signature.  There it
    routes the per-chunk selection through ``lax.approx_min_k``, which is
    approximate on a TPU only and exact elsewhere; this selection is exact
    on every device, so the result equals the exact scan.

    ``n_valid`` / ``index_offset``: only the first ``n_valid`` rows of
    ``g`` are real (the rest score +inf), and returned indices are shifted
    by ``index_offset``.  A slot that saw no valid row gets -1 / inf.
    """
    if recall_target is not None and not 0.0 < float(recall_target) <= 1.0:
        raise ValueError('recall_target must be in (0, 1]: {}'.format(
            recall_target))
    return _scan(q, g, k, max(1, int(chunk)), g_scale=g_scale,
                 n_valid=n_valid, index_offset=index_offset)
