"""Exact top-k retrieval over a resident gallery (counterpart of
``pps_tpu/ops/topk.py``: ``quantize_gallery``, ``gallery_norms``,
``flat_topk``).

Contract, as in the JAX package: Euclidean distances ascending, ties
broken by the lowest global index, ``-1`` / ``inf`` in slots that saw no
valid row, ``n_valid`` masks row padding and ``index_offset`` shifts the
returned indices.  ``torch.topk`` promises no order among ties, so the
selection is a stable sort of each distance row, which gives the lowest
index first by construction.

``streaming_topk`` (the chunked scan for galleries past the flat route's
memory gate) waits for ROADMAP slice 5.
"""

import numpy as np
import torch


def quantize_gallery(g):
    """Per-row symmetric int8 quantization of a gallery matrix.

    Returns numpy (g8 int8 [Ng, d], scale float32 [Ng]); the same bytes as
    the JAX package's ``quantize_gallery``."""
    g = np.asarray(g, np.float32)
    scale = np.maximum(np.max(np.abs(g), axis=1) / 127.0, 1e-12)
    g8 = np.clip(np.round(g / scale[:, None]), -127, 127).astype(np.int8)
    return g8, scale.astype(np.float32)


def gallery_norms(g, g_scale=None):
    """Squared L2 norms of the (dequantized) gallery rows, [Ng] float32."""
    rows = g.float()
    if g_scale is not None:
        rows = rows * g_scale.float()[:, None]
    return torch.sum(rows * rows, dim=1)


def flat_topk(q, g, k=100, g_scale=None, g_norm=None, n_valid=None,
              index_offset=None):
    """Exact top-k of ``q`` [Nq, d] against the whole gallery ``g`` [Ng, d]
    in one product.  Returns (dists [Nq, k'], indices [Nq, k'] int32) with
    k' = min(k, Ng).

    int8 galleries (``g_scale`` given): the per-row scale commutes out of
    the product, q . (g8 * s) = (q . g8) * s, and the query is split into
    bfloat16 hi and lo parts (q = hi + lo) that go through the product as
    two rows, the JAX package's formulation.  A bf16 x int8 product is
    exact in float32, so a float32 product of the split sums the same
    terms in float32 as a bf16 product with float32 accumulation does.
    """
    nq = q.shape[0]
    ng = g.shape[0]
    k = min(k, ng)
    q = q.float()
    qn = torch.sum(q * q, dim=1, keepdim=True)
    if g_scale is not None:
        if g.dtype != torch.int8:
            raise TypeError(
                'g_scale is for int8 galleries; got {}'.format(g.dtype))
        qhi = q.to(torch.bfloat16)
        qlo = (q - qhi.float()).to(torch.bfloat16)
        qq = torch.cat([qhi, qlo], dim=0).float()          # [2nq, d]
        ss = qq @ g.float().T                              # [2nq, Ng]
        scores = (ss[:nq] + ss[nq:]) * g_scale.float()[None, :]
    else:
        scores = q @ g.float().T
    if g_norm is None:
        g_norm = gallery_norms(g, g_scale)
    d2 = torch.clamp(qn + g_norm[None, :] - 2.0 * scores, min=0.0)
    if n_valid is not None:
        col = torch.arange(ng, device=d2.device)
        d2 = torch.where(col[None, :] < n_valid, d2, torch.inf)
    sd, si = torch.sort(d2, dim=1, stable=True)
    out_d = torch.sqrt(sd[:, :k])
    out_i = si[:, :k].to(torch.int32)
    out_i = torch.where(torch.isinf(out_d), -1, out_i)
    if index_offset is not None:
        out_i = torch.where(out_i >= 0, out_i + index_offset, out_i)
    return out_d, out_i
