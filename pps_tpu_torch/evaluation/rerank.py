"""k-reciprocal re-ranking (Zhong et al., CVPR 2017), counterpart of
``pps_tpu/evaluation/rerank.py``.

1. squared distances, column-max normalized, transposed
2. k-reciprocal neighbor sets R(i, k1) with the 2/3-overlap expansion
3. gaussian-weighted sparse membership vectors V, L1-normalized
4. local query expansion: V <- mean of V over the k2 nearest neighbors
5. jaccard distance from the inverted index; blend with original dist

Default hyperparameters k1=20, k2=6, lambda=0.3.

``re_ranking`` is the numpy golden implementation, a copy of the JAX
package's.  ``rerank_distmat_device`` is the formulation for the card
(the counterpart of ``rerank_distmat_jax``): the k-reciprocal sets stay
sparse, as padded [N, k1+1] index lists from a top-k, reciprocity is one
gather and a compare, and only the membership matrix V is dense, built a
block of rows at a time by scatter.  The stages free what they no longer
need, so at most ~3 [N, N] float32 buffers are live.
"""

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.ops.topk import key_index, sq_keys

# rows per block of the [N, N]-sized stages
_ROWS = 1024


def _k_reciprocal_neighbors(initial_rank, i, k):
    forward = initial_rank[i, :k + 1]
    backward = initial_rank[forward, :k + 1]
    rows = np.where(backward == i)[0]
    return forward[rows]


def re_ranking(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6, lambda_value=0.3):
    """Numpy golden implementation; returns the re-ranked [Nq, Ng] distmat."""
    query_num = q_g_dist.shape[0]
    all_num = query_num + q_g_dist.shape[1]

    original_dist = np.concatenate([
        np.concatenate([q_q_dist, q_g_dist], axis=1),
        np.concatenate([q_g_dist.T, g_g_dist], axis=1),
    ], axis=0)
    original_dist = np.power(original_dist, 2).astype(np.float32)
    original_dist = np.transpose(
        original_dist / np.max(original_dist, axis=0))
    initial_rank = np.argsort(original_dist).astype(np.int32)

    V = np.zeros_like(original_dist, dtype=np.float32)
    half_k1 = int(np.around(k1 / 2.0))
    for i in range(all_num):
        base = _k_reciprocal_neighbors(initial_rank, i, k1)
        expansion = base
        for candidate in base:
            cand_set = _k_reciprocal_neighbors(initial_rank, candidate,
                                               half_k1)
            if len(np.intersect1d(cand_set, base)) > (2.0 / 3) * len(
                    cand_set):
                expansion = np.append(expansion, cand_set)
        expansion = np.unique(expansion)
        weight = np.exp(-original_dist[i, expansion])
        V[i, expansion] = weight / np.sum(weight)

    original_dist = original_dist[:query_num]
    if k2 != 1:
        V = np.mean(V[initial_rank[:, :k2], :], axis=1)

    inv_index = [np.where(V[:, g] != 0)[0] for g in range(all_num)]

    jaccard_dist = np.zeros_like(original_dist, dtype=np.float32)
    for i in range(query_num):
        temp_min = np.zeros((all_num,), dtype=np.float32)
        nonzero = np.where(V[i, :] != 0)[0]
        for j in nonzero:
            rows = inv_index[j]
            temp_min[rows] += np.minimum(V[i, j], V[rows, j])
        jaccard_dist[i] = 1 - temp_min / (2.0 - temp_min)

    final = jaccard_dist * (1 - lambda_value) + original_dist * lambda_value
    return final[:, query_num:]


def _as(x, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _build_od(qg, qq, gg):
    """The column-max-normalized squared distances, transposed: [N, N]."""
    nq = qq.shape[0]
    n = nq + gg.shape[0]
    od = torch.empty((n, n), dtype=torch.float32, device=qg.device)
    od[:nq, :nq] = qq
    od[:nq, nq:] = qg
    od[nq:, :nq] = qg.T
    od[nq:, nq:] = gg
    od.square_()
    od.div_(torch.amax(od, dim=0))
    return od.T.contiguous()


def _neighbors(od, kmax):
    """tk [N, kmax]: each row's nearest columns, ascending, the lowest
    index first among equals (``lax.top_k`` of ``-od``).  od is
    non-negative, so the order-preserving keys of ``ops/topk`` apply."""
    n = od.shape[0]
    col = torch.arange(n, device=od.device)[None, :]
    out = []
    for a in range(0, n, _ROWS):
        keys = sq_keys(od[a:a + _ROWS], col)
        top = torch.topk(keys, kmax, dim=1, largest=False, sorted=True)
        out.append(key_index(top.values))
    return torch.cat(out)


def _reciprocal(tk, k):
    """[N, k] bool: is row i in the k-prefix of its k-prefix neighbor."""
    n = tk.shape[0]
    out = []
    for a in range(0, n, _ROWS):
        fwd = tk[a:a + _ROWS, :k]                         # [B, k]
        back = tk[fwd, :k]                                # [B, k, k]
        i = torch.arange(a, a + fwd.shape[0], device=tk.device)
        out.append(torch.any(back == i[:, None, None], dim=-1))
    return torch.cat(out)


def _build_V(od, tk, base_valid, half_valid, k1p, hp):
    """Dense membership weights V [N, N] (rows L1-normalized)."""
    n = od.shape[0]
    V = torch.empty_like(od)
    half_idx_all = tk[:, :hp]
    for a in range(0, n, _ROWS):
        base_idx = tk[a:a + _ROWS, :k1p]                  # [B, K1]
        bvalid = base_valid[a:a + _ROWS]
        b = base_idx.shape[0]
        # candidate c = base_idx[i, s]: its half-k-reciprocal set is
        # accepted when |R(c, half) & R(i, k1)| > 2/3 |R(c, half)|
        ch_idx = half_idx_all[base_idx]                   # [B, K1, H1]
        ch_val = half_valid[base_idx]                     # [B, K1, H1]
        eq = ch_idx[:, :, :, None] == base_idx[:, None, None, :]
        in_base = torch.any(eq & bvalid[:, None, None, :], dim=-1)
        overlap = torch.sum(in_base & ch_val, dim=-1)     # [B, K1]
        sz = torch.sum(ch_val, dim=-1)
        accept = bvalid & (overlap > (2.0 / 3.0) * sz)
        idx = torch.cat([base_idx, ch_idx.reshape(b, -1)], dim=1)
        val = torch.cat([bvalid, (ch_val & accept[:, :, None]).reshape(
            b, -1)], dim=1)                               # [B, S0]
        w = torch.where(val, torch.exp(-torch.gather(od[a:a + b], 1, idx)),
                        0.0)
        # invalid slots go to a dump column n; a duplicate j carries the
        # same weight exp(-od[i, j]) each time, so overwrites are harmless
        # (the dense row is the de-duplicated union)
        sidx = torch.where(val, idx, n)
        row = torch.zeros((b, n + 1), dtype=torch.float32, device=od.device)
        row.scatter_(1, sidx, w)
        row = row[:, :n]
        # an all-invalid row stays all-zero, not 0/0 = NaN
        s = torch.sum(row, dim=1, keepdim=True)
        V[a:a + b] = row * torch.where(s > 0, 1.0 / s, 0.0)
    return V


def _expand_V(V, t2):
    """Local query expansion: each row the mean of V over its k2 nearest
    rows."""
    out = torch.empty_like(V)
    step = max(1, _ROWS // 4)
    for a in range(0, V.shape[0], step):
        out[a:a + step] = torch.mean(V[t2[a:a + step]], dim=1)
    return out


def _jaccard_blend(Vq, Vt, od_q, s_q, lambda_value):
    """Blend of the Jaccard distance (over each query's <= s_q nonzero
    entries, gathered as rows of V^T) with the original distance."""
    nq = Vq.shape[0]
    out = torch.empty_like(od_q)
    step = 16
    for a in range(0, nq, step):
        vals, idxs = torch.topk(Vq[a:a + step], s_q, dim=1)   # [B, S]
        cols = Vt[idxs]                                        # [B, S, N]
        mins = torch.minimum(vals[:, :, None], cols)
        mins = torch.where((vals > 0)[:, :, None], mins, 0.0)
        temp_min = torch.sum(mins, dim=1)                      # [B, N]
        jac = 1.0 - temp_min / (2.0 - temp_min)
        out[a:a + step] = jac * (1 - lambda_value) + \
            od_q[a:a + step] * lambda_value
    return out


@torch.no_grad()
def rerank_distmat_device(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6,
                          lambda_value=0.3, device=None):
    """Re-ranking at gallery scale on ``device`` (default: the input
    tensors' device, else CUDA); the math of ``re_ranking``.  Returns the
    re-ranked [Nq, Ng] float32 tensor on the device.

    Everything data-dependent in the numpy loops becomes fixed-shape
    sparse sets: the k-reciprocal set of a row is at most k1+1 indices,
    its 2/3-overlap expansion at most (k1+1)*(half_k1+1) more, and after
    the k2 expansion a query row of V has at most S = k2*(k1+1)*(half_k1+2)
    nonzeros, so padded index lists with validity masks cover the exact
    algorithm with no truncation.  The neighbourhood sizes are clamped to
    the set size (the numpy slices clamp on tiny sets).

    Matches the numpy golden path to float tolerance; an entry can differ
    where a k-th-neighbour distance is a near-tie (set membership flips
    under a 1-ulp difference in od).  Ties themselves go to the lowest
    index, as ``lax.top_k`` gives; numpy's ``argsort`` promises no order.
    """
    if device is None and torch.is_tensor(q_g_dist):
        device = q_g_dist.device
    device = resolve_device(device)
    qg = _as(q_g_dist, device)
    qq = _as(q_q_dist, device)
    gg = _as(g_g_dist, device)
    query_num = qg.shape[0]
    n = query_num + qg.shape[1]
    k1, k2 = int(k1), int(k2)
    half = int(np.around(k1 / 2.0))
    k1p = min(k1 + 1, n)
    hp = min(half + 1, k1p)
    k2c = min(k2, n)
    kmax = max(k1p, k2c)
    s0 = k1p + k1p * hp                 # max expansion-set slots per row
    s_q = min(n, s0 * k2c)

    od = _build_od(qg, qq, gg)
    del qg, qq, gg
    tk = _neighbors(od, kmax)
    V = _build_V(od, tk, _reciprocal(tk, k1p), _reciprocal(tk, hp), k1p, hp)
    od_q = od[:query_num].clone()
    del od
    if k2 != 1:
        V = _expand_V(V, tk[:, :k2c])
    Vt = V.T.contiguous()
    Vq = V[:query_num].clone()
    del V
    final = _jaccard_blend(Vq, Vt, od_q, s_q, float(lambda_value))
    return final[:, query_num:]
