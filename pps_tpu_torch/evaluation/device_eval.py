"""CMC and mAP on the device (counterpart of
``pps_tpu/evaluation/device_eval.py``).

The Market-1501 protocol (separate_camera_set=False,
single_gallery_shot=False, first_match_break=True) and the pinned
sklearn-0.18.1 trapezoidal AP, vectorised over queries: one stable sort
of the [Nq, Ng] distance matrix and a few passes over it, in place of the
numpy evaluator's per-query loops (``metrics.py``, the golden path).

Exclusion: same-id-same-cam gallery entries go to +inf, which keeps the
order of the valid entries under a stable sort and every row one [Ng]
vector.  +inf must then belong to excluded entries alone, so valid
distances are first made finite (NaN and +inf to 3e38, -inf to -3e38).

Ties: the 0.18.1 AP puts its thresholds at distinct distances, so each
tie group is collapsed to one threshold (``torch.cummin``/``cummax``
propagate each position's group end and start).  Order within a group
then cancels, which makes mAP tie-exact against the host path; CMC breaks
ties by the stable sort order, which the host path (numpy mergesort)
shares.
"""

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device

_BIG = 3.0e38


def _as(x, device, dtype=None):
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return t.to(device=device, dtype=dtype)


@torch.no_grad()
def cmc_map_device(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
                   topk=10, device=None):
    """(mAP 0-d tensor, cmc [topk] tensor) under the Market-1501 protocol.

    Inputs may be numpy arrays or tensors; they are moved to ``device``
    (default: the distance matrix's own device when it is a tensor, else
    CUDA).  The AP arithmetic runs in float64."""
    if device is None and torch.is_tensor(distmat):
        device = distmat.device
    device = resolve_device(device)
    d = _as(distmat, device, torch.float32)
    nq, ng = d.shape
    q_ids = _as(query_ids, device)[:, None]
    q_cams = _as(query_cams, device)[:, None]
    g_ids = _as(gallery_ids, device)[None, :]
    g_cams = _as(gallery_cams, device)[None, :]

    excluded = (g_ids == q_ids) & (g_cams == q_cams)
    d = torch.clamp(torch.nan_to_num(d, nan=_BIG, posinf=_BIG,
                                     neginf=-_BIG), -_BIG, _BIG)
    d = d.masked_fill(excluded, float('inf'))
    d_sorted, order = torch.sort(d, dim=1, stable=True)

    match = torch.gather(g_ids.expand(nq, ng), 1, order) == q_ids
    n_valid = torch.sum(~excluded, dim=1)
    pos = torch.arange(ng, device=device)[None, :]
    match = match & (pos < n_valid[:, None])
    match_f = match.double()
    total = torch.sum(match_f, dim=1)                  # matches per query
    valid_q = total > 0
    n_valid_q = torch.clamp(torch.sum(valid_q), min=1).double()

    # mAP: every position gathers the cumulative true positives at its tie
    # group's end (the group's precision point) and at the previous
    # group's end (the prior trapezoid vertex)
    nxt = torch.cat([d_sorted[:, 1:],
                     torch.full((nq, 1), float('inf'), device=device)], 1)
    is_end = (d_sorted != nxt) | (pos == ng - 1)
    # group end: backward min-propagation of the end positions
    end_pos = torch.where(is_end, pos, ng)
    last = torch.flip(torch.cummin(torch.flip(end_pos, [1]), 1).values, [1])
    # group start: forward max-propagation of the start positions
    is_start = torch.cat([torch.ones((nq, 1), dtype=torch.bool,
                                     device=device), is_end[:, :-1]], 1)
    first = torch.cummax(torch.where(is_start, pos, 0), 1).values

    tps = torch.cumsum(match_f, dim=1)
    p_end = torch.gather(tps, 1, last) / (last + 1.0)
    t_prev = torch.gather(tps, 1, torch.clamp(first - 1, min=0))
    p_prev = torch.where(first == 0, 1.0,
                         t_prev / torch.clamp(first, min=1))
    ap = torch.sum(match_f * (p_end + p_prev), dim=1) / (
        2.0 * torch.clamp(total, min=1.0))
    m_ap = torch.sum(torch.where(valid_q, ap, 0.0)) / n_valid_q

    # CMC (first_match_break): the rank of the first valid match
    first_rank = torch.argmax(match.to(torch.uint8), dim=1)  # 0: no match
    ks = torch.arange(topk, device=device)[None, :]
    hits = (first_rank[:, None] <= ks) & valid_q[:, None]
    cmc = torch.sum(hits.double(), dim=0) / n_valid_q
    return m_ap, cmc


def evaluate_on_device(feat, ids, cams, marks, distmat_fn=None, topk=10,
                       device=None):
    """Single-query mAP/CMC on the device: distance matrix and metrics.

    feat/ids/cams/marks as in ``evaluator.evaluate``.  Returns
    {'mAP': float, 'cmc': np.ndarray [topk]}."""
    from pps_tpu_torch.ops.distance import euclidean_distmat
    device = resolve_device(device)
    feat = _as(feat, device, torch.float32)
    marks = np.asarray(marks)
    q = torch.as_tensor(marks == 0, device=device)
    g = torch.as_tensor(marks == 1, device=device)
    ids = np.asarray(ids)
    cams = np.asarray(cams)
    dist_fn = distmat_fn or euclidean_distmat
    dm = dist_fn(feat[q], feat[g])
    m_ap, cmc = cmc_map_device(dm, ids[marks == 0], ids[marks == 1],
                               cams[marks == 0], cams[marks == 1],
                               topk=topk, device=device)
    return {'mAP': float(m_ap), 'cmc': cmc.cpu().numpy()}
