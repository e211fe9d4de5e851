"""Plain reference of the Market-1501 evaluation: Euclidean distances by the
expand formula in float32 (the published evaluator's ``compute_dist``),
CMC with the first match only (separate_camera_set False,
single_gallery_shot False), and the mean of sklearn 0.18's average
precision: the trapezoid over the precision-recall curve with a threshold
at each distinct distance, closed at recall 0 and precision 1.  Gallery
entries of the query's identity and camera are left out; equal distances
keep their gallery order.
"""

import numpy as np
import torch


def distances(q, g):
    """[Nq, Ng] float32 Euclidean distances, |q|^2 + |g|^2 - 2 q.g clamped
    at 0 under the root."""
    sq = torch.sum(q * q, dim=1, keepdim=True)
    gg = torch.sum(g * g, dim=1)
    return torch.sqrt(torch.clamp(sq + gg[None, :] - 2.0 * (q @ g.T),
                                  min=0.0))


def average_precision(d_sorted, match):
    """[Nq] sklearn-0.18 average precision of rows of ascending distances
    and their match flags (left-out entries at +inf, never matches):
    each run of equal distances is one threshold."""
    n = d_sorted.shape[1]
    pos = torch.arange(n, device=d_sorted.device)
    tps = match.double().cumsum(1)
    prec = tps / (pos + 1).double()
    # a threshold ends where the next distance differs (or the row ends)
    end = torch.ones_like(match)
    end[:, :-1] = d_sorted[:, 1:] != d_sorted[:, :-1]
    ends = torch.where(end, pos, -1)
    # the threshold before each position's own: the last end before it
    before = torch.cat([torch.full_like(ends[:, :1], -1), ends[:, :-1]], 1)
    prev = torch.cummax(before, dim=1).values
    prev_prec = torch.where(prev >= 0, torch.gather(prec, 1, prev.clamp(
        min=0)), torch.ones_like(prec))
    prev_tps = torch.where(prev >= 0, torch.gather(tps, 1, prev.clamp(
        min=0)), torch.zeros_like(tps))
    area = torch.where(end, (tps - prev_tps) * (prec + prev_prec) / 2, 0.0)
    return area.sum(1) / match.sum(1).clamp(min=1)


@torch.no_grad()
def scores(dist, q_ids, g_ids, q_cams, g_cams, topk=10, block=1024):
    """(mAP, cmc [topk]) of a [Nq, Ng] distance matrix (tensors)."""
    aps, firsts = [], []
    for s in range(0, dist.shape[0], block):
        qi, qc = q_ids[s:s + block, None], q_cams[s:s + block, None]
        left_out = (g_ids[None] == qi) & (g_cams[None] == qc)
        d = dist[s:s + block].masked_fill(left_out, float('inf'))
        d_sorted, order = torch.sort(d, dim=1, stable=True)
        match = (g_ids[order] == qi) & ~torch.gather(left_out, 1, order)
        keep = match.any(1)
        aps.append(average_precision(d_sorted, match)[keep])
        firsts.append(match.double().argmax(1)[keep])
    aps, firsts = torch.cat(aps), torch.cat(firsts)
    cmc = torch.stack([(firsts < k + 1).double().mean()
                       for k in range(topk)])
    return float(aps.mean()), cmc.cpu().numpy()


@torch.no_grad()
def market_eval(feats, ids, cams, marks, topk=10, device='cpu'):
    """(mAP, cmc [topk]) of float features [N, D] whose ``marks`` are 0
    (query) or 1 (gallery)."""
    ids, cams, marks = map(np.asarray, (ids, cams, marks))
    q, g = marks == 0, marks == 1
    feats = np.asarray(feats, np.float32)

    def t(x):
        return torch.as_tensor(x, device=device)
    dist = distances(t(feats[q]), t(feats[g]))
    return scores(dist, t(ids[q]), t(ids[g]), t(cams[q]), t(cams[g]), topk)
