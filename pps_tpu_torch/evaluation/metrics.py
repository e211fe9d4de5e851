"""Re-ID retrieval metrics, CMC and mAP, in numpy (a copy of
``pps_tpu/evaluation/metrics.py``; the tests hold the two equal).

Numerics contract (the reference evaluator, reid_dataset_evaluator.py):

* mAP uses the pinned sklearn-0.18.1 ``average_precision_score``
  semantics: the trapezoidal area under the precision-recall curve with
  thresholds at distinct scores and an appended (recall=0, precision=1)
  point, the definition of the Zhong/Zheng Matlab evaluation.
* CMC supports separate_camera_set / single_gallery_shot /
  first_match_break; the Market-1501 protocol is (False, False, True).
* Same-id-same-camera gallery entries are excluded per query.

This is the golden path the card's ``device_eval.cmc_map_device`` is held
to.
"""

import numpy as np
from collections import defaultdict


def average_precision_v0_18(y_true, y_score):
    """sklearn 0.18.1 ``average_precision_score`` for binary labels.

    trapezoidal integral of precision over recall, with thresholds at
    distinct score values (stable descending sort) and the curve closed
    with the (recall=0, precision=1) endpoint.
    """
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    order = np.argsort(y_score, kind='mergesort')[::-1]
    y_true = y_true[order].astype(np.float64)
    y_score = y_score[order]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    last_ind = int(tps.searchsorted(tps[-1]))
    sl = slice(last_ind, None, -1)
    precision = np.r_[precision[sl], 1]
    recall = np.r_[recall[sl], 0]
    # recall is decreasing -> negative trapezoid
    return -float(np.trapezoid(precision, recall))


def _valid_mask(indices_row, q_id, q_cam, gallery_ids, gallery_cams,
                separate_camera_set):
    valid = ((gallery_ids[indices_row] != q_id) |
             (gallery_cams[indices_row] != q_cam))
    if separate_camera_set:
        valid &= gallery_cams[indices_row] != q_cam
    return valid


def mean_ap(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
            average=True):
    """mAP over valid queries (reference reid_dataset_evaluator.py:366-439)."""
    distmat = np.asarray(distmat)
    m = distmat.shape[0]
    # stable sort: with distinct distances identical to the reference's
    # default argsort; under exact ties (possible for re-ranked/jaccard
    # distances) the reference order is quicksort-arbitrary — stable
    # order is the deterministic choice the device path also uses, and
    # the 0.18.1 AP below is tie-grouped so AP is order-independent
    # within a tie anyway.
    indices = np.argsort(distmat, axis=1, kind='mergesort')
    matches = gallery_ids[indices] == query_ids[:, np.newaxis]
    aps = np.zeros(m)
    is_valid_query = np.zeros(m)
    for i in range(m):
        valid = _valid_mask(indices[i], query_ids[i], query_cams[i],
                            gallery_ids, gallery_cams, False)
        y_true = matches[i, valid]
        if not np.any(y_true):
            continue
        y_score = -distmat[i][indices[i]][valid]
        is_valid_query[i] = 1
        aps[i] = average_precision_v0_18(y_true, y_score)
    if average:
        n_valid = np.sum(is_valid_query)
        if n_valid == 0:
            raise RuntimeError('No valid query')
        return float(np.sum(aps)) / n_valid
    return aps, is_valid_query


def _rank_credit(match_flags, topk, first_match_break, scale=1.0):
    """CMC histogram increments for ONE ranked list of valid entries.

    ``match_flags[r]`` says whether the entry at rank ``r`` matches the
    query.  The j-th match is credited at bin ``r - j``: matches ranked
    above it are not competitors, so each match's effective rank counts
    only the non-matching entries before it (the reference evaluator's
    ``k - j`` bookkeeping, reid_dataset_evaluator.py:340-352).

    ``first_match_break`` credits 1.0 to the first match's bin only —
    deliberately unscaled, preserving the reference's behavior where
    the break path ignores the per-draw weight.  Otherwise every match
    whose bin fits in ``topk`` gets ``scale / n_matches``.
    """
    credit = np.zeros(topk)
    ranks = np.flatnonzero(match_flags)
    if ranks.size == 0:
        return credit
    bins = ranks - np.arange(ranks.size)
    if first_match_break:
        if bins[0] < topk:
            credit[bins[0]] = 1.0
        return credit
    # bins can collide (adjacent matches share an effective rank), so
    # accumulate rather than assign
    np.add.at(credit, bins[bins < topk], scale / ranks.size)
    return credit


def _sample_one_per_id(ids):
    """Rank positions keeping one random instance per identity.

    Group order is first appearance in the ranked list and each group
    draws once from numpy's global RNG — the same call sequence as the
    reference's single-gallery-shot sampler, so seeded runs reproduce
    its draws exactly (reid_dataset_evaluator.py:327-339).
    """
    groups = defaultdict(list)
    for rank, gid in enumerate(ids):
        groups[gid].append(rank)
    picked = [np.random.choice(ranks) for ranks in groups.values()]
    return np.sort(np.asarray(picked))


def cmc(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
        topk=100, separate_camera_set=False, single_gallery_shot=False,
        first_match_break=False, average=True):
    """Cumulative matching characteristics.

    Protocol switches as in the reference evaluator
    (reid_dataset_evaluator.py:283-363): Market-1501/Duke use
    ``(separate_camera_set=False, single_gallery_shot=False,
    first_match_break=True)``; the classic CUHK03 protocol keeps one
    random gallery instance per identity and averages 100 draws.
    Stable argsort (see mean_ap): deterministic tie order shared with
    the device path, identical to the reference for distinct distances.
    """
    distmat = np.asarray(distmat)
    n_query = distmat.shape[0]
    order = np.argsort(distmat, axis=1, kind='mergesort')
    hits = np.zeros([n_query, topk])
    is_valid_query = np.zeros(n_query)
    for i in range(n_query):
        keep = _valid_mask(order[i], query_ids[i], query_cams[i],
                           gallery_ids, gallery_cams, separate_camera_set)
        ranked_ids = gallery_ids[order[i]][keep]
        flags = ranked_ids == query_ids[i]
        if not flags.any():
            continue
        is_valid_query[i] = 1
        if single_gallery_shot:
            draws = 100
            for _ in range(draws):
                chosen = _sample_one_per_id(ranked_ids)
                hits[i] += _rank_credit(flags[chosen], topk,
                                        first_match_break, scale=1.0 / draws)
        else:
            hits[i] = _rank_credit(flags, topk, first_match_break)
    n_valid = is_valid_query.sum()
    if n_valid == 0:
        raise RuntimeError('No valid query')
    curve = hits.cumsum(axis=1)
    if average:
        return np.sum(curve, axis=0) / n_valid
    return curve, is_valid_query


def compute_dist(array1, array2, dist_type='euclidean'):
    """All-pairs distance in numpy (the golden path; the card's is
    ``ops/distance.euclidean_distmat``).  The reference's clamping."""
    if dist_type not in ('cosine', 'euclidean'):
        raise ValueError(dist_type)
    if dist_type == 'cosine':
        a1 = array1 / np.maximum(
            np.linalg.norm(array1, axis=1, keepdims=True), 1e-12)
        a2 = array2 / np.maximum(
            np.linalg.norm(array2, axis=1, keepdims=True), 1e-12)
        return np.matmul(a1, a2.T)
    sq1 = np.sum(np.square(array1), axis=1)[:, np.newaxis]
    sq2 = np.sum(np.square(array2), axis=1)[np.newaxis, :]
    squared = -2 * np.matmul(array1, array2.T) + sq1 + sq2
    np.maximum(squared, 0, out=squared)
    return np.sqrt(squared)
