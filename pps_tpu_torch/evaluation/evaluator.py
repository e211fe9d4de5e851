"""Dataset-level re-ID evaluation (counterpart of
``pps_tpu/evaluation/evaluator.py``).

The protocol and the printed lines are the reference evaluator's: the
``Single Query:  [mAP: ...]`` lines are read by downstream tooling, so
their format is an API.  The caller passes features plus per-image (id,
cam, mark) arrays, mark 0 = query, 1 = gallery, 2 = multi-query.

Re-ranked blocks (``to_re_rank``) run k-reciprocal re-ranking on the card
(``rerank.rerank_distmat_device``, scored there) when asked, else on the
host through the C++ engine (``native``).
"""

import logging
from collections import defaultdict

import numpy as np
import torch

from pps_tpu_torch.evaluation import metrics

logger = logging.getLogger(__name__)

# the Market-1501 CMC protocol, for every dataset
CMC_KWARGS = dict(separate_camera_set=False, single_gallery_shot=False,
                  first_match_break=True)


def parse_im_name(im_name, parse_type='id'):
    """Person id or camera from an image file name (chars [0:8] and
    [9:13], the Market-1501 naming)."""
    if parse_type == 'id':
        return int(im_name[:8])
    if parse_type == 'cam':
        return int(im_name[9:13])
    raise ValueError(parse_type)


def _metric_dict(m_ap, cmc_scores):
    """{'mAP', 'cmc1', 'cmc5', 'cmc10', 'cmc'}: the EXPECTED_RESULTS keys."""
    return {'mAP': float(m_ap), 'cmc1': float(cmc_scores[0]),
            'cmc5': float(cmc_scores[4]), 'cmc10': float(cmc_scores[9]),
            'cmc': np.asarray(cmc_scores)}


def _host(dist):
    """A distance matrix as numpy (it may come back as a device tensor)."""
    return dist.cpu().numpy() if torch.is_tensor(dist) else np.asarray(dist)


def print_scores(label, m_ap, cmc_scores):
    print('{:<30}'.format(label), end='')
    print('[mAP: {:5.2%}], [cmc1: {:5.2%}], [cmc5: {:5.2%}], '
          '[cmc10: {:5.2%}]'.format(m_ap, cmc_scores[0], cmc_scores[4],
                                    cmc_scores[9]))


def evaluate(feat, ids, cams, marks, to_re_rank=False, pool_type='average',
             distmat_fn=None, device_single_query=False, device=None,
             device_rerank=False):
    """mAP/CMC for the single-query and (when marks hold 2s) the pooled
    multi-query blocks, and with ``to_re_rank`` their re-ranked variants;
    prints one line for each.

    feat: [N, D] embeddings of the whole test set (numpy).
    distmat_fn: optional (q, g) -> distance matrix (numpy or a tensor);
      numpy by default.
    device_single_query: score the single-query block on ``device``
      (``device_eval.evaluate_on_device``: distance matrix and metrics on
      the card) and the multi-query block with the same scorer; the numpy
      ``metrics`` stay the golden path.
    device_rerank: re-rank on ``device`` (``rerank_distmat_device``) and
      score the result there (``cmc_map_device``); the [N, N] matrices
      never cross to the host.  Otherwise the host C++ engine re-ranks
      (``native``; it raises if it cannot be built).
    Returns {'single': {...}[, 'multi': {...}][, 'single_rerank': {...}]
    [, 'multi_rerank': {...}]}.
    """
    feat = np.asarray(feat)
    ids = np.asarray(ids)
    cams = np.asarray(cams)
    marks = np.asarray(marks)
    dist_fn = distmat_fn or (
        lambda a, b: metrics.compute_dist(a, b, 'euclidean'))

    q_inds = marks == 0
    g_inds = marks == 1
    mq_inds = marks == 2

    def compute_score(dist_mat, query_ids, gallery_ids, query_cams,
                      gallery_cams):
        m_ap = metrics.mean_ap(dist_mat, query_ids, gallery_ids, query_cams,
                               gallery_cams)
        cmc_scores = metrics.cmc(dist_mat, query_ids, gallery_ids,
                                 query_cams, gallery_cams, topk=10,
                                 **CMC_KWARGS)
        return m_ap, cmc_scores

    results = {}
    q_g_dist = None
    if device_single_query:
        from pps_tpu_torch.evaluation.device_eval import evaluate_on_device
        dev = evaluate_on_device(feat, ids, cams, marks,
                                 distmat_fn=distmat_fn, topk=10,
                                 device=device)
        m_ap, cmc_scores = dev['mAP'], dev['cmc']
    else:
        q_g_dist = _host(dist_fn(feat[q_inds], feat[g_inds]))
        m_ap, cmc_scores = compute_score(q_g_dist, ids[q_inds], ids[g_inds],
                                         cams[q_inds], cams[g_inds])
    print_scores('Single Query:', m_ap, cmc_scores)
    results['single'] = _metric_dict(m_ap, cmc_scores)

    mq_feat = None
    if np.any(mq_inds):
        mq_ids = ids[mq_inds]
        mq_cams = cams[mq_inds]
        grouped = defaultdict(list)
        for ind, (pid, cam) in enumerate(zip(mq_ids, mq_cams)):
            grouped[(pid, cam)].append(ind)
        mq_keys = list(grouped.keys())
        pool = np.mean if pool_type == 'average' else np.max
        mq_feat = np.stack([
            pool(feat[mq_inds][grouped[k]], axis=0) for k in mq_keys])
        mq_g_dist = dist_fn(mq_feat, feat[g_inds])
        k_ids = np.array([k[0] for k in mq_keys])
        k_cams = np.array([k[1] for k in mq_keys])
        if device_single_query:
            from pps_tpu_torch.evaluation.device_eval import cmc_map_device
            m, c = cmc_map_device(mq_g_dist, k_ids, ids[g_inds], k_cams,
                                  cams[g_inds], topk=10, device=device)
            mq_map, mq_cmc = float(m), c.cpu().numpy()
        else:
            mq_map, mq_cmc = compute_score(_host(mq_g_dist), k_ids,
                                           ids[g_inds], k_cams, cams[g_inds])
        print_scores('Multi Query:', mq_map, mq_cmc)
        results['multi'] = _metric_dict(mq_map, mq_cmc)

    if not to_re_rank:
        return results
    if device_rerank:
        from pps_tpu_torch.evaluation.device_eval import cmc_map_device
        from pps_tpu_torch.evaluation.rerank import rerank_distmat_device

        def rerank_score(qg, qq, gg, q_ids, q_cams):
            rr = rerank_distmat_device(qg, qq, gg, device=device)
            m, c = cmc_map_device(rr, q_ids, ids[g_inds], q_cams,
                                  cams[g_inds], topk=10, device=device)
            return float(m), c.cpu().numpy()
    else:
        from pps_tpu_torch import native

        def rerank_score(qg, qq, gg, q_ids, q_cams):
            rr = native.rerank_native(_host(qg), _host(qq), _host(gg))
            return compute_score(rr, q_ids, ids[g_inds], q_cams,
                                 cams[g_inds])
    if q_g_dist is None:  # the card's single-query block kept no distmat
        q_g_dist = dist_fn(feat[q_inds], feat[g_inds])
    g_g_dist = dist_fn(feat[g_inds], feat[g_inds])  # shared below
    rr_map, rr_cmc = rerank_score(
        q_g_dist, dist_fn(feat[q_inds], feat[q_inds]), g_g_dist,
        ids[q_inds], cams[q_inds])
    print_scores('Re-ranked Single Query:', rr_map, rr_cmc)
    results['single_rerank'] = _metric_dict(rr_map, rr_cmc)
    if mq_feat is not None:
        rr_map, rr_cmc = rerank_score(mq_g_dist, dist_fn(mq_feat, mq_feat),
                                      g_g_dist, k_ids, k_cams)
        print_scores('Re-ranked Multi Query:', rr_map, rr_cmc)
        results['multi_rerank'] = _metric_dict(rr_map, rr_cmc)
    return results
