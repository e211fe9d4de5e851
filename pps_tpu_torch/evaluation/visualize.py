"""Rank-list visualization: per-query grids of the top-10 gallery matches
(counterpart of ``pps_tpu/evaluation/visualize.py``).

Query image on the left, top-10 valid gallery images to the right, each
framed green (correct id) or red (wrong), written as
``<output_dir>/<query_im_name>``.  Enabled by REID.VIS (``engine/test.py``
passes ``<output_dir>/vis``).  cv2 is imported at first use.
"""

import logging
import os

import numpy as np

from pps_tpu_torch.data.transforms import _cv2

logger = logging.getLogger(__name__)


def visualize_rank_lists(distmat, query_ids, gallery_ids, query_cams,
                         gallery_cams, query_paths, gallery_paths,
                         output_dir, topk=10, max_queries=None,
                         skip_no_match=True):
    """Returns the number of grids written.  skip_no_match=False keeps
    queries with no ground-truth match (the serving case where gallery ids
    are unknown)."""
    cv2 = _cv2()
    os.makedirs(output_dir, exist_ok=True)
    query_paths = np.asarray(query_paths)
    gallery_paths = np.asarray(gallery_paths)
    m = distmat.shape[0]
    indices = np.argsort(distmat, axis=1)
    matches = gallery_ids[indices] == query_ids[:, np.newaxis]
    n_written = 0
    for i in range(m):
        if max_queries is not None and n_written >= max_queries:
            break
        valid = ((gallery_ids[indices[i]] != query_ids[i]) |
                 (gallery_cams[indices[i]] != query_cams[i]))
        y_true = matches[i, valid]
        if skip_no_match and not np.any(y_true):
            continue
        im_query = cv2.imread(str(query_paths[i]), cv2.IMREAD_COLOR)
        if im_query is None:
            continue
        h, w = im_query.shape[:2]
        bs, ms = 4, 10  # border / margin
        canvas = np.full((h + 2 * bs, w * (topk + 1) + 2 * ms +
                          2 * ms * topk, 3), 255, np.uint8)
        canvas[bs:-bs, :w] = im_query
        st = w + 2 * ms
        g_paths = gallery_paths[indices[i]][valid]
        for j in range(min(topk, len(g_paths))):
            im_g = cv2.imread(str(g_paths[j]), cv2.IMREAD_COLOR)
            if im_g is None:
                continue
            im_g = cv2.resize(im_g, (w, h), interpolation=cv2.INTER_CUBIC)
            color = [0, 255, 0] if y_true[j] else [0, 0, 255]  # BGR
            canvas[:, st + ms - bs:st + ms + w + bs] = color
            canvas[bs:-bs, st + ms:st + ms + w] = im_g
            st += w + 2 * ms
        out = os.path.join(output_dir,
                           os.path.basename(str(query_paths[i])))
        cv2.imwrite(out, canvas)
        n_written += 1
    logger.info('wrote %d rank-list grids to %s', n_written, output_dir)
    return n_written
