"""The plain reference against the program at tiny sizes on the CPU: the
same arithmetic gives the same answers (the reference itself imports
nothing of the program; this test does)."""

import numpy as np
import pytest
import torch

import _portbench_tiny as tiny  # noqa: F401  (puts the repo on the path)
from portbench.reference import evaluation


@pytest.mark.parametrize('levels', [3, 50, None])
def test_scores_match_the_programs_numpy_metrics(levels):
    from pps_tpu_torch.evaluation import metrics
    rng = np.random.RandomState(levels or 7)
    nq, ng = 40, 300
    dist = rng.rand(nq, ng)
    if levels:  # many equal distances: sklearn 0.18's thresholds
        dist = np.round(dist * levels) / levels
    q_ids, g_ids = rng.randint(0, 12, nq), rng.randint(0, 12, ng)
    q_cams, g_cams = rng.randint(1, 4, nq), rng.randint(1, 4, ng)
    m, cmc = evaluation.scores(*(torch.as_tensor(x) for x in (
        dist, q_ids, g_ids, q_cams, g_cams)))
    want_m = metrics.mean_ap(dist, q_ids, g_ids, q_cams, g_cams)
    want_c = metrics.cmc(dist, q_ids, g_ids, q_cams, g_cams, topk=10,
                         first_match_break=True)
    assert m == pytest.approx(want_m, abs=1e-12)
    assert np.allclose(cmc, want_c, atol=1e-12)


def test_distances_are_the_expand_formula():
    from pps_tpu_torch.ops.distance import euclidean_distmat
    rng = np.random.RandomState(1)
    q, g = (torch.as_tensor(rng.rand(n, 16).astype(np.float32))
            for n in (5, 9))
    assert torch.equal(evaluation.distances(q, g), euclidean_distmat(q, g))
