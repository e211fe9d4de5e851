"""Training losses of the re-ID model (counterpart of
``pps_tpu/models/losses.py``), stacked over the combination axis:

  total = sum_r CE_r + CRM + TRIPLET_WEIGHT * sum_r triplet_r * scale

where ``scale`` is the runtime ``loss_scale_factor`` of the
TRIPLET_LOSS_CROSS epoch alternation.
"""

import torch
import torch.nn.functional as F

from pps_tpu_torch.ops.batch_hard import batch_hard
from pps_tpu_torch.ops.cross_entropy import cross_entropy_with_logits
from pps_tpu_torch.ops.distance import pairwise_sq_dist_batched

TRIPLET_WEIGHT = 0.14  # reference reid_heads.py:183
TRIPLET_MARGIN = 1.4   # reference reid_heads.py:184


def softmax_ce_losses(logits, labels, denom=None):
    """Per-combo softmax cross entropy, mean over the batch.

    logits: [B, R, K]; labels: [B] int in [0, K).
    denom: divide the batch sums by this instead of B (under a data mesh
    the global batch, so each rank returns its share of the global mean).
    Returns (losses [R], accuracies [R]); accuracy takes the argmax, the
    lowest index on ties.
    """
    log_probs = F.log_softmax(logits, dim=-1)
    idx = labels.long()[:, None, None].expand(-1, logits.shape[1], 1)
    picked = torch.gather(log_probs, 2, idx)[..., 0]        # [B, R]
    hit = (torch.argmax(logits, dim=-1) == labels.long()[:, None]).float()
    if denom is None:
        return -torch.mean(picked, dim=0), torch.mean(hit, dim=0)
    return -torch.sum(picked, dim=0) / denom, torch.sum(hit, dim=0) / denom


def crm_loss(probs, labels_oh, labels, denom=None):
    """CRM image-level loss on probabilities + accuracy (``denom`` as in
    ``softmax_ce_losses``)."""
    loss = cross_entropy_with_logits(probs, labels_oh, n=denom)
    hit = (torch.argmax(probs, dim=-1) == labels.long()).float()
    if denom is None:
        return loss, torch.mean(hit)
    return loss, torch.sum(hit) / denom


def triplet_losses(features, labels, margin=TRIPLET_MARGIN, normalize=True):
    """Per-combo batch-hard triplet margin-ranking loss.

    features: [B, R, D]; labels: [B] int.
    Returns (mrc_mean [R], dist_ap_mean [R], dist_an_mean [R]).

    Per combo: L2-normalise (norm clamped at 1e-12), squared pairwise
    distance, clamp at 1e-12, sqrt, batch-hard mining, then
    max(0, ap - an + margin) averaged.  All combos in one batched pass.
    """
    x = features.transpose(0, 1)  # [R, B, D]
    if normalize:
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        x = x / torch.clamp(norm, min=1e-12)
    dist = torch.sqrt(torch.clamp(pairwise_sq_dist_batched(x), min=1e-12))
    ap, an = batch_hard(dist, labels)                 # [R, B] each
    mrc = torch.relu(ap - an + margin)
    return mrc.mean(dim=1), ap.mean(dim=1), an.mean(dim=1)
