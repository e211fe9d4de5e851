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
from pps_tpu_torch.parallel import collectives

TRIPLET_WEIGHT = 0.14  # reference reid_heads.py:183
TRIPLET_MARGIN = 1.4   # reference reid_heads.py:184


def softmax_ce_losses(logits, labels, denom=None, sharded=False):
    """Per-combo softmax cross entropy, mean over the batch.

    logits: [B, R, K] (``sharded``: this rank's class slice [B, R, K/m]
    of the active mesh's model group, in model order); labels: [B] int in
    [0, K).
    denom: divide the batch sums by this instead of B (under a data mesh
    the global batch, so each rank returns its share of the global mean).
    Returns (losses [R], accuracies [R]); accuracy takes the argmax, the
    lowest index on ties.  Sharded, both are the whole K's, equal on every
    rank of the model group: the log-sum-exp takes its shift (a max) and
    its sum over the group, the label's logit comes from the rank that
    owns it, the argmax is the group's.
    """
    if sharded:
        picked, hit = _sharded_ce_terms(logits, labels)
    else:
        log_probs = F.log_softmax(logits, dim=-1)
        idx = labels.long()[:, None, None].expand(-1, logits.shape[1], 1)
        picked = torch.gather(log_probs, 2, idx)[..., 0]        # [B, R]
        hit = (torch.argmax(logits, dim=-1) ==
               labels.long()[:, None]).float()
    if denom is None:
        return -torch.mean(picked, dim=0), torch.mean(hit, dim=0)
    return -torch.sum(picked, dim=0) / denom, torch.sum(hit, dim=0) / denom


def _sharded_ce_terms(logits, labels):
    """The log-probability of each row's label [B, R] and the argmax hit
    [B, R] from class-sharded logits."""
    k_local = logits.shape[-1]
    shift = collectives.max_model(logits.amax(dim=-1))           # [B, R]
    total = collectives.all_reduce(
        torch.sum(torch.exp(logits - shift[..., None]), dim=-1),
        axis='model')
    lse = shift + torch.log(total)
    # the label's logit from the rank whose slice holds it, 0 elsewhere
    local = labels.long() - collectives.active().model_index * k_local
    owned = (local >= 0) & (local < k_local)
    idx = local.clamp(0, k_local - 1)[:, None, None].expand(
        -1, logits.shape[1], 1)
    mine = torch.gather(logits, 2, idx)[..., 0] * owned[:, None]
    label_logit = collectives.all_reduce(mine, axis='model')
    return label_logit - lse, (group_argmax(logits) ==
                               labels.long()[:, None]).float()


def group_argmax(x):
    """The argmax over the last dim of class-sharded ``x`` across the
    model group, as a global class index; the lowest index on ties (as
    ``torch.argmax`` and ``jnp.argmax`` take it).  No gradient."""
    x = x.detach()
    k_local = x.shape[-1]
    best = collectives.max_model(x.amax(dim=-1))
    offset = collectives.active().model_index * k_local
    # this rank's lowest index holding the group's max, else past the end
    cand = torch.where(x == best[..., None],
                       torch.arange(k_local, device=x.device) + offset,
                       k_local * collectives.model_size())
    return collectives.min_model(cand.amin(dim=-1))


def crm_loss(probs, labels_oh, labels, denom=None, sharded=False):
    """CRM image-level loss on probabilities + accuracy (``denom`` as in
    ``softmax_ce_losses``).  ``sharded``: ``probs`` and ``labels_oh`` are
    this rank's class slice; the per-class terms (the clip stays
    elementwise) and the argmax go over the model group."""
    n = probs.shape[0] if denom is None else denom
    loss = cross_entropy_with_logits(probs, labels_oh, n=n)
    if sharded:
        loss = collectives.all_reduce(loss, axis='model')
        hit = (group_argmax(probs) == labels.long()).float()
    else:
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
