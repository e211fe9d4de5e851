"""Batch-hard example mining with the reference's gradient routing
(counterpart of ``pps_tpu/ops/batch_hard.py``).

forward   AP[a] = max(0, max_{p: l_p == l_a} D[a, p])   (self included)
          AN[a] = min_{n: l_n != l_a} D[a, n]
backward  dD[a, argmax_p] = dAP[a];  dD[a, argmin_n] = dAN[a]

Gradient flows only to the single hardest element of each row, the first
index on ties (the C++ op's scan order), so the backward pass is written
out as a ``torch.autograd.Function``: autograd of ``amax`` would split it
across ties.  ``torch.argmax`` / ``torch.argmin`` return the first
extremal index; ``Tensor.max(dim)`` promises no such thing and is not
used.  Any leading axes are batch axes, so all 31 combinations of the
flagship go through one call on a ``[R, N, N]`` stack.
"""

import torch


class _BatchHard(torch.autograd.Function):

    @staticmethod
    def forward(ctx, dist, labels):
        pos = labels[:, None] == labels[None, :]
        masked_pos = torch.where(pos, dist, float('-inf'))
        masked_neg = torch.where(pos, float('inf'), dist)
        idx_p = torch.argmax(masked_pos, dim=-1, keepdim=True)
        idx_n = torch.argmin(masked_neg, dim=-1, keepdim=True)
        # the reference's positive scan starts at 0: an implicit relu
        ap = torch.clamp(torch.gather(masked_pos, -1, idx_p), min=0.0)
        an = torch.gather(masked_neg, -1, idx_n)
        ctx.save_for_backward(idx_p, idx_n)
        ctx.dist_shape = dist.shape
        return ap[..., 0], an[..., 0]

    @staticmethod
    def backward(ctx, d_ap, d_an):
        idx_p, idx_n = ctx.saved_tensors
        d_dist = torch.zeros(ctx.dist_shape, dtype=d_ap.dtype,
                             device=d_ap.device)
        d_dist.scatter_add_(-1, idx_p, d_ap[..., None])
        d_dist.scatter_add_(-1, idx_n, d_an[..., None])
        return d_dist, None


def batch_hard(dist, labels):
    """dist: [..., N, N] float distances; labels: [N] int.

    Returns (dist_ap [..., N], dist_an [..., N])."""
    return _BatchHard.apply(dist, labels)
