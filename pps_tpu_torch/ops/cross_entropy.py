"""CrossEntropyWithLogits with the reference's clip semantics
(counterpart of ``pps_tpu/ops/cross_entropy.py``).

Despite its name the op consumes *probabilities*:

  forward  loss = -(1/N) sum_i [ L_i log(max(X_i, 1e-20))
                               + (1-L_i) log(max(1-X_i, 1e-20)) ]
  backward dX_i = (1/N) min( dY * (-L_i/max(X_i,1e-20)
                                   + (1-L_i)/max(1-X_i,1e-20)), 1e4 )

The gradient clip is one-sided (upper bound only) and is part of the CRM
loss's training dynamics, so the backward pass is written out as a
``torch.autograd.Function`` (the JAX package's ``custom_vjp``) instead of
autograd of a clipped log.  Labels get no gradient.  Under a model axis
each rank applies it to its class slice and ``models/losses.crm_loss``
sums the result over the model group: the clip stays elementwise.
"""

import torch

LOG_THRESHOLD = 1e-20
DIFF_THRESHOLD = 1e4


class _CrossEntropyWithLogits(torch.autograd.Function):

    @staticmethod
    def forward(ctx, probs, labels, n):
        ctx.save_for_backward(probs, labels)
        ctx.n = n
        p = torch.clamp(probs, min=LOG_THRESHOLD)
        one_p = torch.clamp(1.0 - probs, min=LOG_THRESHOLD)
        loss = -torch.sum(labels * torch.log(p) +
                          (1.0 - labels) * torch.log(one_p))
        return loss / n

    @staticmethod
    def backward(ctx, dy):
        probs, labels = ctx.saved_tensors
        n = ctx.n
        p = torch.clamp(probs, min=LOG_THRESHOLD)
        one_p = torch.clamp(1.0 - probs, min=LOG_THRESHOLD)
        grad = dy * (-labels / p + (1.0 - labels) / one_p)
        return torch.clamp(grad, max=DIFF_THRESHOLD) / n, None, None


def cross_entropy_with_logits(probs, labels, n=None):
    """probs, labels: [N, C] float; returns the scalar loss summed over
    the rows and divided by ``n`` (default N: the mean; under a data mesh
    the global batch, so each rank's loss is its share)."""
    return _CrossEntropyWithLogits.apply(
        probs, labels, probs.shape[0] if n is None else n)
