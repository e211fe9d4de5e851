"""Pairwise distance ops (counterpart of ``pps_tpu/ops/distance.py``).

The expand formula ``|x|^2 + |y|^2 - 2 x.y^T`` puts the O(N M D) work in
one float32 matrix product (full float32 on the card: no TF32, see
``device.py``).
"""

import torch

# outputs up to this many elements (1 GB of float32) are one product
SINGLE_BLOCK_MAX_ELEMS = 1 << 28


def pairwise_sq_dist(x, y=None):
    """Z[p, q] = ||x_p - y_q||^2, shape [N, M]; y defaults to x."""
    if y is None:
        y = x
    xx = torch.sum(x * x, dim=1, keepdim=True)
    yy = torch.sum(y * y, dim=1, keepdim=True)
    return xx + yy.T - 2.0 * (x @ y.T)


def pairwise_sq_dist_batched(x):
    """The combo-batched form: x [R, N, D] -> Z [R, N, N] with
    Z[r, p, q] = ||x_rp - x_rq||^2, one ``torch.bmm`` for all R.  Autograd
    of the expand formula is the reference's hand-written gradient, so no
    custom backward is needed."""
    xx = torch.sum(x * x, dim=2, keepdim=True)
    return xx + xx.transpose(1, 2) - 2.0 * torch.bmm(x, x.transpose(1, 2))


def bf16_product(a, bt):
    """a @ bt with both operands cast to bfloat16 and the products summed
    in float32, giving float32.  On the card one bf16 tensor-core product
    with a float32 output; on the CPU the bf16 values widened to float32
    first (a product of two bf16 values is exact in float32), the same
    arithmetic."""
    a, bt = a.to(torch.bfloat16), bt.to(torch.bfloat16)
    if a.is_cuda:
        return torch.mm(a, bt, out_dtype=torch.float32)
    return a.float() @ bt.float()


def euclidean_distmat(q, g, block_q=1024, fast=False):
    """Euclidean distance matrix [Nq, Ng]: sqrt of the expand formula
    clamped at 0 (the reference evaluator's compute_dist semantics).

    fast=True casts the cross term's operands to bfloat16 and sums their
    products in float32 (the JAX package's ``fast``); the norms stay
    float32.

    Above ``SINGLE_BLOCK_MAX_ELEMS`` output elements the queries go in
    blocks of ``block_q`` so only one [block_q, Ng] set of intermediates
    lives at a time."""
    gg = torch.sum(g * g, dim=1)
    gt = g.T.to(torch.bfloat16) if fast else g.T

    def one_block(qb):
        sq = torch.sum(qb * qb, dim=1, keepdim=True)
        cross = bf16_product(qb, gt) if fast else qb @ gt
        d2 = sq + gg[None, :] - 2.0 * cross
        return torch.sqrt(torch.clamp(d2, min=0.0))

    nq, ng = q.shape[0], g.shape[0]
    if nq * ng <= SINGLE_BLOCK_MAX_ELEMS:
        return one_block(q)
    out = torch.empty((nq, ng), dtype=torch.float32, device=q.device)
    for s in range(0, nq, block_q):
        out[s:s + block_q] = one_block(q[s:s + block_q])
    return out
