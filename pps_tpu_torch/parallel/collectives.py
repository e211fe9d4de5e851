"""Differentiable collectives over the (data, model) mesh (port-only).

pps_tpu computes the global-batch loss in one program and lets XLA insert
the cross-device reductions.  The port runs one process per rank, so the
reductions are explicit, each over one group of the mesh
(``parallel/mesh.py``: the data group splits the rows, the model group
the classes of the classifier FCs), and each has its adjoint over the
same group as its backward:

* ``all_reduce`` (sum) <-> ``all_reduce``;
* ``all_gather`` (rows, group order) <-> reduce-scatter, built as an
  all-reduce followed by this rank's slice, so gloo serves it too;
* ``max_model`` (the log-sum-exp shift): no gradient;
* ``gather_classes`` (class shards for checkpoints and logs): no gradient.

The functions take ``axis`` 'data' (the default), 'model' or 'world'.

THE RULE that makes the gradients right: the objective is the SUM over
every rank of each rank's loss, and must equal the global loss.  Since
every backward is its collective's exact adjoint, the sum over ranks of
each rank's gradient is the gradient of that objective.  So:

* a per-sample term divides its local sum by the global batch (the rows
  of the data group, ``n_data x`` local rows, never ``world x``);
* a term that every rank of a model group computes identically counts
  once: it is divided by ``n_model``.  Such terms are the softmax CE and
  the CRM loss once their class sums are reduced over the model group
  (sharded or replicated FCs alike), and the BN statistics (their
  gradient is linear in what flows back into them);
* a term that every rank computes identically (the triplet loss over the
  features gathered over the data group) is divided by ``n_data x
  n_model``, the world size;
* gradients of replicated parameters are summed over every rank;
  gradients of class-sharded parameters (and so their momentum) over the
  data group only, each model rank holding its own slice.

A class-sharded FC hands each model rank the part of dL/dfeatures that
its own classes contribute; the body's gradient is their sum over the
model group, which the all-rank sum of the replicated gradients makes.
Dropping that share, or counting a class term twice (its ``1/n_model``
undone), changes the update: ``chip_smoke.class_terms_not_over_model``
plants the second and the gates refuse it.

``data_parallel(mesh)`` makes a mesh the active one for the code inside
(train-mode BN takes its statistics over the global batch, the losses
their global denominators); outside it, and with no process group, every
function here is the identity.

Transport: the collectives run on the process group's backend with the
tensor where it lies (NCCL across cards; gloo for ranks that share one
card, on CUDA tensors: gloo stages them through host memory itself).
Nothing here reads a result back to the host, but gloo's collectives
return only when the host has the result, so a gloo step waits on the
host at each collective.
"""

import contextlib
import contextvars

import numpy as np
import torch

_ACTIVE = contextvars.ContextVar('pps_tpu_torch_data_mesh', default=None)


@contextlib.contextmanager
def data_parallel(mesh):
    """Make ``mesh`` the active data mesh inside the block (a mesh without
    a process group, or None, leaves every collective the identity)."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.distributed
                        else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active():
    """The active distributed mesh, or None."""
    return _ACTIVE.get()


def _axis(mesh, axis):
    """(group, size, this rank's index) of ``axis`` on ``mesh``: 'data',
    'model' or 'world'.  The group is None where it holds one rank."""
    if axis == 'data':
        return mesh.data_group, mesh.n_data, mesh.data_index
    if axis == 'model':
        return mesh.model_group, mesh.n_model, mesh.model_index
    if axis == 'world':
        return mesh.group, mesh.world_size, mesh.rank
    raise ValueError(axis)


def data_size():
    """The active mesh's data-axis size: the data slots a global batch is
    split over (1 without one)."""
    mesh = active()
    return 1 if mesh is None else mesh.n_data


def model_size():
    """The active mesh's model-axis size (1 without one)."""
    mesh = active()
    return 1 if mesh is None else mesh.n_model


def _all_reduce_(t, group, op=None):
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return t


def _all_gather(t, group, size, dim=0):
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        return _all_gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: the sum over the group of the cotangent, this
        # rank's rows of it
        g = _all_reduce_(g.contiguous().clone(), ctx.group)
        i, n = ctx.index, ctx.rows
        return g[i * n:(i + 1) * n], None, None, None


def all_reduce(x, mesh=None, axis='data'):
    """Sum of ``x`` over ``axis``'s group of ``mesh`` (default: the active
    mesh), differentiable; the identity without one."""
    mesh = mesh or active()
    if mesh is None:
        return x
    group, size, _ = _axis(mesh, axis)
    if size == 1:
        return x
    if x.requires_grad:
        return _AllReduce.apply(x, group)
    return _all_reduce_(x.detach().clone(), group)


def all_gather(x, mesh=None, axis='data'):
    """The group's ``x`` concatenated along dim 0 in group order (equal
    shapes on every rank), differentiable; the identity without a mesh."""
    mesh = mesh or active()
    if mesh is None:
        return x
    group, size, index = _axis(mesh, axis)
    if size == 1:
        return x
    if x.requires_grad:
        return _AllGather.apply(x, group, size, index)
    return _all_gather(x.detach(), group, size)


def _reduce_model(x, op, mesh):
    import torch.distributed as dist
    mesh = mesh or active()
    if mesh is None or mesh.n_model == 1:
        return x.detach()
    return _all_reduce_(x.detach().clone(), mesh.model_group,
                        getattr(dist.ReduceOp, op))


def max_model(x, mesh=None):
    """Elementwise max of ``x`` over the model group, no gradient (the
    log-sum-exp shift, the argmax's value)."""
    return _reduce_model(x, 'MAX', mesh)


def min_model(x, mesh=None):
    """Elementwise min of ``x`` over the model group, no gradient (the
    argmax's lowest index among ties)."""
    return _reduce_model(x, 'MIN', mesh)


def gather_classes(t, mesh):
    """A class-sharded tensor's slices (its last dim) put together in
    model order, on every rank of the model group; no gradient."""
    if mesh is None or mesh.n_model == 1:
        return t
    return _all_gather(t.detach(), mesh.model_group, mesh.n_model,
                       dim=t.dim() - 1)


def _flat_(tensors, collective):
    """Run ``collective`` in place on one flat buffer per dtype holding
    every tensor, then copy the result back into the tensors."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


def all_reduce_flat_(tensors, mesh, axis='world'):
    """Sum each tensor over ``axis``'s group in place (default every
    rank), as ONE flat buffer per dtype (one collective per group for the
    whole gradient)."""
    group, size, _ = _axis(mesh, axis)
    if size == 1 or not tensors:
        return tensors
    return _flat_(tensors, lambda flat: _all_reduce_(flat, group))


def broadcast_flat_(tensors, mesh, src=0):
    """Rank ``src``'s values of every tensor, in place, one flat buffer
    per dtype."""
    import torch.distributed as dist
    return _flat_(tensors, lambda flat: dist.broadcast(flat, src,
                                                      group=mesh.group))


def agree_any(flag, mesh):
    """True on every rank when ``flag`` is true on any rank: a max over a
    host tensor on the mesh's CPU group (no device work)."""
    import torch.distributed as dist
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.cpu_group)
    return bool(t.item())


def gather_host_rows(arr, mesh):
    """Every rank's host array [n, ...] (equal shapes) concatenated in
    rank order, on every rank, through the CPU group."""
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(arr))
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.cpu_group)
    return torch.cat(parts, dim=0).numpy()
