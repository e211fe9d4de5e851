"""Differentiable collectives over the data mesh (port-only).

pps_tpu computes the global-batch loss in one program and lets XLA insert
the cross-device reductions.  The port runs one process per rank, so the
reductions are explicit, and each has its adjoint as its backward:

* ``all_reduce`` (sum) <-> ``all_reduce``;
* ``all_gather`` (rows, rank order) <-> reduce-scatter, built as an
  all-reduce followed by this rank's slice, so gloo serves it too.

The rule that makes the gradients right: the objective is the SUM over
ranks of each rank's loss.  A per-sample term divides its local sum by
the global batch; a term that every rank computes identically (a loss over
gathered features) is divided by the world size, because the gather's
backward sums the ranks' cotangents.

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


def world_size():
    mesh = active()
    return 1 if mesh is None else mesh.world_size


def _all_reduce_(t, mesh):
    import torch.distributed as dist
    dist.all_reduce(t, group=mesh.group)
    return t


def _all_gather(t, mesh):
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=0)


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.mesh), None


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.rows = x.shape[0]
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: the sum over ranks of the cotangent, this
        # rank's rows of it
        g = _all_reduce_(g.contiguous().clone(), ctx.mesh)
        r, n = ctx.mesh.rank, ctx.rows
        return g[r * n:(r + 1) * n], None


def all_reduce(x, mesh=None):
    """Sum of ``x`` over the ranks of ``mesh`` (default: the active one),
    differentiable; the identity without one."""
    mesh = mesh or active()
    if mesh is None:
        return x
    if x.requires_grad:
        return _AllReduce.apply(x, mesh)
    return _all_reduce_(x.detach().clone(), mesh)


def all_gather(x, mesh=None):
    """The ranks' ``x`` concatenated along dim 0 in rank order (equal
    shapes on every rank), differentiable; the identity without a mesh."""
    mesh = mesh or active()
    if mesh is None:
        return x
    if x.requires_grad:
        return _AllGather.apply(x, mesh)
    return _all_gather(x.detach(), mesh)


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


def all_reduce_flat_(tensors, mesh):
    """Sum each tensor over the ranks in place, as ONE flat buffer per
    dtype (one collective for the whole gradient)."""
    return _flat_(tensors, lambda flat: _all_reduce_(flat, mesh))


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
