"""The training step (counterpart of ``pps_tpu/parallel/train_step.py``).

One step = augmentation on the uint8 wire (raw or padded) -> forward ->
losses -> backward -> momentum-SGD, as one call that reads nothing back
to the host, so consecutive steps queue on the card without a sync.  A
batch of the host chain ('data', float32 or bfloat16) goes straight to
the model.  Scalars that change between steps (``lr``,
``loss_scale_factor``) are arguments.

Over a (data, model) mesh (one process per rank, ``parallel/mesh.py``)
each rank steps on the rows of its data slot, and the step is pps_tpu's
global-batch step:

* the augmentation draws and the dropout mask are drawn for the GLOBAL
  batch from the same generator on every rank, then sliced to the data
  slot's rows, so the slots' augmented rows put together are the one-rank
  batch;
* train-mode BN (body and head) takes global statistics, and each rank's
  loss is its share of the global loss (``parallel/collectives.py``);
* under a model axis the classifier FCs whose class count divides by it
  are class-sharded (``place_train_state`` slices them and their
  momentum); their softmaxes reduce over the model group;
* after backward, one flat all-reduce (a sum) of the replicated
  parameters' gradient over every rank, and one of the class-sharded
  parameters' over the data group; then the unchanged (elementwise)
  momentum-SGD, so every rank holds the same replicated state and its
  model group's class slices.
"""

import numpy as np
import torch

from pps_tpu_torch.data import device_augment as aug_lib
from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.parallel import collectives
from pps_tpu_torch.parallel import mesh as mesh_lib
from pps_tpu_torch.solver import optimizer as opt_lib
from pps_tpu_torch.utils import trace


def _rank_rows(x, mesh, levels=1):
    """This rank's data slot's rows of a global [levels * B, ...] tensor
    laid out level-major (FPN's batch concat), as a [levels * B_local,
    ...] one."""
    if mesh is None:
        return x
    g = x.reshape((levels, -1) + tuple(x.shape[1:]))
    lo, hi = mesh_lib.local_rows(mesh, g.shape[1])
    return g[:, lo:hi].reshape((-1,) + tuple(x.shape[1:]))


def make_train_step(model, cfg, meta, trainable=None, device=None,
                    mesh=None):
    """Build the train step.

    Returns step(train_state, batch, lr, loss_scale_factor, generator,
    draws=None) -> (train_state, logs), where
      train_state = {'params', 'state', 'opt'} (dicts of tensors; the
        step returns new dicts and leaves its inputs as they were);
      batch = {'data_u8' [B, H, W, 3] uint8, 'flipped' [B] bool, and on
        the padded wire 'valid_hw' [B, 2]} or {'data' [B, H', W', 3]
        float32 or bfloat16}, plus 'labels_int32' [B] and 'labels_oh'
        [B, K], all on the device (under a mesh: this rank's rows, and
        ``labels_oh`` whole or, as ``shard_batch`` gives it, its class
        slice);
      generator: a ``torch.Generator`` on the device; it draws the
        augmentation params and the dropout mask (under a mesh, seeded
        alike on every rank);
      draws: optional {'augment': params of
        ``device_augment.sample_params``, 'dropout_mask': [B, R, D] bool}
        used instead of drawing (the tests inject the JAX package's
        draws); under a mesh they are the global batch's;
      logs: the model's logs plus 'lr', each a 0-d tensor on the device
        (under a mesh, global values).
    mesh: a distributed ``parallel/mesh.Mesh``: the (data, model) step,
      on a train state placed by ``place_train_state``.  None, or a mesh
      without a process group, is the one-device step.
    """
    device = resolve_device(device)
    if device != model.device:
        raise ValueError('train step on {} for a model on {}'.format(
            device, model.device))
    if mesh is not None:
        if mesh.distributed and mesh.device != device:
            raise ValueError('train step on {} for a mesh on {}'.format(
                device, mesh.device))
        if not mesh.distributed:
            mesh = None
    flavor = opt_lib.flavor_from_cfg(cfg)
    iter_size = int(cfg.REID.ITER_SIZE)
    momentum = float(cfg.SOLVER.MOMENTUM)
    aug_spec = aug_lib.augment_spec(cfg)
    pixel_means = np.asarray(cfg.PIXEL_MEANS)
    dropout = float(model.head_spec.get('dropout', 0.0))
    levels = 1 if model.fpn_spec is None else model.fpn_spec['fpn_num']

    def global_draws(batch, draws, generator):
        """The global batch's draws, sliced to this rank's rows."""
        n = batch['labels_int32'].shape[0] * mesh.n_data
        out = {}
        if 'data_u8' in batch:
            aug = draws.get('augment')
            if aug is None:
                x = batch['data_u8']
                if 'valid_hw' in batch:
                    vhw = collectives.all_gather(batch['valid_hw'], mesh)
                    raw_hw = (vhw[:, 0], vhw[:, 1])
                else:
                    raw_hw = (int(x.shape[1]), int(x.shape[2]))
                aug = aug_lib.sample_params(generator, aug_spec, n, raw_hw,
                                            x.device)
            out['augment'] = {k: _rank_rows(v, mesh) for k, v in aug.items()}
        mask = draws.get('dropout_mask')
        if mask is None and dropout > 0.0:
            if generator is None:
                raise ValueError(
                    'dropout needs a generator or a mask in train mode')
            shape = (levels * n, model.num_combos,
                     model.head_spec['bpm_dim'])
            mask = torch.rand(shape, generator=generator,
                              device=device) < 1.0 - dropout
        if mask is not None:
            out['dropout_mask'] = _rank_rows(mask, mesh, levels)
        return out

    def step(train_state, batch, lr, loss_scale_factor, generator,
             draws=None):
        # the host time to issue the step (it never syncs)
        with trace.span('train_step'):
            draws = draws or {}
            if mesh is not None:
                draws = global_draws(batch, draws, generator)
            params, state = train_state['params'], train_state['state']
            if 'data_u8' in batch:
                data = aug_lib.augment_batch(
                    generator, batch['data_u8'], batch['flipped'], aug_spec,
                    pixel_means, params=draws.get('augment'),
                    valid_hw=batch.get('valid_hw'))
            else:
                data = batch['data']
            names = [k for k in params
                     if trainable is None or trainable.get(k, True)]
            leaves = dict(params)
            for k in names:
                leaves[k] = params[k].detach().requires_grad_(True)
            lsf = opt_lib.as_scalar(loss_scale_factor, data)
            # a step differentiates whatever the caller's grad mode is
            with torch.enable_grad(), collectives.data_parallel(mesh):
                total, (updates, logs) = model.train_forward(
                    leaves, state, {'data': data,
                                    'labels_int32': batch['labels_int32'],
                                    'labels_oh': batch['labels_oh']},
                    generator, lsf, dropout_mask=draws.get('dropout_mask'))
                # a param the loss does not reach (below a FREEZE_AT detach)
                # gets a zero gradient, as under jax.grad
                grads = torch.autograd.grad(total, [leaves[k] for k in names],
                                            allow_unused=True)
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(names, grads)}
            if mesh is not None:
                # the objective is the sum of the ranks' losses: a replicated
                # param's gradient sums over every rank, a class slice's over
                # the ranks that hold it (the data group)
                sharded = mesh_lib.placed_class_names(
                    mesh, params, model.head_spec['num_logits'])
                collectives.all_reduce_flat_(
                    [g for k, g in grads.items() if k not in sharded], mesh)
                collectives.all_reduce_flat_(
                    [g for k, g in grads.items() if k in sharded], mesh,
                    axis='data')
            new_params, new_opt = opt_lib.sgd_update(
                params, grads, train_state['opt'], lr, meta, momentum=momentum,
                flavor=flavor, iter_size=iter_size, num_devices=1,
                trainable=trainable)
            new_state = dict(state)
            new_state.update({k: v.detach() for k, v in updates.items()})
            logs = {k: v.detach() for k, v in logs.items()}
            logs['lr'] = opt_lib.as_scalar(lr, data)
            return ({'params': new_params, 'state': new_state, 'opt': new_opt},
                    logs)

    step.device = device
    step.mesh = mesh
    return step


def place_train_state(mesh, train_state):
    """Every rank takes rank 0's train state, bitwise (one broadcast per
    dtype), so the ranks start equal; under a model axis each then keeps
    its class slice of every class-sharded param and of its momentum (and
    accumulator).  Returns the state (the dicts' entries replaced)."""
    if mesh is None or not mesh.distributed:
        return train_state
    tensors = list(train_state['params'].values()) + \
        list(train_state['state'].values())
    for v in train_state['opt'].values():
        tensors += list(v.values()) if isinstance(v, dict) else [v]
    collectives.broadcast_flat_([t for t in tensors if torch.is_tensor(t)],
                                mesh)
    rules = mesh_lib.param_shardings(mesh, train_state['params'])
    sharded = [n for n, r in rules.items()
               if isinstance(r, mesh_lib.ClassSharding)]
    trees = [train_state['params']] + [
        v for v in train_state['opt'].values() if isinstance(v, dict)]
    for tree in trees:
        for n in sharded:
            tree[n] = mesh_lib.class_slice(mesh, tree[n])
    return train_state


def gather_train_state(mesh, train_state, num_logits):
    """The whole train state from a placed one: every class slice (of a
    model with ``num_logits`` classes) put together over the model group
    (a collective: every rank calls it, on the main thread).  Without a
    model axis the state as it is."""
    if mesh is None or not mesh.distributed or mesh.n_model == 1:
        return train_state
    names = mesh_lib.placed_class_names(mesh, train_state['params'],
                                        num_logits)
    out = {'params': dict(train_state['params']),
           'state': train_state['state'], 'opt': {}}
    for k, v in train_state['opt'].items():
        out['opt'][k] = dict(v) if isinstance(v, dict) else v
    for tree in [out['params']] + [v for v in out['opt'].values()
                                   if isinstance(v, dict)]:
        for n in names:
            tree[n] = collectives.gather_classes(tree[n], mesh)
    return out


def shard_batch(mesh, batch):
    """This rank's rows of a global batch (a dict of [B, ...] arrays or
    tensors): the rows of its data slot; under a model axis that divides
    the class count, ``labels_oh`` also to this rank's class slice.  The
    identity without a distributed mesh."""
    if mesh is None or not mesh.distributed:
        return batch
    n_model = mesh.devices.shape[1]
    out = {}
    for k, v in batch.items():
        v = v[slice(*mesh_lib.local_rows(mesh, v.shape[0]))]
        if k == 'labels_oh' and n_model > 1 and v.shape[-1] % n_model == 0:
            v = mesh_lib.class_slice(mesh, v)
        out[k] = v
    return out
