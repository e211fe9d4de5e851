"""The training step on one device (counterpart of
``pps_tpu/parallel/train_step.py`` without the mesh).

One step = augmentation on the uint8 wire (raw or padded) -> forward ->
losses -> backward -> momentum-SGD, as one call that reads nothing back
to the host, so consecutive steps queue on the card without a sync.  A
batch of the host chain ('data', float32 or bfloat16) goes straight to
the model.  Scalars
that change between steps (``lr``, ``loss_scale_factor``) are arguments.
Multi-GPU (synchronised BN stats, gradient all-reduce) is ROADMAP slice 8.
"""

import numpy as np
import torch

from pps_tpu_torch.data import device_augment as aug_lib
from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.solver import optimizer as opt_lib


def make_train_step(model, cfg, meta, trainable=None, device=None):
    """Build the train step.

    Returns step(train_state, batch, lr, loss_scale_factor, generator,
    draws=None) -> (train_state, logs), where
      train_state = {'params', 'state', 'opt'} (dicts of tensors; the
        step returns new dicts and leaves its inputs as they were);
      batch = {'data_u8' [B, H, W, 3] uint8, 'flipped' [B] bool, and on
        the padded wire 'valid_hw' [B, 2]} or {'data' [B, H', W', 3]
        float32 or bfloat16}, plus 'labels_int32' [B] and 'labels_oh'
        [B, K], all on the device;
      generator: a ``torch.Generator`` on the device; it draws the
        augmentation params and the dropout mask;
      draws: optional {'augment': params of
        ``device_augment.sample_params``, 'dropout_mask': [B, R, D] bool}
        used instead of drawing (the tests inject the JAX package's draws);
      logs: the model's logs plus 'lr', each a 0-d tensor on the device.
    """
    device = resolve_device(device)
    if device != model.device:
        raise ValueError('train step on {} for a model on {}'.format(
            device, model.device))
    flavor = opt_lib.flavor_from_cfg(cfg)
    iter_size = int(cfg.REID.ITER_SIZE)
    momentum = float(cfg.SOLVER.MOMENTUM)
    aug_spec = aug_lib.augment_spec(cfg)
    pixel_means = np.asarray(cfg.PIXEL_MEANS)

    def step(train_state, batch, lr, loss_scale_factor, generator,
             draws=None):
        draws = draws or {}
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
        with torch.enable_grad():
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
    return step
