"""Momentum-SGD with Caffe2-Detectron update semantics (counterpart of
``pps_tpu/solver/optimizer.py``).

Per-param LR groups by name, as the reference's string matching:

* biases (names ending ``_b``): no weight decay, 2x learning rate
* "new" params (name contains bpm/apm/crm/ekc/pps/youtu): LR x
  ``SOLVER.LR_SCALE_NEW_PARAM``; their FC params: LR x
  ``SOLVER.LR_SCALE_NEW_FC``; ``fpn`` params: LR x LR_SCALE_NEW_PARAM
* everything else: base LR + weight decay

Flavors (momentum lives in the opt-state dict):
  'standard'  v = mu v + lr (g_eff);             p -= v
  'pt'        v = mu v + g_eff;                  p -= lr v
  'iter'      accumulate g for ITER_SIZE steps, then normalise by
              1/(iter_size * num_devices), add wd p, C2-style update (the
              extra num_devices factor is the reference's double
              normalisation, kept)

Updates are functional (new tensors; the inputs stay as they were) and run
under ``torch.no_grad()``.  ``lr`` may be a float or a 0-d tensor on the
params' device; no step reads a value back to the host.
"""

import torch

from pps_tpu_torch.utils import trace

NEW_PARAM_MARKERS = ('bpm', 'apm', 'crm', 'ekc', 'pps', 'youtu')


def classify_param(name, lr_scale_new_param, lr_scale_new_fc):
    """Return (lr_scale, is_bias) for a parameter name."""
    is_bias = name.endswith('_b')
    is_new = any(m in name for m in NEW_PARAM_MARKERS)
    if is_new and 'fc' in name:
        lr_scale = lr_scale_new_fc
    elif is_new or 'fpn' in name:
        lr_scale = lr_scale_new_param
    else:
        lr_scale = 1.0
    return lr_scale, is_bias


def make_param_meta(params, cfg):
    """Static per-param metadata: {name: (lr_scale, is_bias, wd)}."""
    meta = {}
    for name in params:
        lr_scale, is_bias = classify_param(
            name, cfg.SOLVER.LR_SCALE_NEW_PARAM, cfg.SOLVER.LR_SCALE_NEW_FC)
        if is_bias:
            wd = 0.0
        elif name.endswith('_gn_s'):
            wd = cfg.SOLVER.WEIGHT_DECAY_GN
        else:
            wd = cfg.SOLVER.WEIGHT_DECAY
        meta[name] = (lr_scale, is_bias, wd)
    return meta


def _frozen_prefixes(cfg):
    """Param-name prefixes below the freeze point: everything at or below
    the frozen stage gets no update at all (the reference builds update
    ops only for params that receive gradients)."""
    freeze_at = int(cfg.TRAIN.FREEZE_AT)
    if freeze_at not in (0, 1, 2, 3, 4, 5):
        raise ValueError('TRAIN.FREEZE_AT must be in 0..5, got {}'.format(
            freeze_at))
    if cfg.TRAIN.FREEZE_CONV_BODY:
        return ('conv1', 'res_conv1_bn', 'res2_', 'res3_', 'res4_',
                'res5_', 'fpn_')
    if freeze_at == 0:
        return ()
    stem = ('conv1', 'res_conv1_bn')
    return stem + tuple('res%d_' % s for s in range(2, freeze_at + 1))


def trainable_from_cfg(cfg, params):
    """{name: bool} trainable map from TRAIN.FREEZE_AT /
    TRAIN.FREEZE_CONV_BODY, or None when nothing is frozen.  Frozen params
    and their momentum pass through ``sgd_update`` bitwise unchanged; BN
    running stats of frozen stages keep updating (they are state)."""
    prefixes = _frozen_prefixes(cfg)
    if not prefixes:
        return None
    return {name: not name.startswith(prefixes) for name in params}


def init_opt_state(params, flavor='standard', iter_size=1):
    """Zero momentum (and, for 'iter', zero accumulators and a step
    count) beside each param."""
    state = {'momentum': {k: torch.zeros_like(v) for k, v in params.items()}}
    if flavor == 'iter':
        state['acmgrad'] = {k: torch.zeros_like(v)
                            for k, v in params.items()}
        device = next(iter(params.values())).device
        state['count'] = torch.zeros((), dtype=torch.int32, device=device)
    return state


def flavor_from_cfg(cfg):
    if cfg.REID.ITER_SIZE > 1:
        return 'iter'
    if cfg.REID.SGD_PT:
        return 'pt'
    return 'standard'


def as_scalar(value, like):
    """A float32 0-d tensor on ``like``'s device (filled on the device,
    so a float needs no host-to-device copy)."""
    if torch.is_tensor(value):
        return value.to(device=like.device, dtype=torch.float32)
    return torch.full((), value, dtype=torch.float32, device=like.device)


@torch.no_grad()
def sgd_update(params, grads, opt_state, lr, meta, momentum=0.9,
               flavor='standard', iter_size=1, num_devices=1,
               trainable=None):
    """One optimizer step; returns (new_params, new_opt_state).

    trainable: optional {name: bool}; frozen params and their momentum
    (and accumulators) pass through unchanged.
    """
    with trace.span('optimizer.sgd'):
        new_params, new_mom = {}, {}
        mom = opt_state['momentum']
        lr = as_scalar(lr, next(iter(params.values())))

        def frozen(name):
            return trainable is not None and not trainable.get(name, True)

        if flavor == 'iter':
            count = opt_state['count'] + 1
            apply_now = (count % iter_size) == 0
            # a 0-d tensor on the params' device, so the card divides as the
            # CPU does: CUDA turns division by a Python scalar into a product
            # with its float32 reciprocal, which can differ by an ulp
            n_acc = as_scalar(float(iter_size * num_devices),
                              next(iter(params.values())))
            new_acm = {}
            for name, p in params.items():
                if frozen(name):
                    new_params[name] = p
                    new_mom[name] = mom[name]
                    new_acm[name] = opt_state['acmgrad'][name]
                    continue
                lr_scale, is_bias, wd = meta[name]
                lr_mult = 2.0 if is_bias else 1.0
                acm = opt_state['acmgrad'][name] + grads[name]
                g = acm / n_acc
                g = g + wd * p
                v = momentum * mom[name] + lr * lr_scale * lr_mult * g
                new_params[name] = torch.where(apply_now, p - v, p)
                new_mom[name] = torch.where(apply_now, v, mom[name])
                new_acm[name] = torch.where(apply_now, torch.zeros_like(acm),
                                            acm)
            return new_params, {'momentum': new_mom, 'acmgrad': new_acm,
                                'count': count}

        for name, p in params.items():
            if frozen(name):
                new_params[name] = p
                new_mom[name] = mom[name]
                continue
            lr_scale, is_bias, wd = meta[name]
            g = grads[name]
            if is_bias:
                g = 2.0 * g  # bias 2x LR via the gradient
            elif wd > 0:
                g = g + wd * p
            if flavor == 'standard':
                v = momentum * mom[name] + lr * lr_scale * g
                new_params[name] = p - v
            elif flavor == 'pt':
                v = momentum * mom[name] + g
                new_params[name] = p - lr * lr_scale * v
            else:
                raise ValueError(flavor)
            new_mom[name] = v
        out = {k: v for k, v in opt_state.items() if k != 'momentum'}
        out['momentum'] = new_mom
        return new_params, out


@torch.no_grad()
def correct_momentum(opt_state, factor):
    """Scale the update history when the LR changes (v *= new/old)."""
    out = dict(opt_state)
    out['momentum'] = {k: v * factor
                       for k, v in opt_state['momentum'].items()}
    return out


def get_lr_change_ratio(cur_lr, new_lr):
    eps = 1e-10
    return max((new_lr + eps) / (cur_lr + eps),
               (cur_lr + eps) / (new_lr + eps))
