"""Learning-rate policies (counterpart of ``pps_tpu/solver/lr_policy.py``,
numpy only).

The PPS train loop indexes the LR schedule by *epoch* while warm-up is
indexed by raw iteration (reference lr_policy.py:28-43).
"""

import numpy as np


def get_lr_at_iter(cfg, it, ep, ep_size):
    lr = _get_lr_func(cfg)(cfg, ep)
    if ep < cfg.SOLVER.WARM_UP_ITERS:
        method = cfg.SOLVER.WARM_UP_METHOD
        if method == 'constant':
            warmup_factor = cfg.SOLVER.WARM_UP_FACTOR
        elif method == 'linear':
            alpha = it / (cfg.SOLVER.WARM_UP_ITERS * ep_size)
            warmup_factor = cfg.SOLVER.WARM_UP_FACTOR * (1 - alpha) + alpha
        else:
            raise KeyError('Unknown SOLVER.WARM_UP_METHOD: {}'.format(method))
        lr *= warmup_factor
    return np.float32(lr)


def lr_func_steps_with_lrs(cfg, cur_iter):
    ind = _get_step_index(cfg, cur_iter)
    return cfg.SOLVER.LRS[ind]


def lr_func_steps_with_decay(cfg, cur_iter):
    ind = _get_step_index(cfg, cur_iter)
    return cfg.SOLVER.BASE_LR * cfg.SOLVER.GAMMA ** ind


def lr_func_step(cfg, cur_iter):
    return (cfg.SOLVER.BASE_LR *
            cfg.SOLVER.GAMMA ** (cur_iter // cfg.SOLVER.STEP_SIZE))


def lr_func_cosine_decay(cfg, cur_iter):
    iter_frac = float(cur_iter) / cfg.SOLVER.MAX_ITER
    return cfg.SOLVER.BASE_LR * 0.5 * (np.cos(np.pi * iter_frac) + 1)


def lr_func_exp_decay(cfg, cur_iter):
    iter_frac = float(cur_iter) / cfg.SOLVER.MAX_ITER
    return cfg.SOLVER.BASE_LR * np.exp(iter_frac * np.log(cfg.SOLVER.GAMMA))


def _get_step_index(cfg, cur_iter):
    assert cfg.SOLVER.STEPS[0] == 0, 'The first step should always start at 0.'
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_ITER]
    for ind, step in enumerate(steps):
        if cur_iter < step:
            break
    return ind - 1


def _get_lr_func(cfg):
    policy = 'lr_func_' + cfg.SOLVER.LR_POLICY
    if policy not in globals():
        raise NotImplementedError(
            'Unknown LR policy: {}'.format(cfg.SOLVER.LR_POLICY))
    return globals()[policy]
