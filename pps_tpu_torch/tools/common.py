"""What the measurement tools share: the model configuration each one
builds, the device, and the flagship train-step set-up.

``tool_cfg`` is the one place a tool gets its model configuration; the
tests replace it to narrow the model.
"""

import numpy as np
import torch

from pps_tpu_torch.flagship import flagship_cfg


def tool_cfg(**kw):
    """The flagship cfg (``flagship.flagship_cfg``) with ``kw``; frozen."""
    return flagship_cfg(**kw)


def add_device_arg(ap):
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")


def device_kind(dev):
    """The card's name (``torch.cuda.get_device_name``), or 'cpu'."""
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


def synchronize(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def seeded_model(cfg, dev, seed=0):
    """(model, params, state) of ``cfg`` on ``dev`` from a seeded init."""
    from pps_tpu_torch.models.model import build_model
    model = build_model(cfg, device=dev)
    params, state = model.init(torch.Generator().manual_seed(seed))
    return model, params, state


def make_trainer(cfg, model, params, state, dev):
    """(step, train_state) of the shipped train step over ``params``."""
    from pps_tpu_torch.parallel.train_step import make_train_step
    from pps_tpu_torch.solver import optimizer as opt
    step = make_train_step(model, cfg, opt.make_param_meta(params, cfg),
                           trainable=opt.trainable_from_cfg(cfg, params),
                           device=dev)
    ts = {'params': params, 'state': state,
          'opt': opt.init_opt_state(params, flavor=opt.flavor_from_cfg(cfg),
                                    iter_size=int(cfg.REID.ITER_SIZE))}
    return step, ts


def pk_labels(p, k):
    """P identities x K images: [0]*k + [1]*k + ... as int32."""
    return np.repeat(np.arange(p), k).astype(np.int32)


def label_batch(labels, num_classes, dev):
    """'labels_int32' and 'labels_oh' ([B, NUM_CLASSES - 1]) on ``dev``."""
    oh = np.zeros((labels.size, num_classes - 1), np.float32)
    oh[np.arange(labels.size), labels] = 1.0
    return {'labels_int32': torch.from_numpy(labels).to(dev),
            'labels_oh': torch.from_numpy(oh).to(dev)}


def u8_batch(rng, labels, raw_hw, num_classes, dev, flipped=None):
    """A uint8-wire train batch of random decodes at ``raw_hw`` (H, W)."""
    n = labels.size
    batch = label_batch(labels, num_classes, dev)
    batch['data_u8'] = torch.from_numpy(
        rng.randint(0, 256, (n,) + tuple(raw_hw) + (3,)).astype(
            np.uint8)).to(dev)
    batch['flipped'] = torch.from_numpy(
        np.zeros(n, bool) if flipped is None else flipped).to(dev)
    return batch
