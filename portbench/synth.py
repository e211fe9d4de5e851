"""Inputs made from the seed: weights on the card, synthetic Market-1501
decodes, the roidbs the program's loader and test pass read, and the
training draws.

The Market-1501 split (Zheng et al., ICCV 2015) as published: 751 train
identities over 12,936 images; 750 test identities, 3,368 queries and
19,732 gallery images; 128 x 64 crops.  How the images fall to the
identities and cameras is not published per identity: every seed gives
each identity its share of the totals (the same multiset of counts, in
another order), and cameras uniformly from the six.
"""

import numpy as np
import torch

MEANS = (102.9801, 115.9465, 122.7717)  # the published PIXEL_MEANS, BGR


def make_weights(spec, seed, device, branch_scale=1.0):
    """(params, state) of the reference's leaves: the published init
    (MSRA fan-out convs, N(0, 0.001) classifiers, Xavier-uniform CRM,
    BN scale 1 and bias 0, running statistics 0 and 1), drawn on
    ``device`` in two calls and cut into leaves; the BN scale that ends
    each residual branch (``*_branch2c_bn_s``) is ``branch_scale``."""
    leaves = spec.leaves()
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {k: int(np.prod(s)) for k, s, _ in leaves}
    n_norm = sum(sizes[k] for k, _, i in leaves if i[0] == 'normal')
    n_unif = sum(sizes[k] for k, _, i in leaves if i[0] == 'uniform')
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    params, a, b = {}, 0, 0
    for name, shape, init in leaves:
        n = sizes[name]
        if init[0] == 'normal':
            params[name] = (normal[a:a + n] * init[1]).reshape(shape)
            a += n
        elif init[0] == 'uniform':
            params[name] = ((unif[b:b + n] * 2 - 1) * init[1]).reshape(shape)
            b += n
        else:
            fill = 1.0 if init[0] == 'ones' else 0.0
            if name.endswith('_branch2c_bn_s'):
                fill = branch_scale
            params[name] = torch.full(shape, fill, device=device)
    state = {}
    for name, shape in spec.bn_state():
        state[name + '_rm'] = torch.zeros(shape, device=device)
        state[name + '_riv'] = torch.ones(shape, device=device)
    return params, state


def decodes(n, hw, seed, device):
    """[n, h, w, 3] uint8 BGR decodes as a host array, drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (n, hw[0], hw[1], 3), generator=gen,
                      device=device, dtype=torch.uint8)
    return x.cpu().numpy()


def _shares(total, parts, rng):
    """``parts`` counts summing to ``total``, as even as integers allow,
    in an order drawn from ``rng``."""
    counts = np.full(parts, total // parts)
    counts[:total % parts] += 1
    return rng.permutation(counts)


def train_roidb(ids, images, hw, seed):
    """The training roidb: ``images`` entries over ``ids`` identities, each
    with its horizontally flipped duplicate (the flip runs on the card).
    Entry ``i``'s image is decode ``i % images``."""
    rng = np.random.RandomState(seed % 2 ** 31)
    labels = np.repeat(np.arange(ids), _shares(images, ids, rng))
    roidb = [{'image': str(i), 'gt_class': int(labels[i]) + 1,
              'flipped': False, 'height': hw[0], 'width': hw[1]}
             for i in range(images)]
    return roidb + [dict(e, flipped=True) for e in roidb]


def test_roidb(ids, queries, gallery, seed):
    """The test roidb, queries (mark 0) then gallery (mark 1); image
    names in the Market-1501 form ``<id:08>_<cam:04>_<n>.jpg`` that the
    evaluation parses."""
    rng = np.random.RandomState(seed % 2 ** 31)
    out = []
    for mark, total in ((0, queries), (1, gallery)):
        pids = np.repeat(np.arange(1, ids + 1), _shares(total, ids, rng))
        cams = rng.randint(1, 7, size=total)
        for pid, cam in zip(pids, cams):
            n = len(out)
            out.append({'image': str(n), 'mark': mark,
                        'im_name': '{:08d}_{:04d}_{:06d}.jpg'.format(
                            pid, cam, n)})
    return out


def erasing_draws(n, hw, prob, sl, sh, r1, rng):
    """Random erasing (Zhong et al. 2017) per image: fires with ``prob``;
    up to 100 tries of an area share in [sl, sh] and an aspect in
    [r1, 1 / r1]; the first box that fits is placed uniformly.  Returns
    numpy arrays erase_on, er_y, er_x, er_h, er_w (rows, then columns)."""
    h, w = hw
    out = {k: np.zeros(n, np.int32) for k in ('er_y', 'er_x', 'er_h',
                                              'er_w')}
    on = np.zeros(n, bool)
    for i in range(n):
        if rng.uniform() > prob:
            continue
        for _ in range(100):
            area = rng.uniform(sl, sh) * h * w
            ar = rng.uniform(r1, 1.0 / r1)
            eh = int(round(np.sqrt(area * ar)))
            ew = int(round(np.sqrt(area / ar)))
            if ew < w and eh < h:
                on[i] = True
                out['er_h'][i], out['er_w'][i] = eh, ew
                out['er_y'][i] = rng.randint(0, h - eh + 1)
                out['er_x'][i] = rng.randint(0, w - ew + 1)
                break
    out['erase_on'] = on
    return out


def train_draws(batch, hw, combos, dim, erase, seed, device):
    """One step's draws, handed to both sides: the program's augmentation
    parameters (no crop: the window is the whole decode) with the erasing
    box, and the dropout keep-mask [batch, combos, dim] (keep 0.8)."""
    rng = np.random.RandomState(seed % 2 ** 31)
    er = erasing_draws(batch, hw, erase['prob'], erase['sl'], erase['sh'],
                       erase['r1'], rng)
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = torch.rand((batch, combos, dim), generator=gen,
                      device=device) < 0.8
    i32 = dict(dtype=torch.int32, device=device)
    aug = {'ch': torch.full((batch,), hw[0], **i32),
           'cw': torch.full((batch,), hw[1], **i32),
           'y0': torch.zeros(batch, **i32), 'x0': torch.zeros(batch, **i32),
           'erase_on': torch.as_tensor(er['erase_on'], device=device)}
    for k in ('er_y', 'er_x', 'er_h', 'er_w'):
        aug[k] = torch.as_tensor(er[k], **i32)
    return {'augment': aug, 'dropout_mask': keep}
