"""Ablation profile of the flagship training step on the card
(counterpart of ``tools/profile_train_step.py``).

Times each slice of the per-iteration work, so the step-time breakdown is
measured, not guessed:

  eval_fwd        BN-folded extraction forward (the serving path)
  train_fwd       the train forward's value only (batch-stat BN + losses)
  train_grad      the train forward and its gradient
  full_step       gradient + SGD update (the shipped step), f32 images
                  resident on the card
  u8aug_step      the shipped step on the uint8 wire: raw 128x64 decodes,
                  the whole augmentation chain on the card

Optionally writes a ``torch.profiler`` Chrome trace per slice under
--profile-dir.

    python -m pps_tpu_torch.tools.profile_train_step [--batch 64]
        [--iters 20] [--profile-dir DIR] [--dtype bfloat16]
        [--depth 50|101|152] [--device cuda|cpu]
"""

import argparse
import os
import time

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common


def _trace(profile_dir, name, fn, dev):
    """A Chrome trace of 3 calls of ``fn`` at ``profile_dir/name``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == 'cuda' else [])
    with profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        common.synchronize(dev)
    os.makedirs(os.path.join(profile_dir, name), exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, name, 'trace.json'))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--profile-dir', default=None)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--depth', type=int, default=50, choices=(50, 101, 152),
                    help='ResNet body depth (reference BLOCK_COUNTS)')
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    from pps_tpu_torch.models.folding import fold_conv_bn
    from pps_tpu_torch.parallel.eval_step import make_extract_fn
    from pps_tpu_torch.utils.flops import model_fwd_flops
    from pps_tpu_torch.utils.timer import slope_time

    if args.batch % 8:
        raise SystemExit('--batch must be a multiple of 8 (P=8)')
    dev = resolve_device(args.device)
    p = 8
    k = max(1, args.batch // 8)
    cfg = common.tool_cfg(ims_per_batch=args.batch, p=p, k=k,
                          dtype=args.dtype, depth=args.depth)
    model, params, state = common.seeded_model(cfg, dev)
    w, h = cfg.REID.SCALE
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randn(args.batch, h, w, 3).astype(np.float32)).to(dev)
    labels = common.pk_labels(p, k)
    batch = dict(common.label_batch(labels, cfg.MODEL.NUM_CLASSES, dev),
                 data=images)
    gen = torch.Generator(device=dev).manual_seed(1)

    # model FLOP accounting (forward conv + FC MACs x 2), for the rates
    fwd_gf = model_fwd_flops(cfg) / 1e9
    results = {}

    def report(name, t, flops_per_img):
        tf_s = flops_per_img * args.batch / t / 1e3  # TFLOP/s
        results[name] = {'ms': t * 1e3, 'tflops': tf_s,
                         'imgs_per_s': args.batch / t}
        print('%-12s %7.2f ms  %6.1f TFLOP/s  (%5.0f imgs/s)'
              % (name, t * 1e3, tf_s, args.batch / t), flush=True)

    def run(name, fn, flops_per_img):
        report(name, slope_time(fn, iters=args.iters), flops_per_img)
        if args.profile_dir:
            _trace(args.profile_dir, name, fn, dev)

    # 1. eval forward (BN folded into the convs: the serving path)
    fp = fold_conv_bn(params, state)
    extract = make_extract_fn(model, device=dev)
    run('eval_fwd', lambda: extract(fp, state, images), fwd_gf)

    # 2. train forward only (batch-stat BN + CRM + triplet)
    def train_fwd():
        with torch.no_grad():
            return model.train_forward(params, state, batch, gen, 1.0)[0]
    run('train_fwd', train_fwd, fwd_gf)

    # 3. the forward and its gradient
    def train_grad():
        leaves = {n: v.detach().requires_grad_(True)
                  for n, v in params.items()}
        with torch.enable_grad():
            total = model.train_forward(leaves, state, batch, gen, 1.0)[0]
            return torch.autograd.grad(total, list(leaves.values()),
                                       allow_unused=True)[0]
    run('train_grad', train_grad, 3 * fwd_gf)

    # 4. the full shipped step (gradient + SGD), chained through its state
    step, ts = common.make_trainer(cfg, model, params, state, dev)
    holder = {'ts': ts}

    def chained(b):
        def one():
            holder['ts'], _ = step(holder['ts'], b, 0.01, 1.0, gen)
            return holder['ts']['params']['conv1_w']
        return one

    def steps_time(one):
        for _ in range(3):
            one()
        common.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            one()
        common.synchronize(dev)
        return (time.perf_counter() - t0) / args.iters

    full = chained({k_: v for k_, v in batch.items()})
    t = steps_time(full)
    report('full_step', t, 3 * fwd_gf)
    if args.profile_dir:
        _trace(args.profile_dir, 'full_step', full, dev)

    # 5. uint8-wire step: raw Market-geometry decodes (128x64) shipped as
    # uint8, the whole augmentation chain on the card
    u8 = common.u8_batch(rng, labels, (128, 64), cfg.MODEL.NUM_CLASSES, dev,
                         flipped=np.arange(args.batch) % 2 == 1)
    tu = steps_time(chained(u8))
    results['u8aug_step'] = {'ms': tu * 1e3, 'imgs_per_s': args.batch / tu,
                             'share_of_f32_rate': t / tu}
    print('%-12s %7.2f ms  (%5.0f imgs/s)  = %.0f%% of resident-f32 rate'
          % ('u8aug_step', tu * 1e3, args.batch / tu, 100.0 * t / tu))
    print('model fwd GFLOPs/img: %.2f' % fwd_gf)
    results.update(fwd_gflops_per_img=fwd_gf, batch=args.batch,
                   iters=args.iters, dtype=args.dtype, depth=args.depth,
                   device_kind=common.device_kind(dev))
    return results


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    try:
        main()
    finally:
        write_launch_counts()
