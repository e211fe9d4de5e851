"""int8 PTQ extraction shootout against the bf16 (and BN-folded bf16)
path (counterpart of ``tools/bench_int8.py``).

Steady-state extraction throughput of the flagship model on the card under
three serving configurations:
  bf16        the default extraction graph
  bf16+fold   BN folded into the convs (models/folding.py)
  int8        folded + body PTQ-quantized (models/quantize.py): every body
              conv through the hand ``conv2d_int8`` kernel

Slope timing (``utils/timer.slope_time``).  Also reports the embedding
fidelity of the int8 path against bf16 (cosine), so the speed number is
tied to an accuracy bound.  On the card the int8 route must launch
``conv2d_int8``: a run that did not is an error, not a number.

    python -m pps_tpu_torch.tools.bench_int8 [--depth 50|101|152]
        [--device cuda|cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common

BATCH = 512


def cosine_rows(a, b):
    num = np.sum(a * b, axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    return num / np.maximum(den, 1e-12)


def main(argv=None, iters=20, warmup=3):
    """``iters``/``warmup``: the slope timing's counts (callers that must
    be quick cut them; the CLI keeps the JAX tool's 20 and 3)."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--depth', type=int, default=50, choices=(50, 101, 152),
                    help='ResNet body depth (does the bandwidth-bound '
                         'int8 story hold as depth grows?)')
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    from pps_tpu_torch.kernels import conv2d_int8 as ck
    from pps_tpu_torch.models.folding import fold_conv_bn
    from pps_tpu_torch.models.quantize import quantize_for_eval
    from pps_tpu_torch.parallel.eval_step import make_extract_fn
    from pps_tpu_torch.utils.timer import slope_time

    dev = resolve_device(args.device)
    cfg = common.tool_cfg(depth=args.depth)
    model, params, state = common.seeded_model(cfg, dev)
    # plausible running stats so folding/quantization see realistic scales
    rng = np.random.RandomState(0)
    for k in sorted(state):
        if k.endswith('_rm'):
            state[k] = torch.from_numpy(
                rng.randn(*state[k].shape).astype('f4') * 0.1).to(dev)
        if k.endswith('_riv'):
            state[k] = torch.from_numpy(
                rng.rand(*state[k].shape).astype('f4') + 0.5).to(dev)

    w, h = cfg.REID.SCALE
    images = rng.randn(BATCH, h, w, 3).astype(np.float32) * 50
    dev_images = torch.from_numpy(images).to(dev)

    folded = fold_conv_bn(params, state)
    t0 = time.time()
    qparams = quantize_for_eval(model, params, state, images[:256])
    t_q = time.time() - t0

    fn = make_extract_fn(model, device=dev)
    res, feats = {}, {}
    for name, p in (('bf16', params), ('bf16_fold', folded),
                    ('int8', qparams)):
        before = ck.launches
        t = slope_time(lambda: fn(p, state, dev_images), iters=iters,
                       warmup=warmup)
        if name == 'int8' and dev.type == 'cuda' and ck.launches == before:
            raise RuntimeError('the int8 route launched no conv2d_int8')
        res[name] = BATCH / t
        feats[name] = fn(p, state, dev_images[:64]).cpu().numpy()

    cos = cosine_rows(feats['int8'], feats['bf16'])
    out = {
        'imgs_per_sec_per_chip': {k: round(v, 1) for k, v in res.items()},
        'int8_speedup_vs_bf16': round(res['int8'] / res['bf16'], 3),
        'int8_speedup_vs_fold': round(res['int8'] / res['bf16_fold'], 3),
        'fold_speedup_vs_bf16': round(res['bf16_fold'] / res['bf16'], 3),
        'int8_cosine_vs_bf16_min': float(cos.min()),
        'int8_cosine_vs_bf16_mean': float(cos.mean()),
        'calib_quantize_seconds': round(t_q, 1),
        'depth': args.depth,
        'batch': BATCH,
        'device_kind': common.device_kind(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    try:
        main()
    finally:
        write_launch_counts()
