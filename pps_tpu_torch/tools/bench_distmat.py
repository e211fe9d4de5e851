"""Eval distance-matrix benchmark at Market eval geometry (counterpart of
``tools/bench_distmat.py``).

``ops/distance.euclidean_distmat`` in float32 (full float32 products, no
TF32) and with ``fast=True`` (the cross term's operands in bf16, products
summed in float32), on unit-norm rows.  Slope timing
(``utils/timer.slope_time``); the distance error is against the float32
result.

    python -m pps_tpu_torch.tools.bench_distmat [--nq 3368] [--ng 15913]
        [--d 3968] [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common


def unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def main(argv=None, iters=20):
    ap = argparse.ArgumentParser()
    ap.add_argument('--nq', type=int, default=3368)
    ap.add_argument('--ng', type=int, default=15913)
    ap.add_argument('--d', type=int, default=3968)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    from pps_tpu_torch.ops.distance import euclidean_distmat
    from pps_tpu_torch.utils.timer import slope_time

    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    qd = torch.from_numpy(unit_rows(rng, args.nq, args.d)).to(dev)
    gd = torch.from_numpy(unit_rows(rng, args.ng, args.d)).to(dev)
    common.synchronize(dev)
    flops = 2.0 * args.nq * args.ng * args.d

    results, ref = {}, None
    for name, fn in [
        ('f32', lambda: euclidean_distmat(qd, gd)),
        ('fast', lambda: euclidean_distmat(qd, gd, fast=True)),
    ]:
        t = slope_time(fn, iters=iters, warmup=2)
        out = fn()
        if ref is None:
            ref = out
        err = float(torch.max(torch.abs(out - ref)))
        results[name] = {'ms': t * 1e3, 'tflops': flops / t / 1e12,
                         'max_abs_diff': err}
        print('%-10s %7.2f ms  %6.1f TFLOP/s  max|d-dref|=%.2e'
              % (name, t * 1e3, flops / t / 1e12, err), flush=True)
    results.update(nq=args.nq, ng=args.ng, d=args.d,
                   device_kind=common.device_kind(dev))
    return results


if __name__ == '__main__':
    main()
