"""Market-scale k-reciprocal re-ranking benchmark: the card's path against
the host's (counterpart of ``tools/bench_rerank.py``).

Full Market-1501 eval geometry by default (3368 queries + 15913 gallery =
19,281 images).  Compares the card's sparse-set pipeline
(``evaluation/rerank.rerank_distmat_device``), the C++/OpenMP engine
(``native.rerank_native``) and, with --check-numpy, the numpy golden path,
each with its largest difference from the card's result and the share of
entries apart by more than ``ENTRY_ATOL`` (near-tie set flips move a few).

    python -m pps_tpu_torch.tools.bench_rerank [--nq 3368] [--ng 15913]
        [--d 256] [--check-numpy] [--skip-native] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common

ENTRY_ATOL = 1e-5


def dist(a, b):
    aa = np.sum(a * a, axis=1)[:, None]
    bb = np.sum(b * b, axis=1)[None, :]
    return np.sqrt(np.maximum(aa + bb - 2.0 * a @ b.T, 0.0))


def inputs(nq, ng, d, seed=0):
    """(q-g, q-q, g-g) Euclidean distances of unit rows made from
    ``seed``, float32 numpy."""
    rng = np.random.RandomState(seed)
    f = rng.randn(nq + ng, d).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    q, g = f[:nq], f[nq:]
    return dist(q, g), dist(q, q), dist(g, g)


def compare(name, got, ref):
    """(max |got - ref|, share of entries apart by more than
    ``ENTRY_ATOL``)."""
    gap = np.abs(got - ref)
    return {'max_abs_diff_' + name: float(gap.max()),
            'share_apart_' + name: float(np.mean(gap > ENTRY_ATOL))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--nq', type=int, default=3368)
    ap.add_argument('--ng', type=int, default=15913)
    ap.add_argument('--d', type=int, default=256)
    ap.add_argument('--check-numpy', action='store_true')
    ap.add_argument('--skip-native', action='store_true')
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    from pps_tpu_torch import native
    from pps_tpu_torch.evaluation.rerank import (re_ranking,
                                                 rerank_distmat_device)

    dev = resolve_device(args.device)
    n = args.nq + args.ng
    qg, qq, gg = inputs(args.nq, args.ng, args.d)
    print('n=%d (%d q + %d g)' % (n, args.nq, args.ng))

    # the distance matrices go to the card BEFORE the clock starts: in the
    # eval path they are computed there
    qg_d, qq_d, gg_d = (torch.from_numpy(a).to(dev) for a in (qg, qq, gg))
    common.synchronize(dev)

    def on_card():
        t0 = time.perf_counter()
        out = rerank_distmat_device(qg_d, qq_d, gg_d).cpu().numpy()
        return out, time.perf_counter() - t0

    dev_out, t_first = on_card()
    dev_out, t_dev = on_card()
    print('device sparse-set: %.2f s (first call %.2f s; device-resident '
          'inputs)' % (t_dev, t_first), flush=True)
    out = {'n': n, 'nq': args.nq, 'ng': args.ng, 'device_s': t_dev,
           'device_first_call_s': t_first,
           'device_kind': common.device_kind(dev)}

    if not args.skip_native:
        t0 = time.perf_counter()
        nat = native.rerank_native(qg, qq, gg)
        out['native_s'] = time.perf_counter() - t0
        out.update(compare('dev_native', dev_out, nat))
        print('native C++/OpenMP: %.2f s  max|dev-native|=%.2e'
              % (out['native_s'], out['max_abs_diff_dev_native']),
              flush=True)

    if args.check_numpy:
        t0 = time.perf_counter()
        ref = re_ranking(qg, qq, gg)
        out['numpy_s'] = time.perf_counter() - t0
        out.update(compare('dev_numpy', dev_out, ref))
        print('numpy golden: %.2f s  max|dev-numpy|=%.2e'
              % (out['numpy_s'], out['max_abs_diff_dev_numpy']), flush=True)
    return out


if __name__ == '__main__':
    main()
