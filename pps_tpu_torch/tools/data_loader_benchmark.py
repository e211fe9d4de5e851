"""Data-loader throughput harness (counterpart of
``tools/data_loader_benchmark.py``).

Measures ``data/loader.ReIDLoader``'s minibatch production (decode +
augment + resize, and the copy to the device) in imgs/s across worker
counts, with either a synthetic decode (isolates the augmentation
pipeline) or real jpg files.

    python -m pps_tpu_torch.tools.data_loader_benchmark [--imdir DIR]
        [--batches 50] [--batch-size 64] [--workers 1 2 4 8]
        [--device cuda|cpu]
"""

import argparse
import glob
import os
import time

import numpy as np

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common


def synth_decode(path):
    seed = int(path.split('//')[1])
    return np.random.RandomState(seed).randint(
        0, 255, (256, 128, 3)).astype(np.uint8)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--imdir', default=None,
                        help='directory of jpgs; synthetic decode if unset')
    parser.add_argument('--batches', type=int, default=50)
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--workers', type=int, nargs='+',
                        default=[1, 2, 4, 8])
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    from pps_tpu_torch.config import (cfg, merge_cfg_from_list,
                                      assert_and_infer_cfg, reset_cfg)
    from pps_tpu_torch.data.loader import ReIDLoader

    dev = resolve_device(args.device)
    reset_cfg()
    merge_cfg_from_list([
        'MODEL.NUM_CLASSES', '751',
        'TRAIN.IMS_PER_BATCH', str(args.batch_size),
        'REID.SCALE', '(128, 384)',
        'REID.RANDOM_ERASING_PROB', '0.4',
        'SOLVER.MAX_ITER', '10000',
    ])
    assert_and_infer_cfg(make_immutable=False)

    if args.imdir:
        paths = sorted(glob.glob(os.path.join(args.imdir, '*.jpg')))
        if not paths:
            raise SystemExit('no jpgs in {}'.format(args.imdir))
        # replicate so one epoch covers the whole measurement
        need = args.batches * args.batch_size + args.batch_size
        paths = (paths * (need // len(paths) + 1))[:need]
        roidb = [{'image': p, 'gt_class': i % 750 + 1, 'flipped': False,
                  'im_name': os.path.basename(p)}
                 for i, p in enumerate(paths)]
        decode_fn = None
    else:
        roidb = [{'image': 'synth://%d' % i, 'gt_class': i % 750 + 1,
                  'flipped': False, 'im_name': '%08d.jpg' % i}
                 for i in range(args.batch_size * args.batches)]
        decode_fn = synth_decode

    out = {'imgs_per_s': {}, 'ms_per_batch': {}, 'batch_size':
           args.batch_size, 'batches': args.batches,
           'device_kind': common.device_kind(dev)}
    for w in args.workers:
        loader = ReIDLoader(roidb, cfg, num_workers=w, decode_fn=decode_fn,
                            prefetch=2 * w, device=dev)
        t0 = None
        n = 0
        ep = 0
        while n < args.batches:
            for _ in loader.iter_epoch(ep):
                if t0 is None:  # the first batch warms the pool
                    t0 = time.perf_counter()
                else:
                    n += 1
                if n >= args.batches:
                    break
            ep += 1
        common.synchronize(dev)
        dt = max(time.perf_counter() - t0, 1e-9)
        out['imgs_per_s'][w] = n * args.batch_size / dt
        out['ms_per_batch'][w] = dt / n * 1e3
        print('workers={:d}: {:.0f} imgs/s ({:.1f} ms/batch)'.format(
            w, n * args.batch_size / dt, dt / n * 1e3), flush=True)
    return out


if __name__ == '__main__':
    main()
