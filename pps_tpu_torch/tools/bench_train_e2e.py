"""End-to-end training throughput: loader -> wire -> augment on the card ->
step (counterpart of ``tools/bench_train_e2e.py``).

Writes a Market-like synthetic identity dataset (n_ids x per_id raw 128x64
JPEGs + COCO json), registers it, and runs ``engine/train.train_model``
(the training loop) under the flagship config for a few epochs.  The
per-step wall clock lands in the ``json_stats:`` lines (the ``time``
field); pipe stdout to a file and take the median of the steady epochs.

With TPU.DEVICE_AUGMENT the host ships raw uint8 decodes and the
augmentation chain runs on the card; ``--device-augment False`` runs the
host augment chain and the float32 wire instead.

    python -m pps_tpu_torch.tools.bench_train_e2e [--n-ids 751]
        [--per-id 12] [--epochs 2] [--device-augment True|False]
        [--mixed-sizes] [--workers 2] [--data-dir DIR] [--device cuda|cpu]
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common


def make_dataset(root, n_ids=751, per_id=12, hw=(128, 64), seed=0,
                 mixed=False):
    import cv2
    imdir = os.path.join(root, 'images')
    os.makedirs(imdir, exist_ok=True)
    rng = np.random.RandomState(seed)
    # mixed: Duke/CUHK03-style non-uniform decode sizes -> the
    # reflect-padded bucket + valid_hw wire end to end
    size_table = [hw, (hw[0] - 24, hw[1] - 12), (hw[0] - 48, hw[1] - 20)]
    images, anns = [], []
    iid = 0
    for pid in range(1, n_ids + 1):
        for j in range(per_id):
            iid += 1
            name = '{:08d}_{:04d}_{:08d}.jpg'.format(pid, j % 6 + 1, iid)
            shw = size_table[iid % 3] if mixed else hw
            im = rng.randint(0, 256, shw + (3,), dtype=np.uint8)
            cv2.imwrite(os.path.join(imdir, name), im)
            images.append({'id': iid, 'file_name': name,
                           'height': shw[0], 'width': shw[1]})
            anns.append({'id': iid, 'image_id': iid, 'category_id': pid,
                         'mark': 1})
    ann_fn = os.path.join(root, 'trainval.json')
    with open(ann_fn, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': [{'id': p, 'name': str(p)}
                                  for p in range(1, n_ids + 1)]}, f)
    return imdir, ann_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--n-ids', type=int, default=751)
    ap.add_argument('--per-id', type=int, default=12)
    ap.add_argument('--epochs', type=int, default=2)
    ap.add_argument('--device-augment', default='True')
    ap.add_argument('--mixed-sizes', action='store_true',
                    help='non-uniform decode sizes (padded-bucket wire)')
    ap.add_argument('--workers', type=int, default=2)
    ap.add_argument('--data-dir', default=None)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    from pps_tpu_torch.config import merge_cfg_from_list
    from pps_tpu_torch.data.catalog import register_dataset
    from pps_tpu_torch.engine.train import train_model

    dev = resolve_device(args.device)
    root = args.data_dir or tempfile.mkdtemp(prefix='pps_e2e_')
    if not os.path.exists(os.path.join(root, 'trainval.json')):
        print('writing synthetic dataset to %s ...' % root, flush=True)
        make_dataset(root, args.n_ids, args.per_id, mixed=args.mixed_sizes)
    register_dataset('synth_e2e_trainval', os.path.join(root, 'images'),
                     os.path.join(root, 'trainval.json'))

    cfg = common.tool_cfg(num_classes=args.n_ids + 1)
    cfg.immutable(False)  # tool_cfg froze it; amend the run knobs
    out_dir = os.path.join(root, 'out_%d' % os.getpid())
    merge_cfg_from_list([
        'TRAIN.DATASETS', "('synth_e2e_trainval',)",
        'SOLVER.MAX_ITER', str(args.epochs),
        'TPU.DEVICE_AUGMENT', args.device_augment,
        # fresh run dir per invocation: reusing one would hit the
        # model_final.pkl training-complete marker (auto-resume contract)
        # and benchmark nothing
        'OUTPUT_DIR', out_dir,
    ])
    t0 = time.perf_counter()
    checkpoints = train_model(cfg, num_workers=args.workers, log_period=20,
                              device=dev)
    return {'seconds': time.perf_counter() - t0, 'epochs': args.epochs,
            'images': args.n_ids * args.per_id, 'data_dir': root,
            'final': checkpoints.get('final'),
            'device_kind': common.device_kind(dev)}


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    try:
        main()
    finally:
        write_launch_counts()
