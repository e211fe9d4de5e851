"""A tiny benchmark for the CPU tests: the harness's own files (drivers,
metric readers) under a temporary root whose ``BENCHMARK.json``,
configuration, traffic and limit files cut the real ones to a size the
CPU runs in seconds (96 x 32 inputs, 3 strips of 16, 8 classes)."""

import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CUT = ['REID.SCALE', '(32, 96)', 'REID.BPM_DIM', '16',
       'REID.BPM_STRIP_NUM', '3', 'MODEL.NUM_CLASSES', '9', 'REID.P', '4',
       'REID.K', '2', 'TRAIN.IMS_PER_BATCH', '8',
       'TPU.INT8_CALIB_IMAGES', '16', 'TEST.IMS_PER_BATCH', '8']
SIZES = {'depth': 50, 'scale': [32, 96], 'res5_stride': 1, 'strips': 3,
         'bpm_dim': 16, 'num_classes': 9, 'dtype': 'bfloat16'}
TRAFFIC = {
    'tiny-train': {'kind': 'train', 'ids': 8, 'images': 64,
                   'decode_hw': [32, 16], 'epoch': 11, 'checked_steps': 3,
                   'warm_steps': 2, 'trace_seconds': 0.5},
    'tiny-test': {'kind': 'test_pass', 'ids': 6, 'queries': 12,
                  'gallery': 48, 'decode_hw': [32, 16], 'batch': 8,
                  'check_rows': 8},
    'tiny-serve': {'kind': 'open_loop_search', 'gallery_rows': 65536,
                   'decode_hw': [32, 16], 'crops': 64, 'k': 10,
                   'max_batch': 16, 'rate': 20, 'workers': 16,
                   'trace_seconds': 0.5, 'check_requests': 8,
                   'reading_seconds': 1.0},
}
# set from the tiny cells' own readings on the CPU, as the real ones are
LIMITS = {
    't-train': {'loss_gap': 5e-4, 'grad_gap_median': 2e-4,
                'change_gap_median': 3e-3},
    't-test': {'emb_gap': 0.015, 'map_gap': 1e-9, 'cmc_gap': 1e-9},
    't-test8': {'emb_gap': 0.08, 'map_gap': 1e-9, 'cmc_gap': 1e-9},
    't-serve': {'emb_gap': 0.08, 'rank_gap': 0.015, 'dist_gap': 0.015},
}
CELLS = [('t-train', 'tiny32', 'tiny-train'), ('t-test', 'tiny', 'tiny-test'),
         ('t-test8', 'tiny-int8', 'tiny-test'),
         ('t-serve', 'tiny-int8', 'tiny-serve')]


def config(name, yaml, precision, int8, dtype='bfloat16'):
    over = CUT + (['MODEL.DTYPE', dtype] if dtype != 'bfloat16' else [])
    return {'name': name, 'source': 'tiny', 'yaml': str(ROOT / yaml),
            'overrides': over, 'precision': precision, 'branch_scale': 0.01,
            'sizes': dict(SIZES, int8=int8, dtype=dtype), 'reduced': []}


def make(root):
    """Write the tiny benchmark under ``root``; returns a ``core.Bench``."""
    from portbench import core
    root = Path(root)
    pb = root / 'portbench'
    for sub in ('configs', 'traffic', 'limits'):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / 'portbench' / 'metrics', pb / 'metrics',
                    dirs_exist_ok=True)
    confs = {'tiny': config('tiny', 'configs/market1501/'
                            'pps_crm_triplet_R-50_1x.yaml', 'bfloat16',
                            False),
             'tiny32': config('tiny32', 'configs/market1501/'
                              'pps_crm_triplet_R-50_1x.yaml', 'bfloat16',
                              False, 'float32'),
             'tiny-int8': config('tiny-int8', 'configs/market1501/'
                                 'pps_crm_triplet_R-50_1x_int8.yaml', 'int8',
                                 True)}
    for n, c in confs.items():
        (pb / 'configs' / (n + '.json')).write_text(json.dumps(c))
    for n, t in TRAFFIC.items():
        (pb / 'traffic' / (n + '.json')).write_text(json.dumps(t))
    for n, lim in LIMITS.items():
        (pb / 'limits' / (n + '.json')).write_text(json.dumps(
            {'checks': lim}))
    kinds = {'tiny-train': 'train', 'tiny-test': 'test',
             'tiny-serve': 'serve'}
    moves = {'train': 'train_imgs_per_s', 'test': 'test_imgs_per_s',
             'serve': 'query_p95_ms'}
    e2e = [{'name': moves[k], 'unit': 'x', 'better': 'higher', 'bound': 0.25,
            'source': 'host_clock',
            'workloads': [c for c, _, mix in CELLS if kinds[mix] == k]}
           for k in moves]
    e2e.append({'name': 'setup_s', 'unit': 's', 'better': 'lower',
                'bound': 0.25, 'source': 'host_clock'})
    per_layer = []
    for f in sorted((pb / 'metrics').glob('*.py')):
        name = f.name[:-3]
        kind = next(k for k in moves if name.endswith(k) or
                    name.startswith(k + '_'))
        cells = [c for c, _, mix in CELLS if kinds[mix] == kind and
                 (name != 'conv2d_int8_roofline.test' or c == 't-test8')]
        per_layer.append({'name': name, 'unit': 'x', 'better': 'higher',
                          'source': 'host_clock', 'layer': 'x',
                          'moves': moves[kind], 'workloads': cells})
    bench = {
        'command': ['python3', '-m', 'portbench.run'],
        'paths': ['portbench'], 'run_seconds': 2,
        'configs': [{'name': n, 'source': 'tiny',
                     'file': 'portbench/configs/{}.json'.format(n),
                     'reduced': [], 'why': 'tiny'} for n in confs],
        'workloads': [{'name': c, 'config': conf, 'traffic': mix,
                       'chips': 1, 'why': 'tiny'} for c, conf, mix in CELLS],
        'end_to_end': e2e, 'per_layer': per_layer}
    (root / 'BENCHMARK.json').write_text(json.dumps(bench, indent=1))
    return core.Bench(root)


def args(cell, seed=3000000001, seconds=1.5, trace=0):
    from portbench import run
    return run.parse(['--workload', cell, '--seed', str(seed), '--seconds',
                      str(seconds), '--trace', str(trace)])


def cpu_threads():
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
