"""Per-op profile of the flagship train step on the card (counterpart of
``tools/trace_top_ops.py``).

Captures a ``torch.profiler`` trace (CPU and CUDA activities) of N chained
train steps (the shipped step: uint8 augment wire -> forward -> backward ->
SGD, P 8 x K batch/8), writes it as a Chrome trace, and prints the top-K
device kernels by self time, a category rollup, the device FLOP
utilisation and the device's idle share over the traced window.

    python -m pps_tpu_torch.tools.trace_top_ops [--batch 64] [--steps 10]
        [--top 15] [--dtype bfloat16] [--trace-dir DIR] [--device cuda|cpu]
        [--eval [--int8]]   # batched extraction (the int8 PTQ graph)

On the CPU (``--device cpu``) the rows are the CPU's aten ops by self
time.  ``torch.profiler`` counts no bytes, so the memory bandwidth
utilisation is not measured.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common

CATEGORIES = ('conv2d_int8', 'conv_gemm', 'elementwise', 'reduction',
              'cast_copy', 'memcpy', 'collective', 'other')

# name fragments per category, tried in CATEGORIES' order after
# conv2d_int8 (lower case; a CUDA kernel's name or an aten op's)
_FRAGMENTS = (
    ('collective', ('nccl', 'allreduce', 'all_reduce', 'allgather',
                    'all_gather', 'broadcast', 'reducescatter', 'gloo',
                    'c10d')),
    ('memcpy', ('memcpy', 'memset')),
    ('conv_gemm', ('conv', 'gemm', 'cudnn', 'cublas', 'cutlass', 'xmma',
                   'wgrad', 'dgrad', 'fprop', 'sm90_', 'sm80_', 'aten::mm',
                   'aten::bmm', 'aten::addmm', 'aten::matmul',
                   'aten::linear', 'mkldnn')),
    # a CUDA cast is a direct_copy kernel ('nocast' names every
    # elementwise kernel that does not cast)
    ('cast_copy', ('copy', 'aten::to', 'contiguous')),
    ('reduction', ('reduce', 'aten::sum', 'aten::mean', 'aten::amax',
                   'aten::max', 'aten::min', 'aten::norm', 'softmax',
                   'aten::var', 'aten::std', 'aten::topk', 'aten::sort',
                   'argmax', 'argmin', 'aten::cumsum', 'aten::prod',
                   'aten::all', 'aten::any')),
    ('elementwise', ('elementwise', 'aten::', 'index', 'scatter',
                     'gather', 'where', 'fill')),
)


def category(name):
    """One of ``CATEGORIES`` for a kernel or op name: the hand int8 conv
    its own row, then the first fragment that matches."""
    low = name.lower()
    if 'conv2d_int8' in low:
        return 'conv2d_int8'
    for cat, frags in _FRAGMENTS:
        if any(f in low for f in frags):
            return cat
    return 'other'


def _device_attr(avgs):
    """The name of an event's self device time (older torch: cuda)."""
    return ('self_device_time_total' if avgs and hasattr(
        avgs[0], 'self_device_time_total') else 'self_cuda_time_total')


def kernel_rows(prof, device_type):
    """Rows {'name', 'occurrences', 'self_us', 'share'} of the device's
    work in ``prof``, by self time, largest first; ``share`` is the row's
    part of the device's total (the shares sum to 1).  ``device_type``
    'cuda': the kernels' rows (a CPU op's row repeats its kernels' time);
    'cpu': the CPU's ops.  Returns (rows, total self us)."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    if device_type == 'cuda':
        want, attr = DeviceType.CUDA, _device_attr(avgs)
    else:
        want, attr = DeviceType.CPU, 'self_cpu_time_total'
    events = [e for e in avgs
              if e.device_type == want and getattr(e, attr) > 0]
    total = float(sum(getattr(e, attr) for e in events))
    rows = [{'name': e.key, 'occurrences': int(e.count),
             'self_us': float(getattr(e, attr)),
             'share': float(getattr(e, attr)) / total}
            for e in events]
    rows.sort(key=lambda r: -r['self_us'])
    return rows, total


def rollup(rows):
    """{category: self us} over every row (each row in one category)."""
    cats = dict.fromkeys(CATEGORIES, 0.0)
    for r in rows:
        cats[category(r['name'])] += r['self_us']
    return cats


def flop_utilization(flops, wall_s, peak):
    """Model FLOPs over the traced wall window, as a share of ``peak``."""
    return flops / wall_s / peak


def profile_rows(prof, top=15):
    """Print the profiler's table to stderr; return the top ``top`` kernel
    rows [name, device ms, count] and the total kernel time in us."""
    rows, device_us = kernel_rows(prof, 'cuda')
    avgs = prof.key_averages()
    print(avgs.table(sort_by=_device_attr(avgs), row_limit=30),
          file=sys.stderr, flush=True)
    return ([[r['name'][:80], r['self_us'] / 1e3, r['occurrences']]
             for r in rows[:top]], device_us)


def capture_trace(trace_dir, batch, steps, dev, eval_path=False,
                  dtype='bfloat16', int8=False):
    """Trace ``steps`` chained train steps (or extraction batches) on
    ``dev``; writes ``trace.json`` under ``trace_dir``.  Returns (cfg,
    profiler, traced wall seconds, images per step)."""
    from torch.profiler import ProfilerActivity, profile
    p = 8
    k = max(1, batch // p)
    if not eval_path and p * k != batch:
        raise SystemExit(
            '--batch {} is not a multiple of {} (the train step runs '
            'P x K triplet batches: P={} identities x K images); pick '
            'e.g. {} or {}'.format(batch, p, p, p * k, p * (k + 1)))
    # extraction takes any batch; the cfg's train batch stays P x K
    cfg = common.tool_cfg(ims_per_batch=p * k, p=p, k=k, dtype=dtype)
    model, params, state = common.seeded_model(cfg, dev)
    w, h = cfg.REID.SCALE
    rng = np.random.RandomState(0)
    activities = [ProfilerActivity.CPU]
    if dev.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)

    if eval_path:
        from pps_tpu_torch.parallel.eval_step import make_extract_fn
        if int8:
            # int8 PTQ serving graph (models/quantize.py, TPU.INT8_EVAL)
            from pps_tpu_torch.models.quantize import quantize_for_eval
            calib = (rng.randn(64, h, w, 3) * 50).astype(np.float32)
            params = quantize_for_eval(model, params, state, calib)
        fn = make_extract_fn(model, device=dev)
        x = torch.from_numpy(
            rng.randn(batch, h, w, 3).astype(np.float32)).to(dev)
        fn(params, state, x)  # first call: allocator, cuDNN set-up
        common.synchronize(dev)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn(params, state, x)
            common.synchronize(dev)
            wall = time.perf_counter() - t0
    else:
        step, ts = common.make_trainer(cfg, model, params, state, dev)
        db = common.u8_batch(rng, common.pk_labels(p, k), (h, w),
                             cfg.MODEL.NUM_CLASSES, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        ts, logs = step(ts, db, 0.01, 1.0, gen)  # first step
        float(logs['loss'])
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            # chained through the train state: each step consumes the
            # previous step's params
            for _ in range(steps):
                ts, logs = step(ts, db, 0.01, 1.0, gen)
            common.synchronize(dev)
            wall = time.perf_counter() - t0
    # the device work is over: what follows is host work on the capture
    print('traced %d %s in %.1f ms' % (steps, 'batches' if eval_path
                                        else 'steps', wall * 1e3),
          flush=True)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, 'trace.json'))
    return cfg, prof, wall, batch


def analyze(prof, top, dev, flops, wall_s, peak, peak_name):
    """Print the top rows, the category rollup, the FLOP utilisation and
    the idle share; return them as a dict."""
    rows, total = kernel_rows(prof, dev.type)
    total = total or 1.0
    print('\n%-4s %-12s %-52s %6s %9s %7s' %
          ('#', 'category', 'op (truncated)', 'occ', 'self-us', '%step'))
    acc = 0.0
    for i, r in enumerate(rows[:top]):
        acc += 100.0 * r['share']
        print('%-4d %-12s %-52s %6d %9.0f %6.1f%%' % (
            i + 1, category(r['name']), r['name'][:52], r['occurrences'],
            r['self_us'], 100.0 * r['share']))
    print('top-%d ops cover %.1f%% of device self time' % (top, acc))
    cats = rollup(rows)
    print('\ncategory rollup:')
    for c, t in sorted(cats.items(), key=lambda kv: -kv[1]):
        print('  %-28s %9.0f us  %5.1f%%' % (c, t, 100.0 * t / total))
    util = idle = None
    if dev.type == 'cuda':
        util = flop_utilization(flops, wall_s, peak)
        print('\ndevice FLOP utilization (model FLOPs / traced wall %.1f ms '
              '/ %s): %.1f%%' % (wall_s * 1e3, peak_name, 100.0 * util))
        idle = max(0.0, 1.0 - total / 1e6 / wall_s)
        print('device idle share of the traced window: %.1f%%'
              % (100.0 * idle))
    else:
        print('\ndevice FLOP utilization and idle share: not measured (a '
              'CPU run)')
    print('HBM bandwidth utilization: not measured (torch.profiler '
          'counts no bytes)')
    return {'top': [dict(r, category=category(r['name']))
                    for r in rows[:top]],
            'top_share_pct': acc, 'n_rows': len(rows),
            'categories_us': cats, 'device_us': total,
            'wall_ms': wall_s * 1e3, 'flop_utilization': util,
            'peak': peak_name, 'idle_share': idle,
            'hbm_bandwidth_utilization': None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--top', type=int, default=15)
    ap.add_argument('--eval', action='store_true')
    ap.add_argument('--int8', action='store_true',
                    help='with --eval: trace the int8 PTQ serving graph')
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--trace-dir', default=None)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    from pps_tpu_torch.utils.flops import (BF16_PEAK_FLOPS, INT8_PEAK_OPS,
                                           model_fwd_flops)
    dev = resolve_device(args.device)
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix='pps_trace_')
    cfg, prof, wall, imgs = capture_trace(
        trace_dir, args.batch, args.steps, dev, eval_path=args.eval,
        dtype=args.dtype, int8=args.int8)
    print('trace: %s' % os.path.join(trace_dir, 'trace.json'))
    passes = 1 if args.eval else 3  # forward; forward + backward
    flops = passes * model_fwd_flops(cfg) * imgs * args.steps
    if args.eval and args.int8:
        peak, peak_name = INT8_PEAK_OPS, '1979 TOP/s dense int8'
    else:
        peak, peak_name = BF16_PEAK_FLOPS, '989 TFLOP/s dense bf16'
    out = analyze(prof, args.top, dev, flops, wall, peak, peak_name)
    out.update(trace=os.path.join(trace_dir, 'trace.json'),
               path='eval_int8' if args.eval and args.int8 else
               'eval' if args.eval else 'train_step',
               batch=args.batch, steps=args.steps,
               device_kind=common.device_kind(dev))
    line = {k: out[k] for k in (
        'path', 'batch', 'steps', 'top_share_pct', 'device_us', 'wall_ms',
        'flop_utilization', 'idle_share', 'device_kind')}
    line['top'] = [[r['name'][:80], r['self_us'], r['share']]
                   for r in out['top']]
    print(json.dumps(line), flush=True)
    return out


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    try:
        main()
    finally:
        write_launch_counts()
