"""What every cell shares: ``BENCHMARK.json`` and the files it names, the
seeds, the program's configuration, the profiler and the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in a file of its own, found by its name:

* ``portbench/configs/<config>.json``: the configuration as it is run
  (``BENCHMARK.json``'s ``file``);
* ``portbench/traffic/<mix>.json``: a traffic mix, the parameters of one
  of the drivers in ``portbench/drivers/`` (its ``kind``);
* ``portbench/metrics/<metric>.py``: the reader of a per-layer metric;
* ``portbench/limits/<cell>.json``: the limits of a cell's correctness
  comparison.
"""

import bisect
import importlib.util
import json
import math
import os
import re
import time
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        with open(self.root / 'BENCHMARK.json') as f:
            self.data = json.load(f)
        self.pkg = self.root / 'portbench'

    def cell(self, name):
        for w in self.data['workloads']:
            if w['name'] == name:
                return w
        raise KeyError('no workload {!r} in BENCHMARK.json'.format(name))

    def config(self, name):
        for c in self.data['configs']:
            if c['name'] == name:
                with open(self.root / c['file']) as f:
                    return json.load(f)
        raise KeyError('no config {!r} in BENCHMARK.json'.format(name))

    def traffic(self, name):
        with open(self.pkg / 'traffic' / (name + '.json')) as f:
            return json.load(f)

    def limits(self, cell):
        with open(self.pkg / 'limits' / (cell + '.json')) as f:
            return json.load(f)

    def metrics(self, cell, kind):
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.data[kind]
                if 'workloads' not in m or cell in m['workloads']]

    def reader(self, metric):
        """The ``read(run)`` function of a per-layer metric."""
        path = self.pkg / 'metrics' / (metric + '.py')
        spec = importlib.util.spec_from_file_location(
            'portbench_metric_' + metric.replace('.', '_'), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def sub_seeds(seed, names):
    """Independent 63-bit seeds, one per name, from the run's seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(
        len(names), np.uint64)
    return {n: int(s) >> 1 for n, s in zip(names, state)}


def program_cfg(config, root=ROOT):
    """The program's global configuration for a configuration file: its
    yaml, then its ``overrides`` (KEY VALUE pairs); checked against the
    sizes the file states."""
    from pps_tpu_torch import config as cfg_lib
    cfg_lib.reset_cfg()
    cfg_lib.merge_cfg_from_file(str(Path(root) / config['yaml']))
    cfg_lib.merge_cfg_from_list([str(v) for v in config.get('overrides',
                                                            [])])
    cfg_lib.assert_and_infer_cfg()
    cfg = cfg_lib.cfg
    s = config['sizes']
    stated = {'scale': list(cfg.REID.SCALE), 'strips': cfg.REID.BPM_STRIP_NUM,
              'bpm_dim': cfg.REID.BPM_DIM, 'num_classes': cfg.MODEL.NUM_CLASSES,
              'res5_stride': cfg.RESNETS.RES5_STRIDE,
              'depth': int(re.search(r'ResNet(\d+)',
                                     cfg.MODEL.CONV_BODY).group(1)),
              'dtype': cfg.MODEL.DTYPE, 'int8': bool(cfg.TPU.INT8_EVAL)}
    for k, v in stated.items():
        if s[k] != v:
            raise ValueError('{}: the yaml runs {} = {}, the file states {}'
                             .format(config['name'], k, v, s[k]))
    return cfg


def reference_spec(config):
    """The plain reference's static shape for a configuration file."""
    from portbench.reference import pps
    s = config['sizes']
    return pps.Spec(depth=s['depth'], num_classes=s['num_classes'],
                    strips=s['strips'], bpm_dim=s['bpm_dim'],
                    res5_stride=s['res5_stride'], height=s['scale'][1],
                    width=s['scale'][0])


def percentile(values, q):
    """The q-th percentile (0..100) of every value, linear between ranks."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Clock:
    """Host seconds since the process started (``setup_s`` counts from
    there)."""

    def __init__(self, t0=None):
        self.t0 = time.perf_counter() if t0 is None else t0

    def now(self):
        return time.perf_counter() - self.t0


class Tracer:
    """``torch.profiler`` over a stretch of the window (CUDA activity and
    the benchmark's ``record_function`` spans, which need the CPU
    activity), reduced to kernel intervals and spans."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.wall = None
        self.summary = None

    def warm(self):
        """One empty profile in set-up, so the profiler's own start-up does
        not fall into the window."""
        self.start()
        self.stop()
        self.summary = None

    def start(self, sync=True):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
            if sync:
                torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.wall = time.perf_counter() - self._t0
        self.prof.stop()
        self.summary = summarize(self.prof, self.wall)
        self.prof = None

    @property
    def active(self):
        return self.prof is not None


def _events(prof):
    """(kernels [(name, start_us, dur_us)], spans [(name, thread, start_us,
    end_us)], launches [(thread, start_us, kernel us)]) of a finished
    profile, read from the profiler's raw events (building its event tree
    takes minutes for a pass of a few hundred thousand launches).  A
    kernel is tied to the host op that launched it by the profiler's
    linked correlation id; spans and ops share the profiler's thread
    ids."""
    kernels, spans, ops, linked = [], [], {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        on_card = e.device_type().name == 'CUDA'
        if name.startswith('portbench.'):
            # the profiler mirrors each span on the card's timeline too
            if not on_card:
                spans.append((name, e.start_thread_id(), start,
                              start + dur))
        elif on_card:
            kernels.append((name, start, dur))
            c = e.linked_correlation_id()
            linked[c] = linked.get(c, 0.0) + dur
        else:
            ops[e.correlation_id()] = (e.start_thread_id(), start)
    launches = [ops[c] + (us,) for c, us in linked.items() if c in ops]
    return kernels, spans, launches


def summarize(prof, wall):
    """Kernel (seconds, launches) by name; the union of kernel intervals
    (busy seconds) and the traced wall; the longest idle gaps named by the
    innermost benchmark span the host was in; and the device seconds of
    the kernels launched inside each benchmark span (by its thread)."""
    kernels, spans, launches = _events(prof)
    by_name = {}
    for name, _, dur in kernels:
        sec, n = by_name.get(name, (0.0, 0))
        by_name[name] = (sec + dur * 1e-6, n + 1)
    busy, gaps = 0.0, []
    end = None
    for name, start, dur in sorted(kernels, key=lambda k: k[1]):
        if end is None or start > end:
            if end is not None:
                gaps.append((end, start))
            busy += dur
            end = start + dur
        elif start + dur > end:
            busy += start + dur - end
            end = start + dur
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (g0 + g1)
        inner = [s for s in spans if s[2] <= mid <= s[3]]
        label = min(inner, key=lambda s: s[3] - s[2])[0] if inner else \
            'outside the benchmark spans'
        named.append([label, (g1 - g0) * 1e-6])
    by_thread = {}
    for name, t, s0, s1 in sorted(spans, key=lambda s: s[2]):
        by_thread.setdefault(t, []).append((s0, s1, name))
    starts = {t: [s[0] for s in v] for t, v in by_thread.items()}
    under = {}
    for thread, start, us in launches:
        if thread not in by_thread:
            continue
        i = bisect.bisect_right(starts[thread], start) - 1
        # the innermost span holding the launch (spans nest, in order)
        for s0, s1, name in reversed(by_thread[thread][max(0, i - 8):i + 1]):
            if s0 <= start <= s1:
                under[name] = under.get(name, 0.0) + us * 1e-6
                break
    return {'kernels': by_name, 'busy_s': busy * 1e-6, 'wall_s': wall,
            'launches': len(kernels), 'idle_gaps': named,
            'span_device_s': under,
            'launched_device_s': sum(u for _, _, u in launches) * 1e-6}


def breakdown(summary):
    top = sorted(summary['kernels'].items(), key=lambda kv: -kv[1][0])[:10]
    return {'device_ops': [[k, v[0]] for k, v in top],
            'idle_gaps': summary['idle_gaps']}
