"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a profile of the window's last stretch.
Every run checks what the window produced against the plain reference and
prints each compared number beside its limit, last on standard error and
last in the result line.  Exits 2 without a CUDA card (or with fewer than
the cell asks for), 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compile cache at a fixed path inside the checkout (the nvcc builds
# go to build/pps_tpu_torch_kernels/, where the program puts them)
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'portbench',
                                              'triton')
os.environ.setdefault('USE_FLAX', '0')
os.environ.setdefault('USE_JAX', '0')
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pps_tpu')


class Run:
    """One run of one cell: its files, seeds, clock and what it records."""

    def __init__(self, args, device, bench=None, t0=None):
        from portbench import core
        self.bench = bench or core.Bench()
        self.cell = self.bench.cell(args.workload)
        self.config = self.bench.config(self.cell['config'])
        self.traffic = self.bench.traffic(self.cell['traffic'])
        self.limits = self.bench.limits(self.cell['name'])
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.clock = core.Clock(T_START if t0 is None else t0)
        self.e2e, self.record = {}, {}
        self.attempted = self.failed = 0
        self.tracer = core.Tracer(device) if self.trace else None
        from portbench import yardstick
        self.yard_flops = yardstick.model_fwd_flops(self.config['sizes'])


def driver(run):
    return importlib.import_module('portbench.drivers.' +
                                   run.traffic['kind'])


def loaded_forbidden():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def execute(args, device, bench=None, t0=None):
    """Set up, run the window, check; returns the result dict (without
    printing)."""
    import torch
    run = Run(args, device, bench, t0)
    drv = driver(run)
    if run.tracer is not None:
        run.tracer.warm()
    st = drv.setup(run)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    run.e2e['setup_s'] = run.record['setup_s'] = run.clock.now()
    drv.window(run, st)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    drv.free(st)
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    checks = drv.judge(run, st)
    return assemble(run, checks, peak)


def assemble(run, checks, peak):
    import torch
    limits = run.limits['checks']
    compared = {k: {'value': checks[k], 'limit': v}
                for k, v in limits.items()}
    run.record['not_compared'] = {k: v for k, v in checks.items()
                                  if k not in limits}
    correct = (run.failed == 0 and run.attempted > 0 and
               all(c['value'] <= c['limit'] for c in compared.values()))
    if run.trace:
        metrics = {}
        s = run.tracer.summary
        for m in run.bench.metrics(run.cell['name'], 'per_layer'):
            v = run.bench.reader(m['name'])(run)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': run.e2e[m['name']],
                               'unit': m['unit']}
                   for m in run.bench.metrics(run.cell['name'],
                                              'end_to_end')}
    dev = run.device
    device = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
              'kind': (torch.cuda.get_device_name(dev)
                       if dev.type == 'cuda' else 'cpu'),
              'count': run.cell['chips'], 'memory_peak_bytes': int(peak)}
    out = {'correct': bool(correct), 'attempted': run.attempted,
           'failed': run.failed, 'metrics': metrics, 'device': device}
    if run.trace:
        device['busy_s'] = s['busy_s']
        device['window_s'] = s['wall_s']
        run.record['trace'] = {
            'kernel_s': sum(v[0] for v in s['kernels'].values()),
            'linked_s': s['launched_device_s'],
            'span_device_s': s['span_device_s']}
        from portbench import core
        out['breakdown'] = core.breakdown(s)
    out['record'] = run.record
    out['checks'] = compared
    return out


def finite(x):
    """``x`` with every non-finite float (a tail that lies in failed
    requests) as None, so the line stays strict JSON."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def card_facts():
    """nvidia-smi's name, clocks and power limit of the card, or None."""
    import subprocess
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,clocks.sm,clocks.max.sm,'
             'power.limit,temperature.gpu', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch
    from portbench import core
    need = core.Bench().cell(args.workload)['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print('portbench: needs {} CUDA card(s), found {}'.format(
            need, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 2
    out = finite(execute(args, torch.device('cuda', 0)))
    found = loaded_forbidden()
    if found:
        print('portbench: loaded in this process: {}'.format(
            ', '.join(found)), file=sys.stderr)
        return 3
    print('card: {}'.format(card_facts()), file=sys.stderr)
    print('record: {}'.format(json.dumps(out.pop('record'))),
          file=sys.stderr)
    for k, c in out['checks'].items():
        print('check {}: {!r} (limit {!r})'.format(k, c['value'],
                                                    c['limit']),
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
