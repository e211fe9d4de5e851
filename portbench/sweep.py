"""The highest rate a serving cell sustains: its open loop at each of a
list of rates, set up once.  A rate is sustained when every request
completes and the latency does not grow through the run (the median of
the last quarter of requests within twice that of the first quarter).

    python3 -m portbench.sweep --workload <name> --seed <n> \
        --rates 50,100,200 --seconds 10

Prints one JSON line per rate.  The cell's traffic file then states four
fifths of the highest sustained rate; the benchmark never searches for a
rate itself.
"""

import argparse
import json
import sys

from portbench import core
from portbench import run as run_lib


def sweep(workload, seed, rates, seconds, device, bench=None):
    from portbench.drivers import open_loop_search as drv
    args = run_lib.parse(['--workload', workload, '--seed', str(seed),
                          '--seconds', str(seconds)])
    run = run_lib.Run(args, device, bench)
    st = drv.setup(run)
    rows = []
    for rate in rates:
        out = drv.serve(st, rate, seconds)
        lat, lag = drv.lateness(out['due'], out['sent'], out['done'])
        q = max(1, len(lat) // 4)
        first = core.percentile(lat[:q], 50)
        last = core.percentile(lat[-q:], 50)
        c0, c1 = out['c0'], out['c1']
        row = {'rate': rate, 'requests': len(lat),
               'failed': sum(1 for x in lat if x == float('inf')),
               'p50_ms': 1e3 * core.percentile(lat, 50),
               'p95_ms': 1e3 * core.percentile(lat, 95),
               'first_quarter_p50_ms': 1e3 * first,
               'last_quarter_p50_ms': 1e3 * last,
               'lag_p95_ms': 1e3 * core.percentile(lag, 95),
               'embed_batch_mean': (c1['images'] - c0['images']) / max(
                   1, c1['dispatches'] - c0['dispatches']),
               'search_batch_mean': (c1['queries'] - c0['queries']) / max(
                   1, c1['scans'] - c0['scans'])}
        row['sustained'] = bool(row['failed'] == 0 and last <= 2 * first)
        rows.append(row)
        print(json.dumps(row), flush=True)
    drv.free(st)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--rates', required=True)
    p.add_argument('--seconds', type=float, default=10.0)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('portbench.sweep: needs a CUDA card', file=sys.stderr)
        return 2
    sweep(a.workload, a.seed, [float(r) for r in a.rates.split(',')],
          a.seconds, torch.device('cuda', 0))
    return 0


if __name__ == '__main__':
    sys.exit(main())
