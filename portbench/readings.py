"""The readings a cell's limits are set from: the compared numbers of the
program on many seeds (the lower reading) and of the control, the
reference one precision lower in the program's place, on a few (the upper
reading).  Set-up and the check only, no measured window; every seed in
one process.

    python3 -m portbench.readings --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--out FILE]

Prints one JSON line per seed: {"seed", "program": {...}, "control":
{...}}.  Needs the card, as a run does.
"""

import argparse
import gc
import json
import sys

from portbench import run as run_lib


def readings(workload, seeds, control_seeds, device, bench=None, out=None,
             fault=None):
    """[{'seed', 'program', 'control'?}] for each seed; with ``fault``
    (a name in ``faults.FAULTS``) the program runs with it planted."""
    import contextlib
    import torch
    from portbench import faults
    rows = []
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        _readings(workload, seeds, control_seeds, device, bench, out, rows)
    return rows


def _readings(workload, seeds, control_seeds, device, bench, out, rows):
    import torch
    for seed in list(dict.fromkeys(list(seeds) + list(control_seeds))):
        args = run_lib.parse(['--workload', workload, '--seed', str(seed),
                              '--seconds', '0'])
        run = run_lib.Run(args, device, bench)
        drv = run_lib.driver(run)
        st = drv.setup(run)
        row = {'seed': seed}
        if seed in control_seeds:
            row['control'] = drv.control(run, st)
        if seed in seeds:
            if hasattr(drv, 'reading_window'):
                drv.reading_window(run, st)
            row['program'] = drv.judge(run, st)
        row['record'] = run.record
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, 'a') as f:
                f.write(line + '\n')
        drv.free(st)
        del st, run
        gc.collect()
        if device.type == 'cuda':
            torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--out')
    p.add_argument('--fault')
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('portbench.readings: needs a CUDA card', file=sys.stderr)
        return 2

    def ints(s):
        return [int(x) for x in s.split(',') if x]
    readings(a.workload, ints(a.seeds), ints(a.control_seeds),
             torch.device('cuda', 0), out=a.out, fault=a.fault)
    return 0


if __name__ == '__main__':
    sys.exit(main())
