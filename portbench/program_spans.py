"""The program's own spans (the ring of ``pps_tpu_torch/utils/trace.py``)
over the untraced part of a traced run's window, for the readers in
``portbench/metrics/``: the profiler's per-op cost stays out of them, as
it stays out of ``*_mfu``.

That part is [W0, W1) on the host's ``perf_counter`` clock, the ring's:
W0 = ``run.clock.t0 + setup_s``, where the window begins; W1 = where the
profile began (``Tracer.start`` stamps it).  ``W0 + wall_s`` less the
traced wall would also count the profiler's stop and its summary, which
the window's wall holds, and so reach into the traced stretch.  Only
spans wholly inside [W0, W1) count.

Each function returns None where there is nothing to read: the program
has no ring (a commit before it), the window holds no span of a name
asked for, or the ring is full and its oldest record ends after W0 (so
records of the window may have been dropped).  None raises.
"""

import statistics


def window_ns(run):
    """(W0, W1) in ns, or None for a run without a profile."""
    tracer = run.tracer
    setup = run.record.get('setup_s')
    t1 = getattr(tracer, '_t0', None)
    if setup is None or t1 is None:
        return None
    return int((run.clock.t0 + setup) * 1e9), int(t1 * 1e9)


def durations(run, names):
    """{name: [seconds of each span wholly inside the window]} for each of
    ``names``, or None."""
    try:
        from pps_tpu_torch.utils import trace
    except ImportError:
        return None
    w = window_ns(run)
    if w is None:
        return None
    w0, w1 = w
    ring = trace.spans()
    # the ring is in order of each span's end
    if len(ring) >= trace.CAPACITY and ring[0][3] > w0:
        return None
    out = {n: [] for n in names}
    for name, _, s0, s1 in ring:
        if name in out and w0 <= s0 and s1 < w1:
            out[name].append((s1 - s0) * 1e-9)
    return out if all(out.values()) else None


def median_ms(run, name):
    """The median span ``name``, in ms."""
    d = durations(run, [name])
    return None if d is None else 1e3 * statistics.median(d[name])


def share(run, part, whole):
    """Per cent of the spans ``whole``'s time in the spans ``part``."""
    d = durations(run, [part, whole])
    return None if d is None else 100.0 * sum(d[part]) / sum(d[whole])
