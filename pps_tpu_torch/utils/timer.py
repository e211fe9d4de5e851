"""Wall-clock and device timers (counterpart of ``pps_tpu/utils/timer.py``).

``Timer``: tic/toc with a running average.  ``slope_time``: the JAX
package's two-N slope protocol, with completion forced by a synchronise
on the card.  ``cuda_ms``: mean device milliseconds per call from CUDA
events.
"""

import time

import torch


class Timer(object):
    def __init__(self):
        self.reset()

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average=True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0


def _first_tensor(out):
    """The first tensor in ``out`` (a tensor, or nested tuples, lists and
    dicts of them), or None."""
    if torch.is_tensor(out):
        return out
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _synchronize(out):
    """Wait for the card that holds ``out``'s first tensor; nothing for a
    CPU tensor (its work is done when the call returns)."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def slope_time(fn, consume=None, iters=20, warmup=3):
    """Seconds per call of ``fn``: run it N times and force completion once,
    for N = 2 and N = 2 + ``iters``; the per-call time is the slope, so the
    fixed cost of one forced completion cancels.

    fn: nullary callable returning a tensor (or tuples, lists, dicts of
      them).
    consume: callable(out) forcing completion; defaults to a
      ``torch.cuda.synchronize`` of the card that holds ``out``'s first
      tensor, and to nothing for a CPU tensor.
    warmup: single-call runs before the two timed ones.
    """
    if consume is None:
        consume = _synchronize

    def run(n):
        out = None
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        consume(out)
        return time.perf_counter() - t0

    for _ in range(warmup):
        run(1)
    t_small = run(2)
    t_big = run(2 + iters)
    return (t_big - t_small) / iters


def cuda_ms(fn, iters, warmup=3):
    """Mean device milliseconds per call of ``fn`` on the current stream,
    from CUDA events around ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
