"""Spans of the port's host work, kept in a bounded ring in memory.

``with span('loader.wait'): ...`` appends ``(name, thread_id, start_ns,
end_ns)`` to the ring when the block ends, both ends stamped with
``time.perf_counter_ns()``.  A span's parent is not stored: it is the
innermost span of the same thread that contains it (spans nest).  The
ring keeps the newest ``CAPACITY`` records; ``spans()`` copies it,
``clear()`` empties it.

Spans are always recorded: one costs under a microsecond, and
``deque.append`` is atomic under the interpreter lock, so every thread
shares the ring as it is.  The spans, where they sit and who reads them:

* ``loader.wait``: ``data/loader.py`` ``iter_epoch``, the consumer blocked
  for a decoded batch, once a step;
* ``transfer.put``: ``device.Transfer.put``, pinning and issuing the
  host-to-card copies (the loader and ``stream_extract``);
* ``train_step``: ``parallel/train_step.py``, the host time to issue a step;
* ``optimizer.sgd``: ``solver/optimizer.sgd_update``, the per-leaf update;
* ``extract``: ``engine/test.stream_extract``, one streamed pass, and
  inside it ``extract.start`` (entry to the first decoded batch),
  ``extract.decode_wait`` (the consumer blocked on the decode pool, every
  later batch) and ``extract.readback`` (a batch's features back).

The benchmark's readers (``portbench/program_spans.py``) select spans by
their stamps.  ``profiler_offset_ns()`` places a stamp on the PyTorch
profiler's timeline, whose events start in CLOCK_REALTIME ns:
``start_ns + profiler_offset_ns()``.

Imports the standard library only.
"""

import collections
import threading
import time

CAPACITY = 65536

_ring = collections.deque(maxlen=CAPACITY)
_now = time.perf_counter_ns
_thread = threading.get_ident


class span(object):
    """Context manager: one record in the ring when the block ends (also
    when it raises)."""

    __slots__ = ('name', 'start')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = _now()
        return self

    def __exit__(self, *exc):
        _ring.append((self.name, _thread(), self.start, _now()))
        return False


def spans():
    """The ring's records, oldest first, as a list."""
    return list(_ring)


def clear():
    _ring.clear()


def profiler_offset_ns():
    """CLOCK_REALTIME minus ``perf_counter_ns`` now, in ns."""
    return time.time_ns() - time.perf_counter_ns()
