"""Per cent of the untraced window the train loop spent blocked for a
decoded batch: the program's ``loader.wait`` spans
(``data/loader.py iter_epoch``, one a step, also when it does not wait)
over the window (``portbench/program_spans.py``)."""

from portbench import program_spans


def read(run):
    d = program_spans.durations(run, ['loader.wait'])
    if d is None:
        return None
    w0, w1 = program_spans.window_ns(run)
    return 100.0 * sum(d['loader.wait']) / ((w1 - w0) * 1e-9)
