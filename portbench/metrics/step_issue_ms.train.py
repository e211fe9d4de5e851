"""The median host ms to issue one train step: the program's
``train_step`` span (``parallel/train_step.py``; the step never syncs, so
this is issue time), in the untraced window
(``portbench/program_spans.py``)."""

from portbench import program_spans


def read(run):
    return program_spans.median_ms(run, 'train_step')
