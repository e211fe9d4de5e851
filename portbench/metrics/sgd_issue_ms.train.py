"""The median host ms to issue the per-leaf momentum-SGD: the program's
``optimizer.sgd`` span (``solver/optimizer.sgd_update``), in the untraced
window (``portbench/program_spans.py``)."""

from portbench import program_spans


def read(run):
    return program_spans.median_ms(run, 'optimizer.sgd')
