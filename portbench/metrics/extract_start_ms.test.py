"""The median ms from a streamed pass's entry to its first decoded batch:
the program's ``extract.start`` span (``engine/test.stream_extract``
building its extract functions, ``Transfer`` and pool, and the first
decode), over the passes before the traced one
(``portbench/program_spans.py``)."""

from portbench import program_spans


def read(run):
    return program_spans.median_ms(run, 'extract.start')
