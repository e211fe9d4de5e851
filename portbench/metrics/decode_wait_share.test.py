"""Per cent of the streamed passes' time the host spent blocked on the
decode pool: the program's ``extract.decode_wait`` spans (every batch
after a pass's first) over its ``extract`` spans
(``engine/test.stream_extract``), over the passes before the traced one
(``portbench/program_spans.py``)."""

from portbench import program_spans


def read(run):
    return program_spans.share(run, 'extract.decode_wait', 'extract')
