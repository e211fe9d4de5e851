"""Per cent of the streamed passes' time the host spent blocked on the
card for a batch's features and their copy back: the program's
``extract.readback`` spans over its ``extract`` spans
(``engine/test.stream_extract``), over the passes before the traced one
(``portbench/program_spans.py``)."""

from portbench import program_spans


def read(run):
    return program_spans.share(run, 'extract.readback', 'extract')
