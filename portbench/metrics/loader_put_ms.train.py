"""Host ms a step spent pinning batches and issuing their copies to the
card: the program's ``transfer.put`` spans (``device.Transfer.put``, the
loader's) over the count of its ``train_step`` spans, in the untraced
window (``portbench/program_spans.py``)."""

from portbench import program_spans


def read(run):
    d = program_spans.durations(run, ['transfer.put', 'train_step'])
    if d is None:
        return None
    return 1e3 * sum(d['transfer.put']) / len(d['train_step'])
