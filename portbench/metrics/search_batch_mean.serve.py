"""Query rows per device scan over the window (``SearchBatcher.queries /
.device_scans``): how far concurrent searches share one read of the
gallery."""


def read(run):
    n = run.record.get('scans')
    return run.record['queries'] / n if n else None
