"""The exact scan's share of its roofline: one read of the gallery per
scan (``yardstick.scan_bytes``: int8 rows, a scale and a norm per row, the
padded query rows, the results) over the memory rate, for every scan of
the window, over the card's time between two CUDA events around each
``RetrievalIndex.search`` (the benchmark's proxy, on the batcher's
stream).  Kernels another thread queues between the events count in that
time, so the share reads low, never high.  The count is of the work, so
it holds whatever implements the scan."""

from portbench import yardstick


def read(run):
    timed = run.record.get('timed_scans')
    if not timed or not timed[0]:
        return None
    scans, rows_q, sec = timed
    n, dim, k = (run.record['gallery_rows'], run.record['dim'],
                 run.record['k'])
    # scan_bytes is linear in the query rows: sum it over the scans
    nbytes = scans * yardstick.scan_bytes(n, dim, 0, k) + \
        rows_q * (yardstick.scan_bytes(n, dim, 1, k) -
                  yardstick.scan_bytes(n, dim, 0, k))
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / sec
