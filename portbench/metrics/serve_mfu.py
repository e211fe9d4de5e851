"""The served path's share of the card's peak over the window before the
traced stretch: the forward operations of the images embedded plus
2 x dim x gallery rows per query row scanned (padded rows included: the
card computes them), per second, over the configuration's declared
peak."""

from portbench import readers


def read(run):
    u = run.record.get('untraced')
    if not u or u['seconds'] <= 0:
        return None
    ops = (u['images'] * run.record['embed_flops'] +
           2.0 * run.record['dim'] * run.record['gallery_rows'] *
           u['scan_rows'])
    return 100.0 * ops / u['seconds'] / readers.peak(run)
