"""What the per-layer metric readers share (``portbench/metrics/``): each
reader takes the run and returns its number, or None where the run has
nothing to read."""

from portbench import yardstick


def summary(run):
    return run.tracer.summary if run.tracer is not None else None


def idle_share(run):
    """Per cent of the traced stretch in which no kernel ran."""
    s = summary(run)
    if not s or s['wall_s'] <= 0 or not s['launches']:
        return None
    return 100.0 * (1.0 - s['busy_s'] / s['wall_s'])


def category_share(run, cats):
    """Per cent of the traced kernel time in the categories ``cats``."""
    s = summary(run)
    if not s or not s['kernels']:
        return None
    roll = yardstick.rollup((k, v[0]) for k, v in s['kernels'].items())
    total = sum(roll.values())
    return 100.0 * sum(roll[c] for c in cats) / total if total else None


def peak(run):
    return yardstick.PEAKS[run.config['precision']]


def mfu(run, flops_per_img):
    """Per cent of the configuration's peak: ``flops_per_img`` times the
    images per second of the window before the traced stretch."""
    rate = run.record.get('untraced_imgs_per_s')
    if not rate:
        return None
    return 100.0 * flops_per_img * rate / peak(run)
