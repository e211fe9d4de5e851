"""``conv2d_int8``'s share of its roofline: the least time the int8 body's
53 convs need per batch (``yardstick.int8_body_bound``, the larger of
operations over the int8 peak and bytes over the memory rate; bytes set
it) times the batches traced, over the traced device time of the
kernel's launches."""

from portbench import readers, yardstick


def read(run):
    s = readers.summary(run)
    if not s:
        return None
    convs = len(yardstick.body_convs(run.config['sizes']))
    sec = n = 0
    for name, (t, count) in s['kernels'].items():
        if yardstick.category(name) == 'conv2d_int8':
            sec += t
            n += count
    if not n:
        return None
    bound, _ = yardstick.int8_body_bound(run.config['sizes'],
                                         run.record['batch'])
    return 100.0 * bound * n / convs / sec
