"""Per cent of the traced device time in elementwise, reduction and cast
kernels (``yardstick.category``): BN written out, forward and backward,
and the optimizer's passes."""

from portbench import readers


def read(run):
    return readers.category_share(run, ('elementwise', 'reduction',
                                        'cast_copy'))
