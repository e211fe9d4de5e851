"""Per cent of the traced stretch in which no kernel ran on the card
(1 - the union of the kernels' intervals over the stretch's wall)."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
