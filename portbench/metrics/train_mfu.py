"""The whole train step's share of the card's peak: 3 x the forward FLOPs
per image (``yardstick.model_fwd_flops``) x the images per second of the
window before the traced stretch, over the configuration's peak."""

from portbench import readers


def read(run):
    return readers.mfu(run, 3 * run.record['fwd_flops'])
