"""The test pass's share of the card's peak: the forward FLOPs per image x
the images per second of the passes before the traced one, over the peak
of the precision the configuration declares (bf16 989 TFLOP/s, int8 1,979
TOP/s)."""

from portbench import readers


def read(run):
    return readers.mfu(run, run.record['fwd_flops'])
