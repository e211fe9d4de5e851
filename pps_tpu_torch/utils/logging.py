"""Logging helpers (counterpart of ``pps_tpu/utils/logging.py``).

Keeps the reference's single-line ``json_stats: {...}`` format, which
downstream log parsers (loss-vs-mAP plotting) read as an API.
"""

import json

import numpy as np


def log_json_stats(stats, sort_keys=True):
    # top-level floats printed with 6 decimals, as the reference does
    stats = {
        k: '{:.6f}'.format(v) if isinstance(v, float) else v
        for k, v in stats.items()
    }
    print('json_stats: {:s}'.format(json.dumps(stats, sort_keys=sort_keys)),
          flush=True)


class SmoothedValue(object):
    """Track a series of values and give its median and mean over a
    window."""

    def __init__(self, window_size):
        self.deque_vals = []
        self.window_size = window_size
        self.series = []
        self.total = 0.0
        self.count = 0

    def AddValue(self, value):
        self.deque_vals.append(value)
        if len(self.deque_vals) > self.window_size:
            self.deque_vals.pop(0)
        self.series.append(value)
        self.count += 1
        self.total += value

    def GetMedianValue(self):
        return float(np.median(self.deque_vals))

    def GetAverageValue(self):
        return float(np.mean(self.deque_vals))
