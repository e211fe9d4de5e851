"""Logging helpers (counterpart of ``pps_tpu/utils/logging.py``).

Keeps the reference's single-line ``json_stats: {...}`` format, which
downstream log parsers (loss-vs-mAP plotting) read as an API.
"""

import json
import logging
import sys

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


def send_email(subject, body, to):
    """Failure notifier over local SMTP.  Delivery failures are logged,
    never raised: a missing mail daemon must not hide the failure being
    reported."""
    import smtplib
    from email.mime.text import MIMEText
    try:
        s = smtplib.SMTP('localhost')
        mime = MIMEText(body)
        mime['Subject'] = subject
        mime['To'] = to
        s.sendmail('pps_tpu_torch', to, mime.as_string())
        s.quit()
    except (OSError, smtplib.SMTPException) as e:
        logging.getLogger(__name__).warning('send_email to %s failed: %s',
                                            to, e)


def setup_logging(name):
    """INFO logging to stdout in the reference's format (root handlers
    cleared first, so an earlier basicConfig cannot block it)."""
    fmt = '%(levelname)s %(filename)s:%(lineno)4d: %(message)s'
    logging.root.handlers = []
    logging.basicConfig(level=logging.INFO, format=fmt, stream=sys.stdout)
    return logging.getLogger(name)
