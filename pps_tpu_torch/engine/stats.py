"""Per-iteration training statistics and the ``json_stats:`` line
(counterpart of ``pps_tpu/engine/stats.py``).

The train step returns its logs as 0-d tensors on the device; reading
each back every iteration would stall the queue of steps.
``UpdateIterStats`` therefore keeps the device dicts and reads them back
only when a line is emitted, one stacked copy per iteration.
"""

import datetime

import numpy as np
import torch

from pps_tpu_torch.utils.logging import SmoothedValue, log_json_stats
from pps_tpu_torch.utils.timer import Timer


class TrainingStats(object):
    LOG_PERIOD = 20
    WIN_SZ = 20

    def __init__(self, max_iter, log_period=None, device=None, emit=True):
        """emit False: drain and check the logs at each line's step, but
        print nothing (the ranks after rank 0 of a data mesh)."""
        self.max_iter = max_iter
        self.emit = emit
        if log_period:
            self.LOG_PERIOD = log_period
        self.device = torch.device('cpu' if device is None else device)
        self.iter_timer = Timer()
        self.smoothed_losses_and_metrics = {}
        self.smoothed_total_loss = SmoothedValue(self.WIN_SZ)
        # loader prepared-ahead depth
        self.smoothed_mb_qsize = SmoothedValue(self.WIN_SZ)
        self._pending = []
        # None until the first drain, so a NaN check cannot fire on it
        self.iter_total_loss = None

    def IterTic(self):
        self.iter_timer.tic()

    def IterToc(self):
        return self.iter_timer.toc(average=False)

    def ResetIterTimer(self):
        self.iter_timer.reset()

    def UpdateIterStats(self, logs, mb_qsize=None):
        """logs: dict of 0-d tensors from the train step.
        mb_qsize: loader prepared-ahead depth (a host int, gauged now)."""
        self._pending.append(logs)
        if mb_qsize is not None:
            self.smoothed_mb_qsize.AddValue(mb_qsize)

    def _drain(self):
        for logs in self._pending:
            keys = list(logs)
            vals = torch.stack([torch.as_tensor(logs[k]).float().reshape(())
                                for k in keys]).cpu().tolist()
            host = dict(zip(keys, vals))
            for k, v in host.items():
                if k in ('lr',):
                    continue
                if k not in self.smoothed_losses_and_metrics:
                    self.smoothed_losses_and_metrics[k] = SmoothedValue(
                        self.WIN_SZ)
                self.smoothed_losses_and_metrics[k].AddValue(v)
            self.iter_total_loss = host.get('loss', np.nan)
            self.smoothed_total_loss.AddValue(self.iter_total_loss)
        self._pending = []

    def loss_is_nan(self):
        return (self.iter_total_loss is not None
                and np.isnan(self.iter_total_loss))

    def LogIterStats(self, cur_iter, lr, extra=None, force=False):
        if (force or cur_iter % self.LOG_PERIOD == 0
                or cur_iter == self.max_iter - 1):
            self._drain()
            if not self.emit:
                return
            stats = self.GetStats(cur_iter, lr)
            if extra:
                stats.update(extra)
            log_json_stats(stats)

    def GetStats(self, cur_iter, lr):
        eta_seconds = self.iter_timer.average_time * (
            self.max_iter - cur_iter)
        eta = str(datetime.timedelta(seconds=int(eta_seconds)))
        stats = dict(
            iter=cur_iter,
            lr=float(lr),
            time=self.iter_timer.average_time,
            eta=eta,
            loss=self.smoothed_total_loss.GetMedianValue(),
        )
        if self.smoothed_mb_qsize.count:
            stats['mb_qsize'] = int(
                np.round(self.smoothed_mb_qsize.GetAverageValue()))
        mem = device_mem_mb(self.device)
        if mem is not None:
            stats['mem'] = mem
        for k, v in self.smoothed_losses_and_metrics.items():
            stats[k] = v.GetMedianValue()
        return stats


def device_mem_mb(device):
    """MB allocated by tensors on a CUDA ``device``; None on the CPU."""
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    return int(torch.cuda.memory_allocated(device) / (1024 * 1024))
