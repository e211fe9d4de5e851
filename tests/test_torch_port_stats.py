"""The port's TrainingStats prints the same ``json_stats:`` line as
pps_tpu's for the same logs (apart from time, eta and mem), reading the
device logs back lazily."""

import json

import numpy as np
import pytest
import torch

from pps_tpu.engine.stats import TrainingStats as JStats
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.stats import TrainingStats, device_mem_mb
from pps_tpu_torch.utils.logging import SmoothedValue
from pps_tpu_torch.utils.timer import Timer


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _logs(i):
    rng = np.random.RandomState(i)
    v = rng.rand(4).astype(np.float32)
    return {'loss': v[0] * 10, 'accuracy_cls': v[1], 'pps0_loss': v[2],
            'crm_loss': v[3], 'lr': np.float32(0.01)}


def _lines(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(ln[len('json_stats: '):]) for ln in out
            if ln.startswith('json_stats: ')]


def test_json_stats_line_matches(capsys):
    ours, theirs = TrainingStats(30, log_period=5), JStats(30, log_period=5)
    for it in range(12):
        logs = _logs(it)
        ours.UpdateIterStats({k: torch.tensor(v) for k, v in logs.items()},
                             mb_qsize=it % 3)
        theirs.UpdateIterStats({k: np.asarray(v) for k, v in logs.items()},
                               mb_qsize=it % 3)
        ours.LogIterStats(it, 0.01)
        got = _lines(capsys)
        theirs.LogIterStats(it, 0.01)
        want = _lines(capsys)
        assert len(got) == len(want) == (1 if it % 5 == 0 else 0)
        for g, w in zip(got, want):
            for k in ('time', 'eta', 'mem'):
                g.pop(k, None)
                w.pop(k, None)
            assert g == w
    assert not ours.loss_is_nan()


def test_drain_is_lazy_and_nan_is_seen():
    stats = TrainingStats(10, log_period=4)
    stats.UpdateIterStats({'loss': torch.tensor(float('nan'))})
    assert stats.iter_total_loss is None and not stats.loss_is_nan()
    stats.LogIterStats(1, 0.1)           # not a log iteration: no drain
    assert stats.iter_total_loss is None
    stats.LogIterStats(4, 0.1)
    assert stats.loss_is_nan()


def test_device_mem_is_none_on_the_cpu():
    assert device_mem_mb('cpu') is None
    assert 'mem' not in TrainingStats(2).GetStats(0, 0.1)


def test_smoothed_value_and_timer():
    sv = SmoothedValue(3)
    for v in (1.0, 5.0, 2.0, 9.0):
        sv.AddValue(v)
    assert sv.GetMedianValue() == 5.0 and sv.GetAverageValue() == 16 / 3
    assert sv.series == [1.0, 5.0, 2.0, 9.0] and sv.count == 4
    t = Timer()
    t.tic()
    assert t.toc(average=False) >= 0 and t.calls == 1
