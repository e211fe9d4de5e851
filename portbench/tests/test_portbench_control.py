"""The check fails what it must (CPU, tiny sizes): the control, the plain
reference one precision below the configuration's in the program's place,
comes out not correct; and a run with the timed path broken underneath
(``portbench/faults.py``) comes out not correct, once for each fault the
cell can have.  The tiny cells' limits come from their own readings, as
the real cells' do (``_portbench_tiny.LIMITS``)."""

import pytest
import torch

import _portbench_tiny as tiny
from portbench import faults, readings
from portbench import run as run_lib


@pytest.fixture(scope='module')
def bench(tmp_path_factory):
    tiny.cpu_threads()
    return tiny.make(tmp_path_factory.mktemp('tiny'))


def fails(numbers, cell):
    lim = tiny.LIMITS[cell]
    return [k for k in lim if numbers[k] > lim[k]]


@pytest.mark.parametrize('cell', ['t-train', 't-test', 't-test8', 't-serve'])
def test_the_control_is_not_correct(bench, cell):
    rows = readings.readings(cell, [], [7, 8, 9], torch.device('cpu'),
                             bench)
    for row in rows:
        assert fails(row['control'], cell), row


@pytest.mark.parametrize('cell', ['t-train', 't-test', 't-test8', 't-serve'])
def test_sound_runs_are_correct(bench, cell):
    rows = readings.readings(cell, [1, 2], [], torch.device('cpu'), bench)
    for row in rows:
        assert not fails(row['program'], cell), row


@pytest.mark.parametrize('cell,fault', [
    ('t-train', 'state_unchanged'), ('t-train', 'half_batch'),
    ('t-test', 'answer_altered'), ('t-test8', 'answer_altered'),
    ('t-serve', 'answer_altered')])
def test_a_run_with_a_fault_is_not_correct(bench, cell, fault):
    with faults.FAULTS[fault]():
        out = run_lib.execute(tiny.args(cell, seconds=1.0),
                              torch.device('cpu'), bench)
    assert out['correct'] is False
    assert any(c['value'] > c['limit'] for c in out['checks'].values())
