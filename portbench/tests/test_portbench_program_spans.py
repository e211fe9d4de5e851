"""The readers of the program's spans (``portbench/program_spans.py`` and
the seven metrics that use it) on fake runs with a hand-made ring (CPU,
no model): each one's arithmetic, its selection of the untraced window
[W0, W1), and None where there is nothing to read, as on a commit whose
program has no ring."""

import sys
from types import SimpleNamespace

import pytest

from portbench import core, program_spans

BENCH = core.Bench()
TRAIN = ['train-market-r50-pk64']
TEST = ['test-market-r50-int8', 'test-market-r50-bf16']
# name: (unit, layer, cells)
METRICS = {
    'loader_wait_share.train': ('%', 'data/loader.py', TRAIN),
    'loader_put_ms.train': ('ms', 'device.py Transfer', TRAIN),
    'step_issue_ms.train': ('ms', 'parallel/train_step.py', TRAIN),
    'sgd_issue_ms.train': ('ms', 'solver/optimizer.py', TRAIN),
    'extract_start_ms.test': ('ms', 'engine/test.py stream_extract', TEST),
    'decode_wait_share.test': ('%', 'engine/test.py decode pool', TEST),
    'readback_share.test': ('%', 'the device', TEST),
}
MS = 1_000_000  # ns
# the run's clock starts at 100 s; set-up takes 10 s; the profile starts
# 2 s into the window: [W0, W1) = [110 s, 112 s).  W0 + wall_s - the traced
# wall (112.5 s) would take in spans the profile covers (``outside``)
T0, SETUP, TRACED_FROM = 100.0, 10.0, 112.0
W0, W1 = int(110e9), int(112e9)


def fake_run(tracer=True):
    tr = SimpleNamespace(_t0=TRACED_FROM, summary={'wall_s': 1.0}) \
        if tracer else None
    return SimpleNamespace(clock=SimpleNamespace(t0=T0), tracer=tr,
                           record={'setup_s': SETUP, 'wall_s': 3.5})


def at(name, start_ms, dur_ms, thread=1):
    """A record ``start_ms`` after W0."""
    s = W0 + int(start_ms * MS)
    return (name, thread, s, s + int(dur_ms * MS))


# each kind of span once outside the window: before W0, across W0, across
# W1, after W1
def outside(name):
    return [(name, 1, W0 - 5 * MS, W0 - 4 * MS),
            (name, 1, W0 - MS, W0 + MS),
            (name, 1, W1 - MS, W1 + MS),
            (name, 1, W1 + MS, W1 + 2 * MS)]


TRAIN_RING = (
    [at('loader.wait', 0, 4), at('transfer.put', 4, 1),
     at('transfer.put', 5, 2), at('train_step', 10, 100),
     at('optimizer.sgd', 60, 30),
     at('loader.wait', 200, 6), at('transfer.put', 206, 3),
     at('train_step', 210, 120), at('optimizer.sgd', 260, 10),
     at('train_step', 400, 110), at('optimizer.sgd', 450, 20)]
    + outside('loader.wait') + outside('transfer.put')
    + outside('train_step') + outside('optimizer.sgd'))
TEST_RING = (
    # pass 1: 100 ms, start 20, two decode waits, three readbacks
    [at('extract.start', 0, 20), at('extract.decode_wait', 30, 5),
     at('extract.decode_wait', 50, 3), at('extract.readback', 40, 4),
     at('extract.readback', 60, 6), at('extract.readback', 90, 8),
     at('extract', 0, 100),
     # pass 2: 300 ms, start 40
     at('extract.start', 500, 40), at('extract.decode_wait', 600, 12),
     at('extract.readback', 700, 20), at('extract', 500, 300)]
    + outside('extract') + outside('extract.start')
    + outside('extract.decode_wait') + outside('extract.readback'))
EXPECTED = {
    'loader_wait_share.train': 100.0 * (4 + 6) / 2000.0,
    'loader_put_ms.train': (1 + 2 + 3) / 3.0,
    'step_issue_ms.train': 110.0,
    'sgd_issue_ms.train': 20.0,
    'extract_start_ms.test': 30.0,
    'decode_wait_share.test': 100.0 * (5 + 3 + 12) / 400.0,
    'readback_share.test': 100.0 * (4 + 6 + 8 + 20) / 400.0,
}


@pytest.fixture
def ring(monkeypatch):
    """Sets the records ``trace.spans()`` returns."""
    from pps_tpu_torch.utils import trace
    held = []
    monkeypatch.setattr(trace, 'spans', lambda: list(held))

    def put(records):
        held[:] = sorted(records, key=lambda r: r[3])
    return put


def ring_for(name):
    return TRAIN_RING if name.endswith('.train') else TEST_RING


def test_the_entries_are_the_seven_named():
    got = {m['name']: m for m in BENCH.data['per_layer']
           if m['name'] in METRICS}
    assert sorted(got) == sorted(METRICS)
    for name, (unit, layer, cells) in METRICS.items():
        m = got[name]
        assert (m['unit'], m['layer'], m['workloads']) == (unit, layer,
                                                           cells)
        assert m['better'] == 'lower' and m['source'] == 'program_counter'
        assert m['moves'] == ('train_imgs_per_s' if cells == TRAIN
                              else 'test_imgs_per_s')


@pytest.mark.parametrize('name', sorted(METRICS))
def test_each_reader_reads_the_window(ring, name):
    ring(ring_for(name))
    assert BENCH.reader(name)(fake_run()) == pytest.approx(EXPECTED[name])


def test_the_window_is_setup_to_the_profile():
    assert program_spans.window_ns(fake_run()) == (W0, W1)
    assert program_spans.window_ns(fake_run(tracer=False)) is None


def test_a_span_must_lie_wholly_inside(ring):
    ring(outside('train_step'))
    assert program_spans.durations(fake_run(), ['train_step']) is None
    ring(outside('train_step') + [('train_step', 1, W0, W0 + MS),
                                  ('train_step', 1, W1 - MS, W1 - 1)])
    d = program_spans.durations(fake_run(), ['train_step'])
    assert d['train_step'] == pytest.approx([1e-3, 1e-3 - 1e-9])


@pytest.mark.parametrize('name', sorted(METRICS))
def test_none_without_the_programs_ring(monkeypatch, ring, name):
    """As at a commit whose program has no ``utils/trace.py``."""
    import pps_tpu_torch.utils
    ring(ring_for(name))
    monkeypatch.delattr(pps_tpu_torch.utils, 'trace')
    monkeypatch.setitem(sys.modules, 'pps_tpu_torch.utils.trace', None)
    assert BENCH.reader(name)(fake_run()) is None


@pytest.mark.parametrize('name', sorted(METRICS))
def test_none_where_the_window_holds_no_such_span(ring, name):
    other = TEST_RING if name.endswith('.train') else TRAIN_RING
    ring(other)
    assert BENCH.reader(name)(fake_run()) is None
    ring([])
    assert BENCH.reader(name)(fake_run()) is None


@pytest.mark.parametrize('name', sorted(METRICS))
def test_none_without_a_profile(ring, name):
    ring(ring_for(name))
    assert BENCH.reader(name)(fake_run(tracer=False)) is None


def test_a_full_ring_reads_only_if_it_reaches_back_past_w0(ring,
                                                           monkeypatch):
    from pps_tpu_torch.utils import trace
    records = TRAIN_RING
    monkeypatch.setattr(trace, 'CAPACITY', len(records))
    ring(records)  # the oldest record ends before W0: nothing dropped
    assert program_spans.median_ms(fake_run(), 'train_step') == \
        pytest.approx(110.0)
    ring([r for r in records if r[3] > W0] +
         [at('loader.wait', 900, 1)] * (len(records) -
                                        sum(r[3] > W0 for r in records)))
    assert program_spans.median_ms(fake_run(), 'train_step') is None
