"""``pps_tpu_torch/utils/trace.py``, the port's span ring, and the spans the
port records with it (CPU, tiny sizes): a span's record and nesting, the
ring's bound, the offset onto a ``torch.profiler`` timeline, and the spans
of ``ReIDLoader.iter_epoch``, one train step and ``stream_extract``."""

import ast
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data.loader import ReIDLoader
from pps_tpu_torch.engine import test as test_lib
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.models.model import build_model
from pps_tpu_torch.parallel.train_step import make_train_step
from pps_tpu_torch.solver import optimizer as opt_lib
from pps_tpu_torch.utils import trace

RAW_HW = (48, 20)
N_IDS, PER_ID, B = 6, 4, 8


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads: the suite runs six workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    return flagship_cfg(scale=(32, 96), num_classes=N_IDS + 1,
                        ims_per_batch=B, p=4, k=2, dtype='float32')


@pytest.fixture(scope='module')
def model():
    m = build_model(_cfg(), device='cpu')
    params, state = m.init(torch.Generator().manual_seed(0))
    tcfg.reset_cfg()
    return m, params, state


def _decode(key):
    rng = np.random.RandomState(int(key))
    return rng.randint(0, 256, RAW_HW + (3,)).astype(np.uint8)


def _train_roidb():
    return [{'image': str(i), 'gt_class': i // PER_ID + 1, 'flipped': False,
             'height': RAW_HW[0], 'width': RAW_HW[1]}
            for i in range(N_IDS * PER_ID)]


def _named(records, name):
    return [r for r in records if r[0] == name]


def test_a_span_records_name_thread_and_stamps_and_nests():
    trace.clear()
    t0 = time.perf_counter_ns()
    with trace.span('outer'):
        with trace.span('inner'):
            pass
        with pytest.raises(ValueError):
            with trace.span('raised'):
                raise ValueError
    t1 = time.perf_counter_ns()
    got = trace.spans()
    # appended when each ends: the children before their parent
    assert [r[0] for r in got] == ['inner', 'raised', 'outer']
    me = threading.get_ident()
    for name, thread, s0, s1 in got:
        assert thread == me
        assert isinstance(s0, int) and isinstance(s1, int)
        assert t0 <= s0 <= s1 <= t1
    outer = got[-1]
    for child in got[:2]:
        assert outer[2] <= child[2] <= child[3] <= outer[3]
    assert got[0][3] <= got[1][2]
    trace.clear()
    assert trace.spans() == []


def test_another_thread_records_its_own_id():
    trace.clear()
    ids = []

    def work():
        ids.append(threading.get_ident())
        with trace.span('worker'):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    (rec,) = trace.spans()
    assert rec[0] == 'worker' and rec[1] == ids[0] != threading.get_ident()


def test_the_ring_drops_its_oldest_record():
    trace.clear()
    extra = 5
    for i in range(trace.CAPACITY + extra):
        with trace.span(i):
            pass
    got = trace.spans()
    assert trace.CAPACITY == 65536
    assert len(got) == trace.CAPACITY
    assert got[0][0] == extra and got[-1][0] == trace.CAPACITY + extra - 1
    trace.clear()


def test_the_offset_places_a_span_on_the_profiler_timeline():
    from torch.profiler import ProfilerActivity, profile, record_function
    # a process's first record_function is entered ~0.7 ms after its stamp
    for _ in range(2):
        trace.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function('trace_probe'):
                with trace.span('probe'):
                    time.sleep(0.002)
    offset = trace.profiler_offset_ns()
    (rec,) = trace.spans()
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == 'trace_probe']
    assert len(starts) == 1
    assert abs(rec[2] + offset - starts[0]) < 1_000_000
    trace.clear()


def test_the_loader_records_a_wait_and_a_put_per_step():
    cfg = _cfg()
    loader = ReIDLoader(_train_roidb(), cfg, num_workers=2, decode_fn=_decode,
                        device='cpu', device_prefetch=2)
    trace.clear()
    steps = sum(1 for _ in loader.iter_epoch(0))
    got = trace.spans()
    me = threading.get_ident()
    assert steps == loader.schedule.epoch_len(0) == N_IDS * PER_ID // B
    waits, puts = _named(got, 'loader.wait'), _named(got, 'transfer.put')
    assert len(waits) == steps and len(puts) >= steps
    assert all(r[1] == me for r in waits + puts)


def test_a_train_step_records_one_span_holding_one_sgd(model):
    m, params, state = model
    cfg = _cfg()
    loader = ReIDLoader(_train_roidb(), cfg, num_workers=1, decode_fn=_decode,
                        device='cpu')
    batches = loader.iter_epoch(0)
    _, scale, batch = next(batches)
    batches.close()
    step = make_train_step(m, cfg, opt_lib.make_param_meta(params, cfg),
                           device='cpu')
    ts = {'params': params, 'state': state,
          'opt': opt_lib.init_opt_state(params)}
    trace.clear()
    _, logs = step(ts, batch, 0.01, scale, torch.Generator().manual_seed(1))
    assert np.isfinite(float(logs['loss']))
    got = trace.spans()
    (outer,) = _named(got, 'train_step')
    (sgd,) = _named(got, 'optimizer.sgd')
    assert outer[2] <= sgd[2] <= sgd[3] <= outer[3]
    assert got[-1] == outer


def test_stream_extract_records_its_spans(model):
    m, params, state = model
    cfg = _cfg()
    n, batch = 20, 8
    roidb = [{'image': str(i)} for i in range(n)]
    trace.clear()
    feats = test_lib.stream_extract(cfg, m, params, state, roidb, batch,
                                    decode_fn=_decode, num_workers=2)
    assert feats.shape == (n, m.embedding_dim)
    got = trace.spans()
    batches = -(-n // batch)
    (whole,) = _named(got, 'extract')
    assert len(_named(got, 'extract.start')) == 1
    assert len(_named(got, 'extract.decode_wait')) == batches - 1
    assert len(_named(got, 'extract.readback')) == batches
    assert len(_named(got, 'transfer.put')) == batches
    for rec in got:
        assert whole[2] <= rec[2] <= rec[3] <= whole[3], rec
    (start,) = _named(got, 'extract.start')
    assert start[2] - whole[2] < start[3] - start[2]
    assert all(r[2] >= start[3] for r in _named(got, 'extract.decode_wait'))


def test_the_trace_module_imports_the_standard_library_only():
    path = Path(trace.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split('.')[0])
    assert names and names <= set(sys.stdlib_module_names)
    assert not names & {'torch', 'pps_tpu', 'pps_tpu_torch', 'numpy'}
