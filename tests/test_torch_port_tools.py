"""The port's measurement tools (``pps_tpu_torch/tools``) and the shared
pieces they stand on, against the JAX package on the same numpy inputs.

* ``utils/timer.slope_time`` against ``pps_tpu.utils.timer.slope_time``
  under one fake clock: the same arithmetic, so the same seconds exactly.
* ``ops/distance.euclidean_distmat``: ``fast=False`` against pps_tpu's
  within rtol 1e-5 (float32 sums in another order); ``fast=True`` against
  pps_tpu's ``fast=True`` within 1e-5 absolute: both round the cross
  term's operands to bf16 and sum the products in float32, so they differ
  by sum order only (bf16 products are exact in float32), where either
  differs from the float32 matrix by the bf16 rounding, ~1e-3.
* ``tools/trace_top_ops``'s analysis of a CPU ``torch.profiler`` capture.
* each tool of this file run through ``main`` on the CPU with the model
  narrowed (``tools/common.tool_cfg``): its printed lines and JSON keys,
  those of the JAX tool where it prints JSON.
"""

import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pps_tpu.ops import distance as jdist
from pps_tpu.utils import timer as jtimer
from pps_tpu_torch.ops import distance as tdist
from pps_tpu_torch.tools import trace_top_ops
from pps_tpu_torch.utils import timer as ttimer

from _torch_port_tools_common import (  # noqa: F401 (fixtures)
    _fresh_port_cfg, _grad_enabled, _two_threads, narrow, tmp_path)

TOOLS = ('trace_top_ops', 'profile_train_step', 'bench_int8',
         'bench_distmat', 'bench_exact_scan', 'bench_rerank',
         'bench_serving', 'bench_ivf_recall', 'bench_train_e2e',
         'data_loader_benchmark')

# tools/bench_int8.py:99-114
BENCH_INT8_KEYS = {
    'imgs_per_sec_per_chip', 'int8_speedup_vs_bf16', 'int8_speedup_vs_fold',
    'fold_speedup_vs_bf16', 'int8_cosine_vs_bf16_min',
    'int8_cosine_vs_bf16_mean', 'calib_quantize_seconds', 'depth', 'batch',
    'device_kind'}


class FakeClock(object):
    """time.perf_counter that moves only when the timed code runs: each
    call of ``fn`` takes FN_S, each ``consume`` CONSUME_S."""
    FN_S, CONSUME_S = 0.25, 4.0

    def __init__(self):
        self.now = 100.0
        self.fn_calls = 0
        self.consumes = 0

    def __call__(self):
        return self.now

    def fn(self):
        self.fn_calls += 1
        self.now += self.FN_S
        return torch.zeros(1)

    def consume(self, out):
        self.consumes += 1
        self.now += self.CONSUME_S


@pytest.mark.parametrize('iters,warmup', [(20, 3), (5, 0), (1, 2)])
def test_slope_time_matches_pps_tpu(monkeypatch, iters, warmup):
    got, want = [], []
    for impl, out in ((ttimer.slope_time, got), (jtimer.slope_time, want)):
        clock = FakeClock()
        monkeypatch.setattr(time, 'perf_counter', clock)
        sec = impl(clock.fn, consume=clock.consume, iters=iters,
                   warmup=warmup)
        out.append((sec, clock.fn_calls, clock.consumes))
    assert got == want
    sec, fn_calls, consumes = got[0]
    # the forced completion's fixed cost cancels in the slope
    assert sec == FakeClock.FN_S
    # one consume per run: the warm-up runs and the two timed ones
    assert consumes == warmup + 2
    assert fn_calls == warmup + 2 + (2 + iters)


def test_slope_time_default_consume_on_the_cpu(monkeypatch):
    """A CPU result needs no forced completion (no synchronise); nested
    outputs are searched for their first tensor."""
    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda *a, **k: synced.append(a))
    x = torch.ones(8)
    for fn in (lambda: {'a': (x + 1, [x])}, lambda: None):
        assert isinstance(ttimer.slope_time(fn, iters=2, warmup=1), float)
    assert synced == []
    assert ttimer._first_tensor(({'a': 1}, [None, x])) is x
    assert ttimer._first_tensor([{'b': None}]) is None


def _unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize('nq,ng,d', [(33, 70, 128), (5, 300, 3968)])
def test_distmat_matches_pps_tpu(nq, ng, d):
    rng = np.random.RandomState(nq)
    q, g = _unit(rng, nq, d), _unit(rng, ng, d)
    want = np.asarray(jdist.euclidean_distmat(jnp.asarray(q), jnp.asarray(g)))
    got = tdist.euclidean_distmat(torch.tensor(q), torch.tensor(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want_fast = np.asarray(jdist.euclidean_distmat(
        jnp.asarray(q), jnp.asarray(g), fast=True))
    got_fast = tdist.euclidean_distmat(torch.tensor(q), torch.tensor(g),
                                       fast=True).numpy()
    np.testing.assert_allclose(got_fast, want_fast, rtol=0, atol=1e-5)
    # the flag takes effect: bf16 operands move the distances ~1e-3
    assert np.abs(got_fast - got).max() > 1e-5


def test_distmat_fast_blocked_equals_one_block(monkeypatch):
    rng = np.random.RandomState(1)
    q, g = torch.tensor(_unit(rng, 20, 64)), torch.tensor(_unit(rng, 30, 64))
    whole = tdist.euclidean_distmat(q, g, fast=True)
    monkeypatch.setattr(tdist, 'SINGLE_BLOCK_MAX_ELEMS', 100)
    blocked = tdist.euclidean_distmat(q, g, block_q=7, fast=True)
    assert torch.equal(blocked, whole)


@pytest.mark.parametrize('name,cat', [
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc',
     'conv_gemm'),
    ('void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_32x6_tn>',
     'conv_gemm'),
    ('conv2d_int8_wgmma', 'conv2d_int8'),
    ('void at::native::unrolled_elementwise_kernel<at::native::'
     'direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>',
     'cast_copy'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::'
     'CUDAFunctor_add<float>, std::array<char*, 3ul> >', 'elementwise'),
    ('void at::native::elementwise_kernel<128, 2, at::native::'
     'gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, float, '
     'at::native::binary_internal::MulFunctor<float> > >', 'elementwise'),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>',
     'reduction'),
    ('Memcpy HtoD (Pageable -> Device)', 'memcpy'),
    ('ncclDevKernel_AllReduce_Sum_f32_RING_LL', 'collective'),
    ('aten::mkldnn_convolution', 'conv_gemm'),
    ('aten::sum', 'reduction'),
    ('aten::mul', 'elementwise'),
    ('zero_even_kernel', 'other'),
])
def test_category_of_kernel_names(name, cat):
    assert trace_top_ops.category(name) == cat
    assert cat in trace_top_ops.CATEGORIES


def test_trace_analysis_of_a_cpu_capture(capsys):
    from torch.profiler import ProfilerActivity, profile
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.ReLU(),
                              torch.nn.Conv2d(8, 4, 1))
    x = torch.randn(2, 3, 16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            net(x).sum().backward()
    rows, total = trace_top_ops.kernel_rows(prof, 'cpu')
    assert rows and total > 0
    us = [r['self_us'] for r in rows]
    assert us == sorted(us, reverse=True)
    assert abs(sum(r['share'] for r in rows) - 1.0) < 1e-9
    assert all(r['name'] and r['occurrences'] > 0 for r in rows)
    cats = trace_top_ops.rollup(rows)
    assert set(cats) == set(trace_top_ops.CATEGORIES)
    assert abs(sum(cats.values()) - total) < 1e-6 * total
    assert cats['conv_gemm'] > 0
    out = trace_top_ops.analyze(prof, 4, torch.device('cpu'), 1e9, 0.5,
                                989e12, 'bf16')
    assert len(out['top']) == 4 and out['n_rows'] == len(rows)
    assert out['top_share_pct'] <= 100.0 + 1e-9
    # a CPU run names no device metric
    assert out['flop_utilization'] is None and out['idle_share'] is None
    assert 'not measured' in capsys.readouterr().out


def test_flop_utilization_arithmetic():
    # model FLOPs over the traced wall window, as a share of the peak
    assert trace_top_ops.flop_utilization(989e12 * 0.5, 2.0, 989e12) == 0.25
    flops = 3 * 10e9 * 64 * 4  # 3 passes x 10 GFLOP x 64 images x 4 steps
    assert trace_top_ops.flop_utilization(flops, 0.5, 989e12) == \
        pytest.approx(flops / 0.5 / 989e12, rel=1e-15)


@pytest.mark.parametrize('tool', TOOLS)
def test_tool_needs_a_card_unless_cpu_is_asked_for(tool):
    mod = importlib.import_module('pps_tpu_torch.tools.' + tool)
    assert callable(mod.main)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main([])


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith('{')]


def test_trace_top_ops_main_on_the_cpu(narrow, tmp_path, capsys):
    out = trace_top_ops.main(['--device', 'cpu', '--batch', '8',
                              '--steps', '1', '--top', '5',
                              '--trace-dir', str(tmp_path)])
    text = capsys.readouterr().out
    assert os.path.getsize(os.path.join(tmp_path, 'trace.json')) > 0
    for line in ('top-5 ops cover', 'category rollup:',
                 'HBM bandwidth utilization: not measured'):
        assert line in text
    assert out['path'] == 'train_step' and len(out['top']) == 5
    (line,) = _json_lines(text)
    assert [r[0] for r in line['top']] == [r['name'][:80]
                                           for r in out['top']]
    with pytest.raises(SystemExit):
        trace_top_ops.main(['--device', 'cpu', '--batch', '12'])


def test_trace_top_ops_eval_int8_on_the_cpu(narrow, tmp_path):
    out = trace_top_ops.main(['--device', 'cpu', '--batch', '2',
                              '--steps', '1', '--eval', '--int8',
                              '--trace-dir', str(tmp_path)])
    assert out['path'] == 'eval_int8' and out['top']


def test_profile_train_step_main_on_the_cpu(narrow, tmp_path, capsys):
    from pps_tpu_torch.tools import profile_train_step
    out = profile_train_step.main(['--device', 'cpu', '--batch', '8',
                                   '--iters', '1',
                                   '--profile-dir', str(tmp_path)])
    text = capsys.readouterr().out
    for name in ('eval_fwd', 'train_fwd', 'train_grad', 'full_step',
                 'u8aug_step'):
        assert text.count(name) == 1 and name in out
        assert out[name]['ms'] > 0
    assert 'of resident-f32 rate' in text
    assert 'model fwd GFLOPs/img' in text
    assert os.path.exists(os.path.join(tmp_path, 'full_step', 'trace.json'))
    with pytest.raises(SystemExit):
        profile_train_step.main(['--device', 'cpu', '--batch', '12'])


def test_bench_int8_main_on_the_cpu(narrow, monkeypatch, capsys):
    from pps_tpu_torch.tools import bench_int8
    monkeypatch.setattr(bench_int8, 'BATCH', 8)
    out = bench_int8.main(['--device', 'cpu'], iters=1, warmup=1)
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == BENCH_INT8_KEYS == set(out)
    assert set(out['imgs_per_sec_per_chip']) == {'bf16', 'bf16_fold', 'int8'}
    assert out['batch'] == 8 and out['device_kind'] == 'cpu'
    assert out['int8_cosine_vs_bf16_min'] >= 0.99


def test_bench_distmat_main_on_the_cpu(capsys):
    from pps_tpu_torch.tools import bench_distmat
    out = bench_distmat.main(['--device', 'cpu', '--nq', '16', '--ng', '40',
                              '--d', '64'], iters=2)
    text = capsys.readouterr().out
    assert text.count('TFLOP/s  max|d-dref|=') == 2
    assert out['f32']['max_abs_diff'] == 0.0
    assert 0 < out['fast']['max_abs_diff'] < 1e-2


def test_data_loader_benchmark_main_on_the_cpu(capsys):
    from pps_tpu_torch.tools import data_loader_benchmark
    out = data_loader_benchmark.main(['--device', 'cpu', '--batches', '2',
                                      '--batch-size', '4', '--workers', '1',
                                      '2'])
    text = capsys.readouterr().out
    assert text.count('imgs/s') == 2
    assert set(out['imgs_per_s']) == {1, 2}
    assert all(v > 0 for v in out['imgs_per_s'].values())


def test_bench_train_e2e_main_on_the_cpu(narrow, tmp_path, capsys,
                                        monkeypatch):
    from pps_tpu_torch.data import catalog
    from pps_tpu_torch.tools import bench_train_e2e
    # the tool registers its dataset in the process's catalog
    monkeypatch.setattr(catalog, '_CATALOG', dict(catalog._CATALOG))
    out = bench_train_e2e.main(['--device', 'cpu', '--n-ids', '8',
                                '--per-id', '2', '--epochs', '1',
                                '--workers', '1', '--data-dir',
                                str(tmp_path)])
    assert 'json_stats:' in capsys.readouterr().out
    assert os.path.exists(out['final']) and out['images'] == 16
