"""The benchmark's frozen arithmetic against its origins in the program
(CPU)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import yardstick  # noqa: E402

SIZES = {'depth': 50, 'scale': [128, 384], 'res5_stride': 1, 'strips': 5,
         'bpm_dim': 128, 'num_classes': 752}


@pytest.fixture
def flagship():
    from pps_tpu_torch.flagship import flagship_cfg
    return flagship_cfg()


def test_model_fwd_flops_matches_the_program(flagship):
    from pps_tpu_torch.utils import flops
    assert yardstick.model_fwd_flops(SIZES) == flops.model_fwd_flops(flagship)
    assert round(yardstick.model_fwd_flops(SIZES) / 1e9, 2) == 11.88


def test_peaks_match_the_program():
    from pps_tpu_torch.utils import flops
    assert yardstick.PEAKS['bfloat16'] == flops.BF16_PEAK_FLOPS
    assert yardstick.PEAKS['int8'] == flops.INT8_PEAK_OPS
    assert yardstick.HBM_BYTES_PER_S == flops.HBM_BYTES_PER_S


def test_body_convs_match_the_kernel_wrapper(flagship):
    from pps_tpu_torch.kernels import conv2d_int8 as ck
    from pps_tpu_torch.models import resnet
    theirs = ck.resnet_body_convs(resnet.resnet_spec(flagship, 50), 384, 128)
    ours = yardstick.body_convs(SIZES)
    assert len(ours) == 53
    # theirs: (name, c_in, h, w, c_out, k, stride, dilation, groups)
    assert ours == [(c[0],) + c[1:7] + (c[8],) for c in theirs]


@pytest.mark.parametrize('conv_i', [0, 1, 10, 52])
def test_int8_bound_matches_chip_smoke(conv_i):
    import chip_smoke
    conv = yardstick.body_convs(SIZES)[conv_i]
    name, cin, h, w, cout, k, s, g = conv
    dtype = torch.float32 if cin == 3 else torch.bfloat16
    x = torch.empty((64, cin, h, w), dtype=dtype)
    theirs = chip_smoke.int8_bound((name, cin, h, w, cout, k, s, 1, g), 64,
                                   x, 2)
    ours = yardstick.int8_bound(conv, 64, x.element_size(), 2)
    assert ours == pytest.approx(theirs, rel=1e-12)


def test_int8_body_bound_is_set_by_bytes():
    sec, by = yardstick.int8_body_bound(SIZES, 64)
    assert by == 'bytes'
    # PERF.md: 0.890 ms a batch of 64 (PR 7)
    assert sec * 1e3 == pytest.approx(0.890, abs=0.005)


NAMES = ['void conv2d_int8_wgmma<1>(CUtensorMap)', 'sm90_xmma_fprop_x',
         'void at::native::vectorized_elementwise_kernel<4, mul>',
         'void at::native::reduce_kernel<512, 1>', 'Memcpy HtoD (Pinned)',
         'void at::native::unrolled_elementwise_kernel<direct_copy>',
         'ncclDevKernel_AllReduce', 'aten::bmm', 'something else',
         'void at::native::index_elementwise_kernel', 'softmax_warp_forward']


@pytest.mark.parametrize('name', NAMES)
def test_category_matches_trace_top_ops(name):
    from pps_tpu_torch.tools import trace_top_ops
    assert yardstick.category(name) == trace_top_ops.category(name)
    assert yardstick.CATEGORIES == trace_top_ops.CATEGORIES


def test_rollup_sums_by_category():
    roll = yardstick.rollup([('aten::bmm', 1.0), ('reduce_kernel', 2.0),
                             ('aten::bmm', 0.5)])
    assert roll['conv_gemm'] == 1.5 and roll['reduction'] == 2.0
    assert sum(roll.values()) == 3.5


def test_scan_bytes_counts_each_byte_once():
    # int8 rows, a float32 scale and norm per row, float32 queries and
    # k (distance, index) pairs per query
    n, d, q, k = 1 << 20, 3968, 1, 10
    assert yardstick.scan_bytes(n, d, q, k) == n * d + 8 * n + 4 * d + 80
    # one query's scan over 3.35 TB/s: PERF.md's 1.24 ms byte bound
    assert yardstick.scan_bytes(n, d, q, k) / yardstick.HBM_BYTES_PER_S \
        == pytest.approx(1.244e-3, rel=2e-3)
