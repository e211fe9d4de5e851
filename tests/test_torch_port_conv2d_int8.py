"""conv2d_int8's routes and tiling on the CPU: ``route`` sends every conv
of the R-50 body to a ``wgmma`` route and the odd shapes to the general
kernel; the stem route's K layout (each kernel row's 21 values padded to 32
with zero weights, its input rows staged as the kernel's TMA boxes place
them) gives the plain version's int32 accumulators; and the persistent
schedule covers every output tile exactly once.  The kernel itself runs on
the card only (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import chip_smoke
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.kernels import conv2d_int8 as ck
from pps_tpu_torch.models import resnet as resnet_lib

# the R-50 body at the flagship's 384x128, and the extraction's batch
BATCH = chip_smoke.BATCH
TAIL = chip_smoke.INT8_TAIL


def _body_convs():
    cfg = flagship_cfg()
    w, h = cfg.REID.SCALE
    return ck.resnet_body_convs(resnet_lib.resnet_spec(cfg, 50), h, w)


BODY = _body_convs()
# (n, c_in, h, w, c_out, k, stride, dilation, groups): the checks' odd shapes
RAGGED = [(3, 64, 13, 7, 64, 3, 1, 1, 1), (3, 256, 13, 7, 128, 1, 1, 1, 1),
          (3, 512, 16, 10, 256, 1, 2, 1, 1), (2, 64, 12, 10, 96, 3, 1, 2, 1),
          (2, 256, 12, 10, 256, 3, 2, 1, 1), (1, 512, 24, 8, 2048, 1, 1, 1, 1),
          (2, 3, 96, 32, 64, 7, 2, 1, 1)]


def _dtype(cin):
    return torch.float32 if cin == 3 else torch.bfloat16


@pytest.mark.parametrize('conv', BODY, ids=[c[0] for c in BODY])
def test_route_takes_every_body_conv_to_wgmma(conv):
    name, cin, h, w, cout, k, s, d, g = conv
    r = ck.route(_dtype(cin), BATCH, cin, h, w, cout, k, k, s, d, g)
    assert r['kind'] == ('wgmma_stem' if name == 'conv1' else 'wgmma')
    assert r['bn'] in (64, 128, 256)
    bw, bh, bimg = r['box']
    assert bw * bh * bimg == ck.TILE_M
    # the tail batch's 60 real rows take the same route
    assert ck.route(_dtype(cin), TAIL, cin, h, w, cout, k, k, s, d,
                    g)['kind'] == r['kind']


@pytest.mark.parametrize('shape, why', [
    ((2, 8, 12, 10, 16, 3, 1, 1, 4), 'cg 2'),
    ((2, 64, 12, 10, 64, 3, 1, 1, 2), 'groups 2'),
    ((3, 64, 13, 7, 70, 3, 1, 1, 1), 'C_out % 8'),
    ((2, 96, 12, 10, 64, 3, 1, 1, 1), 'C_in % 64'),
    ((3, 3, 50, 30, 64, 7, 2, 1, 1), 'stem rows of 90 floats'),
    ((2, 3, 96, 32, 128, 7, 2, 1, 1), 'stem C_out > 64')])
def test_route_sends_odd_shapes_to_the_general_kernel(shape, why):
    n, cin, h, w, cout, k, s, d, g = shape
    assert ck.route(_dtype(cin), n, cin, h, w, cout, k, k, s, d,
                    g)['kind'] == 'general', why


def test_route_keeps_float32_body_inputs_on_the_general_kernel():
    assert ck.route(torch.float32, 4, 256, 24, 8, 256, 3, 3)['kind'] == \
        'general'
    assert ck.route(torch.bfloat16, 4, 256, 24, 8, 256, 3, 3)['kind'] == \
        'wgmma'


def test_stem_route_tiles_the_r50_stem_as_two_output_rows():
    r = ck.route(torch.float32, BATCH, 3, 384, 128, 64, 7, 7, 2)
    assert r['kind'] == 'wgmma_stem'
    assert r['box'] == (64, 2, 1) and r['out'] == (BATCH, 192, 64)
    assert r['m_tiles'] == BATCH * 96 and r['n_tiles'] == 1
    # 9 input rows, each 2 boxes of 224 floats (the 399 needed + 3 of
    # alignment); 16,128 bytes a ring stage
    assert ck._stem_boxes(64, 2, 3, 7, 7, 2, 1) == (9, 224, 2)


def _stem_route_accumulators(x, wq, xinv, stride, dilation):
    """The stem route's int32 sums in plain PyTorch, index for index: each
    tile's input rows staged as its TMA boxes place them (zeros past the
    edges, the first box started up to 3 floats early so it sits on 16
    bytes), K laid out per kernel row (kw * c_in values, then zero weights
    up to 32), A @ B^T exact in float64."""
    n, cin, h, w = x.shape
    cout, kh, kw, _ = wq.shape
    r = ck.route(x.dtype, n, cin, h, w, cout, kh, kw, stride, dilation)
    assert r['kind'] == 'wgmma_stem'
    bw, bh, _ = r['box']
    _, ho, wo = r['out']
    rows_in, box_w, nbox = ck._stem_boxes(bw, bh, cin, kh, kw, stride,
                                          dilation)
    row_floats = nbox * box_w
    ph, pw = ((kh - 1) * dilation) // 2, ((kw - 1) * dilation) // 2
    krow = kw * cin
    # quantize(0) = 0, so quantizing before staging equals the kernel's
    # quantize of the staged (zero-padded) floats
    q = ck.quantize_input(x, xinv).double().permute(0, 2, 3, 1).reshape(
        n, h, w * cin)
    b = torch.zeros(cout, kh, 32, dtype=torch.float64)
    b[:, :, :krow] = wq.reshape(cout, kh, krow).double()
    b = b.reshape(cout, kh * 32)
    colofs = torch.tensor([(kk // cin) * dilation * cin + kk % cin
                           if kk < krow else 0 for kk in range(32)])
    rows = torch.arange(ck.TILE_M)
    ohl, owl = rows // bw, rows % bw
    idx = ((ohl * stride)[:, None, None] +
           (torch.arange(kh) * dilation)[None, :, None]) * row_floats + \
        (owl * stride * cin)[:, None, None] + colofs[None, None, :]
    acc = torch.zeros(n, ho, wo, cout, dtype=torch.int32)
    for img in range(n):
        for hb in range(-(-ho // bh)):
            for wb in range(-(-wo // bw)):
                iw0, ih0 = wb * bw * stride - pw, hb * bh * stride - ph
                lead = (iw0 * cin) & 3
                c0 = iw0 * cin - lead
                stage = torch.zeros(rows_in, row_floats, dtype=torch.float64)
                for rr in range(rows_in):
                    if 0 <= ih0 + rr < h:
                        lo, hi = max(c0, 0), min(c0 + row_floats, w * cin)
                        stage[rr, lo - c0:hi - c0] = q[img, ih0 + rr, lo:hi]
                a = stage.flatten()[idx + lead].reshape(ck.TILE_M, kh * 32)
                tile = (a @ b.t()).to(torch.int32).reshape(bh, bw, cout)
                oh, ow = hb * bh, wb * bw
                hh, ww = min(bh, ho - oh), min(bw, wo - ow)
                acc[img, oh:oh + hh, ow:ow + ww] = tile[:hh, :ww]
    return acc.permute(0, 3, 1, 2)


@pytest.mark.parametrize('case', [
    (1, 384, 128, 64, 7, 2, 1, False),    # the R-50 stem at full size
    (2, 96, 32, 64, 7, 2, 1, True),       # per-channel scales
    (2, 40, 24, 48, 5, 1, 2, False),      # stride 1, dilated, C_out 48
])
def test_stem_k_layout_gives_the_plain_accumulators(case):
    n, h, w, cout, k, s, d, per_channel = case
    rng = np.random.default_rng(sum(case[:7]))
    x = torch.from_numpy(rng.standard_normal((n, 3, h, w)).astype(
        np.float32) * 2)
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, 3)).astype(
        np.int8))
    xinv = torch.from_numpy((rng.random(3) * 40 + 10).astype(np.float32)) \
        if per_channel else torch.tensor(40.0)
    got = _stem_route_accumulators(x, wq, xinv, s, d)
    want = ck.conv2d_int8_accumulators(x, wq, xinv, stride=s, dilation=d)
    assert torch.equal(got, want)


def _covered_once(r, cout, grid):
    """Every (output pixel, N tile) of the route's view covered exactly once
    by the persistent schedule, with the N tiles spanning C_out."""
    n, ho, wo = r['out']
    bw, bh, bimg = r['box']
    count = np.zeros((n, ho, wo, r['n_tiles']), np.uint8)
    tiles = 0
    for mine in ck.tile_schedule(r, grid):
        for (w0, h0, n0), c0 in mine:
            count[n0:n0 + bimg, h0:h0 + bh, w0:w0 + bw, c0 // r['bn']] += 1
            tiles += 1
    assert tiles == r['m_tiles'] * r['n_tiles']
    assert (count == 1).all()
    assert (r['n_tiles'] - 1) * r['bn'] < cout <= r['n_tiles'] * r['bn']


@pytest.mark.parametrize('conv', BODY, ids=[c[0] for c in BODY])
def test_schedule_covers_every_body_tile_once(conv):
    _, cin, h, w, cout, k, s, d, g = conv
    for n in (BATCH, TAIL):
        r = ck.route(_dtype(cin), n, cin, h, w, cout, k, k, s, d, g)
        _covered_once(r, cout, grid=132)


@pytest.mark.parametrize('shape', RAGGED)
def test_schedule_covers_ragged_shapes_once(shape):
    n, cin, h, w, cout, k, s, d, g = shape
    r = ck.route(_dtype(cin), n, cin, h, w, cout, k, k, s, d, g)
    assert r['kind'] != 'general'
    for grid in (1, 7, 132):
        _covered_once(r, cout, grid)
