"""Bring ``conv2d_int8`` up on one CUDA card alone, away from the model.

    python3 -m pps_tpu_torch.tools.conv2d_int8_check [--body N] [--json F]

Builds ``csrc/conv2d_int8.cu`` (prints nvcc's ``-Xptxas -v`` lines for each
kernel instantiation), checks that the C entry chooses the route
``kernels/conv2d_int8.py:route`` says for every shape, then holds the kernel
bitwise against ``conv2d_int8_plain`` (the int32 accumulators, the bf16
output and the float32 output) on a list of small shapes that covers each
route, tile width and edge: 1x1 flat and strided, 3x3 plain, dilated and
ragged, the stem, K = 4,608, N = 2,048, grouped and per-channel scales.
With ``--body N`` it also checks the 53 convs of the R-50 body at batch N
(384x128) and times each beside cuDNN's bf16 conv and, for the 1x1s,
``torch._int_mm``: device time from CUDA events around replays of a CUDA
graph of 10 calls (``ms``), and eager calls back to back (``eager_ms``,
which includes the host's time per call).  Exits non-zero at the first difference; a
kernel that hangs traps (``mbar_wait``), so run it under ``timeout``.
"""

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

from pps_tpu_torch.kernels import build
from pps_tpu_torch.kernels import conv2d_int8 as ck

# (n, c_in, h, w, c_out, k, stride, dilation, groups, per-channel scales)
CASES = [
    (2, 64, 12, 10, 64, 1, 1, 1, 1, False),     # flat 1x1, BN 64
    (2, 64, 96, 32, 256, 1, 1, 1, 1, False),    # flat 1x1, BN 256
    (3, 256, 13, 7, 128, 1, 1, 1, 1, True),     # flat, ragged M, per-channel
    (2, 256, 24, 16, 512, 1, 2, 1, 1, False),   # strided 1x1 (res3's)
    (3, 512, 16, 10, 256, 1, 2, 1, 1, False),   # strided, ragged
    (2, 64, 24, 8, 64, 3, 1, 1, 1, False),      # 3x3, C_in 64
    (3, 128, 13, 7, 128, 3, 1, 1, 1, False),    # 3x3, ragged box
    (2, 64, 96, 32, 64, 3, 1, 1, 1, True),      # res2's 3x3, per-channel
    (3, 256, 24, 8, 256, 3, 1, 1, 1, False),    # res4's 3x3, odd images
    (1, 64, 24, 8, 64, 3, 1, 2, 1, False),      # dilated
    (2, 64, 12, 10, 96, 3, 1, 2, 1, False),     # dilated, N 96
    (2, 256, 12, 10, 256, 3, 2, 1, 1, False),   # 3x3 stride 2
    (2, 512, 24, 8, 512, 3, 1, 1, 1, True),     # K 4,608, N 512
    (1, 512, 24, 8, 2048, 1, 1, 1, 1, False),   # N 2,048
    (2, 3, 96, 32, 64, 7, 2, 1, 1, False),      # the stem
    (3, 3, 50, 30, 64, 7, 2, 1, 1, True),       # the stem, ragged
    (2, 3, 384, 128, 64, 7, 2, 1, 1, False),    # the stem, full size
    (3, 64, 13, 7, 70, 3, 1, 1, 1, False),      # general: N % 8
    (2, 64, 12, 10, 64, 3, 1, 1, 2, True),      # general: groups 2
    (2, 8, 12, 10, 16, 3, 1, 1, 4, True),       # general: cg 2
]


def inputs(gen, n, cin, h, w, cout, k, groups, per_channel, dev):
    dtype = torch.float32 if cin == 3 else torch.bfloat16
    x = (torch.randn(n, h, w, cin, generator=gen, device=dev) * 2).to(
        dtype).permute(0, 3, 1, 2)
    wq = torch.randint(-127, 128, (cout, k, k, cin // groups), generator=gen,
                       device=dev, dtype=torch.int8)
    xinv = (torch.rand(cin, generator=gen, device=dev) * 40 + 10
            if per_channel else torch.full((), 40.0, device=dev))
    osc = torch.rand(cout, generator=gen, device=dev) * 1e-4 + 1e-5
    fb = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, wq, xinv, osc, fb


def check(args, stride, dilation, groups, label):
    """Bitwise: the accumulators, bf16 and float32 outputs."""
    for out_dtype in (torch.int32, torch.bfloat16, torch.float32):
        kw = dict(stride=stride, dilation=dilation, groups=groups,
                  accumulators=out_dtype == torch.int32)
        if out_dtype != torch.int32:
            kw['out_dtype'] = out_dtype
        got = ck.conv2d_int8(*args, **kw)
        want = ck.conv2d_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(bits), want.view(bits)):
            bad = (got.view(bits) != want.view(bits)).nonzero()
            raise AssertionError('{} {}: {} of {} differ, first at {}'.format(
                label, out_dtype, len(bad), got.numel(),
                bad[:4].tolist()))


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps=10, replays=5):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events (no host
    time between the launches)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _short(mangled):
    """A kernel instantiation's name from its mangled one, e.g.
    conv2d_int8_wgmmaILi256ELi0E13__nv_bfloat16 (BN 256, route 0, bf16)."""
    for key in ('conv2d_int8_wgmma', 'conv2d_int8_kernel'):
        if key in mangled:
            return key + mangled.split(key, 1)[1].split('EEv')[0]
    return mangled


def ptxas_table(log):
    """{kernel instantiation: 'registers, spills, smem'} from nvcc's
    -Xptxas -v output, with ptxas's note where it serialized the wgmmas."""
    out, name = {}, None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            name = _short(line.split("'")[1])
        elif 'serialized' in line and "'" in line:
            key = _short(line.split("'")[1])
            out[key] = out.get(key, '') + ' [wgmma serialized: ' + \
                line.split('serialized due to ')[-1].split(' for the')[0] + ']'
        elif name and ('registers' in line or 'spill' in line):
            out[name] = (out.get(name, '') + ' ' + line.split(':', 1)[-1]
                         .strip()).strip()
    return out


def body(gen, batch, dev):
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.models import resnet as resnet_lib
    cfg = flagship_cfg()
    w_in, h_in = cfg.REID.SCALE
    rows = []
    for conv in ck.resnet_body_convs(resnet_lib.resnet_spec(cfg, 50), h_in,
                                     w_in):
        name, cin, h, w, cout, k, s, d, g = conv
        args = inputs(gen, batch, cin, h, w, cout, k, g, False, dev)
        r = ck.route(args[0].dtype, batch, cin, h, w, cout, k, k, s, d, g)
        check(args, s, d, g, name)
        kw = dict(stride=s, dilation=d, groups=g, out_dtype=torch.bfloat16)
        ms = cuda_ms(lambda: ck.conv2d_int8(*args, **kw))
        dev_ms = graph_ms(lambda: ck.conv2d_int8(*args, **kw))
        wb = torch.randn(cout, cin // g, k, k, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        xb = args[0].to(torch.bfloat16)
        pad = ((k - 1) * d) // 2
        cudnn = graph_ms(lambda: F.conv2d(xb, wb, stride=s, padding=pad,
                                          dilation=d, groups=g))
        int_mm = None
        if k == 1:
            ho, wo = -(-h // s), -(-w // s)
            a = torch.randint(-127, 128, (batch * ho * wo, cin), generator=gen,
                              device=dev, dtype=torch.int8)
            b = args[1].reshape(cout, cin).t()
            int_mm = graph_ms(lambda: torch._int_mm(a, b))
        row = dict(conv=name, route=r['kind'], bn=r['bn'], box=r['box'],
                   ms=dev_ms, eager_ms=ms, cudnn_bf16_ms=cudnn,
                   int_mm_ms=int_mm)
        print(json.dumps(row), flush=True)
        rows.append(row)
    total = {key: sum(r[key] for r in rows if r[key] is not None)
             for key in ('ms', 'eager_ms', 'cudnn_bf16_ms')}
    total['ms_1x1'] = sum(r['ms'] for r in rows if r['int_mm_ms'] is not None)
    total['int_mm_ms_1x1'] = sum(r['int_mm_ms'] for r in rows
                                 if r['int_mm_ms'] is not None)
    return rows, total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--body', type=int, default=0,
                    help='also check and time the R-50 body at this batch')
    ap.add_argument('--json', default=None, help='write the results here')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    report = build.build_all(['conv2d_int8'])['conv2d_int8']
    print('build {:.1f} s'.format(time.perf_counter() - t0), flush=True)
    for name, line in sorted(ptxas_table(report['log']).items()):
        print('ptxas {}: {}'.format(name, line), flush=True)
    for line in report['log'].splitlines():
        if 'arning' in line:
            print(line, flush=True)
    for case in CASES:
        n, cin, h, w, cout, k, s, d, g, _ = case
        dt = torch.float32 if cin == 3 else torch.bfloat16
        want = ck.route(dt, n, cin, h, w, cout, k, k, s, d, g)
        got = ck.native_route(dt, n, cin, h, w, cout, k, k, s, d, g)
        if got != want:
            raise AssertionError('route {}: C {} Python {}'.format(
                case, got, want))
    gen = torch.Generator(device=dev).manual_seed(0)
    for case in CASES:
        n, cin, h, w, cout, k, s, d, g, per_channel = case
        x_args = inputs(gen, n, cin, h, w, cout, k, g, per_channel, dev)
        r = ck.route(x_args[0].dtype, n, cin, h, w, cout, k, k, s, d, g)
        check(x_args, s, d, g, str(case))
        print('ok {} {} bn={} box={}'.format(case, r['kind'], r['bn'],
                                              r['box']), flush=True)
    out = {'cases': len(CASES), 'device': torch.cuda.get_device_name(0)}
    if args.body:
        rows, total = body(gen, args.body, dev)
        out.update(body_batch=args.body, body=total, rows=rows)
        print(json.dumps({'body': total}), flush=True)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=1)
    print('conv2d_int8_check ok', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
