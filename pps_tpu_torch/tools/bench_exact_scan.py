"""Head-to-head shootout for the EXACT single-query gallery scan
(counterpart of ``tools/bench_exact_scan.py``).

The exact single-query top-100 over a resident 1M x 3968 int8 gallery,
against the time it takes to read the gallery once.  Variants (all exact
unless marked):

  stream<chunk>   the shipped ``ops/topk.streaming_topk`` at several chunk
                  sizes (each chunk dequantized, one product, a merge)
  flat-bf16       one pass over the gallery: int8 rows are exact in bf16
                  and the per-row scale commutes out of the product,
                  q . (g8 * s) = (q . g8) * s, so the rows go through a
                  bf16 product (float32 sums) with the query split into
                  bf16 hi and lo rows (float32-exact query precision);
                  one top-k over the [nq, Ng] distance row
  flat-int8       the query quantized to int8 and an s8 x s8 -> s32
                  product (``torch._int_mm``); approximate in the cross
                  term (query quantization only)
  flat-int8+ref   the flat-int8 shortlist (top-1024) rescored exactly in
                  float32; exact whenever the true top-k survives into
                  the shortlist (reported: agreement with the exact scan)
  pure_read       one float32 sum over the gallery's bytes: the floor any
                  scan can reach

Slope timing (``utils/timer.slope_time``).  The gallery is made on the
device from a seed.

    python -m pps_tpu_torch.tools.bench_exact_scan [--gallery-size 1000000]
        [--dim 3968] [--topk 100] [--chunks 4096,16384,65536,262144]
        [--iters 50] [--nq 1] [--device cuda|cpu]
"""

import argparse
import json

import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common

SHORTLIST = 1024
# gallery rows per bf16 conversion in flat-bf16 (65536 x 3968 bf16 =
# 0.5 GB), so the gallery is never converted whole
BF16_BLOCK = 65536


def topk_rows(d2, k):
    """The ``k`` smallest of each row of ``d2`` [nq, n] (squared
    distances), ties to the lowest index: (d2 [nq, k], indices [nq, k]
    int64), ascending."""
    from pps_tpu_torch.ops.topk import key_dist2, key_index, sq_keys
    idx = torch.arange(d2.shape[1], device=d2.device)
    keys = torch.topk(sq_keys(d2, idx[None, :]), min(k, d2.shape[1]),
                      dim=1, largest=False, sorted=True).values
    return key_dist2(keys), key_index(keys)


def _d2(q, gnorm, scores):
    qn = torch.sum(q * q, dim=1, keepdim=True)
    return torch.clamp(qn + gnorm[None, :] - 2.0 * scores, min=0.0)


@torch.no_grad()
def flat_bf16(q, g, s, gnorm):
    """[nq, Ng] squared distances from one bf16 pass over the int8 rows,
    the query split into bf16 hi and lo rows, the scale after the
    product."""
    from pps_tpu_torch.ops.distance import bf16_product
    qhi = q.to(torch.bfloat16)
    qlo = (q - qhi.float()).to(torch.bfloat16)
    qq = torch.cat([qhi, qlo], dim=0)                   # [2nq, d]
    ss = torch.cat([bf16_product(qq, g[a:a + BF16_BLOCK].T)
                    for a in range(0, g.shape[0], BF16_BLOCK)], dim=1)
    nq = q.shape[0]
    return _d2(q, gnorm, (ss[:nq] + ss[nq:]) * s[None, :])


@torch.no_grad()
def flat_int8_scores(q, g, s):
    """q . (g8 * s) with the query quantized per row to int8: one
    s8 x s8 -> s32 product (``torch._int_mm``; its rows padded to 32, as
    the card's wants more than 16)."""
    amax = torch.clamp(torch.amax(torch.abs(q), dim=1, keepdim=True),
                       min=1e-12)
    # tensor divisors: the card divides by a Python scalar through its
    # float32 reciprocal
    qs = amax / torch.full_like(amax, 127.0)
    q8 = torch.clamp(torch.round(q / qs), -127, 127).to(torch.int8)
    m = q8.shape[0]
    pad = max(32, -(-m // 8) * 8) - m
    if pad:
        q8 = torch.cat([q8, q8.new_zeros(pad, q8.shape[1])])
    si = torch._int_mm(q8, g.T)[:m]                      # [nq, Ng]
    return si.float() * qs * s[None, :]


def flat_int8(q, g, s, gnorm):
    return _d2(q, gnorm, flat_int8_scores(q, g, s))


@torch.no_grad()
def flat_int8_refined(q, g, s, gnorm, k, shortlist=SHORTLIST):
    """The flat-int8 top-``shortlist`` of each query, rescored exactly in
    float32 on its dequantized rows; (d2 [nq, k], indices [nq, k])."""
    _, cand = topk_rows(flat_int8(q, g, s, gnorm), shortlist)  # [nq, S]
    rows = g[cand].float() * s[cand][..., None]          # [nq, S, d]
    d2x = (torch.sum(q * q, dim=1, keepdim=True)
           + torch.sum(rows * rows, dim=2)
           - 2.0 * torch.bmm(rows, q[:, :, None])[..., 0])
    dd, ii = topk_rows(torch.clamp(d2x, min=0.0), min(k, shortlist))
    return dd, torch.gather(cand, 1, ii)


def make_gallery(ng, d, nq, dev, seed=0):
    """(g8 [ng, d] int8, scales [ng], unit queries [nq, d]) made on
    ``dev`` from ``seed``: uniform int8 rows, scales 1/(127 sqrt d) times
    1 + 10% noise."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g8 = torch.randint(-127, 128, (ng, d), generator=gen, device=dev,
                       dtype=torch.int8)
    sc = (1.0 + 0.1 * torch.rand(ng, generator=gen, device=dev)) / (
        127.0 * d ** 0.5)
    q = torch.randn(nq, d, generator=gen, device=dev)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    return g8, sc, q


def main(argv=None, results=None):
    """``results``: an optional dict filled with each variant's
    (squared distances, indices) as numpy, for a caller's own checks."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--gallery-size', type=int, default=1_000_000)
    ap.add_argument('--dim', type=int, default=3968)
    ap.add_argument('--topk', type=int, default=100)
    ap.add_argument('--chunks', default='4096,16384,65536,262144')
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--nq', type=int, default=1)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    from pps_tpu_torch.ops.topk import gallery_norms, streaming_topk
    from pps_tpu_torch.utils.flops import HBM_BYTES_PER_S
    from pps_tpu_torch.utils.timer import slope_time

    dev = resolve_device(args.device)
    ng, d, k, nq = args.gallery_size, args.dim, args.topk, args.nq
    gd, sd, qd = make_gallery(ng, d, nq, dev)
    # squared norms of the DEQUANTIZED rows, once per gallery
    gn = gallery_norms(gd, sd)
    common.synchronize(dev)

    def stream(chunk):
        dd, ii = streaming_topk(qd, gd, k=k, chunk=chunk, g_scale=sd)
        return dd * dd, ii

    variants = {'stream%d' % c: (lambda c=c: stream(c))
                for c in [int(x) for x in args.chunks.split(',')]}
    variants['flat_bf16'] = lambda: topk_rows(flat_bf16(qd, gd, sd, gn), k)
    variants['flat_int8'] = lambda: topk_rows(flat_int8(qd, gd, sd, gn), k)
    variants['flat_int8_refined'] = lambda: flat_int8_refined(
        qd, gd, sd, gn, k)

    # ---- correctness cross-check at bench scale (one call each)
    ed, ei = (t.cpu().numpy() for t in streaming_topk(
        qd, gd, k=k, chunk=4096, g_scale=sd))
    got = {}
    for name, fn in variants.items():
        dd, ii = fn()
        got[name] = (dd.cpu().numpy(), ii.cpu().numpy().astype('int64'))
    if results is not None:
        results.update(got)

    def agree(ii):
        return round(float(sum(
            len(set(ii[r].tolist()) & set(ei[r].tolist())) / k
            for r in range(nq)) / nq), 4)

    checks = {
        'flat_bf16_topk_agree': agree(got['flat_bf16'][1]),
        'flat_bf16_dist_maxdiff': round(float(abs(
            got['flat_bf16'][0] ** 0.5 - ed).max()), 6),
        'flat_int8_topk_agree': agree(got['flat_int8'][1]),
        'flat_int8_refined_agree': agree(got['flat_int8_refined'][1]),
    }

    latency = {}
    for name, fn in variants.items():
        chunk = int(name[6:]) if name.startswith('stream') else None
        it = (max(10, args.iters // 4) if chunk is not None and chunk <= 8192
              else args.iters)
        latency[name] = slope_time(fn, iters=it, warmup=1) * 1e3
    # the floor: one float32 sum over the gallery's bytes (whole words of
    # them), a reduction that runs at the memory's rate; the values are
    # not used
    words = gd.reshape(-1)[:gd.numel() // 4 * 4].view(torch.float32)
    latency['pure_read'] = slope_time(lambda: torch.sum(words),
                                      iters=args.iters, warmup=1) * 1e3

    bw_bound_ms = (ng * d) / HBM_BYTES_PER_S * 1e3  # one int8 gallery read
    out = {
        'gallery_size': ng, 'dim': d, 'topk': k, 'nq': nq,
        'bandwidth_bound_ms': round(bw_bound_ms, 2),
        'measured_read_GBps': round((ng * d) / latency['pure_read'] / 1e6,
                                    1),
        'latency_ms': {kk: round(vv, 3) for kk, vv in latency.items()},
        'checks': checks,
        'device_kind': common.device_kind(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
