#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py        # from the repo root, on a GPU host

Phases, each printing one JSON line; any failure raises, so the exit code
is non-zero:

1. build    - nvcc builds every kernel in pps_tpu_torch/csrc (in parallel);
              the card's name and power limit from nvidia-smi.
2. kernel   - each kernel against its plain PyTorch version on the card
              (zero_even: bitwise, f32/bf16/f16, NaN at an even index),
              and its time beside its bound.
3. extract  - the flagship model (R-50, 384x128, bf16 body, 3968-d) with
              seeded random weights embeds a Market-1501-sized gallery
              (19,732 uint8 decodes at 128x64) in batches of 64 through
              the uint8 device-preproc wire; finite, unit-norm.
4. agree    - 4 images: the card's float32 path against the CPU's
              (TF32 off), and the card's bf16 path against its float32.
5. serve    - QueryEmbedder + RetrievalIndex (float32 and int8) answer
              requests of 1, 4 and 16 images (5 of each size), k = 10,
              each held against a brute-force search on the card.
6. profile  - torch.profiler over 4 extraction batches: device time by
              kernel (the full table goes to stderr).

Then a {"kernels": [...]} line (launches counted while the main path,
phases 3 and 5, ran), the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np

GALLERY = 19732           # Market-1501 test gallery size
RAW_HW = (128, 64)        # Market-1501 decode geometry (H, W)
BATCH = 64
REQUESTS = (1, 4, 16)     # images per request
REPEATS = 5               # requests of each size, per index
TOPK = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate

# tolerances, each with its reason
F32_RTOL, F32_ATOL = 1e-3, 2e-4   # card f32 vs CPU f32: sums in another
#   order through 53 convs; the bound the JAX package's torch parity uses
BF16_MIN_COS = 0.99               # bf16 keeps 8 mantissa bits (~0.4% per
#   rounding); ~160 roundings through the body add up to about a percent
#   of the embedding, a cosine of ~0.9999, so 0.99 flags a real fault
DIST2_ATOL = 1e-4                 # index vs brute force, on squared
#   distances: d^2 = |q|^2 + |g|^2 - 2 q.g cancels O(1) terms, and the two
#   sides sum 3968 float32 products in other orders (other GEMM shapes,
#   the int8 hi/lo split), typically ~sqrt(3968) * 2^-24 * 2 ~ 1e-5;
#   compared as d, a self-match (d ~ 1e-2) would magnify that 50x


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch
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


def phase_build():
    from pps_tpu_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    seconds = time.perf_counter() - t0
    smi = nvidia_smi_line()
    print(smi, flush=True)
    ptxas = {n: [ln for ln in r['log'].splitlines()
                 if 'registers' in ln or 'spill' in ln]
             for n, r in report.items()}
    emit('build', seconds=seconds, kernels=sorted(report), ptxas=ptxas,
         nvidia_smi=smi)


def phase_kernel(dev):
    """zero_even against zero_even_plain, bitwise; time at n = 2^24."""
    import torch
    from pps_tpu_torch.kernels import zero_even as ze
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}
    gen = torch.Generator().manual_seed(0)
    checked, max_err = 0, 0.0
    for n in (1, 7, 64, 130, (1 << 24) + 3):
        for dt in bits:
            x = torch.randn(n, generator=gen).to(dt)
            x[0] = float('nan')              # NaN at an even index -> 0
            if n > 3:
                x[3] = float('nan')          # odd index: copied as is
            xd = x.to(dev)
            out = ze.zero_even(xd)
            ref = ze.zero_even_plain(xd)
            torch.cuda.synchronize()
            if not torch.equal(out.view(bits[dt]), ref.view(bits[dt])):
                raise AssertionError('zero_even != plain at n={} {}'.format(
                    n, dt))
            both_nan = torch.isnan(out) & torch.isnan(ref)
            err = torch.where(both_nan, 0.0,
                              (out.float() - ref.float()).abs())
            max_err = max(max_err, float(err.max()))
            checked += 1
    n = 1 << 24
    x = torch.randn(n, generator=gen).to(dev)
    ms = cuda_ms(lambda: ze.zero_even(x), iters=50)
    plain_ms = cuda_ms(lambda: ze.zero_even_plain(x), iters=50)
    bound_ms = 2 * n * x.element_size() / HBM_BYTES_PER_S * 1e3
    emit('kernel', name='zero_even', cases=checked, bitwise_equal=True,
         max_abs_err=max_err, n=n, dtype='float32', ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, check_launches=ze.launches)
    return {'name': 'zero_even', 'route': 'cuda',
            'source': 'pps_tpu_torch/csrc/zero_even.cu',
            'replaces': 'pps_tpu/ops/pallas/zero_even.py:21',
            'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': 'bytes', 'library_ms': None,
            'on_main_path': False}


def randomize_bn_state(state):
    """Non-trivial eval BN: running means ~ N(0, 0.1), variances in
    [0.5, 1.5), drawn with numpy (seed 0) in sorted key order."""
    import torch
    rng = np.random.RandomState(0)
    out = {}
    for k in sorted(state):
        shape = tuple(state[k].shape)
        if k.endswith('_rm'):
            v = rng.randn(*shape).astype(np.float32) * 0.1
        else:
            v = rng.rand(*shape).astype(np.float32) + 0.5
        out[k] = torch.tensor(v, device=state[k].device)
    return out


def make_gallery():
    """[GALLERY, 128, 64, 3] uint8: seeded 8x4 colour blocks upsampled to
    the decode size, so images (and their embeddings) differ clearly."""
    import torch
    gen = torch.Generator().manual_seed(0)
    coarse = torch.randint(0, 256, (GALLERY, 8, 4, 3), dtype=torch.uint8,
                           generator=gen)
    return coarse.repeat_interleave(RAW_HW[0] // 8, dim=1) \
        .repeat_interleave(RAW_HW[1] // 4, dim=2).contiguous().numpy()


def phase_extract(dev, gallery):
    import torch
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.parallel.eval_step import (make_extract_fn,
                                                  extract_features)
    cfg = flagship_cfg()
    model = build_model(cfg, device=dev)
    params, state = model.init(torch.Generator().manual_seed(0))
    state = randomize_bn_state(state)
    w, h = cfg.REID.SCALE
    fn = make_extract_fn(model, device_preproc=(cfg.PIXEL_MEANS, (h, w)),
                         device=dev)
    extract_features(fn, params, state, gallery[:BATCH], BATCH)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    feats = extract_features(fn, params, state, gallery, BATCH)
    end.record()
    end.synchronize()
    host_seconds = time.perf_counter() - t0
    seconds = start.elapsed_time(end) / 1e3
    if feats.shape != (GALLERY, model.embedding_dim):
        raise AssertionError(feats.shape)
    if not np.isfinite(feats).all():
        raise AssertionError('non-finite embeddings')
    norms = np.linalg.norm(feats, axis=1)
    if not np.allclose(norms, 1.0, atol=1e-3):
        raise AssertionError('norms off 1: {}'.format(
            norms[np.abs(norms - 1) > 1e-3][:4]))
    emit('extract', images=GALLERY, batch=BATCH, dim=int(feats.shape[1]),
         dtype=cfg.MODEL.DTYPE, input_hw=[h, w], raw_hw=list(RAW_HW),
         seconds=seconds, imgs_per_s=GALLERY / seconds,
         host_seconds=host_seconds,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return cfg, model, params, state, feats


def phase_agree(dev, params, state, gallery):
    """f32 card vs f32 CPU, bf16 card vs f32 card, on 4 images."""
    import torch
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.parallel.eval_step import make_extract_fn
    cfg32 = flagship_cfg(dtype='float32')
    w, h = cfg32.REID.SCALE
    pre = (cfg32.PIXEL_MEANS, (h, w))
    imgs = torch.from_numpy(gallery[:4].copy())
    out = {}
    for where in ('cpu', dev):
        m = build_model(cfg32, device=where)
        fn = make_extract_fn(m, device_preproc=pre, device=where)
        p = {k: v.to(where) for k, v in params.items()}
        s = {k: v.to(where) for k, v in state.items()}
        out[str(where)] = fn(p, s, imgs.to(where)).cpu().numpy()
    cfg16 = flagship_cfg()  # restores the global cfg to the bf16 flagship
    m16 = build_model(cfg16, device=dev)
    f16 = make_extract_fn(m16, device_preproc=pre, device=dev)(
        params, state, imgs.to(dev)).cpu().numpy()
    cpu, card = out['cpu'], out[str(dev)]
    err = float(np.max(np.abs(card - cpu)))
    if not np.allclose(card, cpu, rtol=F32_RTOL, atol=F32_ATOL):
        raise AssertionError('card f32 != cpu f32: max abs {}'.format(err))
    cos = np.sum(f16 * card, axis=1) / (
        np.linalg.norm(f16, axis=1) * np.linalg.norm(card, axis=1))
    if cos.min() < BF16_MIN_COS:
        raise AssertionError('bf16 vs f32 cosine {}'.format(cos.tolist()))
    emit('agree', f32_card_vs_cpu_max_abs=err, rtol=F32_RTOL, atol=F32_ATOL,
         bf16_vs_f32_cos=cos.tolist(), bf16_min_cos=BF16_MIN_COS)


def brute_force(q, g_f32, k):
    """Expand-formula squared distances and a stable sort, on the card.
    Returns (all d^2, the k smallest d^2, their indices)."""
    import torch
    d2 = (torch.sum(q * q, 1, keepdim=True) + torch.sum(g_f32 * g_f32, 1)
          - 2.0 * q @ g_f32.T).clamp(min=0)
    sd, si = torch.sort(d2, dim=1, stable=True)
    return d2, sd[:, :k], si[:, :k]


def phase_serve(dev, cfg, model, params, state, gallery, feats):
    import torch
    from pps_tpu_torch.engine.serving import QueryEmbedder, RetrievalIndex
    from pps_tpu_torch.ops.topk import quantize_gallery
    qe = QueryEmbedder(cfg, model, params, state, max_batch=BATCH,
                       device=dev)
    qe.warmup(raw_hw=RAW_HW)
    rng = np.random.RandomState(1)
    report = []
    for int8 in (False, True):
        index = RetrievalIndex(feats, list(range(GALLERY)), int8=int8,
                               device=dev)
        # the brute force searches the rows the index holds, dequantized
        if int8:
            g8, scale = quantize_gallery(feats)
            g = torch.as_tensor(g8 * scale[:, None], device=dev)
        else:
            g = torch.as_tensor(feats, device=dev)
        for n in REQUESTS:  # warm-up: row norms, allocator, each shape
            index.search(qe.embed(list(range(n)), lambda i: gallery[i]),
                         TOPK)
        for n in REQUESTS:
            runs = [answer(dev, qe, index, g, gallery,
                           rng.choice(GALLERY, n, replace=False).tolist())
                    for _ in range(REPEATS)]
            row = {'int8': int8, 'queries': n, 'requests': REPEATS}
            for key in ('embed_ms', 'search_ms', 'latency_ms'):
                v = [r[key] for r in runs]
                row[key] = {'median': float(np.median(v)),
                            'min': min(v), 'max': max(v)}
            row['index_equal'] = float(np.mean([r['index_equal']
                                                for r in runs]))
            row['rank1_self'] = float(np.mean([r['rank1_self']
                                               for r in runs]))
            row['max_dist2_diff'] = max(r['max_dist2_diff'] for r in runs)
            report.append(row)
    emit('serve', gallery=GALLERY, k=TOPK, ladder=list(qe.ladder),
         requests=report, dist2_atol=DIST2_ATOL)


def answer(dev, qe, index, g, gallery, ids):
    """One request: embed the images ``ids``, search, and hold the result
    against the brute force over ``g``.  Returns its timings and checks."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = qe.embed(ids, lambda i: gallery[i])
    t1 = time.perf_counter()
    d, i = index.search(q, TOPK)
    t2 = time.perf_counter()
    d2_all, bd2, bi = brute_force(torch.as_tensor(q, device=dev), g, TOPK)
    bd2, bi = bd2.cpu().numpy(), bi.cpu().numpy()
    diff = np.abs(d ** 2 - bd2)
    if diff.max() > DIST2_ATOL:
        raise AssertionError('squared distances: max diff {}'.format(
            diff.max()))
    # an index may differ from the brute force only inside a tie: its own
    # brute-force distance must equal the rank's distance
    own = torch.gather(d2_all, 1, torch.as_tensor(i, device=dev).long())
    if np.abs(own.cpu().numpy() - bd2).max() > DIST2_ATOL:
        raise AssertionError('indices disagree with brute force')
    return {'embed_ms': (t1 - t0) * 1e3, 'search_ms': (t2 - t1) * 1e3,
            'latency_ms': (t2 - t0) * 1e3,
            'index_equal': float(np.mean(i == bi)),
            'rank1_self': float(np.mean(i[:, 0] == np.asarray(ids))),
            'max_dist2_diff': float(diff.max())}


def phase_profile(dev, model, params, state, gallery, cfg):
    """torch.profiler over 4 extraction batches: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pps_tpu_torch.parallel.eval_step import (make_extract_fn,
                                                  extract_features)
    w, h = cfg.REID.SCALE
    fn = make_extract_fn(model, device_preproc=(cfg.PIXEL_MEANS, (h, w)),
                         device=dev)
    imgs = gallery[:4 * BATCH]
    extract_features(fn, params, state, imgs, BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extract_features(fn, params, state, imgs, BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    attr = ('self_device_time_total' if hasattr(avgs[0],
                                                'self_device_time_total')
            else 'self_cuda_time_total')
    # kernel rows only: a CPU op's row repeats its kernels' time
    rows = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: getattr(e, attr), reverse=True)
    device_us = sum(getattr(e, attr) for e in rows)
    print(avgs.table(sort_by=attr, row_limit=30), file=sys.stderr,
          flush=True)
    emit('profile', batches=4, wall_ms=wall * 1e3,
         device_ms=device_us / 1e3,
         idle_share=max(0.0, 1 - device_us / 1e6 / wall),
         top=[[e.key[:80], getattr(e, attr) / 1e3, e.count]
              for e in rows[:15]])


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    from pps_tpu_torch.device import resolve_device
    from pps_tpu_torch.kernels import zero_even as ze
    dev = resolve_device('cuda')

    phase_build()
    kernels = [phase_kernel(dev)]
    gallery = make_gallery()

    # main path, part 1: extraction (counts zeroed just before, read after)
    ze.launches = 0
    cfg, model, params, state, feats = phase_extract(dev, gallery)
    launches = {'zero_even': ze.launches}

    phase_agree(dev, params, state, gallery)

    # main path, part 2: serving
    ze.launches = 0
    phase_serve(dev, cfg, model, params, state, gallery, feats)
    launches['zero_even'] += ze.launches

    phase_profile(dev, model, params, state, gallery, cfg)

    for k in kernels:
        k['launches'] = launches[k['name']]
        if k['on_main_path'] and k['launches'] == 0:
            raise AssertionError('{} never launched on the main path'.format(
                k['name']))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
