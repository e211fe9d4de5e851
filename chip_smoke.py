#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, train step, train -> test
drivers, retrieval side and model variants once on one CUDA card.

    python3 chip_smoke.py        # from the repo root, on a GPU host

Phases, each printing one JSON line; any failure raises, so the exit code
is non-zero:

1. build    - nvcc builds every kernel in pps_tpu_torch/csrc (in parallel);
              the card's name and power limit from nvidia-smi.
2. kernel   - each kernel against its plain PyTorch version on the card
              (zero_even: bitwise, f32/bf16/f16, NaN at an even index;
              conv2d_int8: bitwise, output and int32 accumulators, on the
              53 convs of the R-50 body at batch 4, 64 and 60, a ragged
              and a grouped per-channel shape; every body conv on a wgmma
              route; the library's SASS holds IGMMA, wgmma's s8 form,
              and UTMALDG), and its
              time beside its bound (conv2d_int8: device time of every
              body conv at batch 64 from CUDA-graph replays, beside
              cuDNN's bf16 conv and, for the 1x1s, torch._int_mm; route,
              TOP/s, GB/s and share of the bound per conv; the table goes
              to build/chip_smoke_logs/kernel_int8.json).
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
7. train    - the flagship train step (uint8 augmentation on the card,
              R-50 with train-mode BN, PPS head with dropout, 31 CE + CRM
              + 0.14 x triplet, backward, Caffe2 momentum-SGD) at batch
              P 8 x K 8 = 64: 3 warm-up and 20 timed steps on the same
              images (loss finite and falling, BN stats and momentum
              moved), one step at loss_scale_factor 0, a json_stats line,
              and a pkl checkpoint round trip (bitwise).
8. train_agree - one step at full width and depth, P 4 x K 2, the same
              draws on both sides: card f32 vs CPU f32, card bf16 vs f32.
8b. dp_agree - the data-parallel step (``parallel/train_step.py`` over
              ``parallel/mesh.py``): two ranks on the one card over gloo
              (child processes of this script, launched as torchrun
              launches them) against one rank on the same card, float32
              at full width, global batch P 4 x K 2, from the same state
              and global draws: the ranks' augmented rows put together
              equal the 1-rank batch bitwise, the loss within 1e-5, the BN
              state within 1e-4 (RMS), every update within train_agree's
              rule; then the triplet term alone, and the triplet term with
              a planted fault (its 1/world dropped: a doubled gradient),
              which must fail that rule.
8c. dp_train - two ranks, bf16 flagship at global batch 64 (32 a rank),
              3 + 10 steps: ms/step and the gradient all-reduce's share
              (CUDA events); then one NCCL rank (world size 1) on the same
              step against phase train's bare step.
8d. mp_agree, mp_train - the model axis (one launch of two ranks as a
              (1, 2) mesh over gloo): the Duke yaml at full width (702
              logits, 351 a rank: Market's 751 and CUHK03's 767 divide by
              no model axis of 2), float32, global batch P 4 x K 2, CRM
              and triplet on, against one rank on the card from the same
              state and draws: the rows bitwise, the loss within 1e-5,
              every update (the class slices gathered) by train_agree's
              rule, and a planted fault (class_terms_not_over_model: the
              class terms' 1/n_model undone) that must fail it; then bf16
              at global batch 64, 3 + 5 steps: ms/step and the shares of
              the model group's collectives and of the gradient's
              all-reduce (CUDA events); the state saved as a sharded
              checkpoint (.dcp).
9. profile_train - torch.profiler over 2 train steps (table to stderr).
10. train_net - ``engine.train.train_model`` on the flagship yaml
              (configs/market1501/pps_crm_triplet_R-50_1x.yaml) over a
              synthetic Market-shaped dataset (751 identities x 4 decodes,
              flipped: 6,008 entries, 93 steps per epoch at P 8 x K 8), cut
              to 3 epochs with epoch 1 a triplet epoch and the LR halving
              at epoch 2: loss finite and falling, the JAX package's
              checkpoint names, a momentum-correction line; ms/step and
              the loader's queue depth.
11. resume  - the same run into a fresh directory, preempted mid-epoch 1,
              then auto-resumed: the first resumed step trains on the
              continuous run's batch with its loss (within 1e-4).
12. test_net - ``engine.test.run_inference`` with train_net's
              model_final.pkl on a Market-sized test split (3,368 queries,
              19,732 gallery): features through the pkl equal those of the
              in-memory final state (extracted from a decoded stack, the
              decode and the model timed apart), the card's CMC/mAP equal
              the numpy metrics on the same distance matrix, features.pkl
              loads.
12b. dp_train_net - ``tools.train_net`` on two ranks (one epoch of the
              flagship yaml at global batch 128): a continuous run; a run
              whose rank 1 gets a SIGTERM (both ranks exit 75 after the
              same step, one model_preempt_*.pkl); the same command again,
              whose first step's loss equals the continuous run's (1e-4);
              json_stats from rank 0 alone.
12c. dp_test_net - ``run_inference`` on two ranks with test_net's pkl over
              the 23,100 test images: rank 0's features against the
              one-process run's (cosine >= 0.999), its CMC equal to numpy's
              on its own matrix and its mAP within 1e-6; imgs/s.
12d. ckpt_sharded - mp_train's .dcp loaded into this process, bitwise
              equal to the gathered state; ``tools.train_net`` on two ranks
              (1, 2) under TPU.CKPT_FORMAT orbax over a 128-image
              Duke-shaped subset: a continuous run with PPS_TPU_DUMP_JAXPR
              (train_step.graph.txt written, nodes > 0) beside a run whose
              rank 1 gets a SIGTERM once model_epoch1.dcp is on disk (both
              exit 75, one model_preempt_*.dcp), then the same command
              again: its model_final.pkl bitwise equal to the continuous
              run's.
13. remat   - the flagship train step with TPU.REMAT on and off from the
              same state and draws: the same loss and BN state; ms/step
              and peak memory of both.
14. augment_agree - 64 mixed-size decodes on the padded wire with crops,
              HSV, blur and erasing: the card's uint8 stage equals the
              CPU's bit for bit, the float32 output within 1e-4.
15. train_duke - ``train_model`` on configs/duke/pps_crm_triplet_R-50_1x.yaml
              (HSV and blur turned on) over a synthetic Duke-shaped dataset
              of mixed decode sizes: every batch on the padded wire, the
              loss finite and falling.
16. host_chain - 20 steps of the same with TPU.DEVICE_AUGMENT False and
              TPU.WIRE_DTYPE bfloat16: every batch a float32 host-chain
              batch, cast to bfloat16; the host's decode + augment rate.
17. train_cuhk03 - one epoch of configs/cuhk03/pps_crm_triplet_R-50_1x.yaml
              over a synthetic CUHK03-shaped dataset (padded wire).
18. test_duke, test_duke_fliptta, test_cuhk03 - ``run_inference`` with
              each yaml's final pkl (the Duke one for the flip-TTA yaml):
              every batch 'u8p', features through the pkl equal the
              in-memory state's, the card's CMC/mAP equal numpy's.
19. serve_mixed - QueryEmbedder on 4-image groups of mixed sizes (host
              preprocessing, the model on the card) and a search of the
              Duke gallery, held against a brute force.
20. retrieval_scale - a RetrievalIndex of 1,048,576 x 3968 int8 rows
              (clustered synthetic embeddings made on the card, added in
              chunks) and Market's 3,368 queries: the streaming scan
              against the flat route on 64 queries, recall_target 0.95
              equal to exact, IVF probing every cell of a 65,536-row
              sub-index equal to its exact scan; the scan's seconds and
              GB/s, one-query latency flat and IVF, k-means and assignment
              seconds, recall@100 at nprobe 8 / 16 / 32, peak memory.
20b. retrieval_sharded - the same 1M x 3968 int8 gallery as 4 shards on
              the card through RetrievalIndex(shard=True): the exact scan
              at 64 and 3,368 queries against the flat and streaming
              routes, IVF at nprobe 16 with recall@10 equal to the
              single-device IVF's, and a full probe of the 65,536-row
              sub-index against the single-device IVF; seconds of each.
21. test_cuhk03_rerank - ``run_inference`` on the CUHK03 _rerank yaml with
              REID.VIS on and train_cuhk03's pkl: the card's re-ranking
              against the C++ engine on the same matrices (mAP and CMC
              within 1e-3, under 0.5% of entries apart by more than 1e-5),
              numpy against both on 512 + 1,536 images, the rank-list
              images of the first queries decode; then the same yaml
              through ``python -m pps_tpu_torch.tools.test_net`` over the
              written files prints its Single Query and re-ranked lines.
22. rerank_market - re-ranking over test_net's 3,368 + 19,732 features on
              the card, beside the C++ engine: seconds, peak memory, mAP.
23. serve_daemon - ``python -m pps_tpu_torch.tools.serve`` on the Market
              yaml with test_net's pkl over 2,048 gallery PNGs: every
              endpoint with pps_tpu's JSON keys, 20 sequential and 64
              concurrent /search against an in-process index, /add then
              /remove, SIGTERM with a save, a --load-index restart and
              ``tools.retrieve`` answering as before, also with
              --shard-gallery.

The model variants (after remat, gn_agree; after test_net, the rest, on
the same synthetic Market set):
24. gn_agree - a full-width GroupNorm R-50 (MODEL.USE_GN) on 4 images:
              card f32 against CPU f32; its int8 body (per-channel input
              scales) once through conv2d_int8 (53 launches).
25. train_fpn - ``train_model`` on the FPN2 yaml, 2 epochs x 93 steps
              (128 rows through the head, two levels): loss finite and
              falling, the FPN weights 4-d OIHW in the pkl and bitwise
              through it.
26. test_fpn - ``run_inference`` with train_fpn's pkl, gated as test_net.
27. fold    - test_net's pkl on 2,048 gallery decodes: BN-folded against
              unfolded extraction (f32 within 1e-4, bf16 cosine >= 0.999)
              and the bf16 rates of both, timed in turns.
28. test_int8 - ``run_inference`` on the _int8 yaml with test_net's pkl:
              calibrated on 256 images, 53 conv2d_int8 launches a batch,
              int8 against bf16 embeddings of the same images (cosine >=
              0.99), both mAPs and extraction rates; then the model-bound
              rates from a stack of 2,048 decodes, int8 against the folded
              bf16 flagship, in turns.
29. export  - ``python -m pps_tpu_torch.tools.export_model`` (--fold-bn,
              --int8) in child processes; each .pt2 reloaded and run
              against eager extraction within 1e-6.

Last, the measurement tools:
30. tools   - the 'iter' SGD flavor (ITER_SIZE 3) 6 steps card vs CPU,
              bitwise; every tool of pps_tpu_torch/tools at full width with
              its counts cut, in process through main(argv):
              profile_train_step, bench_int8 (cosine >= 0.99, conv2d_int8
              launched), bench_distmat, bench_exact_scan (the exact
              variants against streaming_topk outside 1e-5 near-ties),
              bench_rerank (1,000 + 5,000, card vs C++ by the near-tie
              rule), bench_serving (its top-k against RetrievalIndex.search
              on the same query; then --load, exact mode, concurrency 1
              and 4, against its own daemon), bench_ivf_recall (64 ids x
              32, 5 steps; recall 1.0 at a full probe), bench_train_e2e
              (64 ids x 4, 1 epoch), data_loader_benchmark; and
              ``python -m pps_tpu_torch.tools.trace_top_ops`` as a child
              (its top rows named, their shares summing to at most 1); each
              JSON line with the JAX tool's keys.

The driver phases' own output (json_stats and Single Query lines, logs)
goes to build/chip_smoke_logs/<phase>.log (a rank's to
<phase>_rank<r>.log).  ``python3 chip_smoke.py --dp-rank CASE DIR`` is
the process of one rank of a data- or model-parallel phase.  Then a
{"phase_seconds": {...}} line (each phase's wall clock and the total), a
{"kernels": [...]} line (launches counted per phase and kernel while the
main path, phases 3, 5, 7, 8b-8d, 10-12d, 15-23 and 25-30, ran), the
nvidia-smi line, and last {"ok": true, "device": {...}}.  Without a CUDA
device it exits non-zero and prints no result.
"""

import contextlib
import json
import logging
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pps_tpu_torch.utils.flops import (BF16_PEAK_FLOPS, HBM_BYTES_PER_S,
                                       INT8_PEAK_OPS)

ROOT = os.path.dirname(os.path.abspath(__file__))

GALLERY = 19732           # Market-1501 test gallery size
RAW_HW = (128, 64)        # Market-1501 decode geometry (H, W)
BATCH = 64
REQUESTS = (1, 4, 16)     # images per request
REPEATS = 5               # requests of each size, per index
TOPK = 10
TRAIN_P, TRAIN_K = 8, 8    # the flagship's P x K batch
WARMUP_STEPS, TIMED_STEPS = 3, 20
MARKET_TRAIN_IMAGES = 12936  # Market-1501 train split: the epoch size
FLAGSHIP_YAML = os.path.join(ROOT, 'configs', 'market1501',
                             'pps_crm_triplet_R-50_1x.yaml')
TRAIN_IDS, TRAIN_PER_ID = 751, 4    # Market's train identities, cut to 4
#   decodes each (3,004 images of Market's 12,936)
TEST_IDS, QUERIES = 750, 3368       # Market-1501's test split
DRIVER_EPOCHS = 3                   # of the yaml's 121
PREEMPT_AFTER = 93 + 40             # steps: 40 steps into epoch 1
NOISE_BANK = 97                     # per-image noise patterns (a prime)
DISTRACTORS, DISTRACTOR_SEED = 389, 100000  # patterns shared across ids

# the mixed-size datasets: each image's decode size is SIZE_TABLE's entry
# at its image id modulo the table's length (a prime), drawn once per
# dataset: height uniform over an integer range, width = round(height x
# an aspect ratio uniform over a range), so every crop is taller than wide
SIZE_TABLE = 4093
DUKE = dict(name='duke', yaml=os.path.join(ROOT, 'configs', 'duke',
                                           'pps_crm_triplet_R-50_1x.yaml'),
            train_ids=702, train_per_id=4, cams=8,
            query_ids=702, queries=2228, gallery_ids=1110, gallery=17661,
            heights=(120, 290), aspect=(0.33, 0.5), seed=7)
CUHK03 = dict(name='cuhk03', yaml=os.path.join(ROOT, 'configs', 'cuhk03',
                                               'pps_crm_triplet_R-50_1x.yaml'),
              train_ids=767, train_per_id=4, cams=2,
              query_ids=700, queries=1400, gallery_ids=700, gallery=5328,
              heights=(96, 240), aspect=(0.35, 0.5), seed=8)
DUKE_FLIPTTA_YAML = os.path.join(ROOT, 'configs', 'duke',
                                 'pps_crm_triplet_R-50_1x_fliptta.yaml')
DUKE_EPOCHS, CUHK03_EPOCHS = 2, 1   # of the yamls' 121
MIXED_AUG = ['REID.HSV_JITTER_PROB', '0.5', 'REID.SATURATION_RANGE', '50',
             'REID.HUE_RANGE', '10', 'REID.VALUE_RANGE', '50',
             'REID.GAUSSIAN_BLUR_PROB', '0.5',
             'REID.GAUSSIAN_BLUR_KERNEL', '7']
HOST_CHAIN_STEPS = 20
MEM_CHECK_IMAGES = 2048             # test images re-extracted in memory
REMAT_STEPS = 5

# tolerances, each with its reason
F32_RTOL, F32_ATOL = 1e-3, 2e-4   # card f32 vs CPU f32: sums in another
#   order through 53 convs; the bound the JAX package's torch parity uses
TRAIN_LOSS_RTOL = 1e-4            # card f32 vs CPU f32 train loss: a
#   forward value, sums in another order (port vs JAX package on the CPU:
#   2e-6)
TRAIN_REL, TRAIN_FLOOR = 0.05, 0.02  # card vs CPU after one step: each
#   tensor's displacement and momentum by RMS error against its own RMS,
#   plus 2% of the RMS over all params (updates that are zero by a BN
#   invariance are noise); from residual-branch BN scales of 0.01, where
#   the gradient is well conditioned (port vs JAX package on the CPU: 0.7%)
TRAIN_STATE_REL = 1e-3            # BN running stats after one step, by
#   RMS (port vs JAX package on the CPU: 7e-6)
BF16_LOSS_RTOL = 1e-3             # card bf16 vs f32 train loss: at a
#   fresh init the 31 CE terms sit near ln(751) whatever the features, so
#   ~1% of bf16 feature noise (see below) moves the loss far less than
#   0.1% (measured on an H100: 4e-6)
BF16_MIN_COS = 0.99               # bf16 keeps 8 mantissa bits (~0.4% per
#   rounding); ~160 roundings through the body add up to about a percent
#   of the embedding, a cosine of ~0.9999, so 0.99 flags a real fault
RESUME_LOSS_RTOL = 1e-4           # the first resumed step's loss vs the
#   continuous run's at that step: the state is loaded bitwise and the
#   draws are reseeded identically; only a nondeterministic backward of an
#   earlier step (cuDNN, scatter-add) could move it
FEAT_ATOL = 1e-6                  # features through model_final.pkl vs the
#   in-memory final state: the same weights bit for bit, the same kernels
MAP_ATOL = 1e-6                   # card mAP (float64 AP sums) vs numpy's
AUG_F32_ATOL = 1e-4               # augment card vs CPU, float32 output:
#   the resize products of |x| <= 255 summed in another order (a few
#   float32 ulps of the partial sums; the port vs the JAX package: 4.6e-5)
REMAT_LOSS_RTOL = 1e-5            # REMAT on vs off: the same forward
REMAT_STATE_ATOL = 1e-6           # BN updates come from the first forward
DIST2_ATOL = 1e-4                 # index vs brute force, on squared
#   distances: d^2 = |q|^2 + |g|^2 - 2 q.g cancels O(1) terms, and the two
#   sides sum 3968 float32 products in other orders (other GEMM shapes,
#   the int8 hi/lo split), typically ~sqrt(3968) * 2^-24 * 2 ~ 1e-5;
#   compared as d, a self-match (d ~ 1e-2) would magnify that 50x

# the model variants: FPN, BN folding, int8, export, GroupNorm
FPN2_YAML = os.path.join(ROOT, 'configs', 'market1501',
                         'pps_crm_triplet_R-50-FPN2_1x.yaml')
INT8_YAML = os.path.join(ROOT, 'configs', 'market1501',
                         'pps_crm_triplet_R-50_1x_int8.yaml')
FPN_EPOCHS = 1                      # of the yaml's 121 (2 before the
#   900 s budget; its loss gate is within epoch 0)
INT8_CHECK_BATCH = 4                # the 53 body convs checked bitwise,
#   here, at BATCH (the extraction batch; its tail is padded to BATCH) and
#   at INT8_TAIL rows
INT8_TAIL = (QUERIES + GALLERY) % BATCH  # the real rows of the tail batch
INT8_CONVS_PER_BATCH = 53           # conv1 + 16 x 3 + 4 branch1
FOLD_IMAGES = 2048                  # gallery decodes through the fold
FOLD_F32_ATOL = 1e-4                # folded vs unfolded, both f32: the BN
#   affine moved into the weights rounds differently through 53 convs (the
#   port on the CPU at 96x32: within 1e-5)
FOLD_BF16_MIN_COS = 0.999           # folded vs unfolded, both bf16: the
#   folded weights round to bf16 themselves, and the BN no longer runs in
#   f32 between conv and cast
INT8_MIN_COS = 0.99                 # int8 vs bf16 embeddings of the same
#   images: per-tensor input scales over 53 convs (pps_tpu reports
#   ~0.9996 at its yaml on trained weights)
EXPORT_ATOL = 1e-6                  # a reloaded .pt2 vs eager extraction:
#   the same weights and the same kernels
GN_CHECK_IMAGES = 4


_CARD = {}  # 'smi': the card's name and power limit, from phase build


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds per call of ``fn`` on the current stream
    (``utils/timer.cuda_ms``)."""
    from pps_tpu_torch.utils.timer import cuda_ms as device_ms
    return device_ms(fn, iters, warmup)


# the numpy metrics (the golden path) of the test phases' distance matrices
# run in worker processes beside the phases that follow, and their gates
# are applied before the script's last lines (settle_numpy_checks)
NUMPY_WORKERS = 2
_NUMPY = {'pool': None, 'pending': []}


def numpy_metrics(host, q_ids, g_ids, q_cams, g_cams):
    """numpy's mAP and CMC of a query x gallery distance matrix, and the
    seconds they took."""
    from pps_tpu_torch.evaluation import evaluator as ev
    from pps_tpu_torch.evaluation import metrics
    t0 = time.perf_counter()
    m = metrics.mean_ap(host, q_ids, g_ids, q_cams, g_cams)
    c = metrics.cmc(host, q_ids, g_ids, q_cams, g_cams, topk=10,
                    **ev.CMC_KWARGS)
    return m, c, time.perf_counter() - t0


def defer_numpy_check(phase, host, q_ids, g_ids, q_cams, g_cams, map_card,
                      cmc_card):
    """Hold the card's mAP and CMC of ``phase`` against numpy's on the same
    matrix ``host``, in a worker process (spawned: no CUDA state crosses)."""
    if _NUMPY['pool'] is None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _NUMPY['pool'] = ProcessPoolExecutor(
            NUMPY_WORKERS, mp_context=multiprocessing.get_context('spawn'))
    fut = _NUMPY['pool'].submit(numpy_metrics, host, q_ids, g_ids, q_cams,
                                g_cams)
    _NUMPY['pending'].append((phase, fut, float(map_card),
                              np.asarray(cmc_card)))


def settle_numpy_checks():
    """Wait for every deferred numpy check and apply its gates (CMC equal,
    mAP within MAP_ATOL); one numpy_checks line; the workers stopped."""
    out = {}
    try:
        for phase, fut, m_card, c_card in _NUMPY['pending']:
            m_np, c_np, secs = fut.result()
            if not np.array_equal(c_card, c_np) or \
                    abs(m_card - m_np) > MAP_ATOL:
                raise AssertionError('{}: card CMC/mAP {} {} vs numpy {} {}'
                                     .format(phase, c_card, m_card, c_np,
                                             m_np))
            out[phase] = {'map_card': m_card, 'map_numpy': m_np,
                          'map_diff': abs(m_card - m_np), 'cmc_equal': True,
                          'numpy_metrics_s': secs}
    finally:
        if _NUMPY['pool'] is not None:
            _NUMPY['pool'].shutdown(cancel_futures=True)
        _NUMPY['pool'], _NUMPY['pending'] = None, []
    emit('numpy_checks', map_atol=MAP_ATOL, phases=out)


def phase_build():
    from pps_tpu_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    seconds = time.perf_counter() - t0
    smi = nvidia_smi_line()
    _CARD['smi'] = smi
    print(smi, flush=True)
    from pps_tpu_torch.tools.conv2d_int8_check import ptxas_table
    ptxas = {n: [ln for ln in r['log'].splitlines()
                 if 'registers' in ln or 'spill' in ln]
             for n, r in report.items() if n != 'conv2d_int8'}
    # conv2d_int8: registers, spills and wgmma serialization by instantiation
    ptxas['conv2d_int8'] = ptxas_table(report['conv2d_int8']['log'])
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
    from pps_tpu_torch.utils.flops import model_fwd_flops
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
    tflops = model_fwd_flops(cfg) * GALLERY / seconds / 1e12
    emit('extract', images=GALLERY, batch=BATCH, dim=int(feats.shape[1]),
         dtype=cfg.MODEL.DTYPE, input_hw=[h, w], raw_hw=list(RAW_HW),
         seconds=seconds, imgs_per_s=GALLERY / seconds,
         host_seconds=host_seconds, fwd_gflop_per_img=model_fwd_flops(cfg)
         / 1e9, tflops=tflops, mfu=tflops * 1e12 / BF16_PEAK_FLOPS,
         mfu_peak='989 TFLOP/s dense bf16 (H100 SXM)',
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
    from pps_tpu_torch.tools.trace_top_ops import profile_rows
    rows, device_us = profile_rows(prof)
    emit('profile', batches=4, wall_ms=wall * 1e3,
         device_ms=device_us / 1e3,
         idle_share=max(0.0, 1 - device_us / 1e6 / wall), top=rows)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_batch(gallery, p, k, num_classes, dev):
    """P identities x K images from the gallery decodes, every other image
    flipped, labels on a P x K pattern, all on ``dev``."""
    import torch
    n = p * k
    labels = np.repeat(np.arange(p) * 7 + 3, k)
    oh = np.zeros((n, num_classes - 1), np.float32)
    oh[np.arange(n), labels] = 1.0
    return {'data_u8': torch.from_numpy(gallery[:n].copy()).to(dev),
            'flipped': torch.from_numpy(np.arange(n) % 2 == 1).to(dev),
            'labels_int32': torch.from_numpy(labels.astype(np.int32)).to(dev),
            'labels_oh': torch.from_numpy(oh).to(dev)}


def make_trainer(cfg, dev, seed, residual_gamma=1.0, mesh=None):
    """(model, step, train_state) for ``cfg`` on ``dev`` from a seeded
    init; ``residual_gamma`` scales each residual branch's last BN; a
    distributed ``mesh`` gives the data-parallel step."""
    import torch
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.parallel.train_step import make_train_step
    from pps_tpu_torch.solver import optimizer as opt
    model = build_model(cfg, device=dev)
    params, state = model.init(torch.Generator().manual_seed(seed))
    params = {k: v * residual_gamma if k.endswith('_branch2c_bn_s') else v
              for k, v in params.items()}
    step = make_train_step(model, cfg, opt.make_param_meta(params, cfg),
                           trainable=opt.trainable_from_cfg(cfg, params),
                           device=dev, mesh=mesh)
    return model, step, {'params': params, 'state': state,
                         'opt': opt.init_opt_state(params)}


def phase_train(dev, gallery):
    """The flagship train step at batch 64: time, gates, json_stats and a
    checkpoint round trip."""
    import torch
    from pps_tpu_torch.engine.stats import TrainingStats
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.solver.lr_policy import get_lr_at_iter
    from pps_tpu_torch.utils.flops import model_fwd_flops
    cfg = flagship_cfg()
    n = TRAIN_P * TRAIN_K
    model, step, ts = make_trainer(cfg, dev, seed=0)
    init = ts
    batch = train_batch(gallery, TRAIN_P, TRAIN_K, cfg.MODEL.NUM_CLASSES,
                        dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ep_size = MARKET_TRAIN_IMAGES // n
    stats = TrainingStats(WARMUP_STEPS + TIMED_STEPS, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events = [], []
    for it in range(WARMUP_STEPS + TIMED_STEPS):
        lr = float(get_lr_at_iter(cfg, it, 0, ep_size))
        if it >= WARMUP_STEPS:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        stats.IterTic()
        ts, logs = step(ts, batch, lr, 1.0, gen)
        stats.IterToc()  # host time to queue the step
        losses.append(logs['loss'])
        stats.UpdateIterStats(logs)
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    events[-1].synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats.LogIterStats(WARMUP_STEPS + TIMED_STEPS - 1, lr, force=True)
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite train loss: {}'.format(losses))
    timed = losses[WARMUP_STEPS:]
    first5, last5 = float(timed[:5].mean()), float(timed[-5:].mean())
    if not last5 < first5:
        raise AssertionError('loss did not fall: first 5 {} last 5 {}'.format(
            first5, last5))
    moved_state = sum(not torch.equal(ts['state'][k], init['state'][k])
                      for k in init['state'])
    moved_mom = sum(bool(v.any()) for v in ts['opt']['momentum'].values())
    if moved_state != len(init['state']) or moved_mom == 0:
        raise AssertionError('state moved {}/{}, momentum {}'.format(
            moved_state, len(init['state']), moved_mom))
    # the triplet term off (TRIPLET_LOSS_CROSS's other epoch type)
    ts0, logs0 = step(ts, batch, lr, 0.0, gen)
    loss0 = float(logs0['loss'])
    if not np.isfinite(loss0) or float(logs0['pps01234_triplet_loss']) != 0:
        raise AssertionError('loss_scale_factor 0 step: {}'.format(loss0))
    ckpt = checkpoint_round_trip(model, cfg, ts)
    ms = float(np.median(step_ms))
    tflops = 3 * model_fwd_flops(cfg) * n / (ms / 1e3) / 1e12
    emit('train', batch=n, p=TRAIN_P, k=TRAIN_K, dtype=cfg.MODEL.DTYPE,
         steps=TIMED_STEPS, warmup=WARMUP_STEPS, ms_per_step=ms,
         ms_min=min(step_ms), ms_max=max(step_ms), imgs_per_s=n / ms * 1e3,
         train_gflop_per_img=3 * model_fwd_flops(cfg) / 1e9, tflops=tflops,
         mfu=tflops * 1e12 / BF16_PEAK_FLOPS,
         mfu_peak='989 TFLOP/s dense bf16 (H100 SXM)', peak_mem_gb=peak_gb,
         loss_first5=first5, loss_last5=last5,
         losses=[float(v) for v in losses], loss_lsf0=loss0,
         lr_last=lr, state_moved=moved_state, momentum_moved=moved_mom,
         checkpoint=ckpt)
    return step, ts, batch, ms


def checkpoint_round_trip(model, cfg, ts):
    """Save (params, state, momentum) as a pkl, load it into zeroed
    copies, and require every tensor back bit for bit."""
    import torch
    from pps_tpu_torch.engine import checkpoint as ck
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'build', 'chip_smoke_train.pkl')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    ck.save_checkpoint(path, model, ts['params'], ts['state'],
                       opt_state=ts['opt'], cfg=cfg)
    save_s = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 1e6

    def zeros(tree):
        return {k: torch.zeros_like(v) for k, v in tree.items()}
    t0 = time.perf_counter()
    p, s, o = ck.load_checkpoint(path, model, zeros(ts['params']),
                                 zeros(ts['state']),
                                 opt_state={'momentum': zeros(
                                     ts['params'])})
    load_s = time.perf_counter() - t0
    os.remove(path)
    for got, want in ((p, ts['params']), (s, ts['state']),
                      (o['momentum'], ts['opt']['momentum'])):
        for k in want:
            if not torch.equal(got[k], want[k]):
                raise AssertionError('checkpoint round trip: {}'.format(k))
    return {'bitwise': True, 'tensors': len(p) + len(s) + len(o['momentum']),
            'mb': size_mb, 'save_s': save_s, 'load_s': load_s}


def _rms(t):
    import torch
    return float(torch.sqrt(torch.mean(t.double().cpu() ** 2)))


def phase_train_agree(dev, gallery):
    """One step at full width and depth, P 4 x K 2, the same draws on both
    sides: card f32 vs CPU f32 (loss, params, BN state, momentum) and card
    bf16 vs card f32 (loss)."""
    import torch
    from pps_tpu_torch.data import device_augment as aug
    from pps_tpu_torch.flagship import flagship_cfg
    p, k = 4, 2
    cfg32 = flagship_cfg(dtype='float32', ims_per_batch=p * k, p=p, k=k)
    spec = aug.augment_spec(cfg32)
    gen = torch.Generator().manual_seed(1)
    draws = {'augment': aug.sample_params(gen, spec, p * k, RAW_HW,
                                          torch.device('cpu')),
             'dropout_mask': torch.rand(p * k, 31, 128, generator=gen) < 0.8}
    out = {}
    for name, where, dtype in (('cpu', 'cpu', 'float32'),
                               ('card', dev, 'float32'),
                               ('card_bf16', dev, 'bfloat16')):
        cfg = flagship_cfg(dtype=dtype, ims_per_batch=p * k, p=p, k=k)
        where = torch.device(where)
        _, step, ts = make_trainer(cfg, where, seed=1, residual_gamma=0.01)
        start = {n: v.cpu() for n, v in ts['params'].items()}
        t0 = time.perf_counter()
        new, logs = step(
            ts, train_batch(gallery, p, k, cfg.MODEL.NUM_CLASSES, where),
            0.01, 1.0, None,
            draws={'augment': {n: v.to(where) for n, v in
                               draws['augment'].items()},
                   'dropout_mask': draws['dropout_mask'].to(where)})
        out[name] = (new, float(logs['loss']), time.perf_counter() - t0)
    flagship_cfg()  # the global cfg back to the bf16 flagship
    (cn, closs, cpu_s), (gn, gloss, _), (_, bloss, _) = (
        out['cpu'], out['card'], out['card_bf16'])
    loss_rel = abs(gloss - closs) / abs(closs)
    if loss_rel > TRAIN_LOSS_RTOL:
        raise AssertionError('card f32 loss {} vs cpu {}'.format(gloss,
                                                                 closs))
    disp = {n: cn['params'][n] - start[n] for n in start}
    floor = TRAIN_FLOOR * _rms(torch.cat([d.flatten()
                                          for d in disp.values()]))
    worst = {'params': 0.0, 'momentum': 0.0, 'state': 0.0}
    for n in start:
        d_g = gn['params'][n].cpu() - start[n]
        e = _rms(d_g - disp[n]) / (_rms(disp[n]) + floor / TRAIN_REL)
        m_c, m_g = cn['opt']['momentum'][n], gn['opt']['momentum'][n].cpu()
        em = _rms(m_g - m_c) / (_rms(m_c) + floor / TRAIN_REL)
        worst['params'] = max(worst['params'], e)
        worst['momentum'] = max(worst['momentum'], em)
        if e > TRAIN_REL or em > TRAIN_REL:
            raise AssertionError('card vs cpu after one step: {} ({}, {})'
                                 .format(n, e, em))
    for n in cn['state']:
        e = _rms(gn['state'][n].cpu() - cn['state'][n]) / _rms(
            cn['state'][n])
        worst['state'] = max(worst['state'], e)
        if e > TRAIN_STATE_REL:
            raise AssertionError('card vs cpu BN state: {} ({})'.format(n, e))
    bf16_rel = abs(bloss - gloss) / abs(gloss)
    if bf16_rel > BF16_LOSS_RTOL:
        raise AssertionError('bf16 loss {} vs f32 {}'.format(bloss, gloss))
    emit('train_agree', batch=p * k, loss_cpu=closs, loss_card=gloss,
         loss_card_bf16=bloss, f32_loss_rel=loss_rel,
         f32_loss_rtol=TRAIN_LOSS_RTOL, worst_rel=worst,
         rel=TRAIN_REL, floor=TRAIN_FLOOR, state_rel=TRAIN_STATE_REL,
         bf16_loss_rel=bf16_rel, bf16_loss_rtol=BF16_LOSS_RTOL,
         residual_gamma=0.01, cpu_step_s=cpu_s)


def phase_profile_train(dev, step, ts, batch):
    """torch.profiler over 2 train steps: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(2)
    ts, _ = step(ts, batch, 0.001, 1.0, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            ts, _ = step(ts, batch, 0.001, 1.0, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from pps_tpu_torch.tools.trace_top_ops import profile_rows
    rows, device_us = profile_rows(prof)
    emit('profile_train', steps=2, wall_ms=wall * 1e3,
         device_ms=device_us / 1e3,
         idle_share=max(0.0, 1 - device_us / 1e6 / wall), top=rows)


# ---------------------------------------------------------------------------
# the train -> test drivers on a synthetic Market-shaped dataset
# ---------------------------------------------------------------------------


class MarketDecoder(object):
    """decode_fn(path) -> [128, 64, 3] uint8 from the file name alone
    (``{id:08d}_{cam:04d}_{image:08d}.jpg``, the names ``parse_im_name``
    reads): 8x4 colour blocks seeded by the identity, mixed 2:1 with the
    blocks of one of DISTRACTORS patterns picked by the image number
    (which images of other identities share, so that retrieval is not
    trivial), plus one of NOISE_BANK noise patterns.  No files."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self._noise = rng.randint(-16, 17, size=(NOISE_BANK,) + RAW_HW
                                  + (3,)).astype(np.int16)
        self._blocks = {}

    def _block(self, key):
        b = self._blocks.get(key)
        if b is None:
            b = np.random.RandomState(key).randint(0, 256, (8, 4, 3))
            self._blocks[key] = b = b.astype(np.int16)
        return b

    def __call__(self, path):
        name = os.path.basename(path)
        pid, iid = int(name[:8]), int(name.split('_')[-1].split('.')[0])
        mixed = (2 * self._block(pid) + self._block(
            DISTRACTOR_SEED + iid % DISTRACTORS)) // 3
        im = mixed.repeat(RAW_HW[0] // 8, 0).repeat(RAW_HW[1] // 4, 1)
        return np.clip(im + self._noise[iid % NOISE_BANK], 0,
                       255).astype(np.uint8)


def write_reid(root, prefix, train, test, size_of=None):
    """trainval.json and test.json under ``root`` from (pid, cam, mark)
    lists, registered as <prefix>_trainval / <prefix>_test; each image's
    height/width from ``size_of(image id)`` (default: RAW_HW)."""
    from pps_tpu_torch.data import catalog
    imdir = os.path.join(root, 'images')
    os.makedirs(imdir, exist_ok=True)

    def write(split, entries):
        images, anns, cats = [], [], {}
        for iid, (pid, cam, mark) in enumerate(entries, start=1):
            cats[pid] = {'id': pid, 'name': '{:08d}'.format(pid)}
            h, w = RAW_HW if size_of is None else size_of(iid)
            images.append({'id': iid, 'width': int(w), 'height': int(h),
                           'file_name':
                           '{:08d}_{:04d}_{:08d}.jpg'.format(pid, cam, iid)})
            ann = {'id': iid, 'image_id': iid, 'category_id': pid}
            if mark is not None:
                ann['mark'] = mark
            anns.append(ann)
        path = os.path.join(root, split + '.json')
        with open(path, 'w') as f:
            json.dump({'images': images, 'annotations': anns,
                       'categories': list(cats.values())}, f)
        catalog.register_dataset(prefix + '_' + split, imdir, path)

    write('trainval', train)
    write('test', test)


def write_market(root):
    """trainval.json (TRAIN_IDS x TRAIN_PER_ID, 6 cameras) and test.json
    (QUERIES queries and GALLERY gallery images of TEST_IDS identities,
    each query's identity in every camera of the gallery) under ``root``,
    registered as market1501_trainval / market1501_test."""
    write_reid(root, 'market1501',
               [(pid, j % 6 + 1, None) for pid in range(1, TRAIN_IDS + 1)
                for j in range(TRAIN_PER_ID)],
               [(1000 + i % TEST_IDS, (i // TEST_IDS) % 6 + 1, 0)
                for i in range(QUERIES)]
               + [(1000 + j % TEST_IDS, (j // TEST_IDS) % 6 + 1, 1)
                  for j in range(GALLERY)])


def driver_cfg(out_dir):
    """The flagship yaml, cut: 3 epochs, epoch 1 a triplet epoch, the LR
    halving at epoch 2, a snapshot per epoch, no bootstrap weights."""
    from pps_tpu_torch.config import (cfg, reset_cfg, merge_cfg_from_file,
                                      merge_cfg_from_list,
                                      assert_and_infer_cfg)
    reset_cfg()
    merge_cfg_from_file(FLAGSHIP_YAML)
    merge_cfg_from_list(['TRAIN.WEIGHTS', "''",
                         'SOLVER.MAX_ITER', str(DRIVER_EPOCHS),
                         'SOLVER.STEPS', '[0, 2]',
                         'REID.TRIPLET_LOSS_START', '0',
                         'TRAIN.SNAPSHOT_ITERS', '1', 'OUTPUT_DIR', out_dir])
    assert_and_infer_cfg()
    return cfg


def wire_kind(batch):
    """'u8p' (padded uint8), 'u8' (raw uint8) or 'data' (the host chain's
    float32 wire, with its dtype)."""
    if 'valid_hw' in batch:
        return 'u8p'
    if 'data_u8' in batch:
        return 'u8'
    return 'data:' + str(batch['data'].dtype).replace('torch.', '')


class StepRecorder(object):
    """While active, records what ``train_model`` does at each step: the
    (epoch, step in epoch), the epoch plans' batch indices, a CUDA event
    at the step's start, the loss (on the card), the loader's queue depth,
    and the last train state."""

    def __init__(self):
        self.plans, self.at, self.events, self.losses = {}, [], [], []
        self.qsize, self.kinds, self.state = [], [], None

    def __enter__(self):
        import torch
        from pps_tpu_torch.data import loader as loader_lib
        from pps_tpu_torch.parallel import train_step as ts_lib
        cls = loader_lib.ReIDLoader
        self._saved = [(cls, 'plan_epoch', cls.plan_epoch),
                       (cls, 'iter_epoch', cls.iter_epoch),
                       (ts_lib, 'make_train_step', ts_lib.make_train_step)]
        plan_epoch, iter_epoch, make = (v for _, _, v in self._saved)

        def plan(loader, ep):
            out = plan_epoch(loader, ep)
            self.plans[ep] = [list(p[3]) for p in out]
            return out

        def iterate(loader, ep, start_step=0):
            for item in iter_epoch(loader, ep, start_step):
                self.at.append((ep, item[0]))
                self.qsize.append(loader.qsize())
                self.kinds.append(wire_kind(item[2]))
                yield item

        def make_step(*args, **kwargs):
            step = make(*args, **kwargs)

            def recorded(*a, **k):
                from torch._subclasses.fake_tensor import FakeTensor
                if isinstance(a[1]['labels_int32'], FakeTensor):
                    return step(*a, **k)  # the graph dump's trace
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.state, logs = step(*a, **k)
                self.losses.append(logs['loss'])
                return self.state, logs
            return recorded
        cls.plan_epoch, cls.iter_epoch = plan, iterate
        ts_lib.make_train_step = make_step
        return self

    def __exit__(self, *exc):
        for owner, name, value in self._saved:
            setattr(owner, name, value)
        return False

    def indices(self, k):
        ep, i = self.at[k]
        return self.plans[ep][i]


@contextlib.contextmanager
def phase_log(name):
    """The phase's stdout and the port's log records go to
    build/chip_smoke_logs/<name>.log; yields the path."""
    path = os.path.join(ROOT, 'build', 'chip_smoke_logs', name + '.log')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    log = logging.getLogger('pps_tpu_torch')
    with open(path, 'w') as f:
        handler = logging.StreamHandler(f)
        handler.setFormatter(logging.Formatter(
            '%(levelname)s %(name)s: %(message)s'))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        try:
            with contextlib.redirect_stdout(f):
                yield path
        finally:
            log.removeHandler(handler)


def _read(path):
    with open(path) as f:
        return f.read().splitlines()


def phase_train_net(dev, out_root, decode, bare_ms):
    """train_model on the flagship yaml over the synthetic Market split."""
    import torch
    from pps_tpu_torch.engine.train import train_model
    cfg = driver_cfg(os.path.join(out_root, 'train_net'))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with phase_log('train_net') as log, StepRecorder() as rec:
        t0 = time.perf_counter()
        ckpts = train_model(cfg, decode_fn=decode, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    lines = _read(log)
    out_dir = os.path.dirname(ckpts['final'])
    names = sorted(os.listdir(out_dir))
    want = ['model_epoch1.pkl', 'model_epoch3.pkl', 'model_final.pkl']
    if names != want:
        raise AssertionError('checkpoints {} != {}'.format(names, want))
    losses = torch.stack(rec.losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite train loss')
    ipe = len(rec.plans[0])
    # epochs 0 and 2 both run at loss_scale_factor 0: compare like with
    # like, the first steps of epoch 0 against the last of epoch 2
    n = min(10, ipe // 2)
    first, last = float(losses[:n].mean()), float(losses[-n:].mean())
    if not last < first:
        raise AssertionError('loss did not fall: {} -> {}'.format(first,
                                                                  last))
    scaled = [ln for ln in lines if 'scaling update history' in ln]
    if not scaled:
        raise AssertionError('no momentum-correction line was logged')
    step_ms = [a.elapsed_time(b) for a, b in zip(rec.events[:-1],
                                                 rec.events[1:])]
    ms = float(np.median(step_ms))
    emit('train_net', config=os.path.relpath(FLAGSHIP_YAML, ROOT),
         entries=TRAIN_IDS * TRAIN_PER_ID * 2, steps_per_epoch=ipe,
         epochs=DRIVER_EPOCHS, steps=len(losses), batch=BATCH,
         ms_per_step=ms, ms_p90=float(np.percentile(step_ms, 90)),
         wall_s=seconds, wall_ms_per_step=seconds / len(losses) * 1e3,
         bare_step_ms=bare_ms, vs_bare=ms / bare_ms,
         imgs_per_s=BATCH / ms * 1e3,
         mb_qsize_median=float(np.median(rec.qsize)),
         mb_qsize_min=int(min(rec.qsize)),
         loss_first=first, loss_last=last, loss_mean_of=n,
         loss_epoch_ends=[float(losses[ipe - 1]), float(losses[-1])],
         checkpoints=names, momentum_lines=scaled[:2],
         json_stats_lines=sum(ln.startswith('json_stats: ') for ln in lines),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, log=log)
    return cfg, rec, ckpts['final']


class _AfterSteps(object):
    """preempt_event: is_set() turns True at its n-th poll (one a step)."""

    def __init__(self, n):
        self.calls, self.n = 0, n

    def clear(self):
        pass

    def is_set(self):
        self.calls += 1
        return self.calls >= self.n


def phase_resume(dev, out_root, decode, cont, cont_final):
    """The train_net run again in a fresh directory holding train_net's
    epoch-1 snapshot (so it auto-resumes at epoch 1: the epoch before was
    train_net's own run, and the 900 s budget has no room for it twice),
    preempted mid-epoch 1, then auto-resumed to the end."""
    import torch
    from pps_tpu_torch.config import get_output_dir
    from pps_tpu_torch.engine.train import Preempted, train_model
    from pps_tpu_torch.utils.io import load_object
    cfg = driver_cfg(os.path.join(out_root, 'resume'))
    out_dir = get_output_dir(cfg.TRAIN.DATASETS, training=True)
    shutil.copyfile(os.path.join(os.path.dirname(cont_final),
                                 'model_epoch1.pkl'),
                    os.path.join(out_dir, 'model_epoch1.pkl'))
    skipped = cont.at.index((1, 0))  # the steps of epoch 0
    with phase_log('resume') as log:
        t0 = time.perf_counter()
        try:
            train_model(cfg, decode_fn=decode, device=dev,
                        preempt_event=_AfterSteps(PREEMPT_AFTER - skipped))
            raise AssertionError('the run was not preempted')
        except Preempted as p:
            point = (p.epoch, p.step, os.path.basename(p.path))
        with StepRecorder() as rec:
            ckpts = train_model(cfg, decode_fn=decode, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if point[:2] != cont.at[PREEMPT_AFTER]:
        raise AssertionError('preempted at {}, expected {}'.format(
            point, cont.at[PREEMPT_AFTER]))
    resumed = [ln for ln in _read(log) if 'Auto-resuming' in ln]
    if len(resumed) != 2 or rec.at[0] != cont.at[PREEMPT_AFTER]:
        raise AssertionError('did not resume at {}: {}'.format(
            cont.at[PREEMPT_AFTER], resumed))
    if rec.indices(0) != cont.indices(PREEMPT_AFTER):
        raise AssertionError('the resumed step trained on another batch')
    loss, want = float(rec.losses[0]), float(cont.losses[PREEMPT_AFTER])
    rel = abs(loss - want) / abs(want)
    if rel > RESUME_LOSS_RTOL:
        raise AssertionError('resumed loss {} vs continuous {}'.format(
            loss, want))
    if not os.path.exists(ckpts['final']):
        raise AssertionError('no model_final.pkl after the resume')
    got = load_object(ckpts['final'])['blobs']
    ref = load_object(cont_final)['blobs']
    equal = sum(np.array_equal(got[k], ref[k]) for k in ref)
    worst = max(float(np.max(np.abs(got[k] - ref[k])) /
                      max(float(np.max(np.abs(ref[k]))), 1e-30))
                for k in ref)
    emit('resume', preempted_at=list(point), resumed_at=list(rec.at[0]),
         resumed_steps=len(rec.losses), same_batch=True,
         first_loss=loss, continuous_loss=want, loss_rel=rel,
         loss_rtol=RESUME_LOSS_RTOL, wall_s=seconds,
         checkpoints=sorted(os.listdir(os.path.dirname(ckpts['final']))),
         final_blobs_bitwise_equal=equal, final_blobs=len(ref),
         final_worst_rel_diff=worst, log=log)


def phase_test_net(dev, out_root, cfg, final_pkl, decode, train_rec,
                   name='test_net'):
    """run_inference with model_final.pkl on the Market-sized test split;
    the features, the card's metrics and features.pkl held.  ``name``
    names the phase (its output directory, log and line).  Returns the
    features, the roidb, and the run's mAP and extraction rate."""
    import torch
    import yaml
    from pps_tpu_torch.engine import test as test_lib
    from pps_tpu_torch.evaluation import evaluator as ev
    from pps_tpu_torch.evaluation.device_eval import cmc_map_device
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.ops.distance import euclidean_distmat
    from pps_tpu_torch.parallel.eval_step import (make_extract_fn,
                                                  extract_features)
    from pps_tpu_torch.utils.io import load_object
    out_dir = os.path.join(out_root, name)
    seen = {}
    extract, evaluate = (test_lib.extract_dataset_features,
                         test_lib.evaluate_dataset)

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seen[name] = (out, time.perf_counter() - t0)
            return out
        return run
    test_lib.extract_dataset_features = timed('extract', extract)
    test_lib.evaluate_dataset = timed('eval', evaluate)
    try:
        with phase_log(name) as log:
            t0 = time.perf_counter()
            results = test_lib.run_inference(cfg, weights_file=final_pkl,
                                             output_dir=out_dir,
                                             decode_fn=decode, device=dev)
            seconds = time.perf_counter() - t0
    finally:
        test_lib.extract_dataset_features = extract
        test_lib.evaluate_dataset = evaluate
    single = [ln for ln in _read(log) if ln.startswith('Single Query:')]
    print(single[0], flush=True)
    feats, extract_s = seen['extract']
    n = QUERIES + GALLERY
    if feats.shape != (n, 3968) or not np.isfinite(feats).all():
        raise AssertionError('features {}'.format(feats.shape))
    # the same features from the in-memory final state of train_net, by
    # the stacked path timed in its two parts: the decode threads alone,
    # then the model over the decoded stack (what streaming overlaps)
    model = build_model(cfg, device=dev)
    roidb = test_lib.roidb_for_test('market1501_test')
    t0 = time.perf_counter()
    stack = test_lib.decode_uint8_stack(roidb, decode_fn=decode)
    decode_s = time.perf_counter() - t0
    w, h = cfg.REID.SCALE
    fn = make_extract_fn(model, device_preproc=(cfg.PIXEL_MEANS, (h, w)),
                         device=dev)
    t0 = time.perf_counter()
    mem = extract_features(fn, train_rec.state['params'],
                           train_rec.state['state'], stack, BATCH)
    stacked_s = time.perf_counter() - t0
    del stack
    feat_diff = float(np.max(np.abs(mem - feats)))
    if feat_diff > FEAT_ATOL:
        raise AssertionError('pkl vs in-memory features: {}'.format(
            feat_diff))
    # the card's metrics against numpy on the card's distance matrix
    marks = np.array([e['mark'] for e in roidb])
    ids = np.array([ev.parse_im_name(e['im_name'], 'id') for e in roidb])
    cams = np.array([ev.parse_im_name(e['im_name'], 'cam') for e in roidb])
    q, g = marks == 0, marks == 1
    ft = torch.as_tensor(feats, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dm = euclidean_distmat(ft[torch.as_tensor(q, device=dev)],
                           ft[torch.as_tensor(g, device=dev)])
    m_card, c_card = cmc_map_device(dm, ids[q], ids[g], cams[q], cams[g])
    m_card, c_card = float(m_card), c_card.cpu().numpy()
    card_s = time.perf_counter() - t0
    defer_numpy_check(name, dm.cpu().numpy(), ids[q], ids[g], cams[q],
                      cams[g], m_card, c_card)
    if abs(results['market1501_test']['single']['mAP'] - m_card) > MAP_ATOL:
        raise AssertionError('run_inference mAP differs from the card\'s')
    pkl = load_object(os.path.join(out_dir, 'features.pkl'))
    plain = yaml.safe_load(pkl['cfg'])
    if not np.array_equal(pkl['all_feats'], feats) or \
            plain['MODEL']['NUM_CLASSES'] != cfg.MODEL.NUM_CLASSES:
        raise AssertionError('features.pkl does not hold the run')
    emit(name, queries=int(q.sum()), gallery=int(g.sum()),
         single_query=single[0], mAP=m_card, cmc1=float(c_card[0]),
         extract_s=extract_s, extract_imgs_per_s=n / extract_s,
         decode_only_imgs_per_s=n / decode_s,
         stacked_extract_imgs_per_s=n / stacked_s,
         eval_s=seen['eval'][1], run_inference_s=seconds,
         pkl_vs_memory_max_abs=feat_diff, feat_atol=FEAT_ATOL,
         map_card=m_card, numpy_check='deferred: the numpy_checks line',
         card_metrics_s=card_s,
         features_pkl_mb=os.path.getsize(os.path.join(
             out_dir, 'features.pkl')) / 1e6, log=log)
    return feats, roidb, {'mAP': m_card, 'extract_imgs_per_s': n / extract_s}


# ---------------------------------------------------------------------------
# the model variants: the int8 kernel, FPN, BN folding, int8 PTQ, export,
# GroupNorm
# ---------------------------------------------------------------------------


def int8_inputs(gen, n, conv, dev, per_channel=False):
    """Seeded inputs of one int8 conv on the card: x float32 for the stem,
    bf16 for the body, NHWC memory; OHWI int8 weights; scales in the
    ranges a calibrated body has."""
    import torch
    _, cin, h, w, cout, k, _, _, groups = conv
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


def int8_bound(conv, n, x, out_bytes):
    """(ops s, bytes s) of one int8 conv: its products over the dense int8
    peak, and its input (in its dtype), int8 weights, scales and output
    over the memory rate."""
    _, cin, h, w, cout, k, s, _, groups = conv
    ho, wo = -(-h // s), -(-w // s)
    ops = 2.0 * n * ho * wo * k * k * (cin // groups) * cout
    nbytes = (x.numel() * x.element_size() + cout * k * k * cin // groups
              + 4 * (2 * cout + cin) + n * ho * wo * cout * out_bytes)
    return ops / INT8_PEAK_OPS, nbytes / HBM_BYTES_PER_S


def check_int8(args, conv):
    """conv2d_int8 against its plain version on one conv's inputs, bitwise:
    the bf16 output and the int32 accumulators."""
    import torch
    from pps_tpu_torch.kernels import conv2d_int8 as ck
    _, _, _, _, _, _, s, d, g = conv
    for acc in (True, False):
        got = ck.conv2d_int8(*args, stride=s, dilation=d, groups=g,
                             out_dtype=torch.bfloat16, accumulators=acc)
        want = ck.conv2d_int8_plain(*args, stride=s, dilation=d, groups=g,
                                    out_dtype=torch.bfloat16,
                                    accumulators=acc)
        torch.cuda.synchronize()
        bits = torch.int32 if acc else torch.int16
        if not torch.equal(got.view(bits), want.view(bits)):
            raise AssertionError('conv2d_int8 != plain: {} n={} {}'.format(
                conv, args[0].shape[0], 'acc' if acc else 'bf16'))


def sass_has(lib_path, opcodes):
    """{opcode: count} of the SASS instructions in a built library
    (``cuobjdump --dump-sass``, found beside nvcc)."""
    from pps_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '--dump-sass', str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {op: sass.count(op) for op in opcodes}


def phase_kernel_int8(dev):
    """conv2d_int8 against its plain version on the card, bitwise (the
    bf16 output and the int32 accumulators), on the 53 convs of the R-50
    body at batch 4, BATCH (the main path's) and INT8_TAIL, a ragged shape
    and a grouped one with per-channel scales; every body conv's route, and
    its time at BATCH beside its bound, its plain version, cuDNN's bf16
    conv and (1x1 convs) torch._int_mm.  Times are device times: CUDA
    events around replays of a CUDA graph of 10 calls (eager calls back to
    back, which add the host's time per call, as ``eager_ms``).  Gates: the
    library's SASS holds wgmma (IGMMA, its s8 form) and TMA loads
    (UTMALDG), and every body conv takes a wgmma route."""
    import torch
    import torch.nn.functional as F
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.kernels import build
    from pps_tpu_torch.kernels import conv2d_int8 as ck
    from pps_tpu_torch.models import resnet as resnet_lib
    from pps_tpu_torch.tools.conv2d_int8_check import graph_ms
    cfg = flagship_cfg()
    w_in, h_in = cfg.REID.SCALE
    convs = ck.resnet_body_convs(resnet_lib.resnet_spec(cfg, 50), h_in, w_in)
    if len(convs) != INT8_CONVS_PER_BATCH:
        raise AssertionError('{} body convs'.format(len(convs)))
    # wgmma assembles to HGMMA for floats and IGMMA for s8 x s8
    sass = sass_has(build.library_path('conv2d_int8'),
                    ('HGMMA', 'IGMMA', 'UTMALDG', 'UTMASTG'))
    if not ((sass['HGMMA'] or sass['IGMMA']) and sass['UTMALDG']):
        raise AssertionError('conv2d_int8 SASS lacks wgmma or TMA: {}'
                             .format(sass))
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(INT8_CHECK_BATCH, c, False) for c in convs] + [
        (3, ('ragged', 64, 13, 7, 70, 3, 1, 1, 1), False),
        (2, ('grouped', 64, 12, 10, 64, 3, 1, 1, 2), True)]
    for n, conv, per_channel in cases:
        check_int8(int8_inputs(gen, n, conv, dev, per_channel), conv)
    rows = []
    for conv in convs:
        args = int8_inputs(gen, BATCH, conv, dev)
        x, wq = args[0], args[1]
        check_int8(args, conv)
        check_int8((x[:INT8_TAIL],) + args[1:], conv)
        _, cin, h, w, cout, k, s, d, g = conv
        r = ck.route(x.dtype, BATCH, cin, h, w, cout, k, k, s, d, g)
        if not r['kind'].startswith('wgmma'):
            raise AssertionError('{} takes the {} route'.format(conv[0],
                                                                r['kind']))
        kw = dict(stride=s, dilation=d, groups=g, out_dtype=torch.bfloat16)
        ms = graph_ms(lambda: ck.conv2d_int8(*args, **kw))
        eager_ms = cuda_ms(lambda: ck.conv2d_int8(*args, **kw), iters=10,
                           warmup=2)
        plain_ms = cuda_ms(lambda: ck.conv2d_int8_plain(*args, **kw),
                           iters=1, warmup=1)
        wb = torch.randn(cout, cin // g, k, k, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        xb = x.to(torch.bfloat16)
        pad = ((k - 1) * d) // 2
        cudnn_ms = graph_ms(lambda: F.conv2d(xb, wb, stride=s, padding=pad,
                                             dilation=d, groups=g))
        int_mm_ms = None
        if k == 1:  # the same int32 product as [N*Ho*Wo, C_in] x [C_in, C_out]
            ho, wo = -(-h // s), -(-w // s)
            a = torch.randint(-127, 128, (BATCH * ho * wo, cin),
                              generator=gen, device=dev, dtype=torch.int8)
            b = wq.reshape(cout, cin).t()
            try:
                int_mm_ms = graph_ms(lambda: torch._int_mm(a, b))
            except RuntimeError as e:  # a yardstick only: report, go on
                int_mm_ms = 'refused: {}'.format(str(e)[:120])
        ops_s, bytes_s = int8_bound(conv, BATCH, x, 2)
        bound_ms = max(ops_s, bytes_s) * 1e3
        rows.append({'conv': conv[0], 'shape': list(conv[1:]),
                     'route': r['kind'], 'bn': r['bn'], 'box': r['box'],
                     'ms': ms, 'eager_ms': eager_ms, 'plain_ms': plain_ms,
                     'cudnn_bf16_ms': cudnn_ms, 'int_mm_ms': int_mm_ms,
                     'ops_s': ops_s, 'bytes_s': bytes_s,
                     'bound_ms': bound_ms,
                     'tops': ops_s * INT8_PEAK_OPS / (ms * 1e-3) / 1e12,
                     'gbps': bytes_s * HBM_BYTES_PER_S / (ms * 1e-3) / 1e9,
                     'bound_share': bound_ms / ms})
    path = os.path.join(ROOT, 'build', 'chip_smoke_logs',
                        'kernel_int8.json')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(rows, f, indent=1)
    named = {r['conv']: r for r in rows}
    timed = {'conv1 (7x7/2, 3->64, f32 in)': named['conv1'],
             'res2 3x3 64->64 at 96x32': named['res2_0_branch2b'],
             'res4 1x1 1024->256 at 24x8': named['res4_1_branch2a']}
    ops_s = sum(r['ops_s'] for r in rows)
    bytes_s = sum(r['bytes_s'] for r in rows)
    one = [r for r in rows if isinstance(r['int_mm_ms'], float)]
    body = {'ms': sum(r['ms'] for r in rows),
            'eager_ms': sum(r['eager_ms'] for r in rows),
            'plain_ms': sum(r['plain_ms'] for r in rows),
            'cudnn_bf16_ms': sum(r['cudnn_bf16_ms'] for r in rows),
            'bound_ms': max(ops_s, bytes_s) * 1e3,
            'bound_by': 'operations' if ops_s >= bytes_s else 'bytes',
            'int_mm_ms_1x1': sum(r['int_mm_ms'] for r in one),
            'kernel_ms_1x1': sum(r['ms'] for r in one)}
    body['tops'] = ops_s * INT8_PEAK_OPS / (body['ms'] * 1e-3) / 1e12
    body['gbps'] = bytes_s * HBM_BYTES_PER_S / (body['ms'] * 1e-3) / 1e9
    body['bound_share'] = body['bound_ms'] / body['ms']
    checks = 2 * (len(cases) + 2 * len(convs))  # output and accumulators
    routes = {}
    for r in rows:
        routes[r['route']] = routes.get(r['route'], 0) + 1
    emit('kernel', name='conv2d_int8', cases=checks,
         bitwise_equal=True, max_abs_err=0.0,
         check_batches=[INT8_CHECK_BATCH, BATCH, INT8_TAIL],
         time_batch=BATCH, routes=routes, sass=sass,
         per_conv=[{k: r[k] for k in ('conv', 'route', 'bn', 'ms', 'tops',
                                      'gbps', 'bound_share')}
                   for r in rows],
         timed_shapes=timed, body_per_batch=body, per_conv_log=path)
    return {'name': 'conv2d_int8', 'route': 'cuda',
            'source': 'pps_tpu_torch/csrc/conv2d_int8.cu',
            'replaces': 'pps_tpu/models/resnet.py:205',
            'replaces_kind': 'XLA int8 conv (conv2d_int8), not a Pallas '
                             'kernel',
            'max_abs_err': 0.0, 'ms': body['ms'],
            'plain_ms': body['plain_ms'], 'bound_ms': body['bound_ms'],
            'bound_by': body['bound_by'], 'library_ms': None,
            'shapes': 'the 53 convs of the R-50 body at batch 64, 384x128',
            'on_main_path': True}


def variant_cfg(yaml_path, out_dir, epochs=None):
    """A yaml cut for the drivers: no bootstrap weights, OUTPUT_DIR, and for
    training ``epochs`` epochs with the triplet loss from epoch 1 and a
    snapshot per epoch."""
    from pps_tpu_torch.config import (cfg, reset_cfg, merge_cfg_from_file,
                                      merge_cfg_from_list,
                                      assert_and_infer_cfg)
    reset_cfg()
    merge_cfg_from_file(yaml_path)
    opts = ['TRAIN.WEIGHTS', "''", 'OUTPUT_DIR', out_dir]
    if epochs is not None:
        opts += ['SOLVER.MAX_ITER', str(epochs), 'SOLVER.STEPS', '[0, 2]',
                 'REID.TRIPLET_LOSS_START', '0', 'TRAIN.SNAPSHOT_ITERS', '1']
    merge_cfg_from_list(opts)
    assert_and_infer_cfg()
    return cfg


def phase_train_fpn(dev, out_root, decode):
    """train_model on the FPN2 yaml over the synthetic Market split: the
    loss falls, the FPN weights survive the pkl (4-d OIHW in the file)."""
    import torch
    from pps_tpu_torch.engine import checkpoint as ckpt_lib
    from pps_tpu_torch.engine.train import train_model
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.utils.io import load_object
    cfg = variant_cfg(FPN2_YAML, os.path.join(out_root, 'train_fpn'),
                      FPN_EPOCHS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with phase_log('train_fpn') as log, StepRecorder() as rec:
        t0 = time.perf_counter()
        ckpts = train_model(cfg, decode_fn=decode, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    losses = torch.stack(rec.losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite FPN train loss')
    ipe = len(rec.plans[0])
    n = min(10, ipe // 2)  # epoch 0 alone: one loss_scale_factor
    first, last = float(losses[:n].mean()), float(losses[ipe - n:ipe].mean())
    if not last < first:
        raise AssertionError('FPN loss did not fall: {} -> {}'.format(
            first, last))
    blobs = load_object(ckpts['final'])['blobs']
    fpn_w = sorted(k for k in blobs if k.startswith('fpn_')
                   and k.endswith('_w'))
    params = rec.state['params']
    if len(fpn_w) != 2:
        raise AssertionError('FPN weights in the pkl: {}'.format(fpn_w))
    for k in fpn_w:
        want = (cfg.FPN.DIM, params[k].shape[0], 1, 1)
        if blobs[k].shape != want:
            raise AssertionError('{} is {} in the pkl'.format(
                k, blobs[k].shape))
    model = build_model(cfg, device=dev)
    p, s = model.init(torch.Generator().manual_seed(0))
    p, s, _ = ckpt_lib.load_checkpoint(ckpts['final'], model, p, s)
    for k in params:
        if not torch.equal(p[k], params[k]):
            raise AssertionError('{} changed through the pkl'.format(k))
    for k in rec.state['state']:
        if not torch.equal(s[k], rec.state['state'][k]):
            raise AssertionError('{} changed through the pkl'.format(k))
    step_ms = [a.elapsed_time(b) for a, b in zip(rec.events[:-1],
                                                 rec.events[1:])]
    emit('train_fpn', config=os.path.relpath(FPN2_YAML, ROOT),
         levels=cfg.REID.FPN_NUM, steps_per_epoch=ipe, epochs=FPN_EPOCHS,
         steps=len(losses), batch=BATCH, head_batch=BATCH * cfg.REID.FPN_NUM,
         ms_per_step=float(np.median(step_ms)),
         ms_p90=float(np.percentile(step_ms, 90)), wall_s=seconds,
         loss_first=first, loss_last=last, loss_mean_of=n,
         fpn_blobs={k: list(blobs[k].shape) for k in fpn_w},
         pkl_round_trip_bitwise=True,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, log=log)
    return cfg, rec, ckpts['final']


def fold_stack(decode):
    """FOLD_IMAGES decoded Market gallery images (a uint8 stack) and their
    roidb entries."""
    from pps_tpu_torch.engine import test as test_lib
    roidb = [e for e in test_lib.roidb_for_test('market1501_test')
             if e['mark'] == 1][:FOLD_IMAGES]
    return test_lib.decode_uint8_stack(roidb, decode_fn=decode), roidb


def folded_model(dev, final_pkl, dtype):
    """The flagship yaml's model in ``dtype`` with test_net's pkl: its
    extraction fn (uint8 wire), params, BN state and BN-folded params."""
    import torch
    from pps_tpu_torch.engine import checkpoint as ckpt_lib
    from pps_tpu_torch.models.folding import fold_conv_bn
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.parallel.eval_step import make_extract_fn
    cfg = variant_cfg(FLAGSHIP_YAML, os.path.join(ROOT, 'build'))
    cfg.immutable(False)
    cfg.MODEL.DTYPE = dtype
    cfg.immutable(True)
    model = build_model(cfg, device=dev)
    p, s = model.init(torch.Generator().manual_seed(0))
    p, s, _ = ckpt_lib.load_checkpoint(final_pkl, model, p, s)
    w, h = cfg.REID.SCALE
    fn = make_extract_fn(model, device_preproc=(cfg.PIXEL_MEANS, (h, w)),
                         device=dev)
    return fn, p, s, fold_conv_bn(p, s)


def events_s(fn):
    """Seconds of ``fn()`` on the current stream (CUDA events), and its
    result."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def phase_fold(dev, final_pkl, decode):
    """test_net's trained Market pkl on FOLD_IMAGES gallery decodes at batch
    64: extraction BN-folded against unfolded, float32 and bf16; the
    bf16 rates timed in turns (plain, folded, folded, plain)."""
    from pps_tpu_torch.parallel.eval_step import extract_features
    stack, roidb = fold_stack(decode)
    out = {}
    for dtype in ('float32', 'bfloat16'):
        fn, p, s, folded = folded_model(dev, final_pkl, dtype)
        trees = {'plain': p, 'folded': folded}
        feats, secs = {}, {'plain': [], 'folded': []}
        for kind in ('plain', 'folded', 'folded', 'plain'):
            extract_features(fn, trees[kind], s, stack[:BATCH], BATCH)
            sec, feats[kind] = events_s(lambda: extract_features(
                fn, trees[kind], s, stack, BATCH))
            secs[kind].append(sec)
        out[dtype] = (feats, secs)
    (f32, secs32), (b16, secs16) = out['float32'], out['bfloat16']
    err = float(np.max(np.abs(f32['folded'] - f32['plain'])))
    if err > FOLD_F32_ATOL:
        raise AssertionError('folded vs unfolded f32: {}'.format(err))
    cos = np.sum(b16['folded'] * b16['plain'], axis=1)
    if cos.min() < FOLD_BF16_MIN_COS:
        raise AssertionError('folded vs unfolded bf16 cosine {}'.format(
            float(cos.min())))
    n = len(roidb)
    emit('fold', images=n, batch=BATCH, f32_max_abs=err,
         f32_atol=FOLD_F32_ATOL, bf16_min_cos=float(cos.min()),
         bf16_mean_cos=float(cos.mean()), min_cos=FOLD_BF16_MIN_COS,
         bf16_imgs_per_s={k: [n / t for t in v] for k, v in secs16.items()},
         f32_imgs_per_s={k: [n / t for t in v] for k, v in secs32.items()})


def phase_test_int8(dev, out_root, final_pkl, decode, bf16_feats, bf16_run):
    """run_inference on the _int8 yaml with test_net's pkl: calibrated on
    TPU.INT8_CALIB_IMAGES test images, every extraction batch through 53
    int8 kernel launches, the embeddings close to the bf16 run's.
    ``bf16_run`` holds test_net's mAP and extraction rate, reported
    beside the int8 run's.  Then the model-bound rates, which the decode
    threads hide there: FOLD_IMAGES decoded gallery images extracted from
    the stack, int8 (the run's quantized params) against the BN-folded
    bf16 flagship, in turns (bf16, int8, int8, bf16)."""
    import torch
    from pps_tpu_torch.engine import test as test_lib
    from pps_tpu_torch.kernels import conv2d_int8 as ck
    from pps_tpu_torch.parallel.eval_step import (make_extract_fn,
                                                  extract_features)
    out_dir = os.path.join(out_root, 'test_int8')
    cfg = variant_cfg(INT8_YAML, out_dir)
    seen = {}
    quantize, extract = (test_lib.quantize_params_for_dataset,
                         test_lib.extract_dataset_features)

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seen[name] = (out, time.perf_counter() - t0)
            seen[name + '_args'] = a
            return out
        return run
    test_lib.quantize_params_for_dataset = timed('calibrate', quantize)
    test_lib.extract_dataset_features = timed('extract', extract)
    before = ck.launches
    try:
        with phase_log('test_int8') as log:
            results = test_lib.run_inference(cfg, weights_file=final_pkl,
                                             output_dir=out_dir,
                                             decode_fn=decode, device=dev)
    finally:
        test_lib.quantize_params_for_dataset = quantize
        test_lib.extract_dataset_features = extract
    feats, extract_s = seen['extract']
    n = len(feats)
    batches = -(-n // BATCH)
    launches = ck.launches - before
    if launches != INT8_CONVS_PER_BATCH * batches:
        raise AssertionError('conv2d_int8 launched {} times for {} '
                             'batches'.format(launches, batches))
    if feats.shape != bf16_feats.shape or not np.isfinite(feats).all():
        raise AssertionError('int8 features {}'.format(feats.shape))
    cos = np.sum(feats * bf16_feats, axis=1) / (
        np.linalg.norm(feats, axis=1) * np.linalg.norm(bf16_feats, axis=1))
    if cos.min() < INT8_MIN_COS:
        raise AssertionError('int8 vs bf16 cosine {}'.format(
            float(cos.min())))
    single = [ln for ln in _read(log) if ln.startswith('Single Query:')]
    print(single[0], flush=True)
    qp = seen['calibrate'][0]
    # model-bound: int8 (the run's model and quantized params) against the
    # folded bf16 flagship on one decoded stack, in turns
    _, model, _, state = seen['extract_args'][:4]
    w, h = cfg.REID.SCALE
    int8_fn = make_extract_fn(model, device_preproc=(cfg.PIXEL_MEANS, (h, w)),
                              device=dev)
    bf16_fn, _, bf16_state, bf16_folded = folded_model(dev, final_pkl,
                                                       'bfloat16')
    stack, _ = fold_stack(decode)
    sides = {'int8': (int8_fn, qp, state),
             'bf16_folded': (bf16_fn, bf16_folded, bf16_state)}
    stacked = {'int8': [], 'bf16_folded': []}
    for kind in ('bf16_folded', 'int8', 'int8', 'bf16_folded'):
        fn, p, s = sides[kind]
        extract_features(fn, p, s, stack[:BATCH], BATCH)
        sec, _ = events_s(lambda: extract_features(fn, p, s, stack, BATCH))
        stacked[kind].append(len(stack) / sec)
    emit('test_int8', config=os.path.relpath(INT8_YAML, ROOT), images=n,
         batches=batches, conv2d_int8_launches=launches,
         quantized_convs=sum(k.endswith('_wq') for k in qp),
         calib_images=cfg.TPU.INT8_CALIB_IMAGES,
         calibrate_s=seen['calibrate'][1],
         int8_vs_bf16_min_cos=float(cos.min()),
         int8_vs_bf16_mean_cos=float(cos.mean()), min_cos=INT8_MIN_COS,
         single_query=single[0],
         map_int8=results['market1501_test']['single']['mAP'],
         map_bf16=bf16_run['mAP'],
         extract_imgs_per_s_int8=n / extract_s,
         extract_imgs_per_s_bf16=bf16_run['extract_imgs_per_s'],
         stacked_images=len(stack),
         stacked_extract_imgs_per_s_int8=stacked['int8'],
         stacked_extract_imgs_per_s_bf16_folded=stacked['bf16_folded'],
         log=log)
    return stacked


def phase_export(dev, out_root, final_pkl, decode):
    """tools.export_model in two child processes at once (--fold-bn, and
    --int8 on a .npy of preprocessed test images): each .pt2 reloaded here
    and run against eager extraction with the weights it holds."""
    import torch
    from pps_tpu_torch.engine import test as test_lib
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.tools.export_model import split_state
    work = os.path.join(out_root, 'export')
    os.makedirs(work, exist_ok=True)
    cfg = variant_cfg(FLAGSHIP_YAML, work)
    roidb = test_lib.roidb_for_test('market1501_test')[:BATCH]
    calib = test_lib.preprocess_images(roidb, cfg, decode_fn=decode)
    calib_npy = os.path.join(work, 'calib.npy')
    np.save(calib_npy, calib)
    children = {}
    t0 = time.perf_counter()
    for mode, flags in (('fold', ['--fold-bn']),
                        ('int8', ['--int8', '--calib-npy', calib_npy])):
        name = 'export_' + mode
        log = open(os.path.join(ROOT, 'build', 'chip_smoke_logs',
                                name + '.log'), 'w')
        path = os.path.join(work, mode + '.pt2')
        proc = subprocess.Popen(
            [sys.executable, '-m', 'pps_tpu_torch.tools.export_model',
             '--cfg', FLAGSHIP_YAML, '--weights', final_pkl, '--out', path,
             '--batch', str(BATCH)] + flags + ['TRAIN.WEIGHTS', "''"],
            cwd=ROOT, env=_child_env(name), stdout=log,
            stderr=subprocess.STDOUT)
        children[mode] = (proc, log, path)
    try:
        for mode, (proc, log, _) in children.items():
            if proc.wait(timeout=600) != 0:
                raise AssertionError('export_model --{} exited {}; see '
                                     '{}'.format(mode, proc.returncode,
                                                 log.name))
    finally:
        for proc, log, _ in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    child_s = time.perf_counter() - t0
    model = build_model(cfg, device=dev)
    x = torch.as_tensor(calib, device=dev)
    report = {'children_s': child_s}
    for mode, (_, log, path) in children.items():
        program = torch.export.load(path)
        p, s = split_state(program)
        with torch.no_grad():
            got = program.module()(x)
            want = model.extract_features(p, s, x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > EXPORT_ATOL:
            raise AssertionError('{} program vs eager: {}'.format(mode, err))
        tool_line = [ln for ln in _read(log.name)
                     if 'vs eager extraction' in ln]
        report[mode] = {'max_abs': err, 'mb': os.path.getsize(path) / 1e6,
                        'quantized_convs': sum(k.endswith('_wq') for k in p),
                        'tool_check': tool_line[-1] if tool_line else None}
    emit('export', batch=BATCH, atol=EXPORT_ATOL, **report)


def phase_gn_agree(dev):
    """A full-width GroupNorm R-50 (MODEL.USE_GN, USE_BN False) on 4
    images: card float32 against CPU float32; its int8 body (per-channel
    scales) once through the kernel."""
    import torch
    from pps_tpu_torch.config import merge_cfg_from_list
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.kernels import conv2d_int8 as ck
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.models.quantize import quantize_for_eval
    cfg = flagship_cfg(dtype='float32')
    cfg.immutable(False)
    merge_cfg_from_list(['MODEL.USE_GN', 'True', 'MODEL.USE_BN', 'False'])
    cfg.immutable(True)
    w, h = cfg.REID.SCALE
    rng = np.random.RandomState(0)
    x = rng.randn(GN_CHECK_IMAGES, h, w, 3).astype(np.float32) * 50
    out = {}
    for where in ('cpu', dev):
        model = build_model(cfg, device=where)
        p, s = model.init(torch.Generator().manual_seed(0))
        # GN scales and biases off their init, drawn in sorted key order
        rng = np.random.RandomState(1)
        for k in sorted(p):
            if k.endswith('_gn_s') or k.endswith('_gn_b'):
                v = (rng.rand(*p[k].shape) + 0.5 if k.endswith('_s')
                     else rng.randn(*p[k].shape) * 0.1)
                p[k] = torch.tensor(v.astype(np.float32), device=where)
        out[str(where)] = model.extract_features(
            p, s, torch.tensor(x, device=where)).cpu().numpy()
    cpu, card = out['cpu'], out[str(dev)]
    err = float(np.max(np.abs(card - cpu)))
    if not np.allclose(card, cpu, rtol=F32_RTOL, atol=F32_ATOL):
        raise AssertionError('GN card f32 != cpu f32: max abs {}'.format(
            err))
    qp = quantize_for_eval(model, p, s, x)
    before = ck.launches
    q = model.extract_features(qp, s, torch.tensor(x, device=dev))
    torch.cuda.synchronize()
    launches = ck.launches - before
    if launches != INT8_CONVS_PER_BATCH or \
            not torch.isfinite(q).all():
        raise AssertionError('GN int8: {} launches'.format(launches))
    q = q.cpu().numpy()
    cos = np.sum(q * card, axis=1) / (np.linalg.norm(q, axis=1) *
                                      np.linalg.norm(card, axis=1))
    emit('gn_agree', images=GN_CHECK_IMAGES, f32_card_vs_cpu_max_abs=err,
         rtol=F32_RTOL, atol=F32_ATOL, int8_launches=launches,
         int8_xinv_per_channel=list(qp['res3_0_branch2b_xinv'].shape),
         int8_vs_f32_cos=cos.tolist())


# ---------------------------------------------------------------------------
# REMAT, and the mixed-size datasets (Duke, CUHK03) through the drivers
# ---------------------------------------------------------------------------


def phase_remat(dev, gallery):
    """The flagship step with TPU.REMAT off and on, from the same state and
    draws: loss and BN state held, ms/step and peak memory of both."""
    import torch
    from pps_tpu_torch.data import device_augment as aug
    from pps_tpu_torch.flagship import flagship_cfg
    cfg = flagship_cfg()
    n = TRAIN_P * TRAIN_K
    _, step, ts = make_trainer(cfg, dev, seed=0)
    batch = train_batch(gallery, TRAIN_P, TRAIN_K, cfg.MODEL.NUM_CLASSES,
                        dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    draws = {'augment': aug.sample_params(gen, aug.augment_spec(cfg), n,
                                          RAW_HW, dev),
             'dropout_mask': torch.rand(n, 31, 128, generator=gen,
                                        device=dev) < 0.8}
    out = {}
    for remat in (False, True):
        cfg.immutable(False)
        cfg.TPU.REMAT = remat
        cfg.immutable(True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        new, logs = step(ts, batch, 0.01, 1.0, None, draws=draws)
        loss = float(logs['loss'])
        events = []
        for _ in range(REMAT_STEPS + 1):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            if len(events) <= REMAT_STEPS:
                step(ts, batch, 0.01, 1.0, None, draws=draws)
        events[-1].synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        out[remat] = {'loss': loss, 'state': new['state'],
                      'ms_per_step': float(np.median(ms)),
                      'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}
    flagship_cfg()  # REMAT back off in the global cfg
    off, on = out[False], out[True]
    loss_rel = abs(on['loss'] - off['loss']) / abs(off['loss'])
    state_diff = max(float((on['state'][k] - off['state'][k]).abs().max())
                     for k in off['state'])
    if loss_rel > REMAT_LOSS_RTOL or state_diff > REMAT_STATE_ATOL:
        raise AssertionError('REMAT on vs off: loss rel {}, BN state {}'
                             .format(loss_rel, state_diff))
    emit('remat', batch=n, dtype=cfg.MODEL.DTYPE, steps=REMAT_STEPS,
         loss_off=off['loss'], loss_on=on['loss'], loss_rel=loss_rel,
         loss_rtol=REMAT_LOSS_RTOL, state_max_abs_diff=state_diff,
         state_atol=REMAT_STATE_ATOL,
         ms_per_step_off=off['ms_per_step'], ms_per_step_on=on['ms_per_step'],
         peak_mem_gb_off=off['peak_mem_gb'], peak_mem_gb_on=on['peak_mem_gb'])


def size_table(spec):
    """[SIZE_TABLE, 2] (H, W) decode sizes of a dataset (see SIZE_TABLE)."""
    rng = np.random.RandomState(spec['seed'])
    h = rng.randint(spec['heights'][0], spec['heights'][1] + 1, SIZE_TABLE)
    w = np.round(h * rng.uniform(*spec['aspect'], size=SIZE_TABLE))
    return np.stack([h, w.astype(np.int64)], axis=1)


class MixedDecoder(MarketDecoder):
    """MarketDecoder's images at the size the table gives the image id:
    the 8x4 blocks upsampled to (h, w), plus a crop of a noise pattern."""

    def __init__(self, table, seed=0):
        super(MixedDecoder, self).__init__(seed)
        self._table = table
        hmax, wmax = table.max(axis=0)
        rng = np.random.RandomState(seed + 1)
        self._noise = rng.randint(-16, 17, size=(NOISE_BANK, hmax, wmax, 3)
                                  ).astype(np.int16)

    def size_of(self, iid):
        return tuple(int(v) for v in self._table[iid % SIZE_TABLE])

    def __call__(self, path):
        name = os.path.basename(path)
        pid, iid = int(name[:8]), int(name.split('_')[-1].split('.')[0])
        h, w = self.size_of(iid)
        mixed = (2 * self._block(pid) + self._block(
            DISTRACTOR_SEED + iid % DISTRACTORS)) // 3
        im = mixed[np.arange(h) * 8 // h][:, np.arange(w) * 4 // w]
        return np.clip(im + self._noise[iid % NOISE_BANK, :h, :w], 0,
                       255).astype(np.uint8)


def write_mixed(root, spec, decode):
    """A dataset of ``spec``'s widths, decode sizes from ``decode``:
    train_ids x train_per_id train images over ``cams`` cameras; queries
    of query_ids identities and a gallery of gallery_ids identities (the
    query identities first), each in every camera in turn."""
    c = spec['cams']
    write_reid(
        root, spec['name'],
        [(pid, j % c + 1, None) for pid in range(1, spec['train_ids'] + 1)
         for j in range(spec['train_per_id'])],
        [(1000 + i % spec['query_ids'], (i // spec['query_ids']) % c + 1, 0)
         for i in range(spec['queries'])]
        + [(1000 + j % spec['gallery_ids'],
            (j // spec['gallery_ids'] + 1) % c + 1, 1)
           for j in range(spec['gallery'])],
        size_of=decode.size_of)


def pad_stats(roidb):
    """The pad bucket of a roidb, its distinct sizes, and the images with
    a pad of 1-2 px on an axis (the blur's double-reflect case)."""
    hw = np.array([(e['height'], e['width']) for e in roidb])
    bucket = hw.max(axis=0)
    pad = bucket - hw
    return {'bucket': bucket.tolist(),
            'distinct_sizes': len({tuple(v) for v in hw}),
            'pad_1_2_px': int(((pad >= 1) & (pad <= 2)).any(axis=1).sum()),
            'taller_than_wide': bool((hw[:, 0] > hw[:, 1]).all())}


def phase_augment_agree(dev, decode):
    """64 mixed-size decodes on the padded wire, crops, HSV and blur at
    probability 1 and erasing: card vs CPU from the same draws."""
    import torch
    from pps_tpu_torch.data import device_augment as aug
    from pps_tpu_torch.data.json_dataset import combined_roidb_for_training
    from pps_tpu_torch.data.minibatch import pad_to_bucket
    roidb, _ = combined_roidb_for_training('duke_trainval')
    entries = roidb[:BATCH]
    ims = [decode(e['image']) for e in entries]
    ph = max(im.shape[0] for im in ims)
    pw = max(im.shape[1] for im in ims)
    padded, valid = pad_to_bucket(ims, (ph, pw))
    valid = torch.from_numpy(valid)
    flipped = torch.tensor(np.arange(BATCH) % 2 == 1)
    spec = dict(crop_prob=0.5, crop_ratio=0.8, hcrop_prob=0.5,
                hcrop_ratio=0.8, hsv_prob=1.0, sat_range=50, hue_range=10,
                val_range=50, blur_prob=1.0, blur_kernel=7, erase_prob=0.5,
                sl=0.02, sh=0.4, r1=0.3, out_hw=(384, 128))
    means = np.array([[[102.9801, 115.9465, 122.7717]]])
    params = aug.sample_params(torch.Generator().manual_seed(0), spec, BATCH,
                               (valid[:, 0], valid[:, 1]),
                               torch.device('cpu'))
    stages, real = [], aug.crop_resize_batch

    def record(xf, *a):
        stages.append(xf.cpu())
        return real(xf, *a)
    outs = {}
    aug.crop_resize_batch = record
    try:
        for where in ('cpu', dev):
            args = (torch.tensor(padded).to(where), flipped.to(where),
                    {k: v.to(where) for k, v in params.items()}, spec, means)
            t0 = time.perf_counter()
            outs[str(where)] = aug.apply_augment(
                *args, valid_hw=valid.to(where)).cpu()
            outs[str(where) + '_s'] = time.perf_counter() - t0
    finally:
        aug.crop_resize_batch = real
    if not torch.equal(stages[0], stages[1]):
        raise AssertionError('augment: the uint8 stage differs, card vs CPU '
                             '({} values)'.format(
                                 int((stages[0] != stages[1]).sum())))
    err = float((outs['cpu'] - outs[str(dev)]).abs().max())
    if err > AUG_F32_ATOL:
        raise AssertionError('augment: float32 output card vs CPU {}'.format(
            err))
    args = (torch.tensor(padded).to(dev), flipped.to(dev),
            {k: v.to(dev) for k, v in params.items()}, spec, means)
    ms = cuda_ms(lambda: aug.apply_augment(*args, valid_hw=valid.to(dev)),
                 iters=10)
    gen = torch.Generator(device=dev).manual_seed(0)
    draw_ms = cuda_ms(lambda: aug.sample_params(
        gen, spec, BATCH, (valid[:, 0].to(dev), valid[:, 1].to(dev)), dev),
        iters=10)
    emit('augment_agree', batch=BATCH, bucket=[ph, pw],
         valid_sizes=len({tuple(v) for v in valid.tolist()}),
         flipped=int(flipped.sum()), erased=int(params['erase_on'].sum()),
         uint8_stage_bitwise=True, f32_max_abs=err, f32_atol=AUG_F32_ATOL,
         apply_ms=ms, sample_params_ms=draw_ms,
         cpu_apply_s=outs['cpu_s'])


def mixed_cfg(spec, out_dir, epochs, extra=()):
    """The dataset's yaml, cut: ``epochs`` epochs, a snapshot per epoch, no
    bootstrap weights, HSV and blur on."""
    from pps_tpu_torch.config import (cfg, reset_cfg, merge_cfg_from_file,
                                      merge_cfg_from_list,
                                      assert_and_infer_cfg)
    reset_cfg()
    merge_cfg_from_file(spec['yaml'])
    merge_cfg_from_list(['TRAIN.WEIGHTS', "''",
                         'SOLVER.MAX_ITER', str(epochs),
                         'TRAIN.SNAPSHOT_ITERS', '1', 'OUTPUT_DIR', out_dir]
                        + MIXED_AUG + list(extra))
    assert_and_infer_cfg()
    return cfg


def phase_train_mixed(dev, out_root, spec, decode, epochs, phase,
                      must_fall=True):
    """train_model on a mixed-size dataset: every batch on the padded wire,
    the loss finite and (``must_fall``) falling from the first 10 steps to
    the last 10."""
    import torch
    from pps_tpu_torch.engine.train import train_model
    cfg = mixed_cfg(spec, os.path.join(out_root, phase), epochs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with phase_log(phase) as log, StepRecorder() as rec:
        t0 = time.perf_counter()
        ckpts = train_model(cfg, decode_fn=decode, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    losses = torch.stack(rec.losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError('{}: non-finite train loss'.format(phase))
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    if must_fall and not last < first:
        raise AssertionError('{}: loss did not fall: {} -> {}'.format(
            phase, first, last))
    kinds = sorted(set(rec.kinds))
    if kinds != ['u8p']:
        raise AssertionError('{}: batches off the padded wire: {}'.format(
            phase, kinds))
    step_ms = [a.elapsed_time(b) for a, b in zip(rec.events[:-1],
                                                 rec.events[1:])]
    ms = float(np.median(step_ms))
    from pps_tpu_torch.data.json_dataset import combined_roidb_for_training
    roidb, _ = combined_roidb_for_training(cfg.TRAIN.DATASETS)
    emit(phase, config=os.path.relpath(spec['yaml'], ROOT),
         num_classes=cfg.MODEL.NUM_CLASSES, entries=len(roidb),
         sizes=pad_stats(roidb), epochs=epochs, steps=len(losses),
         batch=BATCH, augment=MIXED_AUG, ms_per_step=ms,
         ms_p90=float(np.percentile(step_ms, 90)), wall_s=seconds,
         wall_ms_per_step=seconds / len(losses) * 1e3,
         imgs_per_s=BATCH / ms * 1e3,
         mb_qsize_median=float(np.median(rec.qsize)),
         mb_qsize_min=int(min(rec.qsize)),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         loss_first10=[float(v) for v in losses[:10]],
         loss_last10=[float(v) for v in losses[-10:]],
         loss_first=first, loss_last=last,
         wire_kinds={k: rec.kinds.count(k) for k in kinds},
         checkpoints=sorted(os.listdir(os.path.dirname(ckpts['final']))),
         log=log)
    return rec, ckpts['final']


def phase_host_chain(dev, out_root, decode):
    """HOST_CHAIN_STEPS steps of train_model on the Duke data with the host
    chain (TPU.DEVICE_AUGMENT False) and the bfloat16 wire."""
    import torch
    from pps_tpu_torch.data import minibatch
    from pps_tpu_torch.data.json_dataset import combined_roidb_for_training
    from pps_tpu_torch.engine.train import train_model
    cfg = mixed_cfg(DUKE, os.path.join(out_root, 'host_chain'), 1,
                    ['TPU.DEVICE_AUGMENT', 'False',
                     'TPU.WIRE_DTYPE', 'bfloat16'])
    roidb, _ = combined_roidb_for_training(cfg.TRAIN.DATASETS)
    roidb = roidb[:HOST_CHAIN_STEPS * BATCH]
    # the host's decode + augment rate on one thread
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    for b in range(4):
        minibatch.get_minibatch(roidb[b * BATCH:(b + 1) * BATCH], cfg,
                                decode_fn=decode, raw=False, rng=rng)
    one_thread = 4 * BATCH / (time.perf_counter() - t0)
    torch.cuda.synchronize()
    with phase_log('host_chain') as log, StepRecorder() as rec:
        t0 = time.perf_counter()
        train_model(cfg, roidb=roidb, decode_fn=decode, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    losses = torch.stack(rec.losses).cpu().numpy()
    if len(losses) != HOST_CHAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError('host_chain: losses {}'.format(losses))
    kinds = sorted(set(rec.kinds))
    if kinds != ['data:bfloat16']:
        raise AssertionError('host_chain: wire kinds {}'.format(kinds))
    step_ms = [a.elapsed_time(b) for a, b in zip(rec.events[:-1],
                                                 rec.events[1:])]
    ms = float(np.median(step_ms))
    emit('host_chain', config=os.path.relpath(DUKE['yaml'], ROOT),
         steps=len(losses), batch=BATCH, wire_kinds={kinds[0]: len(losses)},
         ms_per_step=ms, imgs_per_s=BATCH / ms * 1e3,
         wall_s=seconds, wall_ms_per_step=seconds / len(losses) * 1e3,
         mb_qsize_median=float(np.median(rec.qsize)),
         mb_qsize_min=int(min(rec.qsize)),
         decode_augment_imgs_per_s_one_thread=one_thread,
         loader_threads=cfg.DATA_LOADER.NUM_THREADS,
         losses=[float(v) for v in losses], log=log)


def phase_test_mixed(dev, out_root, phase, yaml_path, final_pkl, decode,
                     train_rec):
    """run_inference on a mixed-size test split with a final pkl: every
    batch padded, features through the pkl equal the in-memory state's on
    the first MEM_CHECK_IMAGES images, the card's CMC/mAP equal numpy's."""
    import torch
    from pps_tpu_torch.engine import test as test_lib
    from pps_tpu_torch.evaluation import evaluator as ev
    from pps_tpu_torch.evaluation.device_eval import cmc_map_device
    from pps_tpu_torch.data.minibatch import pad_to_bucket
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.ops.distance import euclidean_distmat
    from pps_tpu_torch.config import (cfg, reset_cfg, merge_cfg_from_file,
                                      merge_cfg_from_list,
                                      assert_and_infer_cfg)
    out_dir = os.path.join(out_root, phase)
    reset_cfg()
    merge_cfg_from_file(yaml_path)
    merge_cfg_from_list(['OUTPUT_DIR', out_dir])
    assert_and_infer_cfg()
    seen = {}
    extract = test_lib.extract_dataset_features

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = extract(*a, **k)
        torch.cuda.synchronize()
        seen['extract'] = (out, time.perf_counter() - t0)
        return out
    test_lib.extract_dataset_features = timed
    try:
        with phase_log(phase) as log:
            t0 = time.perf_counter()
            results = test_lib.run_inference(cfg, weights_file=final_pkl,
                                             output_dir=out_dir,
                                             decode_fn=decode, device=dev)
            seconds = time.perf_counter() - t0
    finally:
        test_lib.extract_dataset_features = extract
    lines = _read(log)
    single = [ln for ln in lines if ln.startswith('Single Query:')]
    print(phase + ': ' + single[0], flush=True)
    kinds = json.loads([ln for ln in lines if 'batch kinds' in ln][-1]
                       .split('batch kinds: ')[1])
    feats, extract_s = seen['extract']
    roidb = test_lib.roidb_for_test(cfg.TEST.DATASETS[0])
    n = len(roidb)
    if kinds['u8p'] != (n + BATCH - 1) // BATCH or kinds['u8'] or \
            kinds['f32']:
        raise AssertionError('{}: batch kinds {}'.format(phase, kinds))
    if feats.shape != (n, 3968) or not np.isfinite(feats).all():
        raise AssertionError('{}: features {}'.format(phase, feats.shape))
    # the in-memory final state on the first images, in the same batches
    # at the same wire shape: the first entry carries the split's bucket
    # in its metadata (its decode is unchanged)
    model = build_model(cfg, device=dev)
    bucket = pad_stats(roidb)['bucket']
    sub = ([dict(roidb[0], height=bucket[0], width=bucket[1])]
           + roidb[1:MEM_CHECK_IMAGES])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem = test_lib.stream_extract(
        cfg, model, train_rec.state['params'], train_rec.state['state'],
        sub, BATCH, decode_fn=decode,
        flip_tta=bool(cfg.TEST.BBOX_AUG.ENABLED and cfg.TEST.BBOX_AUG.H_FLIP))
    mem_s = time.perf_counter() - t0
    # the host's part alone on the same images: decode threads, then the
    # reflect padding to the bucket on one thread
    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        ims = list(pool.map(lambda e: decode(e['image']), sub))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in range(0, len(ims), BATCH):
        pad_to_bucket(ims[b:b + BATCH], bucket)
    pad_s = time.perf_counter() - t0
    del ims
    feat_diff = float(np.max(np.abs(mem - feats[:len(sub)])))
    if feat_diff > FEAT_ATOL:
        raise AssertionError('{}: pkl vs in-memory features {}'.format(
            phase, feat_diff))
    marks = np.array([e['mark'] for e in roidb])
    ids = np.array([ev.parse_im_name(e['im_name'], 'id') for e in roidb])
    cams = np.array([ev.parse_im_name(e['im_name'], 'cam') for e in roidb])
    q, g = marks == 0, marks == 1
    ft = torch.as_tensor(feats, device=dev)
    dm = euclidean_distmat(ft[torch.as_tensor(q, device=dev)],
                           ft[torch.as_tensor(g, device=dev)])
    m_card, c_card = cmc_map_device(dm, ids[q], ids[g], cams[q], cams[g])
    m_card, c_card = float(m_card), c_card.cpu().numpy()
    defer_numpy_check(phase, dm.cpu().numpy(), ids[q], ids[g], cams[q],
                      cams[g], m_card, c_card)
    res = results[cfg.TEST.DATASETS[0]]['single']['mAP']
    if abs(res - m_card) > MAP_ATOL:
        raise AssertionError('{}: run_inference mAP {} vs {}'.format(
            phase, res, m_card))
    emit(phase, config=os.path.relpath(yaml_path, ROOT),
         queries=int(q.sum()), gallery=int(g.sum()), sizes=pad_stats(roidb),
         flip_tta=bool(cfg.TEST.BBOX_AUG.ENABLED and cfg.TEST.BBOX_AUG.H_FLIP),
         batch_kinds=kinds, single_query=single[0], mAP=m_card,
         cmc1=float(c_card[0]), extract_s=extract_s,
         extract_imgs_per_s=n / extract_s, run_inference_s=seconds,
         pkl_vs_memory_max_abs=feat_diff, pkl_vs_memory_images=len(sub),
         subset_stream_imgs_per_s=len(sub) / mem_s,
         subset_decode_only_imgs_per_s=len(sub) / decode_s,
         subset_pad_one_thread_imgs_per_s=len(sub) / pad_s,
         feat_atol=FEAT_ATOL, map_card=m_card,
         numpy_check='deferred: the numpy_checks line', log=log)
    return feats, roidb


def phase_serve_mixed(dev, train_rec, feats, roidb, decode):
    """QueryEmbedder on 4-image groups of mixed sizes with the Duke final
    state, then a search of the Duke gallery against a brute force."""
    import torch
    from pps_tpu_torch.config import (cfg, reset_cfg, merge_cfg_from_file,
                                      assert_and_infer_cfg)
    from pps_tpu_torch.engine.serving import QueryEmbedder, RetrievalIndex
    from pps_tpu_torch.models.model import build_model
    reset_cfg()
    merge_cfg_from_file(DUKE['yaml'])
    assert_and_infer_cfg()
    model = build_model(cfg, device=dev)
    qe = QueryEmbedder(cfg, model, train_rec.state['params'],
                       train_rec.state['state'], max_batch=BATCH, device=dev)
    qe.warmup()
    marks = np.array([e['mark'] for e in roidb])
    gal = np.flatnonzero(marks == 1)
    index = RetrievalIndex(feats[gal], [roidb[i]['image'] for i in gal],
                           int8=False, device=dev)
    g = torch.as_tensor(feats[gal], device=dev)
    queries = np.flatnonzero(marks == 0)
    report, rng = [], np.random.RandomState(2)
    for r in range(REPEATS + 1):  # the first request warms the sizes up
        pick = rng.choice(queries, 4, replace=False)
        paths = [roidb[i]['image'] for i in pick]
        sizes = {decode(p).shape for p in paths}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = qe.embed(paths, decode)
        t1 = time.perf_counter()
        d, i = index.search(q, TOPK)
        t2 = time.perf_counter()
        norms = np.linalg.norm(q, axis=1)
        if not np.allclose(norms, 1.0, atol=1e-3):
            raise AssertionError('serve_mixed: norms {}'.format(norms))
        _, bd2, _ = brute_force(torch.as_tensor(q, device=dev), g, TOPK)
        diff = float(np.abs(d ** 2 - bd2.cpu().numpy()).max())
        if diff > DIST2_ATOL:
            raise AssertionError('serve_mixed: d^2 diff {}'.format(diff))
        if r:
            report.append({'sizes': len(sizes), 'embed_ms': (t1 - t0) * 1e3,
                           'search_ms': (t2 - t1) * 1e3,
                           'latency_ms': (t2 - t0) * 1e3,
                           'max_dist2_diff': diff})
    lat = [r['latency_ms'] for r in report]
    emit('serve_mixed', gallery=int(len(gal)), group=4, k=TOPK,
         requests=report, latency_ms_median=float(np.median(lat)),
         embed_ms_median=float(np.median([r['embed_ms'] for r in report])),
         u8_shape=list(qe._u8_shape), dist2_atol=DIST2_ATOL)


# ---------------------------------------------------------------------------
# retrieval at gallery scale, re-ranking, the serving daemon
# ---------------------------------------------------------------------------

# the JAX package's serving size: 1,048,576 rows x 3968 int8 (4.16 GB);
# 16 rows around each of 65,536 random unit identity centres, so a query's
# top-100 are its identity's 16 rows and 84 rows of the identities whose
# centres lie nearest its own, spread over many IVF cells
SCALE_IDS, SCALE_PER_ID = 65536, 16
SCALE_ROWS = SCALE_IDS * SCALE_PER_ID
SCALE_DIM = 3968
SCALE_BUILD = 131072                # rows per RetrievalIndex.add
SCALE_SEED = 11                     # torch generators on the card
SCALE_ROW_NOISE = 0.4               # norm of a row's offset from its centre
SCALE_CHUNK, SCALE_K = 4096, 100
SCALE_FLAT_QUERIES = 64             # 64 x 1M: the flat route's gate
IVF_SUB_ROWS, IVF_GATE_QUERIES = 65536, 256
IVF_RECALL_QUERIES, IVF_NPROBES = 1024, (8, 16, 32)
LATENCY_QUERIES = 20
# timed runs of each exact route at 1 query, at the flat route's gate
# (SCALE_FLAT_QUERIES) and at every query
ROUTE_REPEATS = {1: 5, SCALE_FLAT_QUERIES: 3, QUERIES: 1}  # {1: 10, 64: 5,
#   3,368: 2} before the 900 s budget
FP32_PEAK_FLOPS = 67e12             # H100 SXM float32 outside tensor cores
TIE_EPS = 1e-5                      # scan vs flat, IVF vs exact: indices
#   held wherever neighbouring distances differ by more than this (the
#   two sum 3968 float32 products in other orders)
SCAN_DIST_ATOL = 1e-4               # ... and distances within this
RERANK_METRIC_ATOL = 1e-3           # re-ranked mAP / CMC, card vs C++: an
#   entry moves where a k-th-neighbour distance is a near-tie (~0.1% of
#   entries in the JAX package's measurement)
RERANK_ENTRY_ATOL, RERANK_FLIP_SHARE = 1e-5, 0.005  # the near-tie rule
RERANK_NATIVE_ATOL = 1e-5           # C++ vs numpy: one algorithm, sums in
#   another order
RERANK_SUBSET = (512, 1536)         # queries, gallery of the numpy check
CUHK03_RERANK_YAML = os.path.join(ROOT, 'configs', 'cuhk03',
                                  'pps_crm_triplet_R-50_1x_rerank.yaml')
VIS_CHECK = 8
SERVE_GALLERY, SERVE_QUERIES = 2048, 64
SERVE_SEQ, SERVE_BURST, SERVE_THREADS = 20, 64, 16
SERVE_DIST_ATOL = 1e-4              # daemon vs in-process, a query alone
#   on both sides: the same kernels on the same shapes
SERVE_BATCH_ATOL = 2e-3             # a query coalesced with others: the
#   bf16 body at another batch size (cuDNN picks other kernels) moves an
#   embedding by ~1e-3, bf16's 8-bit mantissa rounding another way; the
#   in-process batch-of-64 vs alone difference is reported beside it
# the JSON keys of tools/serve.py's answers (its handler and ServerState)
SERVE_KEYS = {
    'healthz': {'status', 'gallery_size', 'dim', 'int8', 'sharded', 'ivf'},
    'search': {'results', 'reranked', 'latency_ms'},
    'result': {'rank', 'path', 'distance'},
    'add': {'added', 'gallery_size'},
    'remove': {'removed', 'gallery_size'},
    'stats': {'requests', 'errors', 'adds', 'removes', 'gallery_size',
              'embed', 'search', 'latency_ms'},
    'stats.embed': {'dispatches', 'images', 'avg_batch', 'pending', 'shed'},
    'stats.search': {'dispatches', 'queries', 'device_scans', 'avg_batch',
                     'pending', 'shed'},
    'stats.latency_ms': {'mean', 'p50', 'p90', 'p99', 'count'},
}


def _unit_rows(x):
    import torch
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def scale_centres(dev):
    """[SCALE_IDS, SCALE_DIM] identity centres on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SCALE_SEED)
    return _unit_rows(torch.randn(SCALE_IDS, SCALE_DIM, generator=gen,
                                  device=dev))


def scale_rows(centres, ids, seed):
    """Unit rows around the centres of identities ``ids`` (a tensor)."""
    import torch
    gen = torch.Generator(device=centres.device).manual_seed(seed)
    noise = torch.randn(len(ids), SCALE_DIM, generator=gen,
                        device=centres.device)
    return _unit_rows(centres[ids]
                      + noise * (SCALE_ROW_NOISE / SCALE_DIM ** 0.5))


def _clear(wd, eps, k):
    """[.., k] mask of the ranks whose distance in ``wd`` (k or more
    columns) is more than eps from both neighbours: there the order cannot
    flip under a perturbation below eps.  A column past k tells whether the
    k-th rank could trade places with the next row outside the list."""
    gap = np.diff(wd, axis=-1)
    clear = np.ones(wd.shape, bool)
    clear[..., 1:] &= gap > eps
    clear[..., :-1] &= gap > eps
    return clear[..., :k]


def check_topk(name, got, want, eps=TIE_EPS, atol=SCAN_DIST_ATOL):
    """Indices equal wherever ``want``'s neighbouring distances differ by
    more than eps; distances within atol.  ``want`` may hold one more
    column than ``got`` (see ``_clear``).  Returns the share of the slots
    held index for index, and the largest distance difference."""
    gd, gi = (np.asarray(a.cpu() if hasattr(a, 'cpu') else a) for a in got)
    wd, wi = (np.asarray(a.cpu() if hasattr(a, 'cpu') else a) for a in want)
    k = gi.shape[1]
    clear = _clear(wd, eps, k)
    wd, wi = wd[:, :k], wi[:, :k]
    diff = float(np.abs(gd - wd).max())
    if gi.shape != wi.shape or diff > atol:
        raise AssertionError('{}: shapes {} {}, distance diff {}'.format(
            name, gi.shape, wi.shape, diff))
    if not np.array_equal(gi[clear], wi[clear]):
        raise AssertionError('{}: {} indices differ outside near-ties'.format(
            name, int((gi[clear] != wi[clear]).sum())))
    return float(clear.mean()), diff


def _timed(fn, *a, **k):
    """(fn's result, seconds), the card synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_retrieval_scale(dev):
    """A 1,048,576 x 3968 int8 RetrievalIndex on the card, built by add()
    in chunks: the streaming scan against the flat route, recall_target
    against exact, IVF with a full probe against exact on a sub-index;
    the scan's rate, one-query latency, k-means, recall at 3 nprobes."""
    import torch
    from pps_tpu_torch.engine.serving import RetrievalIndex
    from pps_tpu_torch.ops import ivf as ivf_ops
    from pps_tpu_torch.ops.topk import (flat_topk, gallery_norms,
                                        streaming_topk)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    centres = scale_centres(dev)
    index, sub = None, None
    for c in range(SCALE_ROWS // SCALE_BUILD):
        rows = torch.arange(c * SCALE_BUILD, (c + 1) * SCALE_BUILD,
                            device=dev)
        feats = scale_rows(centres, rows // SCALE_PER_ID,
                           SCALE_SEED + 1 + c)
        paths = ['g%07d' % r for r in range(c * SCALE_BUILD,
                                            (c + 1) * SCALE_BUILD)]
        if index is None:
            index = RetrievalIndex(feats, paths, int8=True, device=dev)
            sub = (feats[:IVF_SUB_ROWS].clone(), paths[:IVF_SUB_ROWS])
        else:
            index.add(feats, paths)
        del feats
    q_ids = np.random.RandomState(SCALE_SEED).randint(0, SCALE_IDS, QUERIES)
    q = scale_rows(centres, torch.as_tensor(q_ids, device=dev),
                   SCALE_SEED + 1000)
    del centres
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q_np = q.cpu().numpy()
    g, s = index._g, index._s
    n = len(index)
    if n != SCALE_ROWS or g.dtype != torch.int8:
        raise AssertionError('index {} rows {}'.format(n, g.dtype))
    gallery_bytes = g.numel() * g.element_size() + s.numel() * 4

    # gate 1: the streaming scan against the flat route (64 x 1M fits)
    qf = q[:SCALE_FLAT_QUERIES]
    st = streaming_topk(qf, g, k=SCALE_K, chunk=SCALE_CHUNK, g_scale=s)
    fl = flat_topk(qf, g, k=SCALE_K + 1, g_scale=s,
                   g_norm=gallery_norms(g, s))
    held_flat, diff_flat = check_topk('streaming vs flat', st, fl)
    ref = {'flat64': tuple(a.cpu().numpy() for a in fl)}
    del st, fl

    # the two exact routes on each side of RetrievalIndex's gate: one
    # query (flat), the gate itself, every query (streaming); warm first
    gn = gallery_norms(g, s)
    routes = {'flat': lambda x: flat_topk(x, g, k=SCALE_K, g_scale=s,
                                          g_norm=gn),
              'streaming': lambda x: streaming_topk(
                  x, g, k=SCALE_K, chunk=SCALE_CHUNK, g_scale=s)}
    routes_ms = {}
    for nq, reps in ROUTE_REPEATS.items():
        row = routes_ms[str(nq)] = {}
        for name, fn in routes.items():
            fn(q[:nq])
            row[name] = float(np.median(
                [_timed(fn, q[:nq])[1] * 1e3 for _ in range(reps)]))
    del gn

    # all queries: RetrievalIndex.search takes the streaming route
    (d_ex, i_ex), exact_s = _timed(index.search, q_np, SCALE_K)
    (d_rt, i_rt), recall_s = _timed(index.search, q_np, SCALE_K,
                                    recall_target=0.95)
    if not (np.array_equal(i_rt, i_ex) and np.array_equal(d_rt, d_ex)):
        raise AssertionError('recall_target 0.95 differs from exact')
    rank1_same_id = float(np.mean(i_ex[:, 0] // SCALE_PER_ID == q_ids))
    flops = 2.0 * QUERIES * n * SCALE_DIM
    scan_bound_s = max(gallery_bytes / HBM_BYTES_PER_S,
                       flops / FP32_PEAK_FLOPS)

    def one_query_ms():
        out = []
        for i in range(LATENCY_QUERIES + 1):
            _, dt = _timed(index.search, q_np[i:i + 1], SCALE_K)
            out.append(dt * 1e3)
        out = out[1:]  # the first warms this shape
        return {'median': float(np.median(out)),
                'p90': float(np.percentile(out, 90)), 'min': min(out)}
    flat_ms = one_query_ms()

    # IVF at the serving size: k-means and assignment timed apart
    nlist = ivf_ops.default_nlist(n)
    cent, kmeans_s = _timed(ivf_ops.kmeans, index._host_g, nlist, iters=10,
                            seed=0, g_scale=index._host_s, sample=262144,
                            device=dev)
    _, assign_s = _timed(ivf_ops.assign_clusters, g, cent, g_scale=s)
    _, install_s = _timed(index._install_ivf, cent, nprobe=IVF_NPROBES[0],
                          budget=None, spill_limit=None,
                          train=dict(nlist=nlist, nprobe=IVF_NPROBES[0]))
    ivf_ms = one_query_ms()
    ivf = index._ivf
    recall = {}
    nr = IVF_RECALL_QUERIES
    for nprobe in IVF_NPROBES:
        budget = min(n, max(2048, 4 * nprobe * n // nlist))
        (_, pos), ivf_s = _timed(
            ivf_ops.ivf_topk, q[:nr], index._g, ivf['cent'],
            ivf['starts_dev'], k=SCALE_K, nprobe=nprobe, budget=budget,
            g_scale=index._s)
        pos = pos.cpu().numpy()
        ids = np.where(pos >= 0, ivf['perm'][np.clip(pos, 0, None)], -1)
        hits = [len(np.intersect1d(a, b)) for a, b in zip(ids, i_ex[:nr])]
        hits10 = [len(np.intersect1d(a[:10], b[:10]))
                  for a, b in zip(ids, i_ex[:nr])]
        recall[str(nprobe)] = {'recall_at_100': float(np.mean(hits)) / 100,
                               'recall_at_10': float(np.mean(hits10)) / 10,
                               'budget': budget, 'queries': nr,
                               'seconds': ivf_s}
    del index, g, s, ivf
    torch.cuda.empty_cache()
    ref.update(q=q_np, exact=(d_ex, i_ex), exact_s=exact_s, cent=cent,
               recall=recall, routes_ms=routes_ms)

    # gate 3: IVF probing every cell with a budget >= N is the exact scan
    sub_index = RetrievalIndex(sub[0], sub[1], int8=True, device=dev)
    sub_nlist = ivf_ops.default_nlist(IVF_SUB_ROWS)
    sub_index.enable_ivf(nlist=sub_nlist, nprobe=sub_nlist,
                         budget=IVF_SUB_ROWS)
    qs = q_np[:IVF_GATE_QUERIES]
    held_ivf, diff_ivf = check_topk(
        'IVF full probe vs exact', sub_index.search(qs, SCALE_K),
        sub_index.search(qs, SCALE_K + 1, exact=True))
    ref.update(sub=sub, sub_cent=sub_index._ivf['cent'], sub_nlist=sub_nlist,
               sub_answer=sub_index.search(qs, SCALE_K + 1))
    emit('retrieval_scale', rows=n, dim=SCALE_DIM, dtype='int8',
         gallery_gb=gallery_bytes / 1e9, queries=QUERIES, k=SCALE_K,
         chunk=SCALE_CHUNK, build_s=build_s,
         streaming_vs_flat={'queries': SCALE_FLAT_QUERIES,
                            'held_share': held_flat, 'max_dist_diff':
                            diff_flat, 'tie_eps': TIE_EPS,
                            'dist_atol': SCAN_DIST_ATOL},
         exact_routes_ms=routes_ms,
         flat_gate_queries=RetrievalIndex.FLAT_SCAN_MAX_ELEMS // n,
         exact_s=exact_s, recall_target_s=recall_s,
         recall_target_equals_exact=True,
         scan_gb_per_s=gallery_bytes / exact_s / 1e9,
         scan_gb_per_s_vs=HBM_BYTES_PER_S / 1e9,
         scan_bound_s=scan_bound_s, scan_bound_by='operations'
         if flops / FP32_PEAK_FLOPS > gallery_bytes / HBM_BYTES_PER_S
         else 'bytes', scan_tflops=flops / exact_s / 1e12,
         rank1_same_identity=rank1_same_id,
         one_query_flat_ms=flat_ms, one_query_ivf_ms=ivf_ms,
         nlist=nlist, kmeans_s=kmeans_s, kmeans_sample=262144,
         kmeans_iters=10, assign_s=assign_s, ivf_install_s=install_s,
         ivf_recall=recall,
         ivf_full_probe={'rows': IVF_SUB_ROWS, 'nlist': sub_nlist,
                         'queries': IVF_GATE_QUERIES,
                         'held_share': held_ivf, 'max_dist_diff': diff_ivf},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return ref


def _write_images(paths, decode):
    """Write each decode to its path (cv2 picks the format by suffix)."""
    from pps_tpu_torch.data.transforms import _cv2
    cv2 = _cv2()

    def one(p):
        if not cv2.imwrite(p, decode(p)):
            raise IOError('could not write ' + p)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(one, paths))


def _rerank_gates(dev, qg, qq, gg, q_ids, g_ids, q_cams, g_cams):
    """Card against the C++ engine on the same matrices: (report, the
    card's re-ranked mAP)."""
    import torch
    from pps_tpu_torch import native
    from pps_tpu_torch.evaluation import evaluator as ev
    from pps_tpu_torch.evaluation import metrics
    from pps_tpu_torch.evaluation.device_eval import cmc_map_device
    from pps_tpu_torch.evaluation.rerank import rerank_distmat_device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card, card_s = _timed(rerank_distmat_device, qg, qq, gg)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    m_card, c_card = cmc_map_device(card, q_ids, g_ids, q_cams, g_cams)
    m_card, c_card = float(m_card), c_card.cpu().numpy()
    host = [t.cpu().numpy() for t in (qg, qq, gg)]
    t0 = time.perf_counter()
    nat = native.rerank_native(*host)
    native_s = time.perf_counter() - t0
    m_nat = metrics.mean_ap(nat, q_ids, g_ids, q_cams, g_cams)
    c_nat = metrics.cmc(nat, q_ids, g_ids, q_cams, g_cams, topk=10,
                        **ev.CMC_KWARGS)
    far = float(np.mean(np.abs(card.cpu().numpy() - nat)
                        > RERANK_ENTRY_ATOL))
    return {'card_s': card_s, 'card_peak_gb_above_inputs': peak_gb,
            'native_s': native_s, 'map_card': m_card, 'map_native': m_nat,
            'map_diff': abs(m_card - m_nat),
            'cmc_max_diff': float(np.abs(c_card - c_nat).max()),
            'entries_apart_share': far}, c_card


def _od_ties(host, k=22):
    """Share of rows of re-ranking's normalised squared distances whose k
    smallest hold two equal values (where numpy's unstable argsort and
    the lowest-index rule may pick different neighbours)."""
    qg, qq, gg = host
    od = np.concatenate([np.concatenate([qq, qg], axis=1),
                         np.concatenate([qg.T, gg], axis=1)])
    od = np.power(od, 2).astype(np.float32)
    od = np.transpose(od / np.max(od, axis=0))
    first = np.sort(od, axis=1)[:, :k]
    return float(np.mean((np.diff(first, axis=1) == 0).any(axis=1)))


def phase_test_cuhk03_rerank(dev, out_root, final_pkl, decode):
    """run_inference on the CUHK03 _rerank yaml (REID.VIS on) with
    train_cuhk03's pkl: the card route's re-ranked block against the C++
    engine on the same matrices, numpy against both on a subset, the
    rank-list images."""
    from pps_tpu_torch.config import (cfg, reset_cfg, merge_cfg_from_file,
                                      merge_cfg_from_list,
                                      assert_and_infer_cfg)
    from pps_tpu_torch.engine import test as test_lib
    phase = 'test_cuhk03_rerank'
    out_dir = os.path.join(out_root, phase)
    reset_cfg()
    merge_cfg_from_file(CUHK03_RERANK_YAML)
    merge_cfg_from_list(['OUTPUT_DIR', out_dir, 'REID.VIS', 'True'])
    assert_and_infer_cfg()
    roidb = test_lib.roidb_for_test(cfg.TEST.DATASETS[0])
    t0 = time.perf_counter()
    _write_images([e['image'] for e in roidb], decode)  # REID.VIS reads
    write_s = time.perf_counter() - t0
    # the same yaml through the test_net CLI, as a user runs it, started
    # here beside the in-process run: the split from $PPS_TPU_DATA_DIR
    # (cuhk03/labeled/), the images decoded from the files just written
    # (JPEG, so its features are not the in-process run's)
    data_dir = os.path.join(out_root, 'cli_data')
    os.makedirs(os.path.join(data_dir, 'cuhk03'), exist_ok=True)
    os.symlink(os.path.dirname(os.path.dirname(roidb[0]['image'])),
               os.path.join(data_dir, 'cuhk03', 'labeled'))
    cli_log = os.path.join(ROOT, 'build', 'chip_smoke_logs',
                           phase + '_cli.log')
    t_cli = time.perf_counter()
    with open(cli_log, 'w') as f:
        cli_proc = subprocess.Popen(
            [sys.executable, '-m', 'pps_tpu_torch.tools.test_net',
             '--device', str(dev), '--cfg', CUHK03_RERANK_YAML,
             'TEST.WEIGHTS', final_pkl,
             'OUTPUT_DIR', os.path.join(out_root, 'cli_test')],
            cwd=ROOT, env=dict(_child_env(phase + '_cli'),
                               PPS_TPU_DATA_DIR=data_dir),
            stdout=f, stderr=subprocess.STDOUT)
    try:
        return _cuhk03_rerank_gates(dev, out_dir, final_pkl, decode, cfg,
                                    roidb, write_s, cli_proc, cli_log,
                                    t_cli)
    finally:
        if cli_proc.poll() is None:
            cli_proc.kill()
            cli_proc.wait()


def _cuhk03_rerank_gates(dev, out_dir, final_pkl, decode, cfg, roidb,
                         write_s, cli_proc, cli_log, t_cli):
    """test_cuhk03_rerank's in-process run and gates, then the CLI's."""
    import torch
    from pps_tpu_torch import native
    from pps_tpu_torch.engine import test as test_lib
    from pps_tpu_torch.evaluation import evaluator as ev
    from pps_tpu_torch.data.transforms import _cv2
    from pps_tpu_torch.evaluation.rerank import (re_ranking,
                                                 rerank_distmat_device)
    from pps_tpu_torch.ops.distance import euclidean_distmat
    phase = 'test_cuhk03_rerank'
    seen = {}
    extract, evaluate = (test_lib.extract_dataset_features,
                         test_lib.evaluate_dataset)

    def timed(name, fn):
        def run(*a, **k):
            out, dt = _timed(fn, *a, **k)
            seen[name] = (out, dt)
            return out
        return run
    test_lib.extract_dataset_features = timed('extract', extract)
    test_lib.evaluate_dataset = timed('eval', evaluate)
    try:
        with phase_log(phase) as log:
            results, seconds = _timed(
                test_lib.run_inference, cfg, weights_file=final_pkl,
                output_dir=out_dir, decode_fn=decode, device=dev)
    finally:
        test_lib.extract_dataset_features = extract
        test_lib.evaluate_dataset = evaluate
    lines = [ln for ln in _read(log) if '[mAP:' in ln]
    single = [ln for ln in lines if ln.startswith('Single Query:')]
    rr_line = [ln for ln in lines if ln.startswith('Re-ranked Single')]
    if not single or not rr_line:
        raise AssertionError('{}: printed {}'.format(phase, lines))
    print(phase + ': ' + single[0], flush=True)
    print(phase + ': ' + rr_line[0], flush=True)
    feats = seen['extract'][0]
    marks = np.array([e['mark'] for e in roidb])
    ids = np.array([ev.parse_im_name(e['im_name'], 'id') for e in roidb])
    cams = np.array([ev.parse_im_name(e['im_name'], 'cam') for e in roidb])
    q, g = marks == 0, marks == 1
    ft = torch.as_tensor(feats, device=dev)
    qf, gf = ft[torch.as_tensor(q, device=dev)], \
        ft[torch.as_tensor(g, device=dev)]
    qg, qq, gg = (euclidean_distmat(qf, gf), euclidean_distmat(qf, qf),
                  euclidean_distmat(gf, gf))
    report, _ = _rerank_gates(dev, qg, qq, gg, ids[q], ids[g], cams[q],
                              cams[g])
    res = results[cfg.TEST.DATASETS[0]]['single_rerank']['mAP']
    emit(phase + '_card_vs_native', run_inference_map=res, **report)
    if abs(res - report['map_card']) > MAP_ATOL:
        raise AssertionError('{}: run_inference re-ranked mAP {} vs {}'
                             .format(phase, res, report['map_card']))
    if report['map_diff'] > RERANK_METRIC_ATOL or \
            report['cmc_max_diff'] > RERANK_METRIC_ATOL or \
            report['entries_apart_share'] > RERANK_FLIP_SHARE:
        raise AssertionError('{}: card vs C++ {}'.format(phase, report))
    # numpy, the golden path, on a subset
    nq, ng = RERANK_SUBSET
    sub = [qg[:nq, :ng], qq[:nq, :nq], gg[:ng, :ng]]
    host = [t.cpu().numpy() for t in sub]
    t0 = time.perf_counter()
    gold = re_ranking(*host)
    numpy_s = time.perf_counter() - t0
    nat_gap = np.abs(native.rerank_native(*host) - gold)
    card_gap = np.abs(rerank_distmat_device(*sub).cpu().numpy() - gold)
    subset = {'queries': nq, 'gallery': ng, 'numpy_s': numpy_s,
              'native_vs_numpy_max': float(nat_gap.max()),
              'native_vs_numpy_apart_share':
              float(np.mean(nat_gap > RERANK_ENTRY_ATOL)),
              'card_vs_numpy_max': float(card_gap.max()),
              'card_vs_numpy_apart_share':
              float(np.mean(card_gap > RERANK_ENTRY_ATOL)),
              'rows_with_tie_in_first_k1_plus_2': _od_ties(host)}
    if subset['native_vs_numpy_max'] > RERANK_NATIVE_ATOL or \
            subset['card_vs_numpy_apart_share'] > RERANK_FLIP_SHARE:
        emit(phase + '_subset_failed', **subset)
        raise AssertionError('{}: subset {}'.format(phase, subset))
    # the rank-list images of the first queries
    cv2 = _cv2()
    vis_dir = os.path.join(out_dir, 'vis')
    q_paths = [e['image'] for e in roidb if e['mark'] == 0][:VIS_CHECK]
    for p in q_paths:
        im = cv2.imread(os.path.join(vis_dir, os.path.basename(p)))
        if im is None or im.ndim != 3:
            raise AssertionError('{}: no rank-list image for {}'.format(
                phase, p))
    # the test_net CLI started beside the run above
    code = cli_proc.wait(timeout=900)
    cli_s = time.perf_counter() - t_cli
    out = '\n'.join(_read(cli_log))
    cli = [ln for ln in out.splitlines() if '[mAP:' in ln]
    if code != 0 or [ln.split('[')[0].strip() for ln in cli] != \
            ['Single Query:', 'Re-ranked Single Query:']:
        raise AssertionError('{}: test_net CLI exit {}, printed {}\n{}'
                             .format(phase, code, cli, out[-3000:]))
    print(phase + ' (test_net CLI): ' + cli[1], flush=True)
    emit(phase, config=os.path.relpath(CUHK03_RERANK_YAML, ROOT),
         queries=int(q.sum()), gallery=int(g.sum()), single_query=single[0],
         rerank_line=rr_line[0], test_net_cli_lines=cli,
         test_net_cli_s=cli_s, test_net_cli_beside_run_inference=True,
         run_inference_s=seconds,
         extract_s=seen['extract'][1], eval_and_vis_s=seen['eval'][1],
         write_images_s=write_s, vis_images=len(os.listdir(vis_dir)),
         vis_checked=len(q_paths), card_vs_native=report, subset=subset,
         metric_atol=RERANK_METRIC_ATOL, entry_atol=RERANK_ENTRY_ATOL,
         flip_share=RERANK_FLIP_SHARE, log=log)


def phase_rerank_market(dev, feats, roidb):
    """rerank_distmat_device over test_net's 3,368 + 19,732 features: its
    seconds, peak memory and re-ranked mAP, the C++ engine's beside it."""
    import torch
    from pps_tpu_torch.evaluation import evaluator as ev
    from pps_tpu_torch.ops.distance import euclidean_distmat
    marks = np.array([e['mark'] for e in roidb])
    ids = np.array([ev.parse_im_name(e['im_name'], 'id') for e in roidb])
    cams = np.array([ev.parse_im_name(e['im_name'], 'cam') for e in roidb])
    q, g = marks == 0, marks == 1
    ft = torch.as_tensor(feats, device=dev)
    qf, gf = ft[torch.as_tensor(q, device=dev)], \
        ft[torch.as_tensor(g, device=dev)]
    qg, qq, gg = (euclidean_distmat(qf, gf), euclidean_distmat(qf, qf),
                  euclidean_distmat(gf, gf))
    report, cmc = _rerank_gates(dev, qg, qq, gg, ids[q], ids[g], cams[q],
                                cams[g])
    emit('rerank_market', queries=int(q.sum()), gallery=int(g.sum()),
         n=int(q.sum() + g.sum()), cmc1_card=float(cmc[0]), **report)


class _Daemon(object):
    """``python -m pps_tpu_torch.tools.serve`` as a user starts it."""

    def __init__(self, root, name, dev, args):
        self.ready = os.path.join(root, name + '.ready')
        if os.path.exists(self.ready):
            os.remove(self.ready)
        cmd = [sys.executable, '-m', 'pps_tpu_torch.tools.serve',
               '--device', str(dev), '--port', '0',
               '--ready-file', self.ready, *args]
        self.log_path = os.path.join(ROOT, 'build', 'chip_smoke_logs',
                                     name + '.log')
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        self.log = open(self.log_path, 'w')
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=_child_env(name),
                                     stdout=self.log,
                                     stderr=subprocess.STDOUT)
        while not os.path.exists(self.ready):
            if self.proc.poll() is not None or \
                    time.perf_counter() - t0 > 600:
                self.kill()
                raise AssertionError('{} did not start:\n{}'.format(
                    name, ''.join(open(self.log_path).readlines()[-30:])))
            time.sleep(0.2)
        self.start_s = time.perf_counter() - t0
        with open(self.ready) as f:
            host, port = f.read().split()
        self.base = 'http://{}:{}'.format(host, port)

    def get(self, path):
        import urllib.request
        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            body = r.read()
        return body.decode() if path == '/metrics' else json.loads(body)

    def post(self, path, data, ctype='application/json'):
        import urllib.request
        if not isinstance(data, bytes):
            data = json.dumps(data).encode()
        req = urllib.request.Request(self.base + path, data=data,
                                     headers={'Content-Type': ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def stop(self):
        import signal
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(120)
        self.log.close()
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


_CHILDREN = {}  # name -> launch-count file of a child process of the phase


def _child_env(name):
    """The environment of child process ``name`` of the port: the checkout
    on its path, and the file its entry point writes its kernel launch
    counts to at exit, which ``child_launches`` reads after the phase."""
    from pps_tpu_torch.kernels import LAUNCH_COUNTS_ENV
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + (os.pathsep + env['PYTHONPATH']
                                if env.get('PYTHONPATH') else '')
    path = os.path.join(ROOT, 'build', 'chip_smoke_logs',
                        name + '.launches.json')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    _CHILDREN[name] = path
    env[LAUNCH_COUNTS_ENV] = path
    return env


def child_launches():
    """{child name: {kernel: launches}} of the child processes started
    since the last call, as each wrote them at its exit; raises for a
    child that wrote none."""
    out = {}
    for name, path in sorted(_CHILDREN.items()):
        if not os.path.exists(path):
            raise AssertionError('{} wrote no launch counts'.format(name))
        with open(path) as f:
            out[name] = json.load(f)
    _CHILDREN.clear()
    return out


def _ranked(results):
    return ([r['path'] for r in results],
            np.array([r['distance'] for r in results], np.float64))


def _same_ranking(name, got, want, eps=SERVE_DIST_ATOL,
                  atol=SERVE_DIST_ATOL):
    """Paths equal wherever ``want``'s neighbouring distances differ by
    more than eps; distances within atol.  ``want`` may hold one more rank
    than ``got`` (see ``_clear``)."""
    (gp, gd), (wp, wd) = got, want
    k = len(gp)
    clear = _clear(np.asarray(wd, np.float64), eps, k)
    wp, wd = list(wp[:k]), np.asarray(wd[:k], np.float64)
    if len(wp) != k or np.abs(np.asarray(gd) - wd).max() > atol or \
            [p for p, c in zip(gp, clear) if c] != \
            [p for p, c in zip(wp, clear) if c]:
        raise AssertionError('{}: {} vs {} (eps {}, atol {})'.format(
            name, list(zip(gp, np.asarray(gd).tolist())),
            list(zip(wp, wd.tolist())), eps, atol))


def _keys(name, got, want):
    if set(got) != want:
        raise AssertionError('{} keys {} != {}'.format(name, sorted(got),
                                                       sorted(want)))


def phase_serve_daemon(dev, final_pkl, roidb, decode):
    """The port's daemon on the Market yaml with test_net's final pkl over
    2,048 gallery PNGs: every endpoint, sequential and concurrent
    /search, /add then /remove, SIGTERM with a save, a --load-index
    restart and tools.retrieve, each held against an in-process index."""
    import torch
    from pps_tpu_torch.config import (cfg, reset_cfg, merge_cfg_from_file,
                                      assert_and_infer_cfg)
    from pps_tpu_torch.engine import checkpoint as ckpt_lib
    from pps_tpu_torch.engine.serving import (QueryEmbedder, RetrievalIndex,
                                              embed_paths,
                                              list_gallery_images)
    from pps_tpu_torch.models.model import build_model
    root = os.path.join(ROOT, 'build', 'chip_smoke_serve')
    shutil.rmtree(root, ignore_errors=True)
    gal_dir, q_dir = os.path.join(root, 'gallery'), os.path.join(root, 'q')
    os.makedirs(gal_dir)
    os.makedirs(q_dir)
    idx_npz = os.path.join(root, 'idx.npz')

    def png(d, e):
        return os.path.join(d, os.path.splitext(e['im_name'])[0] + '.png')
    gal = [png(gal_dir, e) for e in roidb if e['mark'] == 1][:SERVE_GALLERY]
    queries = [png(q_dir, e) for e in roidb if e['mark'] == 0][:SERVE_QUERIES]
    _write_images(gal + queries, decode)
    gal = list_gallery_images(gal_dir)

    # the in-process reference: the same yaml, pkl, embedding and index
    reset_cfg()
    merge_cfg_from_file(FLAGSHIP_YAML)
    assert_and_infer_cfg(make_immutable=False)
    model = build_model(cfg, device=dev)
    params, state = model.init(torch.Generator().manual_seed(cfg.RNG_SEED))
    params, state, _ = ckpt_lib.load_checkpoint(final_pkl, model, params,
                                                state)
    ref = RetrievalIndex(embed_paths(cfg, model, params, state, gal), gal,
                         int8=True, device=dev)
    # each query alone, as a sequential request reaches the daemon's
    # model (ladder size 1); the batch of 64 shows what coalescing moves
    qe = QueryEmbedder(cfg, model, params, state, max_batch=BATCH,
                       device=dev)
    q_feats = np.concatenate([qe.embed([p]) for p in queries])
    want_d, _, want_p = ref.search(q_feats, TOPK + 1, return_paths=True)
    want = [(p, d) for p, d in zip(want_p, want_d)]
    batch_d = ref.search(qe.embed(queries), TOPK + 1)[0]
    rr_d, _, rr_p = ref.search_reranked(q_feats[:1], TOPK + 1,
                                        return_paths=True)
    del model, params, state, qe, ref
    torch.cuda.empty_cache()

    def search(d, i, tol=SERVE_DIST_ATOL):
        with open(queries[i], 'rb') as f:
            raw = f.read()
        t0 = time.perf_counter()
        body = d.post('/search?k={}'.format(TOPK), raw, 'image/png')
        ms = (time.perf_counter() - t0) * 1e3
        _keys('/search', body, SERVE_KEYS['search'])
        for r in body['results']:
            _keys('/search result', r, SERVE_KEYS['result'])
        got = _ranked(body['results'])
        _same_ranking('/search query {}'.format(i), got, want[i], eps=tol,
                      atol=tol)
        return got, ms

    common = ['--cfg', FLAGSHIP_YAML, '--weights', final_pkl,
              '--save-index', idx_npz]
    d = _Daemon(root, 'serve_daemon', dev, common + ['--gallery', gal_dir,
                                                     '--int8-gallery'])
    report = {'start_s': d.start_s, 'batch_vs_alone_max_dist_diff':
              float(np.abs(batch_d - want_d).max())}
    try:
        health = d.get('/healthz')
        _keys('/healthz', health, SERVE_KEYS['healthz'])
        if health['gallery_size'] != SERVE_GALLERY or not health['int8']:
            raise AssertionError('/healthz {}'.format(health))
        seq = [search(d, i % SERVE_QUERIES) for i in range(SERVE_SEQ)]
        before = [r[0] for r in seq[:VIS_CHECK]]
        ms = [r[1] for r in seq]
        report['sequential'] = {'requests': SERVE_SEQ,
                                'p50_ms': float(np.percentile(ms, 50)),
                                'p90_ms': float(np.percentile(ms, 90))}
        e0 = d.get('/stats')['embed']
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_THREADS) as pool:
            burst = list(pool.map(lambda i: search(d, i, SERVE_BATCH_ATOL),
                                  range(SERVE_BURST)))
        burst_s = time.perf_counter() - t0
        e1 = d.get('/stats')['embed']
        ms = [r[1] for r in burst]
        report['concurrent'] = {
            'requests': SERVE_BURST, 'threads': SERVE_THREADS,
            'p50_ms': float(np.percentile(ms, 50)),
            'p90_ms': float(np.percentile(ms, 90)),
            'requests_per_s': SERVE_BURST / burst_s,
            'embed_mean_batch': (e1['images'] - e0['images'])
            / max(1, e1['dispatches'] - e0['dispatches'])}
        rr = d.post('/search_path', {'path': queries[0], 'k': TOPK,
                                     'rerank': True})
        _keys('/search_path', rr, SERVE_KEYS['search'])
        if not rr['reranked']:
            raise AssertionError('/search_path rerank not re-ranked')
        _same_ranking('/search_path rerank', _ranked(rr['results'][0]),
                      (rr_p[0], rr_d[0]))
        multi = d.post('/search_path', {'paths': queries[:4], 'multi': True,
                                        'k': TOPK})
        _keys('/search_path multi', multi, SERVE_KEYS['search'])
        if len(multi['results']) != 1 or len(multi['results'][0]) != TOPK:
            raise AssertionError('/search_path multi {}'.format(multi))
        added = d.post('/add', {'paths': queries})
        _keys('/add', added, SERVE_KEYS['add'])
        removed = d.post('/remove', {'paths': queries})
        _keys('/remove', removed, SERVE_KEYS['remove'])
        if added['gallery_size'] != SERVE_GALLERY + SERVE_QUERIES or \
                removed != {'removed': SERVE_QUERIES,
                            'gallery_size': SERVE_GALLERY}:
            raise AssertionError('/add {} /remove {}'.format(added, removed))
        for i, b in enumerate(before):
            _same_ranking('after /add + /remove', search(d, i)[0], b,
                          eps=1e-6, atol=1e-6)
        stats = d.get('/stats')
        _keys('/stats', stats, SERVE_KEYS['stats'])
        for k in ('embed', 'search', 'latency_ms'):
            _keys('/stats ' + k, stats[k], SERVE_KEYS['stats.' + k])
        metrics = d.get('/metrics')
        if 'pps_serve_search_latency_ms_p90' not in metrics:
            raise AssertionError('/metrics:\n' + metrics)
        report['stats'] = stats
    except BaseException:
        d.kill()
        raise
    rc = d.stop()
    if rc != 0 or not os.path.exists(idx_npz):
        raise AssertionError('SIGTERM: exit {}, {} written: {}'.format(
            rc, idx_npz, os.path.exists(idx_npz)))

    d = _Daemon(root, 'serve_daemon_restart', dev,
                common + ['--load-index', idx_npz])
    report['restart_start_s'] = d.start_s
    try:
        for i, b in enumerate(before):
            _same_ranking('after restart', search(d, i)[0], b, eps=1e-6,
                          atol=1e-6)
    except BaseException:
        d.kill()
        raise
    if d.stop() != 0:
        raise AssertionError('restarted daemon: non-zero exit')

    def retrieve(name, extra=()):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, '-m', 'pps_tpu_torch.tools.retrieve',
             '--device', str(dev), '--cfg', FLAGSHIP_YAML, '--weights',
             final_pkl, '--load-index', idx_npz, '--topk', str(TOPK)]
            + list(extra) + ['--query', *queries[:VIS_CHECK]],
            cwd=ROOT, env=_child_env(name), capture_output=True,
            text=True, timeout=600)
        report[name + '_s'] = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError('{}: exit {}\n{}'.format(
                name, r.returncode, r.stderr[-3000:]))
        blocks = r.stdout.split('query: ')[1:]
        if len(blocks) != VIS_CHECK:
            raise AssertionError(name + ' printed:\n' + r.stdout[-3000:])
        out = []
        for block in blocks:
            rows = [ln.split() for ln in block.splitlines()[1:]
                    if ln.strip()]
            out.append(([row[2] for row in rows],
                        np.array([float(row[1][2:]) for row in rows])))
        return out

    # both children at once (each one's seconds include the other's load)
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(retrieve, 'retrieve'),
                pool.submit(retrieve, 'retrieve_sharded', ['--shard-gallery'])]
        plain, sharded = [f.result() for f in futs]
    for i, got in enumerate(plain):
        # retrieve embeds its queries as one batch (the bf16 body at another
        # batch size), and prints distances to 4 decimals (5e-5 of rounding)
        _same_ranking('retrieve query {}'.format(i), got, want[i],
                      eps=SERVE_BATCH_ATOL, atol=SERVE_BATCH_ATOL + 5e-5)
    # the gallery row-sharded (one shard per card it sees) answers as the
    # unsharded index does: the same embeddings and an exact merge, the
    # scan on another route (a distance's last bits, printed to 4 decimals)
    for i, got in enumerate(sharded):
        _same_ranking('retrieve --shard-gallery query {}'.format(i), got,
                      plain[i], eps=DIST2_ATOL, atol=DIST2_ATOL + 5e-5)
    report['retrieve_sharded_paths_equal'] = float(np.mean(
        [a[0] == b[0] for a, b in zip(sharded, plain)]))
    emit('serve_daemon', gallery=SERVE_GALLERY, queries=SERVE_QUERIES,
         k=TOPK, config=os.path.relpath(FLAGSHIP_YAML, ROOT),
         dist_atol=SERVE_DIST_ATOL, batch_atol=SERVE_BATCH_ATOL,
         endpoints_checked=sorted(SERVE_KEYS),
         **report)


# ---------------------------------------------------------------------------
# data parallel: ranks as child processes of this script, launched as
# torchrun launches them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
# MASTER_PORT); two ranks share the one card, so their collectives go over
# gloo on the CUDA tensors (NCCL refuses two ranks on one device)
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_AGREE_P, DP_AGREE_K = 4, 2       # dp_agree's global batch
DP_LOSS_RTOL = 1e-5                 # 2 ranks vs 1, float32: the same
#   math, the BN sums and the loss shares added in another order
DP_STATE_REL = 1e-4                 # BN running state after one step, by
#   RMS against its own: the global statistics as sums over the count
DP_WARMUP, DP_TIMED = 3, 5          # dp_train's steps (10 timed before
#   the 900 s budget)
DP_NET_EPOCHS = 1                   # dp_train_net: one epoch at global
DP_NET_BATCH = BATCH * DP_WORLD     # batch 128 (IMS_PER_BATCH x NUM_GPUS)
DP_PREEMPT_ITER = 20                # dp_train_net's continuous run stops
#   (SIGTERM to rank 1) once rank 0 logged this iteration (a json_stats
#   line every 20), the preempted run at iteration 0; before the 900 s
#   budget the continuous run ran the epoch out and the preempted run
#   stopped here
DP_TEST_MIN_COS = 0.999             # 2 ranks vs 1 process, bf16: each
#   image embedded in a batch of another size (cuDNN picks other kernels;
#   the daemon saw distance differences of 9.2e-4 for the same reason)
DP_TIMEOUT_S = 600


def _rank_device(dev):
    """The device every rank of a phase takes: this card (cuda:0), or the
    CPU in a rehearsal."""
    dev = str(dev)
    return dev + ':0' if dev == 'cuda' else dev


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


class _Ranks(object):
    """``world`` ranks of ``python3 chip_smoke.py --dp-rank CASE DIR`` with
    ``payload`` pickled into DIR; each rank's output goes to
    build/chip_smoke_logs/<phase>_rank<r>.log (a file, never a pipe: a
    full pipe would block a rank inside a collective)."""

    def __init__(self, phase, case, payload, world=DP_WORLD, extra=None,
                 extra_env=None):
        import pickle
        self.dir = os.path.join(ROOT, 'build', 'chip_smoke_dp', phase)
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir)
        with open(os.path.join(self.dir, 'payload.pkl'), 'wb') as f:
            pickle.dump(payload, f)
        port = _free_port()
        self.logs, self.procs = [], []
        for r in range(world):
            env = _child_env('{}_rank{}'.format(phase, r))
            env.update(RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), MASTER_ADDR='localhost',
                       MASTER_PORT=str(port), **(extra_env or {}))
            log = os.path.join(ROOT, 'build', 'chip_smoke_logs',
                               '{}_rank{}.log'.format(phase, r))
            self.logs.append(log)
            with open(log, 'w') as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), '--dp-rank',
                     case, self.dir] + list(extra or ()), stdout=f,
                    stderr=subprocess.STDOUT, cwd=ROOT, env=env,
                    start_new_session=True))
        self.t0 = time.perf_counter()

    def kill(self):
        import signal
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    def wait(self, ok=(0,)):
        """Wait for every rank (killing all at DP_TIMEOUT_S); raise unless
        each exited with a code in ``ok``.  Returns the exit codes."""
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, DP_TIMEOUT_S -
                                   (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.kill()
        codes = [p.returncode for p in self.procs]
        if any(c not in ok for c in codes):
            tails = '\n'.join('--- rank {} exit {}\n{}'.format(
                r, c, '\n'.join(_read(self.logs[r])[-40:]))
                for r, c in enumerate(codes))
            raise AssertionError('ranks exited {}:\n{}'.format(codes, tails))
        return codes

    def results(self, ok=(0,)):
        """Wait (see ``wait``), then each rank's pickled result."""
        import pickle
        self.wait(ok)
        out = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.dir, 'out{}.pkl'.format(r)),
                      'rb') as f:
                out.append(pickle.load(f))
        return out


@contextlib.contextmanager
def triplet_only():
    """The softmax CE terms zeroed (the CRM off by cfg): only the triplet
    term trains, the term every rank computes in full over the gathered
    features, whose gradient doubles if the gather's backward sums without
    the 1/world."""
    from pps_tpu_torch.models import losses
    ce = losses.softmax_ce_losses

    def zeroed(*a, **k):
        loss, acc = ce(*a, **k)
        return loss * 0.0, acc
    losses.softmax_ce_losses = zeroed
    try:
        yield
    finally:
        losses.softmax_ce_losses = ce


@contextlib.contextmanager
def triplet_not_over_world(world):
    """A planted fault: the triplet term's weight times the world size,
    which undoes the train step's 1/world (``model.train_forward``): the
    gradient that the triplet-only gate must catch."""
    from pps_tpu_torch.models import losses
    weight = losses.TRIPLET_WEIGHT
    losses.TRIPLET_WEIGHT = weight * world
    try:
        yield
    finally:
        losses.TRIPLET_WEIGHT = weight


@contextlib.contextmanager
def class_terms_not_over_model(n_model):
    """A planted fault: the softmax CE and the CRM loss times the model
    axis's size, which undoes their 1/n_model (``model.train_forward``):
    each model rank's share of the feature gradient, and the class
    slices' gradients, doubled at n_model 2.  The model-axis gates must
    refuse it."""
    from pps_tpu_torch.models import losses
    ce, crm = losses.softmax_ce_losses, losses.crm_loss

    def ce_times(*a, **k):
        loss, acc = ce(*a, **k)
        return loss * n_model, acc

    def crm_times(*a, **k):
        loss, acc = crm(*a, **k)
        return loss * n_model, acc
    losses.softmax_ce_losses, losses.crm_loss = ce_times, crm_times
    try:
        yield
    finally:
        losses.softmax_ce_losses, losses.crm_loss = ce, crm


def _dp_step(cfg, dev, mesh, batch_np, seed, triplet=None):
    """One train step of the flagship on ``dev`` from the seeded init of
    ``make_trainer`` (residual scales 0.01; on ``mesh``: this rank's rows
    of the global ``batch_np``), the draws from a generator seeded
    ``seed``.  triplet: None (every loss), 'only' or 'planted' (the
    triplet term alone, without or with the planted fault).  Returns
    (start params on the host, new state, logs, the augmented rows)."""
    import torch
    from pps_tpu_torch.parallel import train_step as ts_lib
    model, step, ts = make_trainer(cfg, dev, seed=1, residual_gamma=0.01,
                                   mesh=mesh)
    ts = ts_lib.place_train_state(mesh, ts)
    start = {k: v.cpu() for k, v in ts['params'].items()}
    batch = ts_lib.shard_batch(mesh, {k: torch.as_tensor(v).to(dev)
                                      for k, v in batch_np.items()})
    seen = []
    fwd = model.train_forward

    def record(p, s, b, *a, **k):
        seen.append(b['data'].detach().cpu().numpy())
        return fwd(p, s, b, *a, **k)
    model.train_forward = record
    gen = torch.Generator(device=dev).manual_seed(seed)
    with contextlib.ExitStack() as stack:
        if triplet:
            stack.enter_context(triplet_only())
        if triplet == 'planted':
            stack.enter_context(triplet_not_over_world(
                1 if mesh is None else mesh.world_size))
        ts, logs = step(ts, batch, 0.01, 1.0, gen)
    return start, ts, logs, seen[0]


def _rel_rms(got, want, floor=0.0):
    return _rms(got - want) / (_rms(want) + floor)


def _dp_updates(start, two, one):
    """The worst relative RMS errors of the 2-rank step's displacement and
    momentum against the 1-rank step's, under train_agree's rule (each
    tensor's RMS + TRAIN_FLOOR of the RMS over all displacements); and the
    first tensor outside TRAIN_REL, or None."""
    import torch
    disp1 = {k: one['params'][k].cpu() - start[k] for k in start}
    floor = TRAIN_FLOOR * _rms(torch.cat([d.flatten()
                                          for d in disp1.values()]))
    worst, bad = {'params': 0.0, 'momentum': 0.0}, None
    for k in start:
        e = _rel_rms(two['params'][k].cpu() - start[k], disp1[k],
                     floor / TRAIN_REL)
        em = _rel_rms(two['opt']['momentum'][k].cpu(),
                      one['opt']['momentum'][k].cpu(), floor / TRAIN_REL)
        worst['params'] = max(worst['params'], e)
        worst['momentum'] = max(worst['momentum'], em)
        if bad is None and (e > TRAIN_REL or em > TRAIN_REL):
            bad = '{} ({}, {})'.format(k, e, em)
    return worst, bad


def dp_rank_agree(p, mesh, dev):
    """Rank side of dp_agree: the 2-rank step, then (rank 0) the 1-rank
    step on the same card from the same state and draws, compared; the
    planted fault's 2-rank step against the triplet-only 1-rank step must
    fail the comparison."""
    from pps_tpu_torch.config import merge_cfg_from_list
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.parallel import collectives
    out, one_rank = {}, {}
    for name, triplet in (('full', None), ('triplet_only', 'only'),
                          ('triplet_planted', 'planted')):
        cfg = flagship_cfg(dtype='float32', ims_per_batch=p['batch_n'],
                           p=DP_AGREE_P, k=DP_AGREE_K)
        cfg.immutable(False)
        merge_cfg_from_list(['REID.CRM', 'False'] if triplet else [])
        cfg.immutable(True)
        start, two, logs2, rows = _dp_step(cfg, dev, mesh, p['batch'],
                                           seed=5, triplet=triplet)
        rows = collectives.gather_host_rows(rows, mesh)
        if mesh.rank:
            continue
        if triplet == 'planted':
            # against the sound triplet-only 1-rank step
            worst, bad = _dp_updates(start, two, one_rank['only'])
            if bad is None:
                raise AssertionError(
                    'the triplet-only gate passed a doubled triplet '
                    'gradient (worst {})'.format(worst))
            out[name] = {'worst_rel': worst, 'caught_at': bad}
            continue
        _, one, logs1, rows1 = _dp_step(cfg, dev, None, p['batch'], seed=5,
                                        triplet=triplet)
        one_rank[triplet] = one
        if not np.array_equal(rows, rows1):
            raise AssertionError('{}: the ranks\' augmented rows differ from '
                                 'the 1-rank batch'.format(name))
        l2, l1 = float(logs2['loss']), float(logs1['loss'])
        if abs(l2 - l1) > DP_LOSS_RTOL * abs(l1):
            raise AssertionError('{}: loss 2 ranks {} 1 rank {}'.format(
                name, l2, l1))
        worst, bad = _dp_updates(start, two, one)
        if bad is not None:
            raise AssertionError('{}: 2 ranks vs 1 after one step: {}'.format(
                name, bad))
        worst['state'] = 0.0
        for k in one['state']:
            e = _rel_rms(two['state'][k].cpu(), one['state'][k].cpu())
            worst['state'] = max(worst['state'], e)
            if e > DP_STATE_REL:
                raise AssertionError('{}: BN state {} ({})'.format(name, k,
                                                                   e))
        out[name] = {'loss_2_ranks': l2, 'loss_1_rank': l1,
                     'loss_rel': abs(l2 - l1) / abs(l1), 'worst_rel': worst,
                     'rows_bitwise': True}
    return out


def dp_rank_train(p, mesh, dev):
    """Rank side of dp_train: DP_WARMUP + DP_TIMED bf16 steps at the
    global batch, timed by CUDA events; then the gradient's all-reduce
    alone, timed the same way."""
    import torch
    import torch.distributed as dist
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.parallel import collectives
    from pps_tpu_torch.parallel import train_step as ts_lib
    cfg = flagship_cfg()
    _, step, ts = make_trainer(cfg, dev, seed=0, mesh=mesh)
    ts = ts_lib.place_train_state(mesh, ts)
    batch = ts_lib.shard_batch(mesh, {k: torch.as_tensor(v).to(dev)
                                      for k, v in p['batch'].items()})
    init_rm = ts['state']['res_conv1_bn_rm'].clone()
    gen = torch.Generator(device=dev).manual_seed(0)
    events, losses = [], []
    for it in range(DP_WARMUP + DP_TIMED):
        if it >= DP_WARMUP:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        ts, logs = step(ts, batch, 0.01, 1.0, gen)
        losses.append(logs['loss'])
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    events[-1].synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite loss {}'.format(losses))
    if torch.equal(ts['state']['res_conv1_bn_rm'], init_rm):
        raise AssertionError('the BN state did not move')
    grads = [torch.zeros_like(v) for v in ts['params'].values()]
    collectives.all_reduce_flat_(grads, mesh)  # warm
    ar = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        collectives.all_reduce_flat_(grads, mesh)
        b.record()
        b.synchronize()
        ar.append(a.elapsed_time(b))
    ms = float(np.median(step_ms))
    return {'backend': dist.get_backend(), 'world': mesh.world_size,
            'batch_per_rank': int(batch['labels_int32'].shape[0]),
            'ms_per_step': ms, 'ms_min': min(step_ms),
            'ms_max': max(step_ms), 'losses': [float(v) for v in losses],
            'grad_mb': sum(g.numel() for g in grads) * 4 / 1e6,
            'allreduce_ms': float(np.median(ar)),
            'allreduce_share': float(np.median(ar)) / ms}


def _market_on(p):
    """A rank's view of the synthetic Market set (or, with ``p['decoder']``
    'duke', of a Duke-shaped one): the parent's catalog entries, and
    decodes made from the file names (no image files)."""
    from pps_tpu_torch.data import catalog, transforms
    for name, (imdir, ann) in p['datasets'].items():
        catalog.register_dataset(name, imdir, ann)
    transforms.decode_image = (
        MixedDecoder(size_table(DUKE), seed=DUKE['seed'])
        if p.get('decoder') == 'duke' else MarketDecoder())


def dp_rank_train_net(p):
    """Rank side of dp_train_net: ``tools.train_net``'s own main (which
    sets the process group up from torchrun's variables) with each step's
    loss and start recorded.  Returns (exit code, record)."""
    import torch
    from pps_tpu_torch.tools import train_net
    _market_on(p)
    code = 0
    with StepRecorder() as rec:
        try:
            train_net.main(p['argv'])
        except SystemExit as e:
            code = e.code
    out = {'code': code, 'losses': [float(v) for v in rec.losses],
           'at': rec.at}
    if len(rec.events) > 1:
        torch.cuda.synchronize()
        out['step_ms'] = [a.elapsed_time(b) for a, b in
                          zip(rec.events[:-1], rec.events[1:])]
    return code, out


def dp_rank_test_net(p, mesh, dev):
    """Rank side of dp_test_net: ``run_inference`` on this rank's rows of
    every global batch; rank 0 returns the results and the extraction's
    seconds."""
    import torch
    from pps_tpu_torch.config import (cfg, merge_cfg_from_file,
                                      merge_cfg_from_list, reset_cfg)
    from pps_tpu_torch.engine import test as test_lib
    _market_on(p)
    reset_cfg()
    merge_cfg_from_file(FLAGSHIP_YAML)
    merge_cfg_from_list(['OUTPUT_DIR', p['out']])
    seen = {}
    extract = test_lib.extract_dataset_features

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract(*a, **k)
        torch.cuda.synchronize()
        seen['extract_s'] = time.perf_counter() - t0
        return feats
    test_lib.extract_dataset_features = timed
    results = test_lib.run_inference(cfg, weights_file=p['weights'],
                                     output_dir=p['out'], device=dev)
    return {'results': results, 'extract_s': seen['extract_s']}


DP_CASES = {'agree': dp_rank_agree, 'train': dp_rank_train,
            'test_net': dp_rank_test_net, 'mp': lambda *a: mp_rank_main(*a)}


def dp_rank_main(case, workdir):
    """A rank of a data-parallel phase (``--dp-rank CASE DIR``): reads
    DIR/payload.pkl, writes DIR/out<rank>.pkl and its kernel launch
    counts, exits with the case's code."""
    import pickle
    from pps_tpu_torch.kernels import write_launch_counts
    from pps_tpu_torch.parallel import mesh as mesh_lib
    with open(os.path.join(workdir, 'payload.pkl'), 'rb') as f:
        payload = pickle.load(f)
    rank = int(os.environ['RANK'])
    code = 0
    try:
        if case == 'train_net':
            code, out = dp_rank_train_net(payload)
        else:
            dev = mesh_lib.init_distributed(device=payload['device'],
                                            backend=payload.get('backend'))
            mesh = mesh_lib.build_mesh(
                device=dev, mesh_shape=payload.get('mesh_shape'))
            print('rank {}: {}, staging: none (gloo copies CUDA tensors '
                  'through host memory itself)'.format(rank, mesh),
                  flush=True)
            out = DP_CASES[case](payload, mesh, dev)
        with open(os.path.join(workdir, 'out{}.pkl'.format(rank)),
                  'wb') as f:
            pickle.dump(out, f)
    finally:
        write_launch_counts()
        mesh_lib.destroy_distributed()
    return code


def _numpy_batch(gallery, p, k):
    """``train_batch`` on the host for the flagship's classes, as numpy
    (a payload for the ranks); leaves the global cfg the flagship's."""
    from pps_tpu_torch.flagship import flagship_cfg
    return {n: v.numpy() for n, v in train_batch(
        gallery, p, k, flagship_cfg().MODEL.NUM_CLASSES, 'cpu').items()}


def phase_dp_agree(dev, gallery):
    """Two ranks on the card over gloo against one rank on the same card,
    float32 at full width, global batch P 4 x K 2: the augmented rows,
    the loss, the BN state and the updates; then the triplet term alone,
    and with the planted fault, which the same rule must refuse."""
    n = DP_AGREE_P * DP_AGREE_K
    t0 = time.perf_counter()
    r0 = _Ranks('dp_agree', 'agree', {
        'device': _rank_device(dev),
        'batch': _numpy_batch(gallery, DP_AGREE_P, DP_AGREE_K),
        'batch_n': n}).results()[0]
    emit('dp_agree', world=DP_WORLD, global_batch=n, dtype='float32',
         backend='gloo', residual_gamma=0.01, loss_rtol=DP_LOSS_RTOL,
         state_rel=DP_STATE_REL, rel=TRAIN_REL, floor=TRAIN_FLOOR,
         wall_s=time.perf_counter() - t0, card=_CARD.get('smi'), **r0)


def phase_dp_train(dev, gallery, bare_ms):
    """Two ranks on the card over gloo, bf16 flagship at global batch 64:
    ms/step and the gradient all-reduce's share; then one NCCL rank (world
    size 1) on the same step, against phase train's bare step."""
    card = _rank_device(dev)
    batch = _numpy_batch(gallery, TRAIN_P, TRAIN_K)
    t0 = time.perf_counter()
    two = _Ranks('dp_train', 'train', {'device': card,
                                       'batch': batch}).results()
    nccl = _Ranks('dp_train_nccl', 'train', {
        'device': card, 'batch': batch, 'backend': 'nccl'},
        world=1).results()[0]
    if nccl['backend'] != 'nccl' or two[0]['backend'] != 'gloo':
        raise AssertionError('backends {} / {}'.format(two[0]['backend'],
                                                       nccl['backend']))
    emit('dp_train', world=DP_WORLD, global_batch=TRAIN_P * TRAIN_K,
         dtype='bfloat16', steps=DP_TIMED, warmup=DP_WARMUP,
         ranks=two, nccl_world1=nccl, bare_step_ms=bare_ms,
         nccl_vs_bare=nccl['ms_per_step'] / bare_ms,
         wall_s=time.perf_counter() - t0, card=_CARD.get('smi'),
         note='2 ranks share one H100: a check that the path works, not a '
              'scaling figure')


def _market_datasets():
    from pps_tpu_torch.data import catalog
    return {n: (catalog.get_im_dir(n), catalog.get_ann_fn(n))
            for n in ('market1501_trainval', 'market1501_test')}


def _sigterm_rank1_after(ranks, it):
    """SIGTERM to rank 1 of ``ranks`` once rank 0 logged iteration ``it``
    (a json_stats line)."""
    import signal
    mark = '"iter": {},'.format(it)
    try:
        while not any(mark in ln for ln in _read(ranks.logs[0])):
            if any(p.poll() is not None for p in ranks.procs) or \
                    time.perf_counter() - ranks.t0 > DP_TIMEOUT_S:
                raise AssertionError('rank 0 never logged iteration {}'
                                     .format(it))
            time.sleep(0.2)
        ranks.procs[1].send_signal(signal.SIGTERM)
    except BaseException:
        ranks.kill()
        raise


def phase_dp_train_net(dev, out_root):
    """``tools.train_net`` on two ranks (flagship yaml, one epoch at global
    batch 128): a continuous run, stopped (SIGTERM to rank 1) once rank 0
    logged iteration DP_PREEMPT_ITER; a run whose rank 1 gets a SIGTERM
    once rank 0 logged iteration 0; the same command again, to the epoch's
    end, whose first step's loss is the continuous run's at that step."""
    card = _rank_device(dev)

    def payload(out_dir):
        return {'datasets': _market_datasets(), 'argv': [
            '--device', card, '--skip-test', '--cfg', FLAGSHIP_YAML,
            'TRAIN.WEIGHTS', "''", 'SOLVER.MAX_ITER', str(DP_NET_EPOCHS),
            'NUM_GPUS', str(DP_WORLD), 'OUTPUT_DIR', out_dir]}

    t0 = time.perf_counter()
    ranks = _Ranks('dp_train_net', 'train_net',
                   payload(os.path.join(out_root, 'dp_cont')))
    _sigterm_rank1_after(ranks, DP_PREEMPT_ITER)
    cont = ranks.results(ok=(75,))
    cont_s = time.perf_counter() - t0
    json_lines = [sum(ln.startswith('json_stats:') for ln in _read(log))
                  for log in ranks.logs]
    if json_lines[0] == 0 or any(json_lines[1:]):
        raise AssertionError('json_stats lines by rank: {}'.format(
            json_lines))
    pre_dir = os.path.join(out_root, 'dp_pre')
    ranks = _Ranks('dp_train_net_pre', 'train_net', payload(pre_dir))
    _sigterm_rank1_after(ranks, 0)
    pre = ranks.results(ok=(75,))
    codes = [p.returncode for p in ranks.procs]
    steps = [len(r['losses']) for r in pre]
    if len(set(steps)) != 1 or steps[0] >= len(cont[0]['losses']):
        raise AssertionError('ranks stopped after {} steps (the continuous '
                             'run after {})'.format(
                                 steps, len(cont[0]['losses'])))
    train_dir = os.path.join(pre_dir, 'train', 'market1501_trainval')
    preempt = [n for n in os.listdir(train_dir)
               if n.startswith('model_preempt_')]
    if preempt != ['model_preempt_epoch0_step{}.pkl'.format(steps[0])]:
        raise AssertionError('resume points {}'.format(preempt))
    resumed = _Ranks('dp_train_net_resume', 'train_net',
                     payload(pre_dir)).results()
    first, want = resumed[0]['losses'][0], cont[0]['losses'][steps[0]]
    rel = abs(first - want) / abs(want)
    ipe = TRAIN_IDS * TRAIN_PER_ID * 2 // DP_NET_BATCH  # flipped entries
    if rel > RESUME_LOSS_RTOL or resumed[0]['at'][0] != (0, steps[0]) or \
            resumed[0]['at'][-1] != (0, ipe - 1):
        raise AssertionError('resumed at {} to {}, loss {} vs continuous {}'
                             .format(resumed[0]['at'][0],
                                     resumed[0]['at'][-1], first, want))
    ms = float(np.median(cont[0]['step_ms']))
    emit('dp_train_net', config=os.path.relpath(FLAGSHIP_YAML, ROOT),
         world=DP_WORLD, global_batch=DP_NET_BATCH, epochs=DP_NET_EPOCHS,
         continuous_steps=len(cont[0]['losses']), ms_per_step=ms,
         imgs_per_s=DP_NET_BATCH / ms * 1e3, continuous_wall_s=cont_s,
         json_stats_lines_by_rank=json_lines, preempt_exit_codes=codes,
         preempted_after_steps=steps[0], resume_point=preempt[0],
         resumed_steps=len(resumed[0]['losses']),
         resumed_to_the_epoch_end=steps[0] + len(resumed[0]['losses']),
         first_resumed_loss=first,
         continuous_loss=want, loss_rel=rel, loss_rtol=RESUME_LOSS_RTOL,
         loss_first=cont[0]['losses'][0], loss_last=cont[0]['losses'][-1],
         wall_s=time.perf_counter() - t0, card=_CARD.get('smi'),
         note='2 ranks share one H100: a check that the path works, not a '
              'scaling figure')


def phase_dp_test_net(dev, out_root, final_pkl, feats_one):
    """``run_inference`` on two ranks over the Market-sized test split
    with test_net's pkl: rank 0's features against the one-process run's,
    its CMC and mAP against numpy's on its own matrix."""
    import torch
    from pps_tpu_torch.engine import test as test_lib
    from pps_tpu_torch.evaluation import evaluator as ev
    from pps_tpu_torch.ops.distance import euclidean_distmat
    from pps_tpu_torch.utils.io import load_object
    out_dir = os.path.join(out_root, 'dp_test_net')
    t0 = time.perf_counter()
    r0 = _Ranks('dp_test_net', 'test_net', {
        'device': _rank_device(dev),
        'datasets': _market_datasets(), 'weights': final_pkl,
        'out': out_dir}).results()[0]
    wall = time.perf_counter() - t0
    feats = load_object(os.path.join(out_dir, 'features.pkl'))['all_feats']
    if feats.shape != feats_one.shape or not np.isfinite(feats).all():
        raise AssertionError('features {}'.format(feats.shape))
    cos = np.sum(feats * feats_one, axis=1) / (
        np.linalg.norm(feats, axis=1) * np.linalg.norm(feats_one, axis=1))
    if cos.min() < DP_TEST_MIN_COS:
        raise AssertionError('2 ranks vs 1: cosine {}'.format(cos.min()))
    roidb = test_lib.roidb_for_test('market1501_test')
    marks = np.array([e['mark'] for e in roidb])
    ids = np.array([ev.parse_im_name(e['im_name'], 'id') for e in roidb])
    cams = np.array([ev.parse_im_name(e['im_name'], 'cam') for e in roidb])
    q, g = marks == 0, marks == 1
    ft = torch.as_tensor(feats, device=dev)
    host = euclidean_distmat(ft[torch.as_tensor(q, device=dev)],
                             ft[torch.as_tensor(g, device=dev)]).cpu().numpy()
    single = r0['results']['market1501_test']['single']
    defer_numpy_check('dp_test_net', host, ids[q], ids[g], cams[q], cams[g],
                      single['mAP'], single['cmc'])
    n = len(roidb)
    emit('dp_test_net', world=DP_WORLD, images=n, mAP=single['mAP'],
         cmc1=single['cmc1'],
         numpy_check='deferred: the numpy_checks line',
         min_cos_vs_one_process=float(cos.min()),
         min_cos=DP_TEST_MIN_COS, extract_s=r0['extract_s'],
         extract_imgs_per_s=n / r0['extract_s'], wall_s=wall,
         card=_CARD.get('smi'),
         note='2 ranks share one H100: a check that the path works, not a '
              'scaling figure')


# ---------------------------------------------------------------------------
# the model axis: two ranks as a (1, 2) mesh on the card over gloo, the
# Duke yaml (702 logits, 351 a rank: Market's 751 and CUHK03's 767 divide
# by no model axis of 2, so their FCs would stay replicated); the sharded
# checkpoint; the train-step graph dump
# ---------------------------------------------------------------------------

MP_MESH = (1, 2)
MP_AGREE_P, MP_AGREE_K = 4, 2       # mp_agree's global batch
MP_WARMUP, MP_TIMED = 3, 5          # mp_train's steps
MP_NET_IDS, MP_NET_PER_ID = 32, 4   # ckpt_sharded's train_net: a Duke-
#   shaped subset, 128 images, global batch 64 (IMS_PER_BATCH 32 x
#   NUM_GPUS 2, P 4 x K 8 a rank): 2 steps an epoch
MP_NET_P, MP_NET_K = 4, 8
MP_NET_EPOCHS = 3


def mp_cfg(dtype, ims_per_batch, p, k):
    """The Duke yaml at full width on a (1, 2) mesh: ``dtype``, the batch
    ``ims_per_batch`` = P x K."""
    from pps_tpu_torch.config import (assert_and_infer_cfg, cfg,
                                      merge_cfg_from_file,
                                      merge_cfg_from_list, reset_cfg)
    reset_cfg()
    merge_cfg_from_file(DUKE['yaml'])
    merge_cfg_from_list(['MODEL.DTYPE', dtype, 'TRAIN.WEIGHTS', "''",
                         'TRAIN.IMS_PER_BATCH', str(ims_per_batch),
                         'REID.P', str(p), 'REID.K', str(k),
                         'TPU.MESH_SHAPE', str(MP_MESH)])
    assert_and_infer_cfg()
    return cfg


def _mp_step(cfg, dev, mesh, batch_np, planted=False):
    """One train step of the Duke model from make_trainer's init (residual
    scales 0.01) on ``mesh`` (None: one rank), draws from a generator
    seeded 5, the triplet term on (loss_scale_factor 1).  Returns (start
    params, the new state with the class slices gathered, logs, the
    augmented rows)."""
    import torch
    from pps_tpu_torch.parallel import train_step as ts_lib
    model, step, ts = make_trainer(cfg, dev, seed=1, residual_gamma=0.01,
                                   mesh=mesh)
    start = {k: v.cpu() for k, v in ts['params'].items()}
    ts = ts_lib.place_train_state(mesh, ts)
    batch = ts_lib.shard_batch(mesh, {k: torch.as_tensor(v).to(dev)
                                      for k, v in batch_np.items()})
    seen = []
    fwd = model.train_forward

    def record(p, s, b, *a, **k):
        seen.append(b['data'].detach().cpu().numpy())
        return fwd(p, s, b, *a, **k)
    model.train_forward = record
    gen = torch.Generator(device=dev).manual_seed(5)
    with contextlib.ExitStack() as stack:
        if planted:
            stack.enter_context(class_terms_not_over_model(mesh.n_model))
        ts, logs = step(ts, batch, 0.01, 1.0, gen)
    ts = ts_lib.gather_train_state(mesh, ts, model.head_spec['num_logits'])
    return start, ts, logs, seen[0]


def mp_rank_agree(p, mesh, dev):
    """Rank side of mp_agree: the (1, 2) step, then (rank 0) the 1-rank
    step on the same card from the same state and draws, compared by
    train_agree's rule (the class-sharded params gathered, and apart); the
    planted fault's (1, 2) step must fail that rule."""
    from pps_tpu_torch.parallel import mesh as mesh_lib
    pk = p['agree_pk']
    cfg = mp_cfg('float32', pk[0] * pk[1], *pk)
    k_logits = cfg.MODEL.NUM_CLASSES - 1
    start, two, logs2, rows = _mp_step(cfg, dev, mesh, p['agree_batch'])
    _, planted, _, _ = _mp_step(cfg, dev, mesh, p['agree_batch'],
                                planted=True)
    sharded = sorted(n for n, r in mesh_lib.param_shardings(
        mesh, two['params']).items() if isinstance(r, mesh_lib.ClassSharding))
    if mesh.rank:
        return {}
    _, one, logs1, rows1 = _mp_step(cfg, dev, None, p['agree_batch'])
    if not np.array_equal(rows, rows1):
        raise AssertionError('the (1, 2) ranks\' rows differ from the '
                             '1-rank batch')
    l2, l1 = float(logs2['loss']), float(logs1['loss'])
    if abs(l2 - l1) > DP_LOSS_RTOL * abs(l1):
        raise AssertionError('loss (1, 2) {} 1 rank {}'.format(l2, l1))
    worst, bad = _dp_updates(start, two, one)
    if bad is not None:
        raise AssertionError('(1, 2) vs 1 rank after one step: ' + bad)
    worst_sharded, bad = _dp_updates({k: start[k] for k in sharded},
                                     two, one)
    if bad is not None:
        raise AssertionError('class-sharded params: ' + bad)
    worst['state'] = max(_rel_rms(two['state'][k].cpu(),
                                  one['state'][k].cpu())
                         for k in one['state'])
    if worst['state'] > DP_STATE_REL:
        raise AssertionError('BN state {}'.format(worst['state']))
    worst_planted, caught = _dp_updates(start, planted, one)
    if caught is None:
        raise AssertionError('the update rule passed the planted fault '
                             '(worst {})'.format(worst_planted))
    return {'logits': k_logits, 'logits_per_rank': k_logits // mesh.n_model,
            'class_sharded': sharded, 'loss_1x2': l2, 'loss_1_rank': l1,
            'loss_rel': abs(l2 - l1) / abs(l1), 'worst_rel': worst,
            'worst_rel_class_sharded': worst_sharded, 'rows_bitwise': True,
            'planted': {'worst_rel': worst_planted, 'caught_at': caught}}


class _CollectiveClock(object):
    """While active, a CUDA event pair around every collective of
    ``parallel/collectives.py``, tagged 'gradient' (the flat gradient
    all-reduce), 'logs' (the logs' all-reduce over every rank) or 'model'
    (the model group's: the log-sum-exp shifts and sums, the label
    logits, the argmaxes, the CRM's softmax and loss)."""

    def __init__(self):
        self.pairs, self._tag = [], 'model'

    def __enter__(self):
        import torch
        from pps_tpu_torch.parallel import collectives as col
        self._saved = {n: getattr(col, n) for n in (
            '_all_reduce_', '_all_gather', 'all_reduce_flat_',
            'all_reduce')}
        saved = self._saved

        def clocked(name):
            def fn(*a, **k):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = saved[name](*a, **k)
                ev[1].record()
                self.pairs.append((self._tag, ev))
                return out
            return fn

        def tagged(name, tag_of):
            def fn(*a, **k):
                old, self._tag = self._tag, tag_of(*a, **k)
                try:
                    return saved[name](*a, **k)
                finally:
                    self._tag = old
            return fn
        col._all_reduce_ = clocked('_all_reduce_')
        col._all_gather = clocked('_all_gather')
        col.all_reduce_flat_ = tagged('all_reduce_flat_',
                                      lambda *a, **k: 'gradient')
        col.all_reduce = tagged(
            'all_reduce', lambda *a, **k: 'logs' if k.get('axis') == 'world'
            else 'model')
        return self

    def __exit__(self, *exc):
        from pps_tpu_torch.parallel import collectives as col
        for n, f in self._saved.items():
            setattr(col, n, f)
        return False

    def ms(self):
        out = {}
        for tag, (a, b) in self.pairs:
            out[tag] = out.get(tag, 0.0) + a.elapsed_time(b)
        return out


def mp_rank_train(p, mesh, dev):
    """Rank side of mp_train: MP_WARMUP + MP_TIMED bf16 steps of the Duke
    model at global batch 64 on the (1, 2) mesh, timed by CUDA events, the
    collectives clocked; then the placed state saved as a sharded
    checkpoint (every rank its shards), and the gathered state written by
    rank 0 for the parent's bitwise load check."""
    import torch
    from pps_tpu_torch.engine import checkpoint as ckpt
    from pps_tpu_torch.parallel import train_step as ts_lib
    pk = p['train_pk']
    cfg = mp_cfg('bfloat16', pk[0] * pk[1], *pk)
    model, step, ts = make_trainer(cfg, dev, seed=0, mesh=mesh)
    ts = ts_lib.place_train_state(mesh, ts)
    batch = ts_lib.shard_batch(mesh, {k: torch.as_tensor(v).to(dev)
                                      for k, v in p['train_batch'].items()})
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(MP_WARMUP):
        ts, logs = step(ts, batch, 0.01, 1.0, gen)
    torch.cuda.synchronize()
    losses = []
    with _CollectiveClock() as clock:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(MP_TIMED):
            ts, logs = step(ts, batch, 0.01, 1.0, gen)
            losses.append(logs['loss'])
        b.record()
        b.synchronize()
    ms = a.elapsed_time(b) / MP_TIMED
    coll = {k: v / MP_TIMED for k, v in clock.ms().items()}
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite loss {}'.format(losses))
    k_logits = model.head_spec['num_logits']
    local_fc = int(ts['params']['pps_fc_w'].shape[-1])
    t0 = time.perf_counter()
    ckpt.save_checkpoint_dcp(p['dcp'], ts, mesh=mesh, num_logits=k_logits,
                             block=True)
    save_s = time.perf_counter() - t0
    full = ts_lib.gather_train_state(mesh, ts, k_logits)
    if mesh.rank == 0:
        torch.save({part: ({n: (t.cpu() if torch.is_tensor(t) else
                                {m: x.cpu() for m, x in t.items()})
                            for n, t in tree.items()})
                    for part, tree in full.items()}, p['gathered'])
    return {'ms_per_step': ms, 'batch_per_rank':
            int(batch['labels_int32'].shape[0]),
            'local_fc_classes': local_fc,
            'collective_ms_per_step': coll,
            'model_group_share': coll.get('model', 0.0) / ms,
            'gradient_share': coll.get('gradient', 0.0) / ms,
            'losses': [float(v) for v in losses], 'dcp_save_s': save_s}


def mp_rank_main(p, mesh, dev):
    """mp_agree then mp_train on the same ranks (one launch)."""
    return {'agree': mp_rank_agree(p, mesh, dev),
            'train': mp_rank_train(p, mesh, dev)}


def phase_mp(dev, gallery):
    """mp_agree and mp_train: two ranks as a (1, 2) mesh on the card over
    gloo, the Duke yaml at full width (see mp_rank_agree, mp_rank_train).
    Returns the sharded checkpoint directory and the gathered state's
    file, for ckpt_sharded."""
    from pps_tpu_torch.config import cfg as gcfg
    d = os.path.join(ROOT, 'build', 'chip_smoke_mp')
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    mp_cfg('float32', 8, 4, 2)
    k_classes = gcfg.MODEL.NUM_CLASSES
    from pps_tpu_torch.flagship import flagship_cfg
    flagship_cfg()  # the global cfg back to the flagship's
    t0 = time.perf_counter()
    payload = {
        'device': _rank_device(dev), 'mesh_shape': MP_MESH,
        'agree_pk': (MP_AGREE_P, MP_AGREE_K), 'train_pk': (TRAIN_P, TRAIN_K),
        'agree_batch': {n: v.numpy() for n, v in train_batch(
            gallery, MP_AGREE_P, MP_AGREE_K, k_classes, 'cpu').items()},
        'train_batch': {n: v.numpy() for n, v in train_batch(
            gallery, TRAIN_P, TRAIN_K, k_classes, 'cpu').items()},
        'dcp': os.path.join(d, 'mp_train.dcp'),
        'gathered': os.path.join(d, 'mp_train_gathered.pt')}
    ranks = _Ranks('mp', 'mp', payload).results()
    wall = time.perf_counter() - t0
    agree, train = ranks[0]['agree'], [r['train'] for r in ranks]
    emit('mp_agree', config=os.path.relpath(DUKE['yaml'], ROOT),
         mesh=list(MP_MESH), global_batch=MP_AGREE_P * MP_AGREE_K,
         dtype='float32', backend='gloo', residual_gamma=0.01,
         loss_rtol=DP_LOSS_RTOL, state_rel=DP_STATE_REL, rel=TRAIN_REL,
         floor=TRAIN_FLOOR, card=_CARD.get('smi'), **agree)
    emit('mp_train', config=os.path.relpath(DUKE['yaml'], ROOT),
         mesh=list(MP_MESH), global_batch=TRAIN_P * TRAIN_K,
         dtype='bfloat16', steps=MP_TIMED, warmup=MP_WARMUP, ranks=train,
         wall_s_with_mp_agree=wall, card=_CARD.get('smi'),
         note='2 ranks share one H100 (each runs the whole batch: a model '
              'group shares rows): a check that the path works, not a '
              'scaling figure')
    return payload['dcp'], payload['gathered']


def _mp_net_cfg_args(out_dir):
    return ['--device', None, '--skip-test', '--cfg', DUKE['yaml'],
            'TRAIN.WEIGHTS', "''", 'TRAIN.DATASETS', "('duke_mp_trainval',)",
            'TRAIN.IMS_PER_BATCH', str(MP_NET_P * MP_NET_K),
            'REID.P', str(MP_NET_P), 'REID.K', str(MP_NET_K),
            'NUM_GPUS', '2', 'TPU.MESH_SHAPE', str(MP_MESH),
            'TPU.CKPT_FORMAT', 'orbax', 'SOLVER.MAX_ITER', str(MP_NET_EPOCHS),
            'TRAIN.SNAPSHOT_ITERS', '1', 'OUTPUT_DIR', out_dir]


def phase_ckpt_sharded(dev, out_root, dcp_dir, gathered):
    """The sharded checkpoint: mp_train's (1, 2) save loaded into this one
    process, bitwise equal to the gathered state; then ``tools.train_net``
    on two ranks (1, 2) under TPU.CKPT_FORMAT orbax over a Duke-shaped
    subset: a continuous run with PPS_TPU_DUMP_JAXPR set (the graph
    written, its node count above zero) and, beside it, a run whose rank 1
    gets a SIGTERM once the first .dcp snapshot is on disk (both exit 75
    after the same step, one model_preempt_*.dcp); then the same command
    again (auto-resumed from the .dcp): its model_final.pkl bitwise equal
    to the continuous run's."""
    import signal
    import torch
    from pps_tpu_torch.engine import checkpoint as ckpt
    from pps_tpu_torch.utils.io import load_object
    t0 = time.perf_counter()
    want = torch.load(gathered)
    tmpl = {part: ({n: (torch.zeros_like(t, device=dev) if torch.is_tensor(t)
                        else {m: torch.zeros_like(x, device=dev)
                              for m, x in t.items()})
                    for n, t in tree.items()})
            for part, tree in want.items()}
    t1 = time.perf_counter()
    got = ckpt.load_checkpoint_dcp(dcp_dir, tmpl)
    load_s = time.perf_counter() - t1
    n_tensors = 0
    for part, tree in want.items():
        for n, t in tree.items():
            pairs = ([(t, got[part][n])] if torch.is_tensor(t) else
                     [(x, got[part][n][m]) for m, x in t.items()])
            for w, g in pairs:
                n_tensors += 1
                if g.device.type != torch.device(dev).type or \
                        not torch.equal(g.cpu(), w):
                    raise AssertionError('dcp load: {}/{} on {}'.format(
                        part, n, g.device))
    dcp_mb = sum(os.path.getsize(os.path.join(dcp_dir, f))
                 for f in os.listdir(dcp_dir)) / 1e6
    shutil.rmtree(os.path.dirname(dcp_dir), ignore_errors=True)

    # tools.train_net on (1, 2) under TPU.CKPT_FORMAT orbax
    spec = dict(DUKE, train_ids=MP_NET_IDS, train_per_id=MP_NET_PER_ID)
    decode = MixedDecoder(size_table(DUKE), seed=DUKE['seed'])
    from pps_tpu_torch.data import catalog
    root = os.path.join(out_root, 'duke_mp')
    write_reid(root, 'duke_mp',
               [(pid, j % spec['cams'] + 1, None)
                for pid in range(1, MP_NET_IDS + 1)
                for j in range(MP_NET_PER_ID)], [], size_of=decode.size_of)
    data = {'duke_mp_trainval': (catalog.get_im_dir('duke_mp_trainval'),
                                 catalog.get_ann_fn('duke_mp_trainval'))}
    card = _rank_device(dev)

    def payload(out_dir):
        argv = _mp_net_cfg_args(out_dir)
        argv[1] = card
        return {'datasets': data, 'decoder': 'duke', 'argv': argv}

    # the continuous run and the run to preempt side by side (four ranks
    # on the card: their start-up overlaps)
    cont_dir = os.path.join(out_root, 'mp_cont')
    cont_ranks = _Ranks('ckpt_sharded', 'train_net', payload(cont_dir),
                        extra_env={'PPS_TPU_DUMP_JAXPR': '1'})
    pre_dir = os.path.join(out_root, 'mp_pre')
    pre_train = os.path.join(pre_dir, 'train', 'duke_mp_trainval')
    ranks = _Ranks('ckpt_sharded_pre', 'train_net', payload(pre_dir))
    first = os.path.join(pre_train, 'model_epoch1.dcp', '.metadata')
    try:
        while not os.path.isfile(first):
            if any(p.poll() is not None for p in ranks.procs) or \
                    time.perf_counter() - ranks.t0 > DP_TIMEOUT_S:
                raise AssertionError('no model_epoch1.dcp before the end')
            time.sleep(0.05)
        ranks.procs[1].send_signal(signal.SIGTERM)
    except BaseException:
        ranks.kill()
        cont_ranks.kill()
        raise
    cont = cont_ranks.results()
    train_dir = os.path.join(cont_dir, 'train', 'duke_mp_trainval')
    graph = os.path.join(train_dir, 'train_step.graph.txt')
    nodes = [ln for ln in _read(cont_ranks.logs[0])
             if 'train_step.graph.txt' in ln]
    n_nodes = int(nodes[0].split('(')[1].split()[0]) if nodes else 0
    if not os.path.isfile(graph) or n_nodes <= 0:
        raise AssertionError('graph dump: {} {}'.format(graph, nodes))
    graph_mb = os.path.getsize(graph) / 1e6
    cont_names = sorted(os.listdir(train_dir))
    pre = ranks.results(ok=(75,))
    steps = [len(r['losses']) for r in pre]
    preempt = [n for n in os.listdir(pre_train)
               if n.startswith('model_preempt_') and n.endswith('.dcp')]
    if len(set(steps)) != 1 or len(preempt) != 1:
        raise AssertionError('ranks stopped after {}; resume points {}'
                             .format(steps, preempt))
    resumed = _Ranks('ckpt_sharded_resume', 'train_net',
                     payload(pre_dir)).results()
    n_cont, n_res = len(cont[0]['losses']), len(resumed[0]['losses'])
    if steps[0] + n_res != n_cont or \
            resumed[0]['losses'][0] != cont[0]['losses'][steps[0]]:
        raise AssertionError('{} + {} steps of {}; first resumed loss {} '
                             'vs {}'.format(steps[0], n_res, n_cont,
                                            resumed[0]['losses'][0],
                                            cont[0]['losses'][steps[0]]))
    got = load_object(os.path.join(pre_train, 'model_final.pkl'))['blobs']
    ref = load_object(os.path.join(train_dir, 'model_final.pkl'))['blobs']
    equal = sum(np.array_equal(got[k], ref[k]) for k in ref)
    if sorted(got) != sorted(ref) or equal != len(ref):
        raise AssertionError('resumed final: {} of {} blobs bitwise equal'
                             .format(equal, len(ref)))
    fc = ref['pps0_fc_w'].shape
    emit('ckpt_sharded', dcp_load_bitwise=True, dcp_tensors=n_tensors,
         dcp_mb=dcp_mb, dcp_load_s=load_s, graph_nodes=n_nodes,
         graph_mb=graph_mb,
         continuous_checkpoints=cont_names,
         continuous_steps=len(cont[0]['losses']),
         preempted_after_steps=steps[0], resume_point=preempt[0],
         resumed_steps=len(resumed[0]['losses']),
         final_blobs_bitwise_equal=equal, final_blobs=len(ref),
         final_fc_shape=list(fc), wall_s=time.perf_counter() - t0,
         card=_CARD.get('smi'))


RET_SHARDS = 4                      # retrieval_sharded: shards on the card
RET_SHARD_NPROBE = 16               # the IVF recall held equal


def _scale_feats(dev):
    """retrieval_scale's float32 gallery rows (the same seeds), on the
    card in one tensor, and their paths."""
    import torch
    centres = scale_centres(dev)
    parts = []
    for c in range(SCALE_ROWS // SCALE_BUILD):
        rows = torch.arange(c * SCALE_BUILD, (c + 1) * SCALE_BUILD,
                            device=dev)
        parts.append(scale_rows(centres, rows // SCALE_PER_ID,
                                SCALE_SEED + 1 + c))
    return torch.cat(parts), ['g%07d' % r for r in range(SCALE_ROWS)]


def phase_retrieval_sharded(dev, ref):
    """retrieval_scale's 1M x 3968 int8 gallery as RET_SHARDS shards on the
    one card, through RetrievalIndex(shard=True): the exact scan at 64 and
    3,368 queries against the flat and streaming routes, IVF at nprobe 16
    (recall@10 equal to the single-device IVF's), and a full probe of the
    65,536-row sub-index against the single-device IVF."""
    import torch
    from pps_tpu_torch.engine.serving import RetrievalIndex
    from pps_tpu_torch.parallel.mesh import build_mesh
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = build_mesh(devices=[_rank_device(dev)] * RET_SHARDS)
    t0 = time.perf_counter()
    feats, paths = _scale_feats(dev)
    index = RetrievalIndex(feats, paths, mesh=mesh, int8=True, shard=True,
                           device=dev)
    del feats
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if len(index._g) != RET_SHARDS or len(index) != SCALE_ROWS:
        raise AssertionError('{} shards, {} rows'.format(len(index._g),
                                                         len(index)))
    q_np = ref['q']
    nf = SCALE_FLAT_QUERIES
    (d64, i64), s64 = _timed(index.search, q_np[:nf], SCALE_K)
    held64, diff64 = check_topk('sharded vs flat (64 queries)', (d64, i64),
                                ref['flat64'])
    (d_all, i_all), s_all = _timed(index.search, q_np, SCALE_K)
    held_all, diff_all = check_topk('sharded vs streaming (all queries)',
                                    (d_all, i_all), ref['exact'])

    # IVF at nprobe 16 over the sharded gallery: the single-device
    # clustering and budget; recall@10 against the exact answer
    nr = IVF_RECALL_QUERIES
    budget = ref['recall'][str(RET_SHARD_NPROBE)]['budget']
    _, install_s = _timed(index._install_ivf, ref['cent'],
                          nprobe=RET_SHARD_NPROBE, budget=budget,
                          spill_limit=None, train={})
    (_, ids), ivf_s = _timed(index.search, q_np[:nr], SCALE_K)
    hits10 = [len(np.intersect1d(a[:10], b[:10]))
              for a, b in zip(ids, ref['exact'][1][:nr])]
    recall10 = float(np.mean(hits10)) / 10
    want10 = ref['recall'][str(RET_SHARD_NPROBE)]['recall_at_10']
    if recall10 != want10:
        raise AssertionError('sharded IVF recall@10 {} vs single-device '
                             '{}'.format(recall10, want10))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del index
    torch.cuda.empty_cache()

    # the 65,536-row sub-index, every cell probed with a full budget
    sub = RetrievalIndex(ref['sub'][0], ref['sub'][1], mesh=mesh, int8=True,
                         shard=True, device=dev)
    sub._install_ivf(ref['sub_cent'], nprobe=ref['sub_nlist'],
                     budget=IVF_SUB_ROWS, spill_limit=None, train={})
    got, sub_s = _timed(sub.search, q_np[:IVF_GATE_QUERIES], SCALE_K)
    held_sub, diff_sub = check_topk('sharded IVF vs single-device IVF',
                                    got, ref['sub_answer'])
    same_sub = float(np.mean(got[1] == ref['sub_answer'][1][:, :SCALE_K]))
    emit('retrieval_sharded', rows=SCALE_ROWS, shards=RET_SHARDS,
         shard_device=_rank_device(dev), dtype='int8', k=SCALE_K,
         build_s=build_s,
         exact_64={'queries': nf, 'seconds': s64, 'held_share': held64,
                   'max_dist_diff': diff64,
                   'unsharded_flat_ms': ref['routes_ms'][str(nf)]['flat']},
         exact_all={'queries': len(q_np), 'seconds': s_all,
                    'held_share': held_all, 'max_dist_diff': diff_all,
                    'unsharded_streaming_s': ref['exact_s']},
         ivf={'nprobe': RET_SHARD_NPROBE, 'budget': budget,
              'queries': nr, 'recall_at_10': recall10,
              'single_device_recall_at_10': want10, 'install_s': install_s,
              'seconds': ivf_s},
         ivf_full_probe={'rows': IVF_SUB_ROWS, 'queries': IVF_GATE_QUERIES,
                         'held_share': held_sub, 'max_dist_diff': diff_sub,
                         'index_equal_share': same_sub, 'seconds': sub_s},
         tie_eps=TIE_EPS, dist_atol=SCAN_DIST_ATOL, peak_mem_gb=peak,
         card=_CARD.get('smi'))


# ---------------------------------------------------------------------------
# the measurement tools (pps_tpu_torch/tools), ITER_SIZE's divide
# ---------------------------------------------------------------------------

# the JSON keys of the JAX tools' lines, which the port's tools keep
BENCH_INT8_KEYS = {                 # tools/bench_int8.py:99-114
    'imgs_per_sec_per_chip', 'int8_speedup_vs_bf16', 'int8_speedup_vs_fold',
    'fold_speedup_vs_bf16', 'int8_cosine_vs_bf16_min',
    'int8_cosine_vs_bf16_mean', 'calib_quantize_seconds', 'depth', 'batch',
    'device_kind'}
EXACT_SCAN_KEYS = {                 # tools/bench_exact_scan.py:226-235
    'gallery_size', 'dim', 'topk', 'nq', 'bandwidth_bound_ms',
    'measured_read_GBps', 'latency_ms', 'checks', 'device_kind'}
SERVING_KEYS = {                    # tools/bench_serving.py:466-472
    'single_query_latency_ms', 'gallery_size', 'dim', 'topk',
    'gallery_dtype', 'embed', 'device_kind'}
LOAD_ROW_KEYS = {                   # tools/bench_serving.py:283-297
    'mode', 'concurrency', 'qps', 'p50_ms', 'p95_ms', 'p99_ms', 'n', 'shed',
    'errors', 'error_kinds', 'embed_dispatches', 'embed_images',
    'search_dispatches', 'search_queries'}
LOAD_KEYS = {'loadbench', 'rows'}   # tools/bench_serving.py:305
IVF_RECALL_KEYS = {                 # tools/bench_ivf_recall.py:246-255
    'metric', 'gallery', 'dim', 'n_ids', 'train_steps', 'final_loss',
    'nlist', 'k', 'recall_sweep_nprobe', 'train_s', 'embed_s', 'device_kind'}
TOOLS_IVF_IDS, TOOLS_IVF_PER_ID = 64, 32
TOOLS_E2E_IDS, TOOLS_E2E_PER_ID = 64, 4
TOOLS_RERANK = (1000, 5000)         # queries, gallery
ITER_SIZE, ITER_STEPS = 3, 6        # the 'iter' flavor held card vs CPU


def iter_size_agree(dev):
    """The 'iter' SGD flavor (ITER_SIZE 3, one device) for 6 steps from the
    same numpy params and gradients on the card and the CPU: every param,
    momentum and accumulator bitwise equal.  Also the divide as it was (by
    a Python float) on the same accumulators: the elements where the card's
    quotient differs from the CPU's."""
    import torch
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.solver import optimizer as opt
    cfg = flagship_cfg()
    rng = np.random.RandomState(0)
    shapes = {'conv1_w': (64, 3, 7, 7), 'res_conv1_bn_s': (64,),
              'res2_0_branch2a_w': (64, 64, 1, 1), 'pps0_fc_w': (128, 751),
              'pps0_fc_b': (751,), 'crm_fc8c_w': (3968, 751)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    meta = opt.make_param_meta(params, cfg)
    sides = {}
    for d in ('cpu', dev):
        p = {k: torch.from_numpy(v).to(d) for k, v in params.items()}
        st = opt.init_opt_state(p, 'iter', ITER_SIZE)
        for step in range(ITER_STEPS):
            g_rng = np.random.RandomState(10 + step)
            grads = {k: torch.from_numpy(
                (g_rng.randn(*s) * 10.0 ** g_rng.randint(-3, 2)).astype(
                    np.float32)).to(d) for k, s in shapes.items()}
            p, st = opt.sgd_update(p, grads, st, 0.01 * (step + 1), meta,
                                   flavor='iter', iter_size=ITER_SIZE,
                                   num_devices=1)
        sides[str(d)] = (p, st)
    (cp, cs), (gp, gs) = sides['cpu'], sides[str(dev)]
    bad = [k for k in shapes
           if not torch.equal(cp[k], gp[k].cpu())
           or not torch.equal(cs['momentum'][k], gs['momentum'][k].cpu())
           or not torch.equal(cs['acmgrad'][k], gs['acmgrad'][k].cpu())]
    if bad:
        raise AssertionError('ITER_SIZE {}: card != CPU at {}'.format(
            ITER_SIZE, bad))
    acm = torch.from_numpy(np.random.RandomState(1).randn(1 << 22).astype(
        np.float32) * 3.0)
    old_card = (acm.to(dev) / float(ITER_SIZE)).cpu()
    new_card = (acm.to(dev) / opt.as_scalar(float(ITER_SIZE),
                                            acm.to(dev))).cpu()
    return {'steps': ITER_STEPS, 'iter_size': ITER_SIZE, 'bitwise': True,
            'elements': int(sum(v.size for v in params.values())),
            'python_float_divide_ulps_apart':
                int((old_card != acm / float(ITER_SIZE)).sum()),
            'tensor_divide_ulps_apart': int((new_card != acm / float(
                ITER_SIZE)).sum()),
            'divide_elements': int(acm.numel())}


def _tool_json_keys(name, got, want):
    if set(got) != want:
        raise AssertionError('{}: keys {} != the JAX tool\'s {}'.format(
            name, sorted(got), sorted(want)))


def phase_tools(dev, bare_ms, int8_stacked):
    """The measurement tools of pps_tpu_torch/tools at full width, counts
    cut: each run in process through main(argv), trace_top_ops as a child
    process (``python -m``), bench_serving --load with its own daemon;
    every tool's JSON with the JAX tool's keys and its gates.

    Order: the tools that work on the host while the trace child starts
    and traces; bench_int8 and bench_distmat (the card's work, little of
    the host's) beside the child's export and analysis; then the rest one
    at a time, the host-bound step first; the load bench's daemon starts
    up beside the IVF and e2e tools, and the load levels run last."""
    import torch
    from pps_tpu_torch.kernels import LAUNCH_COUNTS_ENV
    from pps_tpu_torch.tools import (bench_distmat, bench_int8,
                                     bench_rerank, bench_serving,
                                     data_loader_benchmark,
                                     profile_train_step)
    work = os.path.join(ROOT, 'build', 'chip_smoke_tools')
    logs = os.path.join(ROOT, 'build', 'chip_smoke_logs')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    seconds = {}
    report = {}

    def run(name, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 2)
        print('tools: {} {} s'.format(name, seconds[name]), file=sys.stderr,
              flush=True)
        return out

    load_args = bench_serving.parse_args([
        '--load', '--load-concurrency', '1,4', '--load-duration', '3',
        '--load-warmup', '1', '--load-modes', 'exact', '--load-workdir',
        os.path.join(work, 'load'), '--device', str(dev)])
    trace_log = os.path.join(logs, 'tools_trace_top_ops.log')
    t_child = time.perf_counter()
    with open(trace_log, 'w') as log:
        child = subprocess.Popen(
            [sys.executable, '-m', 'pps_tpu_torch.tools.trace_top_ops',
             '--steps', '3', '--trace-dir', os.path.join(work, 'trace'),
             '--device', str(dev)], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT, env=_child_env('trace_top_ops'))
    daemon = None
    try:
        report['iter_size'] = run('iter_size', iter_size_agree, dev)
        report['data_loader_benchmark'] = run(
            'data_loader_benchmark', data_loader_benchmark.main,
            ['--batches', '5', '--workers', '2'])
        nq, ng = TOOLS_RERANK
        rr = run('bench_rerank', bench_rerank.main,
                 ['--nq', str(nq), '--ng', str(ng)])
        if rr['share_apart_dev_native'] > RERANK_FLIP_SHARE:
            raise AssertionError('bench_rerank: {} of the entries '
                                 'apart'.format(
                                     rr['share_apart_dev_native']))
        report['bench_rerank'] = rr
        run('bench_serving_load_files', bench_serving.load_files,
            load_args, dev)
        # the child prints 'traced ...' when its device work is over
        while child.poll() is None and not any(
                ln.startswith('traced ') for ln in _read(trace_log)):
            if time.perf_counter() - t_child > 600:
                raise AssertionError('trace_top_ops traced nothing in 600 s')
            time.sleep(0.2)
        seconds['trace_top_ops_traced'] = round(
            time.perf_counter() - t_child, 2)

        i8 = run('bench_int8', bench_int8.main, [], iters=3, warmup=2)
        _tool_json_keys('bench_int8', i8, BENCH_INT8_KEYS)
        if i8['int8_cosine_vs_bf16_min'] < INT8_MIN_COS:
            raise AssertionError('bench_int8 cosine {}'.format(
                i8['int8_cosine_vs_bf16_min']))
        i8['test_int8_stacked_imgs_per_s'] = int8_stacked
        report['bench_int8'] = i8
        report['bench_distmat'] = run('bench_distmat', bench_distmat.main,
                                      [], iters=3)
        rc = child.wait(600)
        seconds['trace_top_ops_child'] = round(
            time.perf_counter() - t_child, 2)

        pts = run('profile_train_step', profile_train_step.main,
                  ['--iters', '3'])
        pts['train_phase_bare_ms'] = bare_ms
        report['profile_train_step'] = pts
        report['bench_exact_scan'] = tool_exact_scan(run)
        report['bench_serving'] = tool_serving(run, seconds, dev)
        # the load bench's daemon starts up beside the next two tools; it
        # inherits this process's environment, so its launch counts go to
        # a child file of this phase
        os.environ[LAUNCH_COUNTS_ENV] = _child_env('serve_load')[
            LAUNCH_COUNTS_ENV]
        try:
            daemon = bench_serving.start_first_daemon(load_args, dev)
        finally:
            del os.environ[LAUNCH_COUNTS_ENV]
        report['bench_ivf_recall'] = tool_ivf_recall(run, work)
        report['bench_train_e2e'] = tool_train_e2e(run, work)
        report['bench_serving_load'] = tool_serving_load(
            run, load_args, daemon, dev, work, logs)
    finally:
        for proc in (child, daemon and daemon[0]):
            if proc and proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = _read(trace_log)
    if rc != 0:
        raise AssertionError('trace_top_ops exited {}:\n{}'.format(
            rc, ''.join(lines[-30:])))
    trace = json.loads([ln for ln in lines
                        if ln.startswith('{"path"')][-1])
    if not trace['top'] or any(not r[0] for r in trace['top']) or \
            sum(r[2] for r in trace['top']) > 1.0 + 1e-9:
        raise AssertionError('trace_top_ops top rows: {}'.format(
            trace['top']))
    report['trace_top_ops'] = trace
    shutil.rmtree(work, ignore_errors=True)
    emit('tools', seconds=seconds, **report)


def tool_exact_scan(run):
    """bench_exact_scan; its exact variants against stream4096."""
    import torch
    from pps_tpu_torch.tools import bench_exact_scan
    scan = {}
    es = run('bench_exact_scan', bench_exact_scan.main, ['--iters', '3'],
             results=scan)
    _tool_json_keys('bench_exact_scan', es, EXACT_SCAN_KEYS)
    ref_d2, ref_i = scan['stream4096']
    es['held'] = {}
    for name, (d2, ii) in scan.items():
        if name == 'flat_int8':  # approximate by design: reported only
            continue
        es['held'][name] = check_topk('bench_exact_scan ' + name,
                                      (np.sqrt(d2), ii),
                                      (np.sqrt(ref_d2), ref_i))
    del scan
    torch.cuda.empty_cache()
    return es


def tool_serving(run, seconds, dev):
    """bench_serving's one query; its top-k against RetrievalIndex.search
    over the same rows."""
    import torch
    from pps_tpu_torch.engine.serving import RetrievalIndex
    from pps_tpu_torch.tools import bench_serving
    sq = {}
    sv = run('bench_serving', bench_serving.main, ['--iters', '3'],
             results=sq)
    _tool_json_keys('bench_serving', sv, SERVING_KEYS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = torch.cat([r for _, r in bench_serving.gallery_rows(
        sv['gallery_size'], sv['dim'], dev)])
    index = RetrievalIndex(rows, list(range(sv['gallery_size'])), int8=True,
                           device=dev)
    del rows
    want = index.search(sq['query'], sv['topk'])
    sv['held_vs_retrieval_index'] = check_topk(
        'bench_serving vs RetrievalIndex.search',
        (sq['dists'], sq['indices']), want)
    del index
    torch.cuda.empty_cache()
    seconds['bench_serving_check'] = round(time.perf_counter() - t0, 2)
    return sv


def tool_ivf_recall(run, work):
    """bench_ivf_recall; every cell probed equals the exact top-k wherever
    the k-th rank is not a near-tie (the probe sums each distance in
    another order)."""
    from pps_tpu_torch.ops import ivf as ivf_ops
    from pps_tpu_torch.tools import bench_ivf_recall
    nlist = ivf_ops.default_nlist(TOOLS_IVF_IDS * TOOLS_IVF_PER_ID)
    probes = {}
    iv = run('bench_ivf_recall', bench_ivf_recall.main, [
        '--n-ids', str(TOOLS_IVF_IDS), '--per-id', str(TOOLS_IVF_PER_ID),
        '--train-steps', '5', '--nprobes', '2,8,{}'.format(nlist),
        '--workdir', os.path.join(work, 'ivf')], results=probes)
    _tool_json_keys('bench_ivf_recall', iv, IVF_RECALL_KEYS)
    if iv['nlist'] != nlist:
        raise AssertionError('bench_ivf_recall: {} cells'.format(
            iv['nlist']))
    iv['full_probe_held'] = check_topk('bench_ivf_recall full probe',
                                       probes[nlist], probes['exact'])
    return iv


def tool_train_e2e(run, work):
    from pps_tpu_torch.tools import bench_train_e2e
    e2e = run('bench_train_e2e', bench_train_e2e.main, [
        '--n-ids', str(TOOLS_E2E_IDS), '--per-id', str(TOOLS_E2E_PER_ID),
        '--epochs', '1', '--data-dir', os.path.join(work, 'e2e')])
    if not e2e['final'] or not os.path.exists(e2e['final']):
        raise AssertionError('bench_train_e2e: no final checkpoint')
    return e2e


def tool_serving_load(run, load_args, daemon, dev, work, logs):
    """bench_serving --load on the daemon started earlier: every row with
    samples, no errors and the JAX tool's keys."""
    from pps_tpu_torch.tools import bench_serving
    ld = run('bench_serving_load', bench_serving.run_load, load_args, dev,
             first=daemon)
    _tool_json_keys('bench_serving --load', ld, LOAD_KEYS)
    with open(ld['loadbench']) as f:
        load_rows = json.load(f)['results']
    for row in load_rows:
        _tool_json_keys('bench_serving --load row', row, LOAD_ROW_KEYS)
        if row['n'] == 0 or row['errors']:
            raise AssertionError('bench_serving --load row {}'.format(row))
    shutil.copyfile(os.path.join(work, 'load', 'serve_exact.log'),
                    os.path.join(logs, 'tools_serve_load.log'))
    shutil.rmtree(os.path.join(work, 'load'), ignore_errors=True)
    return load_rows


def main():
    if len(sys.argv) > 1 and sys.argv[1] == '--dp-rank':
        return dp_rank_main(sys.argv[2], sys.argv[3])  # a rank's process
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    from pps_tpu_torch import kernels as kernels_lib
    from pps_tpu_torch.device import resolve_device
    dev = resolve_device('cuda')

    t_start = time.perf_counter()
    seconds = {}  # each phase's wall clock, for the phase_seconds line

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = round(time.perf_counter() - t0, 1)

    timed('build', phase_build)
    kernels = [timed('kernel', phase_kernel, dev),
               timed('kernel_int8', phase_kernel_int8, dev)]
    gallery = timed('gallery', make_gallery)

    # each phase of the main path runs through driven(): the launch counts
    # are zeroed just before it and read just after, per phase and kernel;
    # a child process of the port (test_net, the daemon, retrieve, the
    # export tool) starts at 0 and writes its own counts at exit, which are
    # added to its phase's
    by_phase, in_children = {}, {}

    def driven(name, fn, *args):
        kernels_lib.reset_launch_counts()
        _CHILDREN.clear()
        out = timed(name, fn, *args)
        children = child_launches()
        counts = kernels_lib.launch_counts()
        by_phase[name] = {k: v + sum(c.get(k, 0) for c in children.values())
                          for k, v in counts.items()}
        if children:
            in_children[name] = children
        torch.cuda.empty_cache()
        return out

    # main path, part 1: extraction and serving
    cfg, model, params, state, feats = driven('extract', phase_extract, dev,
                                              gallery)
    timed('agree', phase_agree, dev, params, state, gallery)
    driven('serve', phase_serve, dev, cfg, model, params, state, gallery,
           feats)
    timed('profile', phase_profile, dev, model, params, state, gallery, cfg)
    del model, params, state, feats
    torch.cuda.empty_cache()

    # main path, part 2: the train step
    step, ts, batch, bare_ms = driven('train', phase_train, dev, gallery)
    timed('profile_train', phase_profile_train, dev, step, ts, batch)
    del step, ts, batch
    torch.cuda.empty_cache()
    timed('train_agree', phase_train_agree, dev, gallery)
    torch.cuda.empty_cache()
    # the data-parallel step: two ranks on the card over gloo, one NCCL rank
    driven('dp_agree', phase_dp_agree, dev, gallery)
    driven('dp_train', phase_dp_train, dev, gallery, bare_ms)
    # the model axis: two ranks as a (1, 2) mesh, the Duke yaml
    mp_ckpt = driven('mp_agree_mp_train', phase_mp, dev, gallery)
    timed('remat', phase_remat, dev, gallery)
    torch.cuda.empty_cache()
    timed('gn_agree', phase_gn_agree, dev)
    torch.cuda.empty_cache()

    # main path, part 3: the train -> test drivers
    out_root = os.path.join(ROOT, 'build', 'chip_smoke_run')
    keep = os.path.join(ROOT, 'build', 'chip_smoke_keep')
    for d in (out_root, keep):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(keep)
    decode = MarketDecoder()
    write_market(os.path.join(out_root, 'data'))
    cfg, rec, final_pkl = driven('train_net', phase_train_net, dev, out_root,
                                 decode, bare_ms)
    driven('resume', phase_resume, dev, out_root, decode, rec, final_pkl)
    market_feats, market_roidb, market_run = driven(
        'test_net', phase_test_net, dev, out_root, cfg, final_pkl, decode,
        rec)
    market_pkl = os.path.join(keep, 'market_model_final.pkl')
    shutil.copyfile(final_pkl, market_pkl)  # for the serving daemon
    del rec, gallery
    torch.cuda.empty_cache()
    # the drivers on two ranks: tools.train_net (preempted, resumed) and
    # run_inference with test_net's pkl
    driven('dp_train_net', phase_dp_train_net, dev, out_root)
    driven('dp_test_net', phase_dp_test_net, dev, out_root, market_pkl,
           market_feats)
    # the sharded checkpoint and the graph dump, on the (1, 2) mesh
    driven('ckpt_sharded', phase_ckpt_sharded, dev, out_root, *mp_ckpt)

    # main path, part 3b: the model variants on the same synthetic Market
    # set: FPN through the drivers, BN folding, int8, the export tool
    fpn_cfg, fpn_rec, fpn_pkl = driven('train_fpn', phase_train_fpn, dev,
                                       out_root, decode)
    driven('test_fpn', phase_test_net, dev, out_root, fpn_cfg, fpn_pkl,
           decode, fpn_rec, 'test_fpn')
    del fpn_rec
    torch.cuda.empty_cache()
    driven('fold', phase_fold, dev, market_pkl, decode)
    int8_stacked = driven('test_int8', phase_test_int8, dev, out_root,
                          market_pkl, decode, market_feats, market_run)
    driven('export', phase_export, dev, out_root, market_pkl, decode)
    shutil.rmtree(out_root, ignore_errors=True)  # ~2.5 GB of checkpoints
    torch.cuda.empty_cache()

    # main path, part 4: the mixed-size datasets through the drivers
    decoders = {}
    for spec in (DUKE, CUHK03):
        decoders[spec['name']] = MixedDecoder(size_table(spec),
                                              seed=spec['seed'])
        write_mixed(os.path.join(out_root, spec['name']), spec,
                    decoders[spec['name']])
    duke, cuhk = decoders['duke'], decoders['cuhk03']
    timed('augment_agree', phase_augment_agree, dev, duke)
    duke_rec, duke_pkl = driven('train_duke', phase_train_mixed, dev,
                                out_root, DUKE, duke, DUKE_EPOCHS,
                                'train_duke')
    driven('host_chain', phase_host_chain, dev, out_root, duke)
    # one epoch: the checkpoint for test_cuhk03; its loss is reported
    cuhk_rec, cuhk_pkl = driven('train_cuhk03', phase_train_mixed, dev,
                                out_root, CUHK03, cuhk, CUHK03_EPOCHS,
                                'train_cuhk03', False)
    feats, roidb = driven('test_duke', phase_test_mixed, dev, out_root,
                          'test_duke', DUKE['yaml'], duke_pkl, duke,
                          duke_rec)
    driven('test_duke_fliptta', phase_test_mixed, dev, out_root,
           'test_duke_fliptta', DUKE_FLIPTTA_YAML, duke_pkl, duke, duke_rec)
    driven('test_cuhk03', phase_test_mixed, dev, out_root, 'test_cuhk03',
           CUHK03['yaml'], cuhk_pkl, cuhk, cuhk_rec)
    driven('serve_mixed', phase_serve_mixed, dev, duke_rec, feats, roidb,
           duke)
    del duke_rec, cuhk_rec, feats, roidb

    # main path, part 5: retrieval at gallery scale, re-ranking, the daemon
    ref = driven('retrieval_scale', phase_retrieval_scale, dev)
    driven('retrieval_sharded', phase_retrieval_sharded, dev, ref)
    del ref
    torch.cuda.empty_cache()
    driven('test_cuhk03_rerank', phase_test_cuhk03_rerank, dev, out_root,
           cuhk_pkl, cuhk)
    driven('rerank_market', phase_rerank_market, dev, market_feats,
           market_roidb)
    del market_feats
    driven('serve_daemon', phase_serve_daemon, dev, market_pkl,
           market_roidb, decode)
    for d in (out_root, keep, os.path.join(ROOT, 'build',
                                           'chip_smoke_serve')):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()

    # part 6: the measurement tools, and ITER_SIZE's divide
    driven('tools', phase_tools, dev, bare_ms, int8_stacked)

    for k in kernels:
        name = k['name']
        k['launches_by_phase'] = {p: v[name] for p, v in by_phase.items()}
        k['launches'] = sum(k['launches_by_phase'].values())
        k['launches_in_child_processes'] = {
            p: {c: v.get(name, 0) for c, v in ch.items()}
            for p, ch in in_children.items()}
        if k['on_main_path'] and k['launches'] == 0:
            raise AssertionError('{} never launched on the main path'.format(
                k['name']))
    timed('numpy_checks', settle_numpy_checks)  # the deferred gates
    seconds['total'] = round(time.perf_counter() - t_start, 1)
    print(json.dumps({'phase_seconds': seconds}), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
