"""IVF recall on float embeddings of a trained flagship (counterpart of
``tools/bench_ivf_recall.py``).

Measures recall against nprobe on embeddings the flagship model itself
produces:

1. fabricate a synthetic identity set (smooth per-identity base textures
   at REID.SCALE, so identities have distinct low-frequency structure the
   conv body can separate),
2. train the flagship (PPS + CRM + triplet, the shipped train step on the
   uint8 augment wire) on jittered views for --train-steps steps,
3. embed --per-id jittered gallery views per identity through batched
   extraction (the same features a gallery build produces),
4. quantize to the serving int8 layout (``ops/topk.quantize_gallery``),
5. sweep nprobe and record recall@k of the IVF probe (``ops/ivf``) against
   the EXACT top-k over the same int8 gallery on the card (so probe loss
   is apart from quantization loss).

Prints ONE json line.  Train + embed are cached under --workdir, keyed by
the config and the extraction path's sources.

    python -m pps_tpu_torch.tools.bench_ivf_recall [--n-ids 256]
        [--per-id 200] [--queries 64] [--train-steps 150] [--topk 100]
        [--embed-batch 256] [--nprobes 2,4,8,16,32] [--workdir DIR]
        [--device cuda|cpu]
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.tools import common

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_identities(n_ids, h, w, seed=0):
    """Per-identity smooth base textures: a coarse random grid upsampled
    to (h, w) -- distinct low-frequency appearance per identity."""
    import cv2
    rng = np.random.RandomState(seed)
    bases = np.empty((n_ids, h, w, 3), np.uint8)
    for i in range(n_ids):
        coarse = rng.randint(0, 256, (12, 4, 3), np.uint8)
        bases[i] = cv2.resize(coarse, (w, h),
                              interpolation=cv2.INTER_CUBIC)
    return bases


def jitter(base, rng):
    """One augmentation-jittered view: shift, brightness, noise, flip.
    ``rng``: a ``np.random.Generator`` (its float32 normals keep the
    per-image noise cheap: the embedding pass jitters every gallery
    row)."""
    import cv2
    h, w = base.shape[:2]
    # pad + random-crop (translation up to ~6% of each side)
    py, px = h // 16, w // 16
    padded = cv2.copyMakeBorder(base, py, py, px, px, cv2.BORDER_REFLECT)
    y0 = rng.integers(0, 2 * py + 1)
    x0 = rng.integers(0, 2 * px + 1)
    im = padded[y0:y0 + h, x0:x0 + w]
    if rng.random() < 0.5:
        im = im[:, ::-1]
    gain = np.float32(0.8 + 0.4 * rng.random())
    noise = rng.standard_normal((h, w, 3), dtype=np.float32) * 8.0
    return np.clip(im.astype(np.float32) * gain + noise,
                   0, 255).astype(np.uint8)


def train_flagship(cfg, model, params, state, bases, steps, dev, seed=1):
    """Train the shipped step on P x K jittered identity batches; returns
    (params, state, last loss)."""
    step, ts = common.make_trainer(cfg, model, params, state, dev)
    p, k = cfg.REID.P, cfg.REID.K
    n_ids = bases.shape[0]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loss = None
    for i in range(steps):
        ids = rng.choice(n_ids, size=p, replace=False)
        labels = np.repeat(ids, k).astype(np.int32)
        batch = common.label_batch(labels, cfg.MODEL.NUM_CLASSES, dev)
        batch['data_u8'] = torch.from_numpy(
            np.stack([jitter(bases[j], rng) for j in labels])).to(dev)
        batch['flipped'] = torch.zeros(p * k, dtype=torch.bool, device=dev)
        ts, logs = step(ts, batch, 0.01, 1.0, gen)
        if i % 25 == 0 or i == steps - 1:
            loss = float(logs['loss'])  # a sync point: keeps the host near
            print('step %d loss %.4f' % (i, loss), file=sys.stderr,
                  flush=True)
    return ts['params'], ts['state'], loss


def recall_at_k(pos, perm, exact_idx):
    """Mean over queries of |IVF hits & exact top-k| / k.  ``pos``: IVF
    positions in the cell-sorted layout (-1 = an unfilled slot, dropped:
    counting it as row perm[0] would inflate the recall)."""
    ng = perm.shape[0]
    got = np.where(pos >= 0, perm[np.clip(pos, 0, ng - 1)], -1)
    return float(np.mean(
        [len(set(got[r][got[r] >= 0].tolist()) & set(exact_idx[r].tolist()))
         / exact_idx.shape[1] for r in range(exact_idx.shape[0])]))


def _fingerprint(cfg):
    """The config and the extraction path's sources: a sweep must not
    report recall for embeddings of a model that no longer exists."""
    fp = hashlib.md5()
    fp.update(repr(sorted(cfg.items(), key=lambda kv: kv[0])).encode())
    for rel in ('models/model.py', 'models/resnet.py', 'models/heads.py',
                'parallel/eval_step.py', 'data/device_preprocess.py'):
        with open(os.path.join(ROOT, 'pps_tpu_torch', rel), 'rb') as f:
            fp.update(f.read())
    return fp.hexdigest()[:10]


def main(argv=None, results=None):
    """``results``: an optional dict filled with the exact top-(k+1) and
    each nprobe's IVF top-k as (distances, gallery row ids), numpy, for a
    caller's own checks."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--n-ids', type=int, default=256)
    ap.add_argument('--per-id', type=int, default=200,
                    help='gallery rows per identity')
    ap.add_argument('--queries', type=int, default=64)
    ap.add_argument('--train-steps', type=int, default=150)
    ap.add_argument('--topk', type=int, default=100)
    ap.add_argument('--embed-batch', type=int, default=256)
    ap.add_argument('--nprobes', default='2,4,8,16,32')
    ap.add_argument('--workdir',
                    default=os.path.join(ROOT, 'build', 'ivf_recall'),
                    help='cache dir for the trained embeddings: train + '
                         'embed are the expensive stages, so re-runs of '
                         'the sweep load them from here')
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    from pps_tpu_torch.ops import ivf as ivf_ops
    from pps_tpu_torch.ops.topk import quantize_gallery, streaming_topk
    from pps_tpu_torch.parallel.eval_step import make_extract_fn

    dev = resolve_device(args.device)
    cfg = common.tool_cfg(num_classes=args.n_ids + 1)
    w, h = cfg.REID.SCALE
    ng = args.n_ids * args.per_id
    cache = os.path.join(
        args.workdir, 'embeds_ids%d_per%d_q%d_steps%d_%s.npz'
        % (args.n_ids, args.per_id, args.queries, args.train_steps,
           _fingerprint(cfg)))
    if os.path.exists(cache):
        data = np.load(cache)
        gal, qv = data['gal'], data['qv']
        loss = float(data['loss'])
        t_train = t_embed = 0.0
        print('loaded cached embeddings %s (%d x %d)'
              % (cache, gal.shape[0], gal.shape[1]), file=sys.stderr,
              flush=True)
    else:
        bases = make_identities(args.n_ids, h, w, seed=0)
        model, params, state = common.seeded_model(cfg, dev,
                                                   seed=cfg.RNG_SEED)
        t0 = time.time()
        params, state, loss = train_flagship(cfg, model, params, state,
                                             bases, args.train_steps, dev)
        t_train = time.time() - t0
        print('trained %d steps in %.1f s (loss %.3f)'
              % (args.train_steps, t_train, loss), file=sys.stderr,
              flush=True)

        # embed gallery + queries through batched extraction (uint8 wire)
        extract = make_extract_fn(
            model, device_preproc=(np.asarray(cfg.PIXEL_MEANS), (h, w)),
            device=dev)
        rng = np.random.default_rng(7)

        def embed_stream(n_rows, owner_of):
            feats, bs = [], args.embed_batch
            for s in range(0, n_rows, bs):
                ims = np.stack([jitter(bases[owner_of(i)], rng)
                                for i in range(s, min(s + bs, n_rows))])
                feats.append(extract(params, state,
                                     torch.from_numpy(ims).to(dev)))
            return torch.cat(feats).float().cpu().numpy()

        t0 = time.time()
        gal = embed_stream(ng, lambda i: i % args.n_ids)
        qv = embed_stream(args.queries, lambda i: i % args.n_ids)
        t_embed = time.time() - t0
        os.makedirs(args.workdir, exist_ok=True)
        np.savez(cache, gal=gal, qv=qv, loss=np.float32(loss))
        print('cached embeddings to %s' % cache, file=sys.stderr,
              flush=True)

    # the serving int8 layout; the exact top-k over the same rows
    gd, sd = quantize_gallery(torch.from_numpy(gal).to(dev))
    qd = torch.from_numpy(qv).to(dev)
    # one rank past k: whether the k-th could trade places with the next
    ed, ei = (t.cpu().numpy() for t in streaming_topk(
        qd, gd, k=args.topk + 1, chunk=65536, g_scale=sd))
    if results is not None:
        results['exact'] = (ed, ei)
    ei = ei[:, :args.topk]

    nlist = ivf_ops.default_nlist(ng)
    cent = ivf_ops.kmeans(gd, nlist, iters=10, seed=0, g_scale=sd,
                          device=dev)
    nlist = int(cent.shape[0])
    assign = ivf_ops.assign_clusters(gd, cent, g_scale=sd)
    perm, starts = ivf_ops.build_ivf(assign, nlist)
    perm_dev = torch.from_numpy(perm.astype(np.int64)).to(dev)
    gd_s, sd_s = gd[perm_dev], sd[perm_dev]   # cell-sorted on the card
    starts_dev = torch.from_numpy(starts).to(dev)

    sweep = {}
    for nprobe in [int(x) for x in args.nprobes.split(',')]:
        budget = min(ng, max(2048, 4 * nprobe * ng // max(nlist, 1)))
        dd, pos = (t.cpu().numpy() for t in ivf_ops.ivf_topk(
            qd, gd_s, cent, starts_dev, k=args.topk, nprobe=nprobe,
            budget=budget, chunk=1024, g_scale=sd_s))
        sweep[nprobe] = round(recall_at_k(pos, perm, ei), 4)
        if results is not None:
            results[nprobe] = (dd, np.where(pos >= 0, perm[np.clip(
                pos, 0, ng - 1)], -1))

    out = {
        'metric': 'ivf_recall_real_embeddings',
        'gallery': ng, 'dim': int(gal.shape[1]), 'n_ids': args.n_ids,
        'train_steps': args.train_steps, 'final_loss': round(loss, 3),
        'nlist': nlist, 'k': args.topk,
        'recall_sweep_nprobe': sweep,
        'train_s': round(t_train, 1), 'embed_s': round(t_embed, 1),
        'device_kind': common.device_kind(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
