"""Inference and evaluation engine (counterpart of
``pps_tpu/engine/test.py``), on one device or over a data mesh.

Test images are decoded on the host by a thread pool, shipped as raw uint8
and preprocessed, embedded and scored on the device.  The tail batch is
padded to the batch size (its pad rows dropped), and ``features.pkl``
keeps the reference container ``{'all_feats': [N, E], 'cfg': yaml}``, so
the JAX package's evaluation tools read it.

Mixed decode sizes with height/width metadata (Duke, CUHK03) ride the
padded uint8 wire: decodes padded to one dataset-global bucket plus each
sample's ``valid_hw``.  Batches outside the uint8 contracts, and
``TPU.DEVICE_PREPROC False``, take the float32 host preprocessing
(``transforms.prep_im_for_blob``).

``REID.RERANK`` adds the re-ranked blocks (on the card with
``TPU.DEVICE_EVAL``, else the host C++ engine), and ``REID.VIS`` writes
rank-list images to ``<output_dir>/vis/``.  ``TPU.INT8_EVAL`` extracts
through the int8 body (``models/quantize.py``), calibrated on the first
``TPU.INT8_CALIB_IMAGES`` test images.

Over a data mesh (a process group, one rank per card) every rank runs
``run_inference``: each extracts its rows of every global batch
(``TEST.IMS_PER_BATCH x`` the world size, the tail padded), rank 0 gathers
the features, evaluates them and writes ``features.pkl``, and the other
ranks return.  ``TPU.INT8_EVAL`` calibrates alike on every rank.

Weights are a pkl or a ``.dcp`` directory of the port's sharded format
(``engine/checkpoint.py``); under a model axis extraction folds it into
data, as pps_tpu's ``batch_sharding(fold_model=True)`` does.  pps_tpu's
``.orbax`` directories raise: pkl is the format both packages read.
"""

import collections
import json
import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pps_tpu_torch.data import transforms
from pps_tpu_torch.data.json_dataset import roidb_for_test
from pps_tpu_torch.data.minibatch import fits_bucket, pad_to_bucket
from pps_tpu_torch.device import Transfer, resolve_device
from pps_tpu_torch.engine import checkpoint as ckpt_lib
from pps_tpu_torch.evaluation import evaluator as eval_lib
from pps_tpu_torch.models.model import build_model
from pps_tpu_torch.parallel import collectives
from pps_tpu_torch.parallel import eval_step as eval_step_lib
from pps_tpu_torch.parallel import mesh as mesh_lib
from pps_tpu_torch.utils.io import save_object
from pps_tpu_torch.utils import trace
from pps_tpu_torch.utils.timer import Timer

logger = logging.getLogger(__name__)


def _default_workers(num_workers):
    """None -> scale with the host (capped at 8); explicit ints honoured."""
    if num_workers is None:
        return min(8, os.cpu_count() or 1)
    return num_workers


def _pad_bucket(roidb):
    """The dataset-global (H_pad, W_pad) of a mixed-size roidb with
    height/width metadata, else None."""
    sizes = {(e.get('height'), e.get('width')) for e in roidb}
    if len(sizes) > 1 and all(None not in s for s in sizes):
        return (max(s[0] for s in sizes), max(s[1] for s in sizes))
    return None


def preprocess_images(roidb, cfg, decode_fn=None, num_workers=None):
    """Decode and preprocess the whole set on the host to a float32
    [N, H, W, 3] stack (threads: cv2's decode and resize release the
    interpreter lock)."""
    num_workers = _default_workers(num_workers)
    decode_fn = decode_fn or transforms.decode_image
    w, h = cfg.REID.SCALE
    pixel_means = np.asarray(cfg.PIXEL_MEANS)
    out = np.empty((len(roidb), h, w, 3), np.float32)

    def work(i):
        im = decode_fn(roidb[i]['image'])
        out[i] = transforms.prep_im_for_blob(im, pixel_means, (w, h))

    if num_workers > 1 and len(roidb) > 16:
        with ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(work, range(len(roidb))))
    else:
        for i in range(len(roidb)):
            work(i)
    return out


def decode_uint8_stack(roidb, decode_fn=None, num_workers=None):
    """Decode the whole set to one uint8 stack [N, h, w, 3], or None when
    the decodes differ in size."""
    decode_fn = decode_fn or transforms.decode_image
    with ThreadPoolExecutor(max(1, _default_workers(num_workers))) as pool:
        ims = list(pool.map(lambda e: decode_fn(e['image']), roidb))
    if not ims or any(im.shape != ims[0].shape for im in ims):
        return None
    return np.stack(ims)


def stream_extract(cfg, model, params, state, roidb, batch_size,
                   decode_fn=None, flip_tta=False, device_preproc=True,
                   num_workers=None, prefetch=3, mesh=None):
    """Streaming extraction in O(prefetch x batch) host memory: threads
    decode whole batches ahead (cv2 releases the GIL), each batch goes to
    the device on a side stream while the previous one computes.  Returns
    [N, E] float32 numpy.

    Each batch takes one of three kinds:

    * 'u8p': a mixed-size roidb with height/width metadata; decodes
      padded to the dataset-global bucket plus valid_hw, preprocessed on
      the device (``make_extract_fn(padded_wire=True)``);
    * 'u8': every decode of the batch has the shape of the run's first
      uint8 batch, preprocessed on the device;
    * 'f32': anything else (or ``device_preproc`` off), preprocessed on
      the host.

    The run keeps one uint8 shape (the JAX package's rule, where each
    shape compiles a graph), so a metadata-less mixed set does not mix
    wires at random.  The count of each kind is logged at the end.

    ``batch_size`` is the global batch.  Under a distributed ``mesh`` each
    rank decodes and embeds only its rows of every (tail-padded) global
    batch, and the features come back on every rank, in row order.
    """
    with trace.span('extract'):
        # from entry until the first batch is decoded
        opening = trace.span('extract.start').__enter__()
        decode_fn = decode_fn or transforms.decode_image
        w, h = cfg.REID.SCALE
        pixel_means = np.asarray(cfg.PIXEL_MEANS)
        pre = (pixel_means, (h, w))
        fns = {'f32': eval_step_lib.make_extract_fn(
            model, flip_tta=flip_tta, device=model.device)}
        if device_preproc:
            fns['u8'] = eval_step_lib.make_extract_fn(
                model, flip_tta=flip_tta, device_preproc=pre,
                device=model.device)
            fns['u8p'] = eval_step_lib.make_extract_fn(
                model, flip_tta=flip_tta, device_preproc=pre,
                device=model.device, padded_wire=True)
        pad_hw = _pad_bucket(roidb) if device_preproc else None
        transfer = Transfer(model.device)
        u8_shape = []  # the first uniform raw shape pins the uint8 wire

        def prep(start):
            # the tail batch is padded with its last image, then each rank
            # takes its rows of the global batch
            idx = list(range(start, min(start + batch_size, len(roidb))))
            idx += idx[-1:] * (batch_size - len(idx))
            if mesh is not None and mesh.distributed:
                idx = idx[slice(*mesh_lib.local_rows(mesh, batch_size,
                                                     fold_model=True))]
            ims = [decode_fn(roidb[j]['image']) for j in idx]
            if pad_hw is not None and fits_bucket(ims, pad_hw):
                return 'u8p', pad_to_bucket(ims, pad_hw)
            if device_preproc and all(im.shape == ims[0].shape for im in ims):
                # list append is atomic under the GIL; a racing second shape
                # only sends that batch to the host path
                if not u8_shape:
                    u8_shape.append(ims[0].shape)
                if ims[0].shape == u8_shape[0]:
                    return 'u8', (np.stack(ims),)
            out = np.empty((len(ims), h, w, 3), np.float32)
            for i, im in enumerate(ims):
                out[i] = transforms.prep_im_for_blob(im, pixel_means, (w, h))
            return 'f32', (out,)

        starts = list(range(0, len(roidb), batch_size))
        kinds = collections.Counter()
        out, futs = [], deque()
        pending = None  # features tensor
        with ThreadPoolExecutor(max(1, _default_workers(num_workers))) as pool:
            issued = 0
            for _ in range(min(prefetch, len(starts))):
                futs.append(pool.submit(prep, starts[issued]))
                issued += 1
            for n in range(len(starts)):
                if n:
                    with trace.span('extract.decode_wait'):
                        kind, arrays = futs.popleft().result()
                else:
                    kind, arrays = futs.popleft().result()
                    opening.__exit__()
                if issued < len(starts):
                    futs.append(pool.submit(prep, starts[issued]))
                    issued += 1
                kinds[kind] += 1
                dev = transfer.ready(transfer.put(dict(enumerate(arrays))))
                feats = fns[kind](params, state, *[dev[i] for i in
                                                   range(len(arrays))])
                if pending is not None:
                    with trace.span('extract.readback'):
                        out.append(pending.cpu().numpy())
                pending = feats
        if pending is not None:
            with trace.span('extract.readback'):
                out.append(pending.cpu().numpy())
        logger.info('stream_extract batch kinds: %s',
                    json.dumps({k: kinds[k] for k in ('u8p', 'u8', 'f32')}))
        if not out:
            return np.zeros((0, model.embedding_dim), np.float32)
        local = np.concatenate(out, axis=0)
        if mesh is not None and mesh.distributed:
            # [world, batches, rows, E] -> global row order
            full = collectives.gather_host_rows(local, mesh)
            local = full.reshape((mesh.world_size, len(starts), -1) +
                                 full.shape[1:]).transpose(1, 0, 2, 3).reshape(
                                     (-1,) + full.shape[1:])
        return local[:len(roidb)]


def default_eval_batch(cfg, n_dev=1, batch_size=None):
    """The padded extraction batch: TEST.IMS_PER_BATCH per device (64 when
    unset) times the device count, rounded down to a device multiple."""
    if batch_size is None:
        per_dev = cfg.TEST.IMS_PER_BATCH if cfg.TEST.IMS_PER_BATCH > 0 else 64
        batch_size = per_dev * n_dev
    return max(n_dev, (batch_size // n_dev) * n_dev)


def extract_dataset_features(cfg, model, params, state, roidb,
                             decode_fn=None, batch_size=None, flip_tta=None,
                             device_preproc=None, streaming=None, mesh=None):
    """[N, E] float32 numpy features of ``roidb`` on ``model.device``:
    streamed (``TPU.STREAMING_EVAL``, the default) or from one decoded
    stack.  Under a distributed ``mesh`` the ranks split every global
    batch and each gets every feature back."""
    world = mesh.world_size if mesh is not None else 1
    batch_size = default_eval_batch(cfg, world, batch_size)
    if flip_tta is None:
        flip_tta = bool(cfg.TEST.BBOX_AUG.ENABLED and cfg.TEST.BBOX_AUG.H_FLIP)
    if device_preproc is None:
        device_preproc = cfg.TPU.DEVICE_PREPROC
    if streaming is None:
        streaming = cfg.TPU.STREAMING_EVAL
    timer = Timer()
    timer.tic()
    if streaming:
        feats = stream_extract(cfg, model, params, state, roidb, batch_size,
                               decode_fn=decode_fn, flip_tta=flip_tta,
                               device_preproc=device_preproc, mesh=mesh)
        t_total = timer.toc(average=False)
        logger.info('Extracted %d features (streaming): %.1fs '
                    '(%.1f imgs/s)', len(roidb), t_total,
                    len(roidb) / max(t_total, 1e-9))
        return feats
    images, preproc = None, None
    if device_preproc:
        # a mixed-size set is known from its metadata, before decoding
        if _pad_bucket(roidb) is None:
            images = decode_uint8_stack(roidb, decode_fn=decode_fn)
        if images is not None:
            w, h = cfg.REID.SCALE
            preproc = (np.asarray(cfg.PIXEL_MEANS), (h, w))
        else:
            logger.info('mixed image sizes; host preprocessing path')
    if images is None:
        images = preprocess_images(roidb, cfg, decode_fn=decode_fn)
    extract = eval_step_lib.make_extract_fn(
        model, flip_tta=flip_tta, device_preproc=preproc,
        device=model.device)
    t_prep = timer.toc(average=False)
    timer.tic()
    feats = eval_step_lib.extract_features(extract, params, state, images,
                                           batch_size, mesh=mesh)
    t_extract = timer.toc(average=False)
    logger.info('Extracted %d features: decode %.1fs, extract %.1fs '
                '(%.1f imgs/s)', len(roidb), t_prep, t_extract,
                len(roidb) / max(t_extract, 1e-9))
    return feats


def quantize_params_for_dataset(cfg, model, params, state, roidb,
                                decode_fn=None):
    """int8 PTQ for extraction (``TPU.INT8_EVAL``): calibrates the static
    input scales on the first ``TPU.INT8_CALIB_IMAGES`` test images
    (preprocessed on the host: calibration is a one-off) and returns
    BN-folded, body-quantized params."""
    from pps_tpu_torch.models.quantize import quantize_for_eval
    n = max(1, min(int(cfg.TPU.INT8_CALIB_IMAGES), len(roidb)))
    calib = preprocess_images(roidb[:n], cfg, decode_fn=decode_fn)
    logger.info('int8 PTQ: calibrating on %d images', n)
    return quantize_for_eval(model, params, state, calib)


def test_net(cfg, weights_file, dataset_name, output_dir=None,
             decode_fn=None, device=None, mesh=None):
    """Extract the features of a test dataset; write features.pkl to
    ``output_dir`` (rank 0 alone under a distributed ``mesh``, whose
    device is the model's).  Returns (features, roidb)."""
    ckpt_lib.check_not_orbax(weights_file)
    if mesh is not None:
        device = mesh.device
    model = build_model(cfg, device=device)
    params, state = model.init(torch.Generator().manual_seed(cfg.RNG_SEED))
    if ckpt_lib.is_dcp(weights_file):
        # the whole params and BN state, read on every rank
        ts = ckpt_lib.load_checkpoint_dcp(weights_file, {'params': params,
                                                         'state': state})
        params, state = ts['params'], ts['state']
    elif weights_file:
        params, state, _ = ckpt_lib.load_checkpoint(weights_file, model,
                                                    params, state)
    roidb = roidb_for_test(dataset_name)
    if cfg.TPU.INT8_EVAL:
        params = quantize_params_for_dataset(cfg, model, params, state,
                                             roidb, decode_fn=decode_fn)
    feats = extract_dataset_features(cfg, model, params, state, roidb,
                                     decode_fn=decode_fn, mesh=mesh)
    if output_dir and (mesh is None or mesh.rank == 0):
        os.makedirs(output_dir, exist_ok=True)
        feat_file = os.path.join(output_dir, 'features.pkl')
        save_object(dict(all_feats=feats, cfg=ckpt_lib.dump_cfg(cfg)),
                    feat_file)
        logger.info('Wrote features to: %s', os.path.abspath(feat_file))
    return feats, roidb


def evaluate_dataset(cfg, feats, roidb, distmat_fn=None, output_dir=None,
                     device=None):
    """CMC/mAP (multi-query and re-ranked blocks too) from features and the
    roidb's marks.  On the card the distance matrices and, with
    ``TPU.DEVICE_EVAL``, the single-query metrics and the re-ranking are
    computed there.  ``REID.VIS``: rank-list images of the single-query
    block in ``<output_dir>/vis/``."""
    device = resolve_device(device)
    ids = np.array([eval_lib.parse_im_name(e['im_name'], 'id')
                    for e in roidb])
    cams = np.array([eval_lib.parse_im_name(e['im_name'], 'cam')
                     for e in roidb])
    marks = np.array([e['mark'] for e in roidb])
    on_card = device.type == 'cuda'
    if distmat_fn is None and on_card:
        from pps_tpu_torch.ops.distance import euclidean_distmat

        def distmat_fn(q, g):
            return euclidean_distmat(
                torch.as_tensor(q, dtype=torch.float32, device=device),
                torch.as_tensor(g, dtype=torch.float32, device=device))
    results = eval_lib.evaluate(
        feats, ids, cams, marks, to_re_rank=cfg.REID.RERANK,
        distmat_fn=distmat_fn,
        device_single_query=on_card and bool(cfg.TPU.DEVICE_EVAL),
        device=device,
        device_rerank=on_card and bool(cfg.TPU.DEVICE_EVAL))
    if cfg.REID.VIS and output_dir:
        from pps_tpu_torch.evaluation.metrics import compute_dist
        from pps_tpu_torch.evaluation.visualize import visualize_rank_lists
        q = marks == 0
        g = marks == 1
        paths = np.array([e['image'] for e in roidb])
        visualize_rank_lists(
            compute_dist(feats[q], feats[g]), ids[q], ids[g], cams[q],
            cams[g], paths[q], paths[g], os.path.join(output_dir, 'vis'))
    return results


def run_inference(cfg, weights_file=None, output_dir=None, decode_fn=None,
                  device=None):
    """The test_net driver: features and metrics for every dataset of
    ``TEST.DATASETS``.  Returns {dataset: results}.  Without an
    ``output_dir`` the artifacts go to <OUTPUT_DIR>/test/<dataset>/.
    Under a process group every rank calls it (``device`` is the rank's
    own); rank 0 evaluates and returns the results, the others {}."""
    weights_file = weights_file or cfg.TEST.WEIGHTS
    # extraction folds a model axis into data (pps_tpu's
    # batch_sharding(fold_model=True)): every rank embeds its own rows
    mesh = mesh_lib.build_mesh(cfg, device=device)
    device = mesh.device
    from pps_tpu_torch.config import get_output_dir
    results = {}
    datasets = cfg.TEST.DATASETS
    if isinstance(datasets, str):
        datasets = (datasets,)
    for ds in datasets:
        ds_out = output_dir or get_output_dir((ds,), training=False)
        feats, roidb = test_net(cfg, weights_file, ds, output_dir=ds_out,
                                decode_fn=decode_fn, mesh=mesh)
        if mesh.rank == 0:
            results[ds] = evaluate_dataset(cfg, feats, roidb,
                                           output_dir=ds_out, device=device)
    return results
