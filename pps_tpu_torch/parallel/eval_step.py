"""Batched feature extraction (counterpart of
``pps_tpu/parallel/eval_step.py``): images are batched, the tail batch is
padded by repeating its last row and the pad rows are dropped, and the
next batch's host-to-device copy overlaps the current batch's compute.

Over a data mesh (one process per rank) every rank drives the same loop
over the same global batches: ``put_global_batch`` takes the rank's rows
(and raises when a batch does not split), ``fetch_global`` puts the
ranks' features back together on every rank, in row order.
"""

import numpy as np
import torch

from pps_tpu_torch.data.device_preprocess import (
    preprocess_on_device, preprocess_on_device_padded)
from pps_tpu_torch.device import Transfer, resolve_device
from pps_tpu_torch.parallel import collectives
from pps_tpu_torch.parallel import mesh as mesh_lib


def make_extract_fn(model, flip_tta=False, device_preproc=None, device=None,
                    padded_wire=False):
    """(params, state, images[B,H,W,3] tensor) -> [B, E] float32 tensor.

    flip_tta: average the embeddings of the image and its horizontal flip,
      then L2-renormalise (the TEST.BBOX_AUG.H_FLIP analog); the flip is
      of the preprocessed images.
    device_preproc: optional (pixel_means, out_hw); the images are then raw
      uint8 decodes and the cast, mean subtraction and cv2-exact bicubic
      resize run on the device.
    padded_wire: the mixed-size form of device_preproc; the fn takes a
      fourth argument valid_hw [B, 2], and the decodes are padded to one
      bucket (``preprocess_on_device_padded``).
    device: must be the model's device (default CUDA).
    """
    device = resolve_device(device)
    if device != model.device:
        raise ValueError('extract fn on {} for a model on {}'.format(
            device, model.device))
    if padded_wire and device_preproc is None:
        raise ValueError('padded_wire needs device_preproc')

    @torch.no_grad()
    def extract(params, state, images, valid_hw=None):
        if padded_wire:
            means, out_hw = device_preproc
            images = preprocess_on_device_padded(images, valid_hw, means,
                                                 out_hw)
        elif device_preproc is not None:
            means, out_hw = device_preproc
            images = preprocess_on_device(images, means, out_hw)
        feats = model.extract_features(params, state, images)
        if flip_tta:
            feats_f = model.extract_features(params, state,
                                             torch.flip(images, dims=(2,)))
            feats = (feats + feats_f) * 0.5
            norm = torch.linalg.norm(feats, dim=1, keepdim=True)
            feats = feats / torch.clamp(norm, min=1e-12)
        return feats

    extract.device = device
    return extract


def put_global_batch(mesh, arr):
    """This rank's rows of a global [B, ...] host array (all of it without
    a distributed mesh).  Raises when B does not split over the ranks:
    a truncated shard would mis-align features to images, so callers pad
    the tail batch to a divisible size."""
    if mesh is None or not mesh.distributed:
        return arr
    if arr.shape[0] % mesh.world_size:
        raise ValueError(
            'global batch {} not divisible by {} ranks: the truncated '
            'shard would mis-align features to images (callers pad the '
            'tail batch to a divisible size)'.format(arr.shape[0],
                                                     mesh.world_size))
    # extraction folds the model axis into data (no classifier on the
    # path): each rank takes the rows of its flat rank
    return arr[slice(*mesh_lib.local_rows(mesh, arr.shape[0],
                                          fold_model=True))]


def fetch_global(mesh, x):
    """This rank's [b, ...] rows (a tensor or host array) -> the global
    [b * world, ...] numpy array on every rank, in rank order (a
    collective over the mesh's host group: call it in the same order on
    every rank)."""
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if mesh is None or not mesh.distributed:
        return x
    return collectives.gather_host_rows(x, mesh)


def extract_features(extract_fn, params, state, images, batch_size,
                     mesh=None):
    """Drive ``extract_fn`` over a numpy image stack [N, H, W, 3].

    ``batch_size`` is the global batch: the tail batch is padded to it by
    repeating its last row, then the pad rows are dropped.  On the card
    each batch goes through pinned host memory on a side stream, issued
    before the current batch's result is fetched, so the copy overlaps
    compute.  Under a distributed ``mesh`` every rank passes the same
    stack, extracts its rows of each batch and gets every row back.
    Returns [N, E] float32 numpy.
    """
    transfer = Transfer(extract_fn.device)
    n = images.shape[0]

    def put(start):
        chunk = images[start:start + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0)
        return transfer.put(put_global_batch(mesh, chunk)), pad

    starts = list(range(0, n, batch_size))
    out = []
    pending = None  # (feats tensor, pad)
    next_dev = put(starts[0]) if starts else None
    for i in range(len(starts)):
        dev, pad = next_dev
        dev = transfer.ready(dev)
        feats = extract_fn(params, state, dev)  # queued, not waited on
        if i + 1 < len(starts):
            next_dev = put(starts[i + 1])       # overlap H2D with compute
        if pending is not None:
            pf, ppad = pending
            out.append(fetch_global(mesh, pf)[:batch_size - ppad])
        pending = (feats, pad)
    if pending is not None:
        pf, ppad = pending
        out.append(fetch_global(mesh, pf)[:batch_size - ppad])
    return np.concatenate(out, axis=0) if out else np.zeros((0,))
