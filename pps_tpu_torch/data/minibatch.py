"""Minibatch assembly: roidb entries -> a host numpy batch (counterpart of
``pps_tpu/data/minibatch.py``).

Three wires, as in the JAX package:

* raw uint8 (``TPU.DEVICE_AUGMENT``), when every decode of the batch has
  one shape: flip, augmentation and resize then run on the device;
* padded uint8 (mixed-size datasets): every decode reflect-padded
  bottom/right to a dataset-global bucket, plus each sample's
  ``valid_hw``: one wire shape for the whole dataset;
* float32 'data', the host chain (``transforms.augment`` then
  ``prep_im_for_blob``): for batches outside both contracts.
"""

import numpy as np

from pps_tpu_torch.data import transforms


def pad_to_bucket(ims, pad_hw):
    """Decodes of (H, W) <= pad_hw -> (uint8 [B, H_pad, W_pad, 3] padded
    bottom/right with numpy 'reflect', valid_hw [B, 2] int32)."""
    ph, pw = pad_hw
    padded = np.stack([np.pad(im, ((0, ph - im.shape[0]),
                                   (0, pw - im.shape[1]), (0, 0)),
                              mode='reflect') for im in ims])
    return padded, np.asarray([im.shape[:2] for im in ims], np.int32)


def fits_bucket(ims, pad_hw):
    """Every decode fits the bucket and has >= 2 px per axis (numpy
    'reflect' needs a value to reflect)."""
    return all(2 <= im.shape[0] <= pad_hw[0] and 2 <= im.shape[1] <= pad_hw[1]
               for im in ims)


def _shape_of(entry, decode_fn):
    """An entry's decode shape: from its height/width metadata, else from
    its decode."""
    if entry.get('height') is not None and entry.get('width') is not None:
        return (int(entry['height']), int(entry['width']), 3)
    return decode_fn(entry['image']).shape


def get_minibatch(roidb_entries, cfg, train=True, decode_fn=None, raw=True,
                  raw_pad_hw=None, rng=None, ahead=()):
    """Decode a list of roidb entries into a batch with 'labels_int32'
    [B] (identity - 1) and 'labels_oh' [B, NUM_CLASSES - 1], plus

    * the raw wire: 'data_u8' [B, h, w, 3] uint8 and 'flipped' [B] bool;
    * the padded wire (``raw_pad_hw`` = (H_pad, W_pad)): 'data_u8'
      [B, H_pad, W_pad, 3] padded with numpy 'reflect' (cv2
      BORDER_REFLECT_101, so blur borders on the device match the
      true-size chain), 'flipped' and 'valid_hw' [B, 2] int32 (each
      decode needs >= 2 px per axis and must fit the bucket);
    * otherwise the host chain: 'data' [B, H, W, 3] float32, BGR, mean
      subtracted, resized to REID.SCALE; with ``train``, augmented with
      draws from ``rng`` (a ``numpy.random.RandomState``).

    ahead: the entries of the global batch before these (a data rank's
    rows).  On the host chain their draws are taken from ``rng`` first,
    so each row gets the draws that one process augmenting the whole
    global batch gives it; they are not decoded when their metadata has
    the size.
    """
    decode_fn = decode_fn or transforms.decode_image
    w, h = cfg.REID.SCALE
    num_classes = cfg.MODEL.NUM_CLASSES
    b = len(roidb_entries)
    labels = np.asarray([e['gt_class'] - 1 for e in roidb_entries],
                        np.int32)  # ids are 1-based, 0 = background
    oh = np.zeros((b, num_classes - 1), np.float32)
    oh[np.arange(b), labels] = 1.0

    ims = [decode_fn(entry['image']) for entry in roidb_entries]
    if raw and train:
        flipped = np.asarray([bool(e.get('flipped')) for e in roidb_entries])
        if raw_pad_hw is None:
            if all(im.shape == ims[0].shape for im in ims):
                return {'data_u8': np.stack(ims), 'flipped': flipped,
                        'labels_int32': labels, 'labels_oh': oh}
        elif fits_bucket(ims, raw_pad_hw):
            padded, valid_hw = pad_to_bucket(ims, raw_pad_hw)
            return {'data_u8': padded, 'flipped': flipped,
                    'valid_hw': valid_hw,
                    'labels_int32': labels, 'labels_oh': oh}

    if train and rng is None:
        raise ValueError('the host augmentation chain needs rng (a '
                         'numpy.random.RandomState)')
    data = np.empty((b, h, w, 3), np.float32)
    pixel_means = np.asarray(cfg.PIXEL_MEANS)
    if train:
        for entry in ahead:
            # each op's draws depend on the image's shape alone: a blank
            # of that shape takes the row's draws
            transforms.augment(np.zeros(_shape_of(entry, decode_fn),
                                        np.uint8), rng, cfg)
    for i, (entry, im) in enumerate(zip(roidb_entries, ims)):
        if entry.get('flipped'):
            im = im[:, ::-1, :]
        if train:
            im = transforms.augment(im, rng, cfg)
        data[i] = transforms.prep_im_for_blob(im, pixel_means, (w, h))
    return {'data': data, 'labels_int32': labels, 'labels_oh': oh}
