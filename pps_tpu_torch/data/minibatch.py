"""Minibatch assembly: roidb entries -> a host numpy batch (counterpart of
``pps_tpu/data/minibatch.py``, uniform raw uint8 wire only).

Ported: the wire of ``TPU.DEVICE_AUGMENT`` when every decode in the batch
has one shape; flip, augmentation and resize then run on the device.
Not ported: the padded ``valid_hw`` wire for mixed-size datasets and the
host augmentation chain (ROADMAP slice 3b); both raise.
"""

import numpy as np

from pps_tpu_torch.data import transforms

_TODO = ('{} is not ported yet (ROADMAP slice 3b: mixed-size datasets and '
         'the host augmentation chain)')


def get_minibatch(roidb_entries, cfg, train=True, decode_fn=None, raw=True,
                  raw_pad_hw=None):
    """Decode a list of roidb entries into
    {'data_u8': [B, h, w, 3] uint8, 'flipped': [B] bool,
     'labels_int32': [B] (identity - 1), 'labels_oh': [B, NUM_CLASSES-1]}.
    """
    if raw_pad_hw is not None:
        raise NotImplementedError(_TODO.format('The padded valid_hw wire'))
    if not (raw and train):
        raise NotImplementedError(_TODO.format('The host augmentation chain'))
    decode_fn = decode_fn or transforms.decode_image
    num_classes = cfg.MODEL.NUM_CLASSES
    b = len(roidb_entries)
    labels = np.asarray([e['gt_class'] - 1 for e in roidb_entries],
                        np.int32)  # ids are 1-based, 0 = background
    oh = np.zeros((b, num_classes - 1), np.float32)
    oh[np.arange(b), labels] = 1.0
    ims = [decode_fn(entry['image']) for entry in roidb_entries]
    if any(im.shape != ims[0].shape for im in ims):
        raise NotImplementedError(_TODO.format(
            'A batch of mixed decode sizes ({})'.format(
                sorted({im.shape for im in ims}))))
    flipped = np.asarray([bool(e.get('flipped')) for e in roidb_entries])
    return {'data_u8': np.stack(ims), 'flipped': flipped,
            'labels_int32': labels, 'labels_oh': oh}
