"""Re-ID dataset reader: COCO-style json -> a list of small dicts (a copy
of ``pps_tpu/data/json_dataset.py``).

The json layout (written by ``tools/reid_to_coco.py``):

  images:      [{id, file_name, width, height}]
  annotations: [{image_id, category_id, mark, ...}]  (one per image)
  categories:  [{id, name}]  (person identities)

mark: 0 = query, 1 = gallery, 2 = multi-query; absent for training sets.
"""

import json
import logging
import os

from pps_tpu_torch.data import catalog

logger = logging.getLogger(__name__)


class ReIDDataset(object):
    def __init__(self, name):
        self.name = name
        self.image_directory = catalog.get_im_dir(name)
        ann_fn = catalog.get_ann_fn(name)
        with open(ann_fn, 'r') as f:
            raw = json.load(f)
        cats = sorted(c['id'] for c in raw.get('categories', []))
        # identity labels are 1..C-1 with 0 = background: json category ids
        # map to contiguous class ids by sorted order + 1
        self.category_ids = cats
        self.category_to_class = {c: i + 1 for i, c in enumerate(cats)}
        self.num_classes = len(cats) + 1
        anns_by_image = {}
        for ann in raw.get('annotations', []):
            anns_by_image.setdefault(ann['image_id'], []).append(ann)
        self._roidb = []
        for im in raw['images']:
            anns = anns_by_image.get(im['id'], [])
            if len(anns) != 1:
                raise ValueError(
                    'Exactly one annotation per re-ID image expected; image '
                    '%r has %d' % (im.get('file_name'), len(anns)))
            ann = anns[0]
            self._roidb.append({
                'dataset_name': name,
                'im_name': im['file_name'],
                'image': os.path.join(self.image_directory, im['file_name']),
                'width': im.get('width'),
                'height': im.get('height'),
                'gt_class': self.category_to_class[ann['category_id']],
                'mark': ann.get('mark'),
                'flipped': False,
            })

    def get_roidb(self):
        return [dict(e) for e in self._roidb]

    def __len__(self):
        return len(self._roidb)


def extend_with_flipped_entries(roidb):
    """Append horizontally flipped duplicates (the flip itself happens on
    the device, from the entry's ``flipped`` flag)."""
    flipped = []
    for entry in roidb:
        e = dict(entry)
        e['flipped'] = True
        flipped.append(e)
    roidb.extend(flipped)
    return roidb


def combined_roidb_for_training(dataset_names, use_flipped=True):
    """Merge training roidbs; returns (roidb, num_classes)."""
    if isinstance(dataset_names, str):
        dataset_names = (dataset_names,)
    roidb, num_classes = [], 1
    for name in dataset_names:
        ds = ReIDDataset(name)
        num_classes = max(num_classes, ds.num_classes)
        roidb.extend(ds.get_roidb())
    if use_flipped:
        logger.info('Appending horizontally-flipped training examples...')
        extend_with_flipped_entries(roidb)
    logger.info('Loaded dataset(s) %s: %d roidb entries',
                list(dataset_names), len(roidb))
    return roidb, num_classes


def roidb_for_test(dataset_name):
    return ReIDDataset(dataset_name).get_roidb()
