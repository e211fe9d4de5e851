"""Dataset catalog: name -> {image dir, annotation json} (a copy of
``pps_tpu/data/catalog.py``).

The data root defaults to ``<repo>/datasets/data`` and moves with
``$PPS_TPU_DATA_DIR``, the JAX package's variable, so both packages read
the same datasets.  ``register_dataset`` adds entries at run time.
"""

import os

_DATA_DIR = os.environ.get(
    'PPS_TPU_DATA_DIR',
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'datasets', 'data'))

_CATALOG = {}


def register_dataset(name, image_directory, annotation_file):
    _CATALOG[name] = {'im_dir': image_directory, 'ann_fn': annotation_file}


def _register_default(name, subdir):
    register_dataset(
        name + '_trainval',
        os.path.join(_DATA_DIR, subdir, 'images'),
        os.path.join(_DATA_DIR, subdir, 'trainval.json'))
    register_dataset(
        name + '_test',
        os.path.join(_DATA_DIR, subdir, 'images'),
        os.path.join(_DATA_DIR, subdir, 'test.json'))


_register_default('market1501', 'market1501')
_register_default('duke', 'duke')
_register_default('cuhk03', os.path.join('cuhk03', 'labeled'))
_register_default('cuhk03_detected', os.path.join('cuhk03', 'detected'))

# the reference's remaining entries: wanda (a re-ID set in the same json
# layout) and ped_attr, kept so the names match the JAX package's catalog
for _split in ('trainval', 'val', 'test', 'debug'):
    register_dataset(
        'wanda_' + _split,
        os.path.join(_DATA_DIR, 'wanda', 'images'),
        os.path.join(_DATA_DIR, 'wanda', _split + '.json'))
for _split in ('trainval', 'debug'):
    register_dataset(
        'ped_attr_' + _split,
        os.path.join(_DATA_DIR, 'ped_attr', 'trainval'),
        os.path.join(_DATA_DIR, 'ped_attr', _split + '.json'))


def datasets():
    """Available dataset names."""
    return _CATALOG.keys()


def contains(name):
    return name in _CATALOG


def get_im_dir(name):
    if name not in _CATALOG:
        raise KeyError('Unknown dataset: {}'.format(name))
    return _CATALOG[name]['im_dir']


def get_ann_fn(name):
    if name not in _CATALOG:
        raise KeyError('Unknown dataset: {}'.format(name))
    return _CATALOG[name]['ann_fn']
