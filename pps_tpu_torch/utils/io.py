"""Checkpoint-compatible pickle I/O (counterpart of ``pps_tpu/utils/io.py``).

The reference stores weights as python pickles of ``{blobs: {name:
ndarray}}``; the port reads and writes the same container.  URL caching
is not ported: weights are local files.
"""

import os
import pickle
import tempfile


def save_object(obj, file_name):
    """Save a Python object by pickling it; atomic via temp-file rename."""
    file_name = os.path.abspath(file_name)
    d = os.path.dirname(file_name)
    if d and not os.path.exists(d):
        os.makedirs(d)
    fd, tmp = tempfile.mkstemp(dir=d or '.', suffix='.tmp')
    try:
        with os.fdopen(fd, 'wb') as f:
            pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, file_name)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_object(file_name):
    with open(file_name, 'rb') as f:
        # latin1 lets py2-era reference pickles (numpy arrays) load
        return pickle.load(f, encoding='latin1')
