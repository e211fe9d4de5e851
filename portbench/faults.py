"""Faults planted under the timed path, for the check's own tests and for
reading a training number's upper limit on the card: each is a context
manager that patches the program while a run is set up and measured.

* ``state_unchanged``: the train step returns the state it was given;
* ``half_batch``: the train step sees only the first half of each batch
  (the mean taken over the rest);
* ``answer_altered``: the test pass's features, or the search's answers,
  altered where they are produced.
"""

import contextlib

import numpy as np


def _wrap(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    return original


@contextlib.contextmanager
def patched(module, name, make):
    original = _wrap(module, name, make)
    try:
        yield
    finally:
        setattr(module, name, original)


def state_unchanged():
    from pps_tpu_torch.parallel import train_step

    def make(orig):
        def build(*a, **kw):
            step = orig(*a, **kw)

            def broken(ts, batch, *args, **kws):
                _, logs = step(ts, batch, *args, **kws)
                return ts, logs
            return broken
        return build
    return patched(train_step, 'make_train_step', make)


def half_batch():
    from pps_tpu_torch.parallel import train_step

    def make(orig):
        def build(*a, **kw):
            step = orig(*a, **kw)

            def broken(ts, batch, lr, scale, gen, draws=None):
                n = batch['labels_int32'].shape[0] // 2
                half = {k: v[:n] for k, v in batch.items()}
                if draws:
                    draws = {'augment': {k: v[:n] for k, v in
                                         draws['augment'].items()},
                             'dropout_mask': draws['dropout_mask'][:n]}
                return step(ts, half, lr, scale, gen, draws=draws)
            return broken
        return build
    return patched(train_step, 'make_train_step', make)


def answer_altered():
    """Every test feature's first combination zeroed (the rows
    renormalised), and every search answer moved one gallery row on."""
    from pps_tpu_torch.engine import serving
    from pps_tpu_torch.engine import test as test_lib

    def make_extract(orig):
        def extract(*a, **kw):
            f = np.array(orig(*a, **kw))
            f[:, :f.shape[1] // 31] = 0.0
            return f / np.linalg.norm(f, axis=1, keepdims=True)
        return extract

    def make_search(orig):
        def search(self, *a, **kw):
            d, i, *rest = orig(self, *a, **kw)
            return (d, (i + 1) % len(self), *rest)
        return search
    stack = contextlib.ExitStack()
    stack.enter_context(patched(test_lib, 'extract_dataset_features',
                                make_extract))
    stack.enter_context(patched(serving.RetrievalIndex, 'search',
                                make_search))
    return stack


FAULTS = {'state_unchanged': state_unchanged, 'half_batch': half_batch,
          'answer_altered': answer_altered}
