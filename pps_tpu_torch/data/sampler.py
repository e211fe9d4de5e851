"""Batch index sampling (a numpy copy of ``pps_tpu/data/sampler.py``):
shuffled rotation, P x K identity sampling, and the TRIPLET_LOSS_CROSS
epoch-alternation schedule as a pure function of the step counter.

The index streams equal the JAX package's for the same seed (the tests
compare them), so a dataset trains on the same batches under both.

Epoch math:
  iters/epoch          = len(roidb) // global_batch   (the roidb holds the
                         flipped duplicates)
  triplet iters/epoch  = num_classes // P_global

Alternation: with TRIPLET_LOSS_CROSS, epochs e > TRIPLET_LOSS_START with e
odd run only the first `triplet iters/epoch` steps, with P x K batches and
loss_scale_factor 1; all other epochs run full length with shuffled
batches and loss_scale_factor 0.  Without CROSS every batch is P x K.
"""

import numpy as np


class PermSampler(object):
    """Shuffled rotation over all entries."""

    def __init__(self, n, batch_size, seed=0):
        self._n = n
        self._b = batch_size
        self._rng = np.random.RandomState(seed)
        self._shuffle()

    def _shuffle(self):
        self._perm = self._rng.permutation(self._n)
        self._pos = 0
        self._consumed = 0

    def next_batch(self):
        idx = [int(self._perm[(self._pos + i) % self._n])
               for i in range(self._b)]
        self._pos = (self._pos + self._b) % self._n
        self._consumed += self._b
        if self._consumed >= self._n:
            self._shuffle()
        return idx


class PKSampler(object):
    """P identities x K instances."""

    def __init__(self, labels, p, k, seed=0):
        self._class2idx = {}
        for i, lab in enumerate(labels):
            self._class2idx.setdefault(int(lab), []).append(i)
        self.num_classes = len(self._class2idx)
        self._p, self._k = p, k
        self._rng = np.random.RandomState(seed)
        self._pool = []

    def next_batch(self):
        if len(self._pool) < self._p:
            self._pool = list(self._class2idx.keys())
            self._rng.shuffle(self._pool)
        idx = []
        for _ in range(self._p):
            key = self._pool.pop()
            population = self._class2idx[key]
            if len(population) < self._k:
                population = population * self._k
            sel = self._rng.choice(len(population), size=self._k,
                                   replace=False)
            idx.extend(population[i] for i in sel)
        return idx


class EpochSchedule(object):
    """Pure schedule: step -> (epoch, mode, loss_scale_factor).

    mode is 'perm' or 'pk'.  iters_per_epoch counts only executed steps:
    an alternation epoch is the shortened one.
    """

    def __init__(self, cfg, num_images, num_classes_present):
        self.global_batch = cfg.TRAIN.IMS_PER_BATCH * cfg.NUM_GPUS
        self.ipe = max(1, num_images // self.global_batch)
        self.triplet = cfg.REID.TRIPLET_LOSS
        self.cross = self.triplet and cfg.REID.TRIPLET_LOSS_CROSS
        self.tl_start = cfg.REID.TRIPLET_LOSS_START
        p_global = cfg.REID.P * cfg.NUM_GPUS
        self.ipe_triplet = max(1, num_classes_present // p_global) \
            if self.triplet else 0
        self.max_epoch = cfg.SOLVER.MAX_ITER

    def is_triplet_epoch(self, ep):
        return self.cross and ep > self.tl_start and ep % 2 == 1

    def epoch_len(self, ep):
        if self.is_triplet_epoch(ep):
            return min(self.ipe_triplet, self.ipe)
        return self.ipe

    def describe(self, ep, it_in_epoch):
        """(mode, loss_scale) for executed step it_in_epoch of epoch ep."""
        if not self.triplet:
            return 'perm', 0.0
        if not self.cross:
            return 'pk', 1.0
        if self.is_triplet_epoch(ep):
            return 'pk', 1.0
        return 'perm', 0.0

    def total_steps(self):
        return sum(self.epoch_len(e) for e in range(self.max_epoch))

    def steps_before_epoch(self, ep):
        return sum(self.epoch_len(e) for e in range(ep))

    def lr_iter(self, ep, it_in_epoch):
        """The LR policy indexes by the raw iteration ep * ipe + i."""
        return ep * self.ipe + it_in_epoch
