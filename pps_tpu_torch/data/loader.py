"""Prefetching data loader: host decode workers -> batches on the device
(counterpart of ``pps_tpu/data/loader.py``).

Batch composition is decided up front, single-threaded, by the pure
``EpochSchedule`` and the seeded samplers (``plan_epoch``); a pool of
decode workers only executes that plan, so the number of workers never
changes what is sampled, and the index streams equal the JAX package's.

On the card each decoded batch goes through pinned host memory and a
``non_blocking`` copy on a side stream, up to
``DATA_LOADER.BLOBS_QUEUE_CAPACITY`` batches ahead of the consumer, so the
copies overlap the steps; before a batch is handed over, the consumer's
stream waits for the copies (``device.Transfer``, as in
``parallel/eval_step.py``).

The wire is decided once, from roidb metadata, never per batch:
uniform sizes take the raw uint8 wire; mixed sizes the padded wire at the
dataset-global bucket (each axis's maximum); a roidb without height/width
metadata, or ``raw=False`` (``TPU.DEVICE_AUGMENT False``), the float32
host chain, whose draws come from a ``RandomState`` keyed by (seed,
epoch, step), never by worker, so a batch does not depend on thread
scheduling.  ``wire_dtype='bfloat16'`` (``TPU.WIRE_DTYPE``) casts the
host chain's 'data' to bfloat16 in the worker, before the copy; the uint8
wires have nothing to cast.

Over a data mesh (``mesh``, one process per rank) every rank runs the
same seeded plan of GLOBAL batches (``TRAIN.IMS_PER_BATCH x NUM_GPUS``
images, ``REID.P x NUM_GPUS`` identities) and decodes only its own rows of
each, so the ranks agree without communicating.  The host chain takes the
global batch's draws in plan order, the rows ahead of this rank's first
(``minibatch.get_minibatch``'s ``ahead``), so the ranks' rows put together
are the one-process batch; the uint8 wires draw on the device, for the
global batch.
"""

import logging
import queue
import threading

import numpy as np
import torch

from pps_tpu_torch.data import minibatch as minibatch_lib
from pps_tpu_torch.data.sampler import EpochSchedule, PermSampler, PKSampler
from pps_tpu_torch.device import Transfer
from pps_tpu_torch.parallel import mesh as mesh_lib
from pps_tpu_torch.utils import trace

logger = logging.getLogger(__name__)


class ReIDLoader(object):
    def __init__(self, roidb, cfg, num_workers=None, prefetch=None,
                 seed=None, decode_fn=None, device=None, raw=True,
                 device_prefetch=None, wire_dtype='float32', mesh=None):
        """num_workers / prefetch / device_prefetch default from
        DATA_LOADER: NUM_THREADS decode workers, MINIBATCH_QUEUE_SIZE host
        batches prepared ahead, BLOBS_QUEUE_CAPACITY device batches copied
        ahead.  ``device`` None yields host batches; a device yields dicts
        of tensors there.  ``raw``: the uint8 wires when the metadata
        allows them (see the module docstring).  ``mesh``: a distributed
        data mesh; the batches are this rank's rows."""
        self._roidb = roidb
        self._mesh = mesh if mesh is not None and mesh.distributed else None
        self._cfg = cfg
        if num_workers is None:
            num_workers = cfg.DATA_LOADER.NUM_THREADS
        if prefetch is None:
            prefetch = cfg.DATA_LOADER.MINIBATCH_QUEUE_SIZE
        if device_prefetch is None:
            device_prefetch = cfg.DATA_LOADER.BLOBS_QUEUE_CAPACITY
        self._device_prefetch = max(1, int(device_prefetch))
        self._decode_fn = decode_fn
        self._transfer = None if device is None else Transfer(device)
        if wire_dtype not in ('float32', 'bfloat16'):
            raise ValueError("wire_dtype must be 'float32' or 'bfloat16', "
                             'not {!r}'.format(wire_dtype))
        self._bf16_wire = wire_dtype == 'bfloat16'
        # the wire is decided ONCE from roidb metadata, never per batch
        self._raw_pad_hw = None
        if raw:
            sizes = {(e.get('height'), e.get('width')) for e in roidb}
            if not sizes or any(None in s for s in sizes):
                if sizes:
                    logger.warning(
                        'roidb lacks height/width metadata; disabling the '
                        'uint8 device-augment wire (host chain instead)')
                    raw = False
            elif len(sizes) > 1:
                self._raw_pad_hw = (max(s[0] for s in sizes),
                                    max(s[1] for s in sizes))
        self._raw = raw
        logger.info('loader wire: %s', 'host chain' if not raw else (
            'raw uint8' if self._raw_pad_hw is None else
            'padded uint8 at {}x{}'.format(*self._raw_pad_hw)))
        self._prefetch = max(1, int(prefetch))
        self._num_workers = max(1, int(num_workers))
        self._seed = cfg.RNG_SEED if seed is None else seed

        labels = [e['gt_class'] - 1 for e in roidb]
        n_ids = len(set(labels))
        self.schedule = EpochSchedule(cfg, len(roidb), n_ids)
        if self._mesh is not None:
            # raises unless the global batch splits over the ranks
            mesh_lib.local_rows(self._mesh, self.schedule.global_batch)
        self._perm = PermSampler(len(roidb), self.schedule.global_batch,
                                 seed=self._seed)
        self._pk = None
        if cfg.REID.TRIPLET_LOSS:
            self._pk = PKSampler(labels, cfg.REID.P * cfg.NUM_GPUS,
                                 cfg.REID.K, seed=self._seed + 1)

        self._plan_q = queue.Queue()
        self._stop = threading.Event()
        self._exc = []
        self._last_qsize = 0

    # -- plan ---------------------------------------------------------------
    def skip_epochs(self, n):
        """Advance the samplers past the first n epochs without decoding,
        so a run resumed at epoch n samples exactly as a continuous one."""
        for ep in range(n):
            self.plan_epoch(ep)

    def plan_epoch(self, ep):
        """[(step_in_epoch, mode, loss_scale, indices)] for epoch ep."""
        plan = []
        for i in range(self.schedule.epoch_len(ep)):
            mode, scale = self.schedule.describe(ep, i)
            if mode == 'pk':
                idx = self._pk.next_batch()
            else:
                idx = self._perm.next_batch()
            plan.append((i, mode, scale, idx))
        return plan

    # -- worker pool --------------------------------------------------------
    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._plan_q.get(timeout=0.1)
            except queue.Empty:
                continue
            slot, (i, mode, scale, idx) = item
            try:
                # the host chain's draws keyed by (seed, epoch, step), not
                # by worker: which worker takes a batch is a race
                rng = np.random.RandomState(
                    (self._seed * 1000003 + self._cur_ep * 10007 + i)
                    % (2 ** 31))
                ahead = []
                if self._mesh is not None:
                    start, stop = mesh_lib.local_rows(self._mesh, len(idx))
                    ahead = [self._roidb[j] for j in idx[:start]]
                    idx = idx[start:stop]
                entries = [self._roidb[j] for j in idx]
                batch = minibatch_lib.get_minibatch(
                    entries, self._cfg, train=True,
                    decode_fn=self._decode_fn, raw=self._raw,
                    raw_pad_hw=self._raw_pad_hw, rng=rng, ahead=ahead)
                if self._bf16_wire and 'data' in batch:
                    # numpy has no bfloat16: torch casts on the host
                    batch['data'] = torch.from_numpy(batch['data']).to(
                        torch.bfloat16)
                self._slots[slot] = (i, mode, scale, batch)
            except Exception as e:  # handed to the consumer, which raises
                logger.exception('loader worker failed')
                self._exc.append(e)
                self._stop.set()
                return
            finally:
                self._sem.release()

    def iter_epoch(self, ep, start_step=0):
        """Yield (step_in_epoch, loss_scale, batch) for epoch ep, strictly
        in plan order.

        start_step > 0 resumes mid-epoch: the FULL epoch is still planned,
        consuming sampler state as a continuous run does, and the trained
        prefix is skipped before any decode."""
        plan = self.plan_epoch(ep)
        if start_step:
            plan = plan[start_step:]
        if not plan:
            return
        dev_ready = {}  # slot -> device batch copied ahead
        self._cur_ep = ep
        self._slots = [None] * len(plan)
        self._sem = threading.Semaphore(0)
        self._stop.clear()
        self._exc = []
        workers = [threading.Thread(target=self._worker, daemon=True)
                   for _ in range(self._num_workers)]
        for w in workers:
            w.start()
        issued = 0
        for slot in range(min(self._prefetch, len(plan))):
            self._plan_q.put((slot, plan[slot]))
            issued += 1
        try:
            for step in range(len(plan)):
                with trace.span('loader.wait'):
                    while self._slots[step] is None:
                        self._sem.acquire()
                        if self._exc:
                            raise RuntimeError('data loader worker failed') \
                                from self._exc[0]
                i, mode, scale, batch = self._slots[step]
                self._slots[step] = None
                # prepared-ahead depth; 0 = the consumer is starved
                self._last_qsize = sum(
                    1 for s in self._slots[step + 1:issued]
                    if s is not None)
                if issued < len(plan):
                    self._plan_q.put((issued, plan[issued]))
                    issued += 1
                if mode == 'pk':
                    # the global batch's composition, from the plan
                    self._check_pk([self._roidb[j]['gt_class'] - 1
                                    for j in plan[step][3]])
                if self._transfer is not None:
                    put = self._transfer.put
                    dev = dev_ready.pop(step, None)
                    if dev is None:
                        dev = put(batch)
                    # copy up to BLOBS_QUEUE_CAPACITY decoded batches
                    # ahead, overlapping the steps already queued
                    for s in range(step + 1,
                                   min(step + 1 + self._device_prefetch,
                                       issued)):
                        if s not in dev_ready and self._slots[s] is not None:
                            dev_ready[s] = put(self._slots[s][3])
                    batch = self._transfer.ready(dev)
                yield i, scale, batch
        finally:
            self._stop.set()
            while not self._plan_q.empty():
                try:
                    self._plan_q.get_nowait()
                except queue.Empty:
                    break
            for w in workers:
                w.join(timeout=2.0)

    def qsize(self):
        """Batches prepared ahead of the consumer at the last yield."""
        return self._last_qsize

    def _check_pk(self, labels):
        """The P x K composition of a triplet batch."""
        cfg = self._cfg
        _, counts = np.unique(labels, return_counts=True)
        if (counts.shape[0] != cfg.REID.P * cfg.NUM_GPUS
                or not (counts == cfg.REID.K).all()):
            raise AssertionError('not a P x K batch: {}'.format(counts))
