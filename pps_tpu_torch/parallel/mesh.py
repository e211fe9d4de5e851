"""The data mesh (counterpart of ``pps_tpu/parallel/mesh.py``).

pps_tpu has one controller over a ``jax.sharding.Mesh(('data', 'model'))``
and lets XLA insert the collectives.  The port maps that onto PyTorch's
own idiom, in two forms:

* **Training and extraction: one process per card** on
  ``torch.distributed``, as ``torchrun`` launches them.  The mesh is the
  grid of ranks; each process owns one local device and the rows of every
  global batch that its rank owns.  Ranks on separate cards talk over
  NCCL.  Where ranks share one card (one H100 cannot hold two NCCL ranks
  of one communicator) the collectives go over gloo on the CUDA tensors
  while all compute stays on the card; NCCL asked for with two ranks on
  one device raises instead of hanging (``init_distributed``).
* **Sharded retrieval: one process over a device list**, as pps_tpu's
  ``shard_map`` runs (``parallel/retrieval.py``).  ``build_mesh(devices=
  [...])`` takes an explicit list, which may name one device more than
  once (the CPU tests use ``['cpu'] * 8``; one card can hold four shards).

Only the ``data`` axis is ported: a model axis above 1 (class-sharded
classifier FCs) raises, naming ROADMAP slice 9.  Nothing of
``torch.distributed`` is imported at module level.
"""

import datetime
import os
import socket
import time

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device

_MODEL_AXIS_TODO = ('a model axis above 1 (class-sharded classifier FCs) is '
                    'not ported yet (ROADMAP slice 9: the model axis); '
                    'mesh shape {}')


def _dist():
    import torch.distributed as dist
    return dist


def process_group_active():
    """True when ``torch.distributed`` has a default process group."""
    if not torch.distributed.is_available():
        return False
    return _dist().is_initialized()


class Mesh(object):
    """A (data, model) grid of shards.

    devices: [n_data, n_model] object array; under a process group the
      entries are rank ids (each process knows only its own device), else
      the ``torch.device`` of each shard.
    rank / world_size: this process's rank and the group's size (0 / 1
      without a process group).
    group: the default process group, or None.
    cpu_group: a gloo group over the same ranks for host-side agreement
      (preemption, the gathers of host features), or None.
    device: this process's device.
    """

    def __init__(self, devices, axis_names, device, group=None,
                 cpu_group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.device = device
        self.group = group
        self.cpu_group = cpu_group
        if group is not None:
            dist = _dist()
            self.rank = dist.get_rank()
            self.world_size = dist.get_world_size()
            self.backend = dist.get_backend()
        else:
            self.rank, self.world_size, self.backend = 0, 1, None

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def distributed(self):
        """True when this mesh's shards are ranks of a process group."""
        return self.group is not None

    def shard_devices(self):
        """The device of every shard in linear order (single process)."""
        if self.distributed:
            raise ValueError('a process-group mesh has one device per rank')
        return list(self.devices.flat)

    def __repr__(self):
        return 'Mesh({}, rank {}/{}, device {}, backend {})'.format(
            self.shape, self.rank, self.world_size, self.device,
            self.backend)


def build_mesh(cfg=None, devices=None, mesh_shape=None, device=None):
    """The (data, model) mesh.

    mesh_shape: (n_data, n_model); -1 in the data slot takes every shard
    left.  Defaults: cfg.TPU.MESH_SHAPE, else all-data.
    devices: an explicit list of devices (repeats allowed), for a
      single-process mesh; cfg.TPU.NUM_DEVICES > 0 takes a prefix, as in
      pps_tpu.  Without it the mesh is over the ranks of the process group
      (or this process alone), and ``device`` (default
      ``cuda:<LOCAL_RANK>``; ``'cpu'`` asks for the CPU) is this rank's.
    """
    names = ('data', 'model')
    if cfg is not None:
        names = (cfg.TPU.DATA_AXIS, cfg.TPU.MODEL_AXIS)
    want = cfg.TPU.NUM_DEVICES if cfg is not None else -1
    group = cpu_group = None
    if devices is not None:
        items = [torch.device(d) for d in devices]
        if want > 0:
            if want > len(items):
                raise ValueError('TPU.NUM_DEVICES {} > {} devices'.format(
                    want, len(items)))
            items = items[:want]
        local = items[0]
    else:
        if device is None:
            device = 'cuda:{}'.format(int(os.environ.get('LOCAL_RANK', 0)))
        local = resolve_device(device)
        if process_group_active():
            dist = _dist()
            group = dist.group.WORLD
            n = dist.get_world_size()
            if want > 0 and want != n:
                # a rank outside the mesh would have no rows to own
                raise ValueError('TPU.NUM_DEVICES {} != world size {}'.format(
                    want, n))
            items = list(range(n))
            cpu_group = _cpu_group()
        else:
            if want > 1:
                raise ValueError(
                    'TPU.NUM_DEVICES {} needs {} ranks; launch one process '
                    'per card (torchrun)'.format(want, want))
            items = [local]
    n = len(items)
    if mesh_shape is None:
        mesh_shape = (tuple(cfg.TPU.MESH_SHAPE) if cfg is not None
                      else (-1, 1))
    n_data, n_model = (int(v) for v in mesh_shape)
    if n_data == -1:
        if n % n_model:
            raise ValueError('{} shards do not split by a model axis of '
                             '{}'.format(n, n_model))
        n_data = n // n_model
    if n_data * n_model > n:
        raise ValueError('mesh shape {} needs {} shards, have {}'.format(
            mesh_shape, n_data * n_model, n))
    if group is not None and n_data * n_model != n:
        raise ValueError('mesh shape {} must cover all {} ranks'.format(
            mesh_shape, n))
    grid = np.empty(n_data * n_model, object)
    grid[:] = items[:n_data * n_model]
    return Mesh(grid.reshape(n_data, n_model), names, local, group=group,
                cpu_group=cpu_group)


def check_data_only(mesh):
    """Raise for a model axis above 1 (ROADMAP slice 9)."""
    if mesh.devices.shape[1] > 1:
        raise NotImplementedError(_MODEL_AXIS_TODO.format(
            tuple(mesh.devices.shape)))


class RowSharding(object):
    """Which rows of a [B, ...] array each shard owns, in linear shard
    order (the counterpart of a ``NamedSharding``'s index map)."""

    def __init__(self, n_shards, n_parts):
        self.n_shards = int(n_shards)
        self.n_parts = int(n_parts)  # 1: replicated

    def rows(self, n):
        """[(start, stop)] per shard for a leading dim of ``n``."""
        if n % self.n_parts:
            raise ValueError('{} rows do not split over {} shards'.format(
                n, self.n_parts))
        per = n // self.n_parts
        reps = self.n_shards // self.n_parts
        return [(p * per, (p + 1) * per)
                for p in range(self.n_parts) for _ in range(reps)]


def replicated(mesh):
    """Every shard holds every row."""
    return RowSharding(mesh.size, 1)


def batch_sharding(mesh, fold_model=True):
    """Rows split over the data axis (and the model axis too when
    ``fold_model``, as at extraction)."""
    n_data, n_model = mesh.devices.shape
    return RowSharding(mesh.size, n_data * n_model if fold_model
                       else n_data)


def local_rows(mesh, n):
    """(start, stop) of this rank's rows of an ``n``-row global batch.
    A model axis above 1 raises (ROADMAP slice 9): its ranks would each
    take the rows of their whole data slot."""
    check_data_only(mesh)
    return batch_sharding(mesh, fold_model=False).rows(n)[mesh.rank]


def param_shardings(mesh, params):
    """{name: RowSharding}: every parameter replicated.  A model axis
    above 1 raises (ROADMAP slice 9)."""
    check_data_only(mesh)
    rep = replicated(mesh)
    return {name: rep for name in params}


# ---------------------------------------------------------------------------
# process group set-up and host-side agreement
# ---------------------------------------------------------------------------

# the store and CPU group of this process's process group (one per process,
# as torch.distributed's own default group is)
_STATE = {}


def _cpu_group():
    if 'cpu_group' not in _STATE:
        dist = _dist()
        _STATE['cpu_group'] = (dist.group.WORLD
                               if dist.get_backend() == 'gloo'
                               else dist.new_group(backend='gloo'))
    return _STATE['cpu_group']


def init_distributed(device=None, backend=None, rank=None, world_size=None,
                     master_addr=None, master_port=None, timeout_s=600):
    """Initialise the default process group as ``torchrun`` would
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT`` unless given), one rank per device.

    device: this rank's device (default ``cuda:<LOCAL_RANK>``; ``'cpu'``
      asks for the CPU).  backend: None picks NCCL when every rank has a
      CUDA device of its own and gloo otherwise (ranks sharing a card, or
      the CPU).  ``'nccl'`` with two ranks on one device raises: NCCL
      refuses a duplicate GPU inside one communicator, and would hang.
    Returns this rank's ``torch.device``; with CUDA it becomes the current
    device.
    """
    dist = _dist()
    env = os.environ
    rank = int(env['RANK'] if rank is None else rank)
    world_size = int(env['WORLD_SIZE'] if world_size is None
                     else world_size)
    if device is None:
        device = 'cuda:{}'.format(int(env.get('LOCAL_RANK', 0)))
    device = resolve_device(device)
    addr = master_addr or env.get('MASTER_ADDR', 'localhost')
    port = int(master_port or env['MASTER_PORT'])
    timeout = datetime.timedelta(seconds=timeout_s)
    # under torchrun's agent the store already listens on MASTER_PORT
    agent = env.get('TORCHELASTIC_USE_AGENT_STORE') == 'True'
    store = dist.TCPStore(addr, port, world_size,
                          is_master=(rank == 0 and not agent),
                          timeout=timeout)
    # every rank's device, agreed through the store before any collective
    me = '{}/{}'.format(socket.gethostname(), device)
    store.set('pps_tpu_torch/device/{}'.format(rank), me)
    seen = [store.get('pps_tpu_torch/device/{}'.format(r)).decode()
            for r in range(world_size)]
    shared = len(set(seen)) < len(seen)
    if backend is None:
        backend = ('nccl' if device.type == 'cuda' and not shared
                   else 'gloo')
    if backend == 'nccl' and (shared or device.type != 'cuda'):
        raise ValueError(
            'NCCL needs one CUDA device per rank; ranks share {} (use gloo '
            'for ranks on one card)'.format(sorted(set(
                s for s in seen if seen.count(s) > 1)) or device))
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    _STATE.clear()
    _STATE['store'] = store
    return device


def init_from_env(device):
    """The CLIs' set-up: under ``torchrun``'s variables (``RANK`` and
    ``WORLD_SIZE`` set) initialise the process group, one rank per card
    (``device`` 'cuda' becomes ``cuda:<LOCAL_RANK>``; another value is
    taken as given, e.g. 'cuda:0' for ranks that share a card), and
    return this rank's device; without them return ``device`` as it
    was."""
    if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
        return device
    if device == 'cuda':
        device = 'cuda:{}'.format(int(os.environ.get('LOCAL_RANK', 0)))
    return init_distributed(device=device)


def destroy_distributed():
    """Tear down the default process group (and the CPU group)."""
    if process_group_active():
        _dist().destroy_process_group()
    _STATE.clear()


_BARRIER_SEQ = {}


def coordination_barrier(name, timeout_s=1800):
    """Align all ranks through the process group's key-value store, not a
    device collective: it absorbs skew in build and compile time (a rank
    that builds its kernels cold arrives minutes after one that does not)
    and raises ``TimeoutError`` after ``timeout_s``.  A no-op without a
    process group.  Barrier keys are single use; a per-name counter,
    advanced identically on every rank, keeps repeated calls distinct.
    The group must come from ``init_distributed``, whose store it uses.
    """
    if not process_group_active():
        return
    store = _STATE.get('store')
    if store is None:
        raise RuntimeError('coordination_barrier needs the process group '
                           'of init_distributed (its key-value store)')
    world = _dist().get_world_size()
    seq = _BARRIER_SEQ.get(name, 0)
    _BARRIER_SEQ[name] = seq + 1
    key = 'pps_tpu_torch/barrier/{}#{}'.format(name, seq)
    if store.add(key, 1) == world:
        store.set(key + '/done', b'1')
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            store.wait([key + '/done'], datetime.timedelta(seconds=min(
                30.0, max(0.1, deadline - time.monotonic()))))
            return
        except RuntimeError as e:  # the store's wait timed out
            if time.monotonic() >= deadline:
                raise TimeoutError('barrier {!r}: {} of {} ranks after '
                                   '{} s'.format(name, store.add(key, 0),
                                                 world, timeout_s)) from e
