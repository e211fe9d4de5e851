"""The (data, model) mesh (counterpart of ``pps_tpu/parallel/mesh.py``).

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

Ranks are laid out row-major over ``(n_data, n_model)``, as pps_tpu's
devices are (``reshape(n_data, n_model)``): rank ``r`` sits at
``(r // n_model, r % n_model)``.  The ranks of one data index form a
**model group** (they see the same rows and split the classes of the
classifier FCs, ``param_shardings``); the ranks of one model index form a
**data group** (they split the rows; a class shard's gradient is summed
over it).  Every rank creates every subgroup, in one order (a subgroup
made on some ranks only would hang).  Nothing of ``torch.distributed`` is
imported at module level.
"""

import datetime
import os
import socket
import time

import numpy as np
import torch

from pps_tpu_torch.device import resolve_device

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
    data_group / model_group: this rank's data group and model group (the
      process group of each; ``group`` where one spans every rank, None
      where it holds this rank alone or there is no process group).
    data_index / model_index: this rank's grid position.
    device: this process's device.
    """

    def __init__(self, devices, axis_names, device, group=None,
                 cpu_group=None, data_group=None, model_group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.n_data, self.n_model = (int(v) for v in devices.shape)
        self.device = device
        self.group = group
        self.cpu_group = cpu_group
        self.data_group = data_group
        self.model_group = model_group
        if group is not None:
            dist = _dist()
            self.rank = dist.get_rank()
            self.world_size = dist.get_world_size()
            self.backend = dist.get_backend()
        else:
            self.rank, self.world_size, self.backend = 0, 1, None

    @property
    def data_index(self):
        return self.rank // self.n_model

    @property
    def model_index(self):
        return self.rank % self.n_model

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
        return 'Mesh({}, rank {}/{} at {}, device {}, backend {})'.format(
            self.shape, self.rank, self.world_size,
            (self.data_index, self.model_index), self.device, self.backend)


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
    data_group = model_group = None
    if group is not None:
        data_group, model_group = _axis_groups(n_data, n_model)
    return Mesh(grid.reshape(n_data, n_model), names, local, group=group,
                cpu_group=cpu_group, data_group=data_group,
                model_group=model_group)


def _axis_groups(n_data, n_model):
    """(data group, model group) of this rank on an (n_data, n_model)
    grid of the process group's ranks.  Every rank creates every subgroup
    in the same order (``dist.new_group`` is collective over the world),
    once per grid shape; a group of one rank is None, a group of every
    rank the default group."""
    key = ('axis_groups', n_data, n_model)
    if key not in _STATE:
        dist = _dist()
        rank = dist.get_rank()
        grid = np.arange(n_data * n_model).reshape(n_data, n_model)

        def mine(lines):
            if len(lines[0]) == 1:
                return None
            if len(lines[0]) == n_data * n_model:
                return dist.group.WORLD
            out = None
            for ranks in lines:
                g = dist.new_group([int(r) for r in ranks])
                if rank in ranks:
                    out = g
            return out
        model = mine([list(row) for row in grid])
        data = mine([list(col) for col in grid.T])
        _STATE[key] = (data, model)
    return _STATE[key]


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


def local_rows(mesh, n, fold_model=False):
    """(start, stop) of this rank's rows of an ``n``-row global batch: the
    rows of its data slot (shared by its model group), or with
    ``fold_model`` (extraction) the rows of its flat rank."""
    return batch_sharding(mesh, fold_model=fold_model).rows(n)[mesh.rank]


def is_class_sharded(name):
    """pps_tpu's ``_is_class_sharded``: a parameter whose last dim is the
    identity-class dim (``*fc_w``, ``*fc_b``, the CRM ``_fc8`` weights
    and biases)."""
    return name.endswith('fc_w') or name.endswith('fc_b') or (
        '_fc8' in name and (name.endswith('_w') or name.endswith('_b')))


class ClassSharding(object):
    """A class-sharded parameter: its last dim split in ``n_parts``
    contiguous slices over the model axis; model index j owns
    ``slice(j * K / n_parts, (j + 1) * K / n_parts)``."""

    def __init__(self, n_parts):
        self.n_parts = int(n_parts)

    def classes(self, k, index):
        per = k // self.n_parts
        return index * per, (index + 1) * per

    def __eq__(self, other):
        return isinstance(other, ClassSharding) and \
            other.n_parts == self.n_parts


def param_shardings(mesh, params):
    """{name: ClassSharding or RowSharding}: a classifier FC (pps_tpu's
    predicate) whose last dim divides by the model axis is class-sharded
    over it; every other parameter is replicated.  Market's K = 751 and
    CUHK03's K = 767 divide by no model axis of 2, so their FCs stay
    replicated there; Duke's K = 702 shards."""
    rep = replicated(mesh)
    n_model = mesh.n_model
    out = {}
    for name, p in params.items():
        if (n_model > 1 and is_class_sharded(name)
                and p.shape[-1] % n_model == 0):
            out[name] = ClassSharding(n_model)
        else:
            out[name] = rep
    return out


def placed_class_names(mesh, params, num_logits):
    """The names of a placed train state's class slices, sorted (one order
    on every rank, for collectives over them): the class-sharded params
    (``param_shardings``' rule for a model of ``num_logits`` classes) that
    hold ``num_logits / n_model`` classes."""
    m = mesh.n_model
    if m == 1 or num_logits % m:
        return []
    return sorted(n for n, p in params.items()
                  if is_class_sharded(n) and p.shape[-1] == num_logits // m)


def class_slice(mesh, t):
    """This rank's class slice of a full tensor (its last dim), as a
    contiguous copy."""
    lo, hi = ClassSharding(mesh.n_model).classes(t.shape[-1],
                                                 mesh.model_index)
    t = t[..., lo:hi]
    return t.contiguous() if torch.is_tensor(t) else np.ascontiguousarray(t)


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
