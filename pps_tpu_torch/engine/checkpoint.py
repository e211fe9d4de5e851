"""Checkpoint I/O: reference-pkl-compatible save/load, and the bridge from
the JAX package's params.

Counterpart of ``pps_tpu/engine/checkpoint.py`` (pkl part).  The container
is the reference's pickle of ``{'blobs': {name: ndarray}, 'cfg': yaml}``
holding params, BN running stats (``*_bn_riv`` stores plain variance) and
``*_momentum`` blobs.  The port's in-memory layout differs from the blobs
only in the stacked head:

  conv weights       OIHW in the port and in the pkl (no transpose)
  FPN 1x1 weights    [C_in, C_out] <-> [C_out, C_in, 1, 1]
  head combo params  '{combo_prefix}_conv_w' [D,C,1,1] <-> stacked [R][C,D]
  FC weights         [K, D] <-> stacked [R, D, K]; CRM [K, D] <-> [D, K]

A ConvGN head carries ``{combo_prefix}_gn_s/_b`` and no running stats.

``params_from_numpy`` takes the JAX package's flat dicts (HWIO convs,
int8 HWIO ``*_wq`` of a quantized body), and optionally its optimizer
state, and places them on the model's device; the tests carry identical
weights across with it.  ``*_momentum`` blobs
are written from and read into ``opt_state['momentum']``.

The sharded format (``TPU.CKPT_FORMAT: orbax``; the counterpart of
pps_tpu's orbax backend) is a ``torch.distributed.checkpoint`` directory
``*.dcp`` of the native tree ``{'params', 'state', 'opt'}``: each rank
writes its own shards, a class-sharded tensor carries its placement (a
DTensor over a CPU device mesh of the ranks), and a load re-shards onto
the template's placements (``save_checkpoint_dcp``,
``load_checkpoint_dcp``, ``wait_for_dcp``).  pps_tpu's ``.orbax``
directories need orbax's storage layer, which the port does not import:
given one, the port raises; pkl is the format both packages read.
"""

import logging
import os
import re

import numpy as np
import torch

from pps_tpu_torch.utils.io import load_object, save_object

logger = logging.getLogger(__name__)


def _head_entries(model):
    """Yield (stacked_key, combo_idx, c2_name, kind) for head params."""
    prefix = model.head_param_prefix
    norm = '_gn' if model.head_spec.get('use_gn') else '_bn'
    for r, (combo_prefix, _) in enumerate(model.head_spec['combos']):
        yield prefix + '_conv_w', r, combo_prefix + '_conv_w', 'conv1x1_w'
        yield prefix + '_conv_b', r, combo_prefix + '_conv_b', 'vec'
        yield prefix + norm + '_s', r, combo_prefix + norm + '_s', 'vec'
        yield prefix + norm + '_b', r, combo_prefix + norm + '_b', 'vec'
        yield prefix + '_fc_w', r, combo_prefix + '_fc_w', 'fc_w'
        yield prefix + '_fc_b', r, combo_prefix + '_fc_b', 'vec'


def _head_state_entries(model):
    if model.head_spec.get('use_gn'):
        return  # a ConvGN head has no running stats
    prefix = model.head_param_prefix
    for r, (combo_prefix, _) in enumerate(model.head_spec['combos']):
        yield prefix + '_bn_rm', r, combo_prefix + '_bn_rm', 'vec'
        yield prefix + '_bn_riv', r, combo_prefix + '_bn_riv', 'vec'


_CRM_W = ('crm_fc8c_w', 'crm_fc8d_w')


def _is_fpn_w(name, ndim):
    return name.startswith('fpn_') and name.endswith('_w') and ndim == 2


def _np(t):
    return t.detach().to('cpu', torch.float32).numpy()


def params_from_numpy(model, params, state, opt_state=None):
    """The JAX package's (params, state) as numpy -> the port's, as float32
    tensors on ``model.device``.  4-d conv weights go HWIO -> OIHW; the
    stacked head, the 2-d FPN weights and the CRM [D, K] weights keep
    their layout.  A quantized body's int8 ``*_wq`` stay int8 and go HWIO
    -> OHWI; its ``*_xinv`` stay 0-d or [C_in].

    With ``opt_state`` (the JAX package's optimizer state: 'momentum' and,
    for the 'iter' flavor, 'acmgrad' and 'count') the result is a triple
    (params, state, opt_state); the param-shaped trees convert as params
    do and the step count becomes an int32 0-d tensor."""
    def convert(name, a):
        if name.endswith('_wq'):
            a = np.asarray(a, np.int8).transpose(3, 0, 1, 2)
        else:
            a = np.asarray(a, np.float32)
            if a.ndim == 4 and name.endswith('_w'):
                a = a.transpose(3, 2, 0, 1)
        # (ascontiguousarray would make a 0-d xinv 1-d)
        return torch.tensor(np.ascontiguousarray(a) if a.ndim else a,
                            device=model.device)

    def tree(t):
        return {k: convert(k, v) for k, v in t.items()}
    if opt_state is None:
        return tree(params), tree(state)
    opt = {k: (tree(v) if isinstance(v, dict) else
               torch.tensor(np.asarray(v), dtype=torch.int32,
                            device=model.device))
           for k, v in opt_state.items()}
    return tree(params), tree(state), opt


def params_to_blobs(model, params, state=None):
    """The port's (params[, state]) -> a reference blob dict of numpy."""
    blobs = {}
    head_keys = {k for k, _, _, _ in _head_entries(model)}
    for name, t in params.items():
        if name in head_keys:
            continue  # handled stacked below
        a = _np(t)
        if name in _CRM_W:
            a = np.ascontiguousarray(a.T)
        elif _is_fpn_w(name, a.ndim):
            a = np.ascontiguousarray(a.T)[:, :, None, None]
        blobs[name] = a
    for key, r, c2_name, kind in _head_entries(model):
        blobs[c2_name] = _stacked_to_c2(_np(params[key][r]), kind)
    if state is not None:
        head_state_keys = {k for k, _, _, _ in _head_state_entries(model)}
        for name, t in state.items():
            if name not in head_state_keys:
                blobs[name] = _np(t)
        for key, r, c2_name, _ in _head_state_entries(model):
            blobs[c2_name] = _np(state[key][r])
    return blobs


def _stacked_to_c2(a, kind):
    if kind == 'conv1x1_w':  # stacked [C, D] -> c2 [D, C, 1, 1]
        return np.ascontiguousarray(a.T)[:, :, None, None]
    if kind == 'fc_w':  # stacked [D, K] -> c2 [K, D]
        return np.ascontiguousarray(a.T)
    return a


def _c2_to_stacked(a, kind):
    if kind == 'conv1x1_w':
        return np.ascontiguousarray(a[:, :, 0, 0].T)
    if kind == 'fc_w':
        return np.ascontiguousarray(a.T)
    return a


def blobs_to_params(model, blobs, params, state):
    """Load a reference blob dict into copies of (params, state).

    Name-matched and shape-checked like the reference loader; missing
    blobs keep their current values, unknown blobs are ignored with a log
    line.  Returns (params, state, matched names).
    """
    params = dict(params)
    state = dict(state)
    matched = set()

    def _try_set(tree, name, value):
        cur = tree[name]
        if tuple(cur.shape) != tuple(value.shape):
            raise ValueError(
                'Shape mismatch for {}: checkpoint {} vs model {}'.format(
                    name, value.shape, tuple(cur.shape)))
        tree[name] = torch.tensor(np.ascontiguousarray(value),
                                  dtype=torch.float32, device=cur.device)

    head = {c2: (key, r, kind) for key, r, c2, kind in _head_entries(model)}
    head_state = {
        c2: (key, r, kind) for key, r, c2, kind in _head_state_entries(model)}

    # stacked head params are assembled on the host, then written once
    stacked_new = {}

    def _stacked(tree, key):
        if key not in stacked_new:
            stacked_new[key] = (tree, _np(tree[key]).copy())
        return stacked_new[key][1]

    for c2_name, arr in blobs.items():
        arr = np.asarray(arr, dtype=np.float32)
        if c2_name in head:
            key, r, kind = head[c2_name]
            _stacked(params, key)[r] = _c2_to_stacked(arr, kind)
            matched.add(c2_name)
        elif c2_name in head_state:
            key, r, _ = head_state[c2_name]
            _stacked(state, key)[r] = arr
            matched.add(c2_name)
        elif c2_name in _CRM_W and c2_name in params:
            _try_set(params, c2_name, arr.T)
            matched.add(c2_name)
        elif c2_name in params:
            if _is_fpn_w(c2_name, params[c2_name].ndim) and arr.ndim == 4:
                arr = arr[:, :, 0, 0].T  # [C_out, C_in, 1, 1] -> 2-d
            _try_set(params, c2_name, arr)
            matched.add(c2_name)
        elif c2_name in state:
            _try_set(state, c2_name, arr)
            matched.add(c2_name)
        elif not c2_name.endswith('_momentum'):
            logger.info('Ignoring checkpoint blob with no model match: %s',
                        c2_name)
    for key, (tree, arr) in stacked_new.items():
        tree[key] = torch.tensor(arr, device=tree[key].device)
    return params, state, matched


def save_checkpoint(path, model, params, state, opt_state=None, cfg=None):
    """Write a reference-compatible weights pickle, with a
    ``{name}_momentum`` blob per param when ``opt_state`` is given.

    Blobs preserved by ``load_checkpoint`` (present in the file, unused by
    the model) are re-emitted, so load -> save is lossless; live model
    blobs win a name collision."""
    blobs = params_to_blobs(model, params, state)
    if opt_state is not None and 'momentum' in opt_state:
        for name, arr in params_to_blobs(model,
                                         opt_state['momentum']).items():
            blobs[name + '_momentum'] = arr
    preserved = getattr(model, '_preserved_blobs', {})
    n_pres = 0
    for name, arr in preserved.items():
        if name not in blobs:
            blobs[name] = arr
            n_pres += 1
    if n_pres:
        logger.info('Re-emitting %d preserved (model-unused) blobs', n_pres)
    payload = {'blobs': blobs}
    if cfg is not None:
        payload['cfg'] = dump_cfg(cfg)
    save_object(payload, path)
    logger.info('Wrote checkpoint: %s (%d blobs)', path, len(blobs))


def dump_cfg(cfg):
    """``cfg`` as the yaml string the pkl containers carry; it parses
    with ``yaml.safe_load`` (plain dicts, lists and scalars only)."""
    import yaml
    return yaml.safe_dump(_plain(dict(cfg)))


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def load_checkpoint(path, model, params, state, opt_state=None):
    """Load weights (+ momentum when ``opt_state`` is given) from a pickle:
    ours, the JAX package's or the reference's, including the
    backbone-only ImageNet bootstrap.  Returns (params, state, opt_state);
    momentum blobs are never preserved."""
    payload = load_object(path)
    blobs = payload.get('blobs', payload)
    weight_blobs = {k: v for k, v in blobs.items()
                    if not k.endswith('_momentum')}
    params, state, matched = blobs_to_params(model, weight_blobs, params,
                                             state)
    logger.info('Loaded %d/%d checkpoint blobs from %s', len(matched),
                len(weight_blobs), path)
    # unmatched blobs ride on the model and are re-emitted on save
    model._preserved_blobs = {k: np.asarray(v)
                              for k, v in weight_blobs.items()
                              if k not in matched and v is not None}
    if opt_state is not None:
        mom_blobs = {k[:-len('_momentum')]: v for k, v in blobs.items()
                     if k.endswith('_momentum')}
        if mom_blobs:
            mom, _, _ = blobs_to_params(model, mom_blobs,
                                        opt_state['momentum'], {})
            opt_state = dict(opt_state)
            opt_state['momentum'] = mom
    return params, state, opt_state


# ---------------------------------------------------------------------------
# the sharded format: torch.distributed.checkpoint directories (*.dcp)
# ---------------------------------------------------------------------------

ORBAX_REFUSED = ('{}: an orbax directory of the JAX package; the port reads '
                 'no orbax storage (it imports torch and numpy only). pkl is '
                 'the format both packages read: write one with '
                 "TPU.CKPT_FORMAT pkl (or the JAX package's save_checkpoint)")

# the background writer: one save in flight at a time
_DCP = {'pool': None, 'fut': None}
_DEVICE_MESHES = {}


def check_not_orbax(path):
    """Raise for a pps_tpu ``.orbax`` directory (the port cannot read it)."""
    if path and str(path).rstrip('/').endswith('.orbax'):
        raise ValueError(ORBAX_REFUSED.format(path))


def is_dcp(path):
    return bool(path) and str(path).rstrip('/').endswith('.dcp')


def _device_mesh(mesh):
    """A CPU ``DeviceMesh`` over the (data, model) grid of the process
    group's ranks, once per grid shape (its creation is collective: every
    rank calls it, on the main thread).  CPU: the state is staged to host
    memory before a save, so no CUDA mesh (which would ask for NCCL
    between ranks that share one card) is made."""
    key = (mesh.n_data, mesh.n_model)
    if key not in _DEVICE_MESHES:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        kw = {}
        if dist.get_backend() != 'gloo':
            kw['backend_override'] = {'data': 'gloo', 'model': 'gloo'}
        _DEVICE_MESHES[key] = init_device_mesh(
            'cpu', key, mesh_dim_names=('data', 'model'), **kw)
    return _DEVICE_MESHES[key]


def _dcp_group(mesh):
    """A gloo group of every rank for the background writer's own
    collectives (created once, on the main thread, by every rank), so
    they never interleave with the train step's on the same group."""
    key = ('dcp_group', mesh.world_size)
    if key not in _DEVICE_MESHES:
        import torch.distributed as dist
        _DEVICE_MESHES[key] = dist.new_group(backend='gloo')
    return _DEVICE_MESHES[key]


def _distributed(mesh):
    return mesh is not None and mesh.distributed


def _dcp_tree(train_state, mesh, num_logits):
    """``{'params', 'state', 'opt'}`` of host tensors (copies, so the
    caller's tensors may change at once); under a model axis each class
    slice is a DTensor ``[Replicate(), Shard(-1)]`` over the CPU device
    mesh.  ``num_logits``: the model's class count (which params are
    slices)."""
    from pps_tpu_torch.parallel import mesh as mesh_lib
    sharded = ()
    if _distributed(mesh) and mesh.n_model > 1:
        sharded = mesh_lib.placed_class_names(mesh, train_state['params'],
                                              num_logits)
    if sharded:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        dmesh = _device_mesh(mesh)

    def host(name, t):
        t = t.detach().to('cpu', copy=True)
        if name in sharded:
            return DTensor.from_local(t, dmesh,
                                      [Replicate(), Shard(t.dim() - 1)],
                                      run_check=False)
        return t

    out = {}
    for part in ('params', 'state', 'opt'):
        if part not in train_state:
            continue
        tree = {}
        for k, v in train_state[part].items():
            if isinstance(v, dict):
                tree[k] = {n: host(n, t) for n, t in v.items()}
            else:
                tree[k] = host(k, v)
        out[part] = tree
    return out


def wait_for_dcp():
    """Block until an in-flight sharded save has committed (its errors
    raise here)."""
    fut, _DCP['fut'] = _DCP['fut'], None
    if fut is not None:
        fut.result()


def save_checkpoint_dcp(path, train_state, cfg=None, mesh=None,
                        num_logits=None, block=False):
    """Write ``{'params', 'state', 'opt'}`` to the directory ``path``
    (``*.dcp``) with ``torch.distributed.checkpoint``.

    Under a distributed ``mesh`` every rank calls this together (from the
    main thread): each writes its own shards, the class slices of a model
    axis as DTensors (``num_logits``: the model's class count), and rank 0
    writes the ``path + '.cfg.yaml'`` sidecar.  The state is staged to
    host memory here; the write runs in a background thread (one save in
    flight: this waits for the last), unless ``block``.  Call
    ``wait_for_dcp`` before reading the directory."""
    import torch.distributed.checkpoint as dcp
    from concurrent.futures import ThreadPoolExecutor
    wait_for_dcp()
    dist = _distributed(mesh)
    tree = _dcp_tree(train_state, mesh, num_logits)
    group = _dcp_group(mesh) if dist else None
    path = os.path.abspath(path)
    if cfg is not None and (not dist or mesh.rank == 0):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + '.cfg.yaml', 'w') as f:
            f.write(dump_cfg(cfg))

    def write():
        dcp.save(tree, checkpoint_id=path, process_group=group,
                 no_dist=not dist)
        logger.info('Wrote sharded checkpoint: %s', path)
    if block:
        return write()
    if _DCP['pool'] is None:
        _DCP['pool'] = ThreadPoolExecutor(1)
    _DCP['fut'] = _DCP['pool'].submit(write)
    logger.info('Writing sharded checkpoint: %s (async)', path)


def load_checkpoint_dcp(path, train_state, mesh=None, num_logits=None):
    """Load a ``*.dcp`` directory into the structure of ``train_state``
    (a template: any of 'params', 'state', 'opt'; its values set the
    shapes, dtypes, devices and placements).  The load re-shards onto the
    template's placements: a template of whole tensors reads whole
    tensors (in one process, or on every rank), one whose class-sharded
    params are this rank's slices on a model axis (``num_logits`` as for
    the save) reads those slices, whatever grid wrote the directory.
    Every rank reads on its own (no collective).  Returns a new tree of
    tensors on the template's devices."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor
    check_not_orbax(path)
    wait_for_dcp()
    if not os.path.isfile(os.path.join(path, '.metadata')):
        raise FileNotFoundError('{}: no sharded checkpoint (no .metadata: '
                                'never written, or the write did not '
                                'finish)'.format(path))
    tree = _dcp_tree(train_state, mesh, num_logits)
    dcp.load(tree, checkpoint_id=os.path.abspath(path), no_dist=True)

    def back(t, like):
        if isinstance(t, DTensor):
            t = t.to_local()
        return t.to(like.device)
    out = {}
    for part, v in tree.items():
        out[part] = {}
        for k, x in v.items():
            tmpl = train_state[part][k]
            out[part][k] = ({n: back(t, tmpl[n]) for n, t in x.items()}
                            if isinstance(x, dict) else back(x, tmpl))
    logger.info('Restored sharded checkpoint: %s', path)
    return out


_EPOCH_RE = re.compile(r'^model_epoch(\d+)\.(pkl|orbax|dcp)$')
_PREEMPT_RE = re.compile(
    r'^model_preempt_epoch(\d+)_step(\d+)\.(pkl|orbax|dcp)$')


def find_resume_checkpoint(output_dir):
    """The auto-resume scan: (path, epoch, step) of the furthest resume
    point in ``output_dir``, or (None, 0, 0).  ``model_epoch{N}`` resumes
    at (N, 0); ``model_preempt_epoch{E}_step{S}``, written by the
    preemption path after S steps of epoch E, at (E, S); the (epoch, step)
    order is the resume-position order.  ``model_final.pkl`` wins with
    epoch -1: training is complete.  ``.orbax`` names are matched as the
    JAX package does, so such a directory is found (and then refused by
    the loader: the port reads no orbax storage); a ``.dcp`` directory
    counts once its write finished (its ``.metadata`` is there)."""
    final = os.path.join(output_dir, 'model_final.pkl')
    if os.path.exists(final):
        return final, -1, 0
    best = (None, 0, 0)
    if os.path.isdir(output_dir):
        for f in os.listdir(output_dir):
            m = _EPOCH_RE.match(f)
            key = (int(m.group(1)), 0) if m else None
            if key is None:
                m = _PREEMPT_RE.match(f)
                if m:
                    key = (int(m.group(1)), int(m.group(2)))
            if key is not None and f.endswith('.dcp') and \
                    not os.path.isfile(os.path.join(output_dir, f,
                                                    '.metadata')):
                key = None
            if key is not None and key > best[1:]:
                best = (os.path.join(output_dir, f),) + key
    return best
