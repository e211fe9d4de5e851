"""Run the port on several gloo ranks on the CPU, one process each, as
``torchrun`` would, for the data-parallel tests.

``Ranks(case, world, workdir, payload)`` pickles ``payload`` into
``workdir``, starts ``world`` processes of this file (each with
``RANK``/``WORLD_SIZE``/``MASTER_*`` set and its output written to a file,
never a pipe: a full pipe would block a rank inside a collective), waits
for them under a timeout that kills the whole group, and returns each
rank's pickled result.  The ranks import torch, numpy and the port only.

Each case below is a function ``case(payload, mesh) -> result`` run on
every rank after the process group is up.
"""

import contextlib
import os
import pickle
import signal
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


class Ranks(object):
    """``world`` ranks running ``case`` in the background; ``results``
    waits for them (killing the group after ``timeout`` seconds from the
    start) and returns [result of rank r]."""

    def __init__(self, case, world, workdir, payload, timeout=120,
                 threads=1, env=None):
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, 'payload.pkl'), 'wb') as f:
            pickle.dump(payload, f)
        self.workdir, self.world = workdir, world
        self.deadline = time.monotonic() + timeout
        port = free_port()
        self.procs = []
        for r in range(world):
            e = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(r), MASTER_ADDR='localhost',
                     MASTER_PORT=str(port), OMP_NUM_THREADS=str(threads),
                     PYTHONPATH=os.pathsep.join([ROOT, HERE]))
            e.update(env or {})
            with open(self._log(r), 'w') as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), case,
                     workdir, str(threads)], stdout=log,
                    stderr=subprocess.STDOUT, env=e, cwd=ROOT,
                    start_new_session=True))

    def _log(self, r):
        return os.path.join(self.workdir, 'rank{}.log'.format(r))

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    def results(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.kill()
        codes = [p.returncode for p in self.procs]
        if any(c != 0 for c in codes):
            tails = []
            for r in range(self.world):
                with open(self._log(r)) as f:
                    tails.append('--- rank {} (exit {}) ---\n{}'.format(
                        r, codes[r], f.read()[-4000:]))
            raise RuntimeError('ranks failed: {}\n{}'.format(
                codes, '\n'.join(tails)))
        out = []
        for r in range(self.world):
            path = os.path.join(self.workdir, 'out{}.pkl'.format(r))
            with open(path, 'rb') as f:
                out.append(pickle.load(f))
        return out


def run_ranks(case, world, workdir, payload, **kwargs):
    """Run ``case`` on ``world`` ranks; returns [result of rank r]."""
    return Ranks(case, world, workdir, payload, **kwargs).results()


def decoder(hw=(96, 32)):
    """decode_fn(path) -> uint8 [h, w, 3] from the file name alone: 8x4
    colour blocks seeded by the identity, plus noise seeded by the image."""
    h, w = hw

    def decode(path):
        base = os.path.basename(path)
        pid = int(base[:8])
        iid = int(base.split('_')[-1].split('.')[0])
        blocks = np.random.RandomState(pid).randint(
            0, 255, size=(8, 4, 3)).astype(np.float32)
        im = np.kron(blocks, np.ones((h // 8, w // 4, 1), np.float32))
        im += np.random.RandomState(iid).randn(h, w, 3) * 8.0
        return np.clip(im, 0, 255).astype(np.uint8)
    return decode


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def case_collectives(payload, mesh):
    """The collectives' values and adjoints, and the global BN stats."""
    import torch
    from pps_tpu_torch.models import heads, resnet
    from pps_tpu_torch.parallel import collectives as col
    from pps_tpu_torch.parallel import mesh as mesh_lib
    r, w = mesh.rank, mesh.world_size
    dev = mesh.device
    out = {}
    x = torch.tensor(payload['x'][r], device=dev, requires_grad=True)
    ct = torch.tensor(payload['ct'][r], device=dev)
    y = col.all_gather(x, mesh)
    (gx,) = torch.autograd.grad((y * ct).sum(), [x])
    out['gather'], out['gather_grad'] = y.detach().cpu().numpy(), \
        gx.cpu().numpy()
    z = col.all_reduce(x, mesh)
    (gz,) = torch.autograd.grad((z * ct[:x.shape[0]]).sum(), [x])
    out['reduce'], out['reduce_grad'] = z.detach().cpu().numpy(), \
        gz.cpu().numpy()
    # the body's BN (NCHW over N, H, W) and the head's (over axis 0) on
    # this rank's rows, under the active mesh
    lo, hi = mesh_lib.local_rows(mesh, payload['body'].shape[0])
    with col.data_parallel(mesh):
        body = torch.tensor(payload['body'][lo:hi], device=dev,
                            requires_grad=True)
        mean, var = resnet.batch_stats(body, (0, 2, 3))
        # every rank computes this term alike: 1/world of it each
        (gb,) = torch.autograd.grad((mean * 3.0 + var).sum() / w, [body])
        head = torch.tensor(payload['head'][lo:hi], device=dev)
        hmean, hvar = heads.batch_stats(head, (0,))
    out.update({k: v.detach().cpu().numpy() for k, v in (
        ('body_mean', mean), ('body_var', var), ('body_grad', gb),
        ('head_mean', hmean), ('head_var', hvar))})
    out['agree'] = [col.agree_any(r == w - 1 and k == 1, mesh)
                    for k in range(3)]
    mesh_lib.coordination_barrier('test')
    mesh_lib.coordination_barrier('test')
    return out


def collectives_payload(world, device='cpu'):
    """Seeded inputs of ``case_collectives``."""
    rng = np.random.RandomState(0)
    return {'x': rng.randn(world, 3, 4).astype(np.float32),
            'ct': rng.randn(world, 3 * world, 4).astype(np.float32),
            'body': rng.randn(8, 5, 3, 2).astype(np.float32),
            'head': rng.randn(8, 7, 6).astype(np.float32),
            'device': device}


def check_collectives(out, payload):
    """Hold each rank's ``case_collectives`` result against one process's
    computation on the whole of the global batch."""
    import torch
    from pps_tpu_torch.models import resnet
    x, ct = payload['x'], payload['ct']
    world = len(out)
    bt = torch.tensor(payload['body'], requires_grad=True)
    with torch.enable_grad():
        m, v = resnet.batch_stats(bt, (0, 2, 3))
        (gb,) = torch.autograd.grad((m * 3.0 + v).sum(), [bt])
    hm, hv = resnet.batch_stats(torch.tensor(payload['head']), (0,))
    rows, n = payload['body'].shape[0] // world, x.shape[1]
    tol = dict(rtol=1e-5, atol=1e-6)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o['gather'], np.concatenate(x))
        np.testing.assert_allclose(o['gather_grad'],
                                   ct.sum(0)[r * n:(r + 1) * n], rtol=1e-6)
        np.testing.assert_allclose(o['reduce'], x.sum(0), rtol=1e-6)
        np.testing.assert_allclose(o['reduce_grad'], ct[:, :n].sum(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(o['body_mean'], m.detach().numpy(), **tol)
        np.testing.assert_allclose(o['body_var'], v.detach().numpy(), **tol)
        np.testing.assert_allclose(o['body_grad'],
                                   gb.numpy()[r * rows:(r + 1) * rows],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(o['head_mean'], hm.numpy(), **tol)
        np.testing.assert_allclose(o['head_var'], hv.numpy(), **tol)
        assert o['agree'] == [False, True, False]


def _port_model(p):
    """The port's model and train state from a payload's cfg and numpy
    weights (pps_tpu's layout)."""
    import torch
    from pps_tpu_torch.engine.checkpoint import params_from_numpy
    from pps_tpu_torch.flagship import flagship_cfg
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.solver import optimizer as opt_lib
    if p.get('cfg_list'):
        from pps_tpu_torch import config as tcfg
        tcfg.reset_cfg()
        tcfg.merge_cfg_from_list(p['cfg_list'])
        tcfg.assert_and_infer_cfg()
        cfg = tcfg.cfg
    else:
        cfg = flagship_cfg(**p['cfg'])
    if p.get('opts'):
        from pps_tpu_torch import config as tcfg
        cfg.immutable(False)
        tcfg.merge_cfg_from_list(p['opts'])
        cfg.immutable(True)
    model = build_model(cfg, device='cpu')
    params, state = params_from_numpy(model, p['params'], p['state'])[:2]
    meta = opt_lib.make_param_meta(params, cfg)
    ts = {'params': params, 'state': state,
          'opt': opt_lib.init_opt_state(params)}
    return cfg, model, meta, ts, torch


def step_once(p, mesh):
    """One train step of a payload on ``mesh`` (None: one rank) from its
    global batch and global draws; ``triplet_only`` trains the triplet term
    alone (the CRM off by the payload's opts), ``planted`` adds the planted
    fault of ``chip_smoke.triplet_not_over_world``, ``planted_model`` that
    of ``chip_smoke.class_terms_not_over_model``.  Returns numpy results
    (the class-sharded params and momentum gathered) and the augmented
    rows this rank trained on."""
    from chip_smoke import (class_terms_not_over_model,
                            triplet_not_over_world, triplet_only)
    from pps_tpu_torch.parallel import train_step as ts_lib
    cfg, model, meta, ts, torch = _port_model(p)
    ts = ts_lib.place_train_state(mesh, ts)
    step = ts_lib.make_train_step(model, cfg, meta, device='cpu', mesh=mesh)
    batch = ts_lib.shard_batch(mesh, {k: torch.tensor(v)
                                      for k, v in p['batch'].items()})
    seen = {}
    fwd = model.train_forward

    def record(params, state, b, *a, **k):
        seen['data'] = b['data'].detach().clone()
        return fwd(params, state, b, *a, **k)
    model.train_forward = record
    draws = {k: ({n: torch.tensor(a) for n, a in v.items()}
                 if isinstance(v, dict) else torch.tensor(v))
             for k, v in (p.get('draws') or {}).items()}
    gen = torch.Generator().manual_seed(p.get('seed', 0))
    with contextlib.ExitStack() as stack:
        if p.get('triplet_only'):
            stack.enter_context(triplet_only())
        if p.get('planted'):
            stack.enter_context(triplet_not_over_world(
                1 if mesh is None else mesh.world_size))
        if p.get('planted_model'):
            stack.enter_context(class_terms_not_over_model(
                1 if mesh is None else mesh.n_model))
        new, logs = step(ts, batch, p['lr'], 1.0, gen, draws=draws)
    new = ts_lib.gather_train_state(mesh, new,
                                    model.head_spec['num_logits'])
    return {'logs': {k: float(v) for k, v in logs.items()},
            'params': {k: v.numpy() for k, v in new['params'].items()},
            'state': {k: v.numpy() for k, v in new['state'].items()},
            'momentum': {k: v.numpy()
                         for k, v in new['opt']['momentum'].items()},
            'data': seen['data'].numpy()}


def case_step(payload, mesh):
    """Each of the payload's steps; rank 0 returns everything, the other
    ranks a digest of their state (every rank must hold the same).  Then,
    with ``payload['infer']``, ``run_inference`` on every rank."""
    out = []
    for p in payload['steps']:
        res = step_once(dict(payload['common'], **p), mesh)
        if p.get('logs_only'):
            res = {'logs': res['logs']}
        elif mesh.rank:
            res = {'digest': {k: float(np.sum(v, dtype=np.float64))
                              for k, v in res['params'].items()},
                   'data': res['data'], 'logs': res['logs']}
        out.append(res)
    if payload.get('infer'):
        from pps_tpu_torch import config as tcfg
        from pps_tpu_torch.data import catalog
        from pps_tpu_torch.engine import test as test_engine
        p = payload['infer']
        for name, (imdir, ann) in p['datasets'].items():
            catalog.register_dataset(name, imdir, ann)
        tcfg.reset_cfg()
        tcfg.merge_cfg_from_list(p['opts'])
        test_engine.run_inference(tcfg.cfg, output_dir=p['out'],
                                  decode_fn=decoder(p['hw']), device='cpu')
    return out


class AfterPolls(object):
    """A preempt_event whose is_set() turns True at its n-th poll (the
    loop polls once per step); never, for n None."""

    def __init__(self, n):
        self.calls, self.n = 0, n

    def clear(self):
        pass

    def is_set(self):
        self.calls += 1
        return self.n is not None and self.calls >= self.n


def case_driver(payload, mesh):
    """``train_model`` on every rank: a continuous run, a run preempted by
    one rank's flag, its resume; then ``run_inference`` in float32 and
    int8, and with a model axis (``payload['model_axis']``: extraction
    folds it into data).  Returns what each run left (checkpoint names, the
    Preempted point, rank 0's final blobs and features, the model axis's
    features)."""
    import torch
    from pps_tpu_torch import config as tcfg
    from pps_tpu_torch.data import catalog
    from pps_tpu_torch.engine import test as test_engine
    from pps_tpu_torch.engine import train as train_engine
    from pps_tpu_torch.utils.io import load_object
    for name, (imdir, ann) in payload['datasets'].items():
        catalog.register_dataset(name, imdir, ann)
    dec = decoder(payload['hw'])
    root = payload['root']
    out = {}

    def cfg_of(opts):
        tcfg.reset_cfg()
        tcfg.merge_cfg_from_list(opts)
        return tcfg.cfg

    with torch.enable_grad():
        cfg = cfg_of(payload['train'])
        ck = train_engine.train_model(cfg, output_dir=root + '/cont',
                                      decode_fn=dec, num_workers=1,
                                      device='cpu')
        out['cont'] = sorted(os.listdir(root + '/cont'))
        out['cont_ckpts'] = sorted(ck, key=str)
        flag = AfterPolls(payload['preempt_at'] if mesh.rank == 1 else None)
        try:
            train_engine.train_model(cfg, output_dir=root + '/pre',
                                     decode_fn=dec, num_workers=1,
                                     device='cpu', preempt_event=flag)
        except train_engine.Preempted as e:
            out['preempted'] = (e.epoch, e.step, os.path.basename(e.path))
        out['pre'] = sorted(os.listdir(root + '/pre'))
        ck = train_engine.train_model(cfg, output_dir=root + '/pre',
                                      decode_fn=dec, num_workers=1,
                                      device='cpu')
        if mesh.rank == 0:
            out['final'] = load_object(ck['final'])['blobs']
            out['cont_final'] = load_object(
                root + '/cont/model_final.pkl')['blobs']
    for name, opts in payload.get('test', {}).items():
        cfg = cfg_of(opts)
        res = test_engine.run_inference(cfg, output_dir=root + '/' + name,
                                        decode_fn=dec, device='cpu')
        out[name] = res
        if mesh.rank == 0:
            out[name + '_feats'] = load_object(
                root + '/' + name + '/features.pkl')['all_feats']
    if not payload.get('model_axis'):
        return out
    test_engine.run_inference(cfg_of(payload['model_axis']),
                              output_dir=root + '/model_axis',
                              decode_fn=dec, device='cpu')
    if mesh.rank == 0:
        out['model_axis_feats'] = load_object(
            root + '/model_axis/features.pkl')['all_feats']
    return out


def _dcp_tree_of(tree):
    """A numpy tree in the port's layout -> tensors on the CPU."""
    import torch
    return {part: ({k: ({n: torch.tensor(a) for n, a in v.items()}
                        if isinstance(v, dict) else torch.tensor(v))
                    for k, v in t.items()})
            for part, t in tree.items()}


def case_dcp(payload, mesh):
    """The sharded checkpoint on this grid: load ``payload['load']`` (a
    directory written elsewhere, waited for) into a template placed here,
    then save
    ``payload['tree']`` placed here to ``payload['save']``.  Returns the
    loaded tree gathered and, per class-sharded name, this rank's slice
    as loaded."""
    import torch
    from pps_tpu_torch.engine import checkpoint as ckpt
    from pps_tpu_torch.parallel import train_step as ts_lib
    k = payload['num_logits']
    out = {}
    if payload.get('load'):
        # a directory another group of ranks is writing: wait for its end
        meta = os.path.join(payload['load'], '.metadata')
        deadline = time.monotonic() + 60
        while not os.path.isfile(meta) and time.monotonic() < deadline:
            time.sleep(0.05)
        zeros = _dcp_tree_of(payload['tree'])
        for part in zeros.values():
            for v in part.values():
                for t in (v.values() if isinstance(v, dict) else [v]):
                    t.zero_()
        tmpl = ts_lib.place_train_state(mesh, zeros)
        got = ckpt.load_checkpoint_dcp(payload['load'], tmpl, mesh=mesh,
                                       num_logits=k)
        out['local'] = {n: got['params'][n].numpy()
                        for n in payload['sharded']}
        full = ts_lib.gather_train_state(mesh, got, k)
        out['loaded'] = {part: {n: (v.numpy() if torch.is_tensor(v) else
                                    {m: t.numpy() for m, t in v.items()})
                                for n, v in t.items()}
                         for part, t in full.items()}
    if payload.get('save'):
        ts = ts_lib.place_train_state(mesh, _dcp_tree_of(payload['tree']))
        ckpt.save_checkpoint_dcp(payload['save'], ts, mesh=mesh,
                                 num_logits=k)
        ckpt.wait_for_dcp()
    return out


def main(argv):
    case, workdir, threads = argv[1], argv[2], int(argv[3])
    import torch
    torch.set_num_threads(threads)
    from pps_tpu_torch.parallel import mesh as mesh_lib
    with open(os.path.join(workdir, 'payload.pkl'), 'rb') as f:
        payload = pickle.load(f)
    if case == 'step_one':  # the one-rank reference: no process group
        result = [step_once(dict(payload['common'], **p), None)
                  for p in payload['steps']]
    else:
        device = payload.get('device', 'cpu')
        mesh_lib.init_distributed(device=device,
                                  backend=payload.get('backend'))
        try:
            mesh = mesh_lib.build_mesh(device=device,
                                       mesh_shape=payload.get('mesh_shape'))
            result = globals()['case_' + case](payload, mesh)
        finally:
            mesh_lib.destroy_distributed()
    rank = int(os.environ['RANK'])
    with open(os.path.join(workdir, 'out{}.pkl'.format(rank)), 'wb') as f:
        pickle.dump(result, f)


if __name__ == '__main__':
    main(sys.argv)
