"""Kind ``train``: the program's training loop over P x K batches.

Set-up builds one train step (``parallel/train_step.make_train_step``)
with the benchmark's weights and zero momentum, and a ``ReIDLoader`` over
the synthetic training roidb whose ``decode_fn`` looks the decodes up (no
disk).  It drives that step from the seed through its first
``checked_steps`` steps, with the benchmark's augmentation and dropout
draws, then ``warm_steps`` more as the window runs them; the window runs
the same step on the same loader, epoch after epoch of the mix's regime,
as ``engine/train.train_model``'s loop does: the loader's batches, the
epoch's LR and loss scale, a generator reseeded every step.

The check: the plain reference follows the checked steps from the same
weights, batches and draws.  Compared: each step's loss; the first step's
mean hardest-positive and hardest-negative distance of each combination
(the forward pass alone, from the step's logs); and, by the median leaf,
the gap between the program's and the reference's norm of the first
step's gradient as the optimizer gets it (its velocity over the step's
LR) and of each parameter's change over the checked steps.  The worst
leaf's gaps are recorded, not compared: they are the noise of a few small
BN leaves near the input (PERF.md).
"""

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import core, synth
from portbench.reference import pps


def _lr(cfg, epoch):
    """The LR of ``epoch`` under the configuration's steps-with-decay
    schedule (no warm-up at the mix's epochs)."""
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_ITER]
    idx = max(i for i, s in enumerate(steps) if epoch >= s)
    return float(cfg.SOLVER.BASE_LR * cfg.SOLVER.GAMMA ** idx)


class Setup:
    """The program's train step and loader, their first steps, and what
    the check needs."""

    def __init__(self, run):
        from pps_tpu_torch.data.loader import ReIDLoader
        from pps_tpu_torch.models.model import build_model
        from pps_tpu_torch.parallel.train_step import make_train_step
        from pps_tpu_torch.solver import optimizer as opt_lib

        t, dev = run.traffic, run.device
        self.cfg = cfg = core.program_cfg(run.config, run.bench.root)
        self.spec = core.reference_spec(run.config)
        seeds = core.sub_seeds(run.seed, ['weights', 'data', 'roidb',
                                          'loader', 'draws', 'steps'])
        self.params0, state0 = synth.make_weights(
            self.spec, seeds['weights'], dev,
            run.config.get('branch_scale', 1.0))
        hw = tuple(t['decode_hw'])
        self.decodes = synth.decodes(t['images'], hw, seeds['data'], dev)
        roidb = synth.train_roidb(t['ids'], t['images'], hw, seeds['roidb'])
        self.model = build_model(cfg, device=dev)
        self.combos = self.model.head_spec['combos']
        meta = opt_lib.make_param_meta(self.params0, cfg)
        self.step = make_train_step(self.model, cfg, meta, device=dev)
        self.loader = ReIDLoader(roidb, cfg, seed=seeds['loader'] % 2 ** 31,
                                 decode_fn=self._decode, device=dev)
        self.epochs = self._epochs(t['epoch'])
        self.batches = self.loader.iter_epoch(next(self.epochs))
        self.lr = _lr(cfg, t['epoch'])
        self.gen = torch.Generator(device=dev)
        self.step_seed = seeds['steps']
        self.global_step = 0
        self.erase = {'prob': cfg.REID.RANDOM_ERASING_PROB,
                      'sl': cfg.REID.SL, 'sh': cfg.REID.SH, 'r1': cfg.REID.R1}
        ts = {'params': dict(self.params0), 'state': state0,
              'opt': opt_lib.init_opt_state(self.params0)}
        # the checked steps: the benchmark's draws, kept with their batches
        self.checked = []
        for i in range(t['checked_steps']):
            batch, scale = self.next_batch()
            draws = synth.train_draws(
                batch['labels_int32'].shape[0], hw, self.model.num_combos,
                self.model.head_spec['bpm_dim'], self.erase,
                seeds['draws'] + i, dev)
            ts, logs = self.step(ts, batch, self.lr, scale, self.gen,
                                 draws=draws)
            self.checked.append({'batch': batch, 'draws': draws,
                                 'scale': scale, 'logs': logs})
            if i == 0:
                self.velocity1 = ts['opt']['momentum']
        self.params_checked = ts['params']
        for _ in range(t['warm_steps']):
            ts, logs = self.one_step(ts)
        self.ts, self.last_logs = ts, logs
        torch.cuda.synchronize(dev) if dev.type == 'cuda' else None

    def _decode(self, key):
        return self.decodes[int(key) % len(self.decodes)]

    def _epochs(self, first):
        """The mix's regime: ``first`` and every epoch of the same kind
        after it (the triplet epochs alternate)."""
        ep = first
        step = 2 if self.loader.schedule.is_triplet_epoch(first) else 1
        while True:
            yield ep
            ep += step

    def next_batch(self):
        with record_function('portbench.loader_next'):
            for _ in range(2):
                try:
                    _, scale, batch = next(self.batches)
                    return batch, scale
                except StopIteration:
                    self.batches = self.loader.iter_epoch(next(self.epochs))
        raise RuntimeError('the loader yields no batch')

    def one_step(self, ts):
        batch, scale = self.next_batch()
        self.gen.manual_seed(core.sub_seeds(self.step_seed + self.global_step,
                                            ['s'])['s'])
        self.global_step += 1
        with record_function('portbench.train_step'):
            return self.step(ts, batch, self.lr, scale, self.gen)

    def close(self):
        self.batches.close()


def setup(run):
    return Setup(run)


def window(run, st):
    """Steps until the window's time is up; the rate over every image and
    the whole window, the card synchronised at both ends.  With a tracer,
    the last ``trace_seconds`` are profiled and the rate for the per-layer
    metrics is taken over the steps before them."""
    dev, t = run.device, run.traffic
    batch = st.cfg.TRAIN.IMS_PER_BATCH
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == 'cuda' \
        else (lambda: None)
    ts, logs = st.ts, st.last_logs
    qsizes, steps = [], 0
    tracer, traced_from = run.tracer, None
    sync()
    t0 = time.perf_counter()
    while True:
        ts, logs = st.one_step(ts)
        qsizes.append(st.loader.qsize())
        steps += 1
        el = time.perf_counter() - t0
        if tracer is not None and traced_from is None and \
                el >= run.seconds - t['trace_seconds']:
            sync()
            traced_from = (steps, time.perf_counter() - t0)
            tracer.start()
        if el >= run.seconds:
            break
    if tracer is not None and tracer.active:
        tracer.stop()
    sync()
    wall = time.perf_counter() - t0
    st.ts, st.last_logs = ts, logs
    run.attempted, run.failed = steps, int(not math.isfinite(
        float(logs['loss'])))
    run.e2e['train_imgs_per_s'] = steps * batch / wall
    run.record.update(steps=steps, imgs=steps * batch, wall_s=wall,
                      starved=sum(1 for q in qsizes if q == 0),
                      fwd_flops=run.yard_flops, batch=batch)
    if traced_from is not None:
        n, s = traced_from
        run.record['untraced_imgs_per_s'] = n * batch / s


def _norms(tree, names):
    return {k: float(torch.linalg.vector_norm(tree[k].double()))
            for k in names}


def _gaps(prog, ref, names):
    """Each leaf's gap of norms, over the larger of the leaf's reference
    norm and the median leaf's."""
    med = float(np.median([ref[k] for k in names]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def reference_trees(st, body='f32'):
    """(losses, first effective gradients, changes over the checked steps)
    of the plain reference from the benchmark's weights over the checked
    batches."""
    means = synth.MEANS
    out_hw = (st.spec.height, st.spec.width)
    batches = []
    for c in st.checked:
        b, d = c['batch'], c['draws']
        batches.append({
            'images': pps.augment(b['data_u8'], b['flipped'], d['augment'],
                                  means, out_hw),
            'labels': b['labels_int32'].long(),
            'keep_mask': d['dropout_mask'], 'lr': st.lr,
            'loss_scale': float(c['scale'])})
    losses, g1, p_end, trip = pps.train_steps(st.spec, st.params0, batches,
                                              body)
    return (losses, g1, {k: p_end[k] - st.params0[k] for k in p_end},
            trip)


def judge(run, st, control=None):
    """The compared numbers: program (or ``control``, the reference in a
    lower precision) against the float32 reference."""
    pps.strict_float32()
    names = list(st.params0)
    ref_loss, ref_g, ref_d, ref_trip = reference_trees(st)
    if control is None:
        losses = [float(c['logs']['loss']) for c in st.checked]
        g = {k: st.velocity1[k] / (st.lr * pps.lr_scale(st.spec, k))
             for k in names}
        d = {k: st.params_checked[k] - st.params0[k] for k in names}
        logs = st.checked[0]['logs']
        trip = {s: [float(logs['{}_dist_{}_mean'.format(p, s)])
                    for p, _ in st.combos] for s in ('ap', 'an')}
    else:
        losses, g, d, trip = reference_trees(st, control)
    ref_gn, ref_dn = _norms(ref_g, names), _norms(ref_d, names)
    # leaves the loss does not reach (a bias under BN): their reference
    # gradient is rounding, under a thousandth of the median leaf's
    med = float(np.median([ref_gn[k] for k in names]))
    moved = [k for k in names if ref_gn[k] >= 1e-3 * med]
    run.record['leaves_left_out'] = sorted(set(names) - set(moved))
    out = {'loss_gap': max(abs(a - b) / abs(b)
                           for a, b in zip(losses, ref_loss)),
           # the first step's forward pass alone: the mean hardest-positive
           # and hardest-negative distance of each combination
           'trip_gap': max(abs(float(a) - float(b)) / float(b)
                           for s in ('ap', 'an')
                           for a, b in zip(trip[s], ref_trip[s]))}
    for key, prog, ref_n in (('grad', g, ref_gn), ('change', d, ref_dn)):
        gaps = _gaps(_norms(prog, moved), ref_n, moved)
        worst = max(gaps, key=gaps.get)
        out[key + '_gap'] = gaps[worst]
        out[key + '_gap_median'] = float(np.median(list(gaps.values())))
        run.record[key + '_worst_leaf'] = worst
    return out


def free(st):
    """Drop the program's state, keeping what the check reads."""
    st.close()
    st.ts = st.last_logs = st.step = st.loader = st.model = None


# the reference's body one precision below the configuration's
CONTROL = {'bfloat16': 'fp8', 'float32': 'bf16'}


def control(run, st):
    """The control's numbers: the reference with the body one precision
    below the configuration's (float8 training for a bfloat16 body,
    bfloat16 for a float32 one) in the program's place."""
    return judge(run, st, CONTROL[run.config['sizes']['dtype']])
