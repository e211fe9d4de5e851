"""Training driver: epoch loop, LR feed, checkpoints, auto-resume and
preemption (counterpart of ``pps_tpu/engine/train.py``), on one device or
over a (data, model) mesh of one process per card.

One ``make_train_step`` call per iteration; the TRIPLET_LOSS_CROSS
alternation comes from the pure ``EpochSchedule``; the momentum is
corrected when the LR changes; reference-pkl snapshots per epoch with the
JAX package's names and auto-resume contract; a NaN abort; ``json_stats``
lines.

* Per-step randomness (augmentation, dropout) comes from one generator on
  the device, reseeded each step from (RNG_SEED + 1, global step) alone,
  the counterpart of ``jax.random.fold_in(base, global_step)``: a resumed
  run draws exactly what a continuous run draws at the same step.
* No host sync per step: the step returns its logs on the device and
  ``TrainingStats`` reads them back only when a line prints.  The NaN
  abort therefore fires at the next printed line, at the latest the line
  forced at each epoch's end, before that epoch's snapshot is taken.
* Snapshots: the step returns new tensors and leaves its inputs as they
  were, so an epoch's final state needs no device copy.  Its D2H copies
  start on a side stream into pinned memory; one background writer waits
  for them, then pickles, with one write in flight.
* Over a data mesh (a ``torch.distributed`` process group, one rank per
  card, as ``torchrun`` launches them; ``parallel/mesh.py``) every rank
  runs this loop on its rows of each global batch and holds the same
  state (rank 0's, broadcast before the first step).  Rank 0 alone writes
  the pkl snapshots, ``model_final.pkl`` and the ``json_stats`` lines;
  every rank resumes from the same pkl.  A SIGTERM to any rank stops every
  rank after the same step (the flag is agreed each step over a gloo
  group of host tensors, with no device sync), with one
  ``model_preempt_*.pkl``.  The ranks pass a store barrier between
  building and the first step.
* A model axis (``TPU.MESH_SHAPE (n, m)``, ``m > 1``): the ranks of a
  model group share rows and split the classifier FCs' classes
  (``parallel/train_step.py``); a pkl is written from the class slices
  gathered over the model group on the main thread, before the
  background writer takes them.
* ``TPU.CKPT_FORMAT: orbax`` writes the epoch snapshots and the
  preemption checkpoint in the port's sharded format instead
  (``model_epoch{N}.dcp``, ``model_preempt_epoch{E}_step{S}.dcp``:
  ``torch.distributed.checkpoint``, every rank its own shards, one save
  in flight); ``model_final.pkl`` is always a pkl.  Auto-resume reads
  either format, on any grid.
* ``PPS_TPU_DUMP_JAXPR`` set: ``train_step.graph.txt`` in the output
  directory, the abstract trace of the one-device step at the global
  batch (``make_fx`` on fake tensors: nothing runs on the device, no
  sampler state is consumed, the parameters stay as they were), the
  counterpart of pps_tpu's ``train_step.jaxpr.txt``; its node count is
  logged.
"""

import logging
import os
import signal
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pps_tpu_torch.data.json_dataset import combined_roidb_for_training
from pps_tpu_torch.data.loader import ReIDLoader
from pps_tpu_torch.engine import checkpoint as ckpt_lib
from pps_tpu_torch.engine.stats import TrainingStats
from pps_tpu_torch.models.model import build_model
from pps_tpu_torch.parallel import collectives
from pps_tpu_torch.parallel import mesh as mesh_lib
from pps_tpu_torch.parallel import train_step as ts_lib
from pps_tpu_torch.solver import lr_policy
from pps_tpu_torch.solver import optimizer as opt_lib

logger = logging.getLogger(__name__)

# SIGTERM (maintenance events, spot capacity) sets this flag; the loop
# checkpoints after the in-flight step and raises `Preempted`, so a
# restarted job resumes mid-epoch, losing at most one step.
_PREEMPT = threading.Event()


def request_preemption(signum=None, frame=None):
    """Ask the running train_model to checkpoint and stop after the
    in-flight step (safe from signal handlers and other threads)."""
    _PREEMPT.set()


class Preempted(Exception):
    """Raised by train_model once a preemption checkpoint is written.
    Carries (epoch, step, path) of the resume point; the CLI exits 75
    (EX_TEMPFAIL: run the same command again)."""

    def __init__(self, epoch, step, path):
        super(Preempted, self).__init__(
            'preempted after {} steps of epoch {}; resume point {}'
            .format(step, epoch, path))
        self.epoch = epoch
        self.step = step
        self.path = path


def step_seed(base, global_step):
    """The seed of a step's draws: a pure function of (base, step)."""
    return int(np.random.SeedSequence([base, global_step]).generate_state(
        1, np.uint64)[0])


def create_model(cfg, output_dir, device=None):
    """Build the model and its initial or resumed state.  Returns
    (model, params, state, opt_state, start_epoch, start_step,
    resumed_final)."""
    model = build_model(cfg, device=device)
    params, state = model.init(torch.Generator().manual_seed(cfg.RNG_SEED))
    opt_state = opt_lib.init_opt_state(
        params, flavor=opt_lib.flavor_from_cfg(cfg),
        iter_size=cfg.REID.ITER_SIZE)

    final_path = os.path.join(output_dir, 'model_final.pkl')
    if cfg.TRAIN.AUTO_RESUME and os.path.exists(final_path):
        logger.info('model_final.pkl exists; skipping training')
        return model, params, state, opt_state, -1, 0, True

    start_epoch, start_step = 0, 0
    if cfg.TRAIN.AUTO_RESUME:
        path, epoch, step = ckpt_lib.find_resume_checkpoint(output_dir)
        if path is not None:
            ckpt_lib.check_not_orbax(path)
            logger.info('Auto-resuming from %s (epoch %d, step %d)',
                        path, epoch, step)
            if ckpt_lib.is_dcp(path):
                # whole tensors on every rank (each reads on its own);
                # place_train_state then slices a model axis's classes
                ts = ckpt_lib.load_checkpoint_dcp(
                    path, {'params': params, 'state': state,
                           'opt': opt_state})
                params, state, opt_state = ts['params'], ts['state'], \
                    ts['opt']
            else:
                params, state, opt_state = ckpt_lib.load_checkpoint(
                    path, model, params, state, opt_state=opt_state)
            start_epoch, start_step = epoch, step
    if start_epoch == 0 and start_step == 0 and cfg.TRAIN.WEIGHTS:
        logger.info('Bootstrapping weights from %s', cfg.TRAIN.WEIGHTS)
        params, state, _ = ckpt_lib.load_checkpoint(
            cfg.TRAIN.WEIGHTS, model, params, state)
    return model, params, state, opt_state, start_epoch, start_step, False


def dump_train_graph(model, cfg, meta, trainable, global_batch,
                     train_state, output_dir):
    """Write ``train_step.graph.txt`` to ``output_dir``: the one-device
    train step at the global batch (float32 ``data``, ``labels_int32``,
    ``labels_oh``, the dropout mask an input), traced with ``make_fx`` on
    fake tensors, so nothing runs on the device and the real parameters
    are only read for their metadata.  Returns the graph's node count."""
    from torch.fx.experimental.proxy_tensor import make_fx
    step = ts_lib.make_train_step(model, cfg, meta, trainable=trainable,
                                  device=model.device)
    w, h = cfg.REID.SCALE
    dev = model.device
    levels = 1 if model.fpn_spec is None else model.fpn_spec['fpn_num']
    batch = {'data': torch.empty((global_batch, h, w, 3), device=dev),
             'labels_int32': torch.zeros((global_batch,), dtype=torch.int32,
                                         device=dev),
             'labels_oh': torch.empty((global_batch,
                                       model.head_spec['num_logits']),
                                      device=dev)}
    mask = torch.empty((levels * global_batch, model.num_combos,
                        model.head_spec['bpm_dim']), dtype=torch.bool,
                       device=dev)

    def traced(ts, b, m):
        return step(ts, b, 0.01, 1.0, None, draws={'dropout_mask': m})
    # the model's own constants (the combo masks) enter as fake too
    graph = make_fx(traced, tracing_mode='fake',
                    _allow_non_fake_inputs=True)(train_state, batch, mask)
    path = os.path.join(output_dir, 'train_step.graph.txt')
    with open(path, 'w') as f:
        f.write(graph.print_readable(print_output=False))
    nodes = len(graph.graph.nodes)
    logger.info('wrote train_step.graph.txt (%d nodes)', nodes)
    return nodes


def _fetch_async(train_state, device):
    """Start the D2H copies of (params, state, momentum) and return
    (host tensors, event).  On the card they run on a side stream into
    pinned memory, after the work queued so far; on the CPU the tensors
    are already the host's (the step never writes into them)."""
    tree = {'params': train_state['params'], 'state': train_state['state'],
            'momentum': train_state['opt']['momentum']}
    if device.type != 'cuda':
        return tree, None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        host = {}
        for k, d in tree.items():
            host[k] = {}
            for n, t in d.items():
                # the next steps drop these tensors; their memory must not
                # be reused before the side stream has read them
                t.record_stream(side)
                host[k][n] = t.to('cpu', non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return host, done


def train_model(cfg, output_dir=None, roidb=None, decode_fn=None,
                num_workers=None, log_period=None, preempt_event=None,
                device=None):
    """Run the training schedule.  Returns {epoch: checkpoint path} plus
    'final'.

    While the loop runs in the main thread, SIGTERM is wired to
    ``request_preemption``: the in-flight step finishes, a mid-epoch
    resume checkpoint ``model_preempt_epoch{E}_step{S}.pkl`` is written
    synchronously and ``Preempted`` is raised.  ``preempt_event`` (any
    object with ``is_set`` and ``clear``) replaces the module's flag.

    output_dir defaults to <OUTPUT_DIR>/train/<dataset>/; num_workers to
    DATA_LOADER.NUM_THREADS; roidb and decode_fn are injectable.  The
    model, its steps and its data live on ``device`` (default CUDA).
    ``PPS_TPU_PROFILE_DIR`` set: a ``torch.profiler`` trace of global
    steps [5, 15) is written there as a Chrome trace.

    Under a process group every rank calls this with the same arguments
    (``device`` is the rank's own; default ``cuda:<LOCAL_RANK>``); the
    global batch is ``TRAIN.IMS_PER_BATCH x NUM_GPUS`` split over the
    ranks.
    """
    mesh = mesh_lib.build_mesh(cfg, device=device)
    device = mesh.device
    chief = mesh.rank == 0
    if output_dir is None:
        from pps_tpu_torch.config import get_output_dir
        output_dir = get_output_dir(cfg.TRAIN.DATASETS, training=True)
    os.makedirs(output_dir, exist_ok=True)
    checkpoints = {}

    model, params, state, opt_state, start_epoch, resume_step, done = \
        create_model(cfg, output_dir, device=device)
    if done:
        checkpoints['final'] = os.path.join(output_dir, 'model_final.pkl')
        return checkpoints

    if roidb is None:
        roidb, _ = combined_roidb_for_training(
            cfg.TRAIN.DATASETS, use_flipped=cfg.TRAIN.USE_FLIPPED)
    meta = opt_lib.make_param_meta(params, cfg)
    # TRAIN.FREEZE_AT / FREEZE_CONV_BODY: frozen params get no update
    trainable = opt_lib.trainable_from_cfg(cfg, params)
    step_fn = ts_lib.make_train_step(model, cfg, meta, trainable=trainable,
                                     device=device, mesh=mesh)
    # TPU.DEVICE_AUGMENT False: the host chain; TPU.WIRE_DTYPE bfloat16
    # casts its float32 'data' before the copy (the uint8 wires have
    # nothing to cast)
    loader = ReIDLoader(roidb, cfg, num_workers=num_workers,
                        decode_fn=decode_fn, device=device,
                        raw=bool(cfg.TPU.DEVICE_AUGMENT),
                        wire_dtype=cfg.TPU.WIRE_DTYPE, mesh=mesh)
    if start_epoch > 0:
        loader.skip_epochs(start_epoch)  # the samplers as a continuous run
    sched = loader.schedule
    stats = TrainingStats(sched.total_steps(), log_period=log_period,
                          device=device, emit=chief)
    if os.environ.get('PPS_TPU_DUMP_JAXPR') and chief:
        # the reference's net.pbtxt analog: the one-device step's graph
        dump_train_graph(model, cfg, meta, trainable, sched.global_batch,
                         {'params': params, 'state': state,
                          'opt': opt_state}, output_dir)
    train_state = ts_lib.place_train_state(
        mesh, {'params': params, 'state': state, 'opt': opt_state})
    num_logits = model.head_spec['num_logits']
    sharded_ckpt = cfg.TPU.CKPT_FORMAT == 'orbax'

    def whole(ts):
        # a model axis's class slices put together (every rank, main
        # thread): what a pkl holds
        return ts_lib.gather_train_state(mesh, ts, num_logits)
    generator = torch.Generator(device=device)
    base_seed = cfg.RNG_SEED + 1
    global_step = sched.steps_before_epoch(start_epoch) + resume_step
    start_step = global_step
    # the LR of the last trained step, so a resumed run fires the momentum
    # correction a continuous run fires at this boundary (the LR is a
    # pure function of (epoch, step))
    cur_lr = None
    if global_step > 0:
        if resume_step > 0:
            pe, pi = start_epoch, resume_step - 1
        else:
            pe, pi = start_epoch - 1, -1
            while pe >= 0:
                pi = sched.epoch_len(pe) - 1
                if pi >= 0:
                    break
                pe -= 1
        if pe >= 0 and pi >= 0:
            cur_lr = float(lr_policy.get_lr_at_iter(
                cfg, sched.lr_iter(pe, pi), pe, sched.ipe))
    snapshot_period = max(1, cfg.TRAIN.SNAPSHOT_ITERS)

    profile_dir = chief and os.environ.get('PPS_TPU_PROFILE_DIR')
    profile_window = (5, 15)
    prof = None

    saver = ThreadPoolExecutor(1)  # the background checkpoint writer
    saver_fut = None

    def write_snapshot(path, host, done):
        if done is not None:
            done.synchronize()  # the D2H copies have landed
        ckpt_lib.save_checkpoint(path, model, host['params'], host['state'],
                                 opt_state={'momentum': host['momentum']},
                                 cfg=cfg)

    preempt = preempt_event if preempt_event is not None else _PREEMPT
    preempt.clear()  # a stale flag must not stop the fresh run at step 1
    # build and kernel-compile skew is absorbed here, not in a collective
    mesh_lib.coordination_barrier('train_model/start')
    old_sig, sig_installed = None, False
    if threading.current_thread() is threading.main_thread():
        try:
            old_sig = signal.signal(signal.SIGTERM, request_preemption)
            sig_installed = True
        except (ValueError, OSError):  # no signal support here
            pass
    try:
        for ep in range(start_epoch, cfg.SOLVER.MAX_ITER):
            ep_start = resume_step if ep == start_epoch else 0
            for i, loss_scale, batch in loader.iter_epoch(ep, ep_start):
                if profile_dir and global_step == profile_window[0]:
                    prof = _start_profile(device)
                if prof is not None and global_step == profile_window[1]:
                    _stop_profile(prof, profile_dir, device)
                    prof = None
                if global_step == start_step + stats.LOG_PERIOD:
                    # shed the first iterations' outliers from time/ETA
                    logger.info('Resetting iteration timer after warm-up')
                    stats.ResetIterTimer()
                stats.IterTic()
                lr = float(lr_policy.get_lr_at_iter(
                    cfg, sched.lr_iter(ep, i), ep, sched.ipe))
                if cur_lr is not None and cur_lr != lr:
                    ratio = opt_lib.get_lr_change_ratio(cur_lr, lr)
                    if ratio > cfg.SOLVER.LOG_LR_CHANGE_THRESHOLD:
                        logger.info(
                            'Changing learning rate %.6f -> %.6f at '
                            'iter %d', cur_lr, lr, global_step)
                    if (cfg.SOLVER.SCALE_MOMENTUM and cur_lr > 1e-7 and
                            ratio > cfg.SOLVER.SCALE_MOMENTUM_THRESHOLD):
                        logger.info('LR change %.6f -> %.6f; scaling '
                                    'update history by %.6f',
                                    cur_lr, lr, lr / cur_lr)
                        train_state['opt'] = opt_lib.correct_momentum(
                            train_state['opt'], lr / cur_lr)
                cur_lr = lr
                generator.manual_seed(step_seed(base_seed, global_step))
                train_state, logs = step_fn(train_state, batch, lr,
                                            loss_scale, generator)
                stats.IterToc()
                stats.UpdateIterStats(logs, mb_qsize=loader.qsize())
                # a line at each epoch's end, so short triplet epochs log
                stats.LogIterStats(global_step, lr, extra={'epoch': ep},
                                   force=(i == sched.epoch_len(ep) - 1))
                global_step += 1
                if stats.loss_is_nan():
                    raise FloatingPointError('Loss is NaN')
                stop = preempt.is_set()
                if mesh.distributed:
                    # a SIGTERM to any rank stops every rank here
                    stop = collectives.agree_any(stop, mesh)
                if stop:
                    # checkpoint synchronously (the grace window is
                    # short; durability before exit beats overlap)
                    if saver_fut is not None:
                        saver_fut.result()
                        saver_fut = None
                    done_steps = i + 1
                    ppath = os.path.join(
                        output_dir, 'model_preempt_epoch{}_step{}.{}'.format(
                            ep, done_steps, 'dcp' if sharded_ckpt else 'pkl'))
                    if sharded_ckpt:
                        ckpt_lib.save_checkpoint_dcp(
                            ppath, train_state, cfg=cfg, mesh=mesh,
                            num_logits=num_logits, block=True)
                    else:
                        full = whole(train_state)
                        if chief:
                            ckpt_lib.save_checkpoint(
                                ppath, model, full['params'],
                                full['state'], opt_state=full['opt'],
                                cfg=cfg)
                    # no rank exits before the resume point is on disk
                    mesh_lib.coordination_barrier('train_model/preempt')
                    logger.info('preemption requested: wrote %s (epoch '
                                '%d, %d/%d steps); exiting', ppath, ep,
                                done_steps, sched.epoch_len(ep))
                    raise Preempted(ep, done_steps, ppath)

            # per-epoch snapshot; the shortened triplet epochs get none
            if ep % snapshot_period == 0 and not sched.is_triplet_epoch(ep):
                path = os.path.join(output_dir, 'model_epoch{}.{}'.format(
                    ep + 1, 'dcp' if sharded_ckpt else 'pkl'))
                checkpoints[ep] = path
                if sharded_ckpt:
                    # staged to host here, written in the background
                    ckpt_lib.save_checkpoint_dcp(path, train_state, cfg=cfg,
                                                 mesh=mesh,
                                                 num_logits=num_logits)
                    continue
                full = whole(train_state)
                if not chief:
                    continue
                host, copied = _fetch_async(full, device)
                if saver_fut is not None:
                    saver_fut.result()  # surface errors; one in flight
                saver_fut = saver.submit(write_snapshot, path, host, copied)
    finally:
        # an in-flight snapshot is valid even when the loop aborts, so let
        # it finish.  Its failure is fatal on the normal path; while the
        # loop is already unwinding it is logged instead of masking the
        # first error (checked before result(), whose own except would
        # change sys.exc_info)
        unwinding = sys.exc_info()[0] is not None
        if sig_installed:
            try:
                signal.signal(signal.SIGTERM,
                              signal.SIG_DFL if old_sig is None else old_sig)
            except (ValueError, OSError):
                pass
        if prof is not None:
            _stop_profile(prof, profile_dir, device)
        try:
            if saver_fut is not None:
                saver_fut.result()
            ckpt_lib.wait_for_dcp()
        except Exception:
            if not unwinding:
                raise
            logger.exception('background checkpoint write failed')
        finally:
            saver.shutdown(wait=True)

    # model_final.pkl is also the training-complete marker of auto-resume
    final_path = os.path.join(output_dir, 'model_final.pkl')
    full = whole(train_state)
    if chief:
        ckpt_lib.save_checkpoint(final_path, model, full['params'],
                                 full['state'], opt_state=full['opt'],
                                 cfg=cfg)
    mesh_lib.coordination_barrier('train_model/final')
    checkpoints['final'] = final_path
    return checkpoints


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir, device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, 'train_steps.trace.json')
    prof.export_chrome_trace(path)
    logger.info('wrote a profiler trace of the train steps: %s', path)
