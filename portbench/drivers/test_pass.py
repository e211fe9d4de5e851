"""Kind ``test_pass``: whole Market-1501 test passes, back to back, as
``test_net`` runs one: ``engine/test.extract_dataset_features`` over the
test decodes (a lookup ``decode_fn``, the uint8 wire), then
``engine/test.evaluate_dataset`` (distance matrix and CMC/mAP on the
card).

Set-up makes the weights and the decodes, builds the model and, for an
int8 configuration, runs the program's own calibration and quantization
(``engine/test.quantize_params_for_dataset``: the first
``INT8_CALIB_IMAGES`` test images); one whole pass warms every shape.

The check, on the window's last pass: the embeddings of a sample of images
drawn from the seed against the plain reference's (which works the int8
body out again from the float weights and the same calibration images),
and the pass's mAP and CMC against the reference evaluation of the pass's
own features, whose float32 distances are the published evaluator's
expand formula.  (Random-weight features lie close together: a float64
distance matrix reorders their near-ties and moves the mAP by up to 1e-5,
as far as the control moves it.)
"""

import contextlib
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import core, synth
from portbench.reference import evaluation, pps


class Setup:

    def __init__(self, run):
        from pps_tpu_torch.engine import test as test_lib
        from pps_tpu_torch.models.model import build_model

        t, dev = run.traffic, run.device
        self.t, self.dev = t, dev
        self.cfg = cfg = core.program_cfg(run.config, run.bench.root)
        self.spec = core.reference_spec(run.config)
        self.seeds = core.sub_seeds(run.seed, ['weights', 'data', 'roidb',
                                               'sample'])
        self.params, self.state = synth.make_weights(
            self.spec, self.seeds['weights'], dev,
            run.config.get('branch_scale', 1.0))
        self.roidb = synth.test_roidb(t['ids'], t['queries'], t['gallery'],
                                      self.seeds['roidb'])
        self.decodes = synth.decodes(len(self.roidb), tuple(t['decode_hw']),
                                     self.seeds['data'], dev)
        self.model = build_model(cfg, device=dev)
        self.test_lib = test_lib
        self.run_params = self.params
        if cfg.TPU.INT8_EVAL:
            self.run_params = test_lib.quantize_params_for_dataset(
                cfg, self.model, self.params, self.state, self.roidb,
                decode_fn=self.decode)
        self.last = self.one_pass()
        self.pass_s = self.last['extract_s'] + self.last['eval_s']

    def decode(self, key):
        return self.decodes[int(key)]

    def sync(self):
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)

    def one_pass(self, distmat_fn=None):
        t0 = time.perf_counter()
        with record_function('portbench.extract'):
            feats = self.test_lib.extract_dataset_features(
                self.cfg, self.model, self.run_params, self.state, self.roidb,
                decode_fn=self.decode, batch_size=self.t['batch'])
        self.sync()
        t1 = time.perf_counter()
        with record_function('portbench.evaluate'), \
                contextlib.redirect_stdout(sys.stderr):
            results = self.test_lib.evaluate_dataset(
                self.cfg, feats, self.roidb, distmat_fn=distmat_fn,
                device=self.dev)
        self.sync()
        return {'feats': feats, 'results': results['single'],
                'extract_s': t1 - t0, 'eval_s': time.perf_counter() - t1}


def setup(run):
    return Setup(run)


def window(run, st):
    """Whole passes while the window lasts; the rate over every image of
    every pass and the time they took.  With a tracer, the last pass is
    profiled and the rates for the per-layer metrics come from the passes
    before it."""
    tracer, passes, traced = run.tracer, [], False
    n = len(st.roidb)
    st.sync()
    t0 = time.perf_counter()
    while True:
        el = time.perf_counter() - t0
        if el >= run.seconds and (tracer is None or traced):
            break
        if tracer is not None and passes and el + st.pass_s >= run.seconds:
            tracer.start()
            traced = True
        st.last = st.one_pass()
        passes.append((st.last['extract_s'], st.last['eval_s']))
        if traced:
            tracer.stop()
            break
    wall = time.perf_counter() - t0
    run.attempted, run.failed = len(passes), 0
    run.e2e['test_imgs_per_s'] = len(passes) * n / wall
    untraced = passes[:-1] if tracer is not None and len(passes) > 1 \
        else passes
    run.record.update(
        passes=len(passes), imgs_per_pass=n, wall_s=wall,
        extract_s=[p[0] for p in passes], eval_s=[p[1] for p in passes],
        untraced_imgs_per_s=len(untraced) * n / sum(sum(p)
                                                     for p in untraced),
        eval_share=sum(p[1] for p in untraced) / sum(sum(p)
                                                     for p in untraced),
        mAP=st.last['results']['mAP'], batch=st.t['batch'],
        fwd_flops=run.yard_flops)


def free(st):
    st.model = st.run_params = None


def _labels(roidb):
    ids = np.array([int(e['im_name'][:8]) for e in roidb])
    cams = np.array([int(e['im_name'][9:13]) for e in roidb])
    marks = np.array([e['mark'] for e in roidb])
    return ids, cams, marks


def sample(st):
    rng = np.random.RandomState(st.seeds['sample'] % 2 ** 31)
    return np.sort(rng.choice(len(st.roidb), st.t['check_rows'],
                              replace=False))


def reference_embeddings(st, idx, bits=None):
    """The reference's embeddings of decodes ``idx``: float32 with BN
    (``bits`` None), or the int8 (``bits`` 8) or int4 body worked out from
    the same calibration images."""
    dev = st.dev
    out_hw = (st.spec.height, st.spec.width)

    def images(rows):
        u8 = torch.as_tensor(st.decodes[rows], device=dev)
        return pps.preprocess(u8, synth.MEANS, out_hw)

    p, mode = st.params, 'eval'
    if bits is not None:
        calib = images(np.arange(st.cfg.TPU.INT8_CALIB_IMAGES))
        p, mode = pps.quantize_body(st.spec, st.params, st.state, calib,
                                    bits=bits), 'int8'
    b = st.t['batch']
    return torch.cat([pps.embed(st.spec, p, st.state, images(idx[i:i + b]),
                                mode) for i in range(0, len(idx), b)]
                     ).cpu().numpy()


def _emb_gap(a, b):
    return float(np.max(np.linalg.norm(np.asarray(a, np.float64) - b,
                                       axis=1)))


def _eval_gaps(results, ref):
    """(mAP gap, the widest CMC gap) of a pass's evaluation against the
    reference's of the same features."""
    m, cmc = ref
    return {'map_gap': abs(results['mAP'] - m),
            'cmc_gap': float(np.max(np.abs(
                np.asarray(results['cmc'][:len(cmc)]) - cmc)))}


def judge(run, st):
    pps.strict_float32()
    idx = sample(st)
    int8 = bool(st.cfg.TPU.INT8_EVAL)
    ref = reference_embeddings(st, idx, 8 if int8 else None)
    feats = st.last['feats']
    ids, cams, marks = _labels(st.roidb)
    ref_eval = evaluation.market_eval(feats, ids, cams, marks,
                                      device=st.dev)
    return {'emb_gap': _emb_gap(feats[idx], ref),
            **_eval_gaps(st.last['results'], ref_eval)}


def control(run, st):
    """The numbers of the control in the program's place: the embeddings
    one precision lower (int4 for an int8 body; the program's own int8
    body for a bfloat16 one), and the evaluation with the program's own
    bfloat16 distance matrix (``euclidean_distmat(fast=True)``)."""
    from pps_tpu_torch.ops.distance import euclidean_distmat
    pps.strict_float32()
    idx = sample(st)
    if st.cfg.TPU.INT8_EVAL:
        ref = reference_embeddings(st, idx, 8)
        low = reference_embeddings(st, idx, 4)
    else:
        ref = reference_embeddings(st, idx)
        from pps_tpu_torch.parallel import eval_step
        q = st.test_lib.quantize_params_for_dataset(
            st.cfg, st.model, st.params, st.state, st.roidb,
            decode_fn=st.decode)
        fn = eval_step.make_extract_fn(
            st.model, device_preproc=(np.asarray(st.cfg.PIXEL_MEANS),
                                      (st.spec.height, st.spec.width)),
            device=st.dev)
        b = st.t['batch']
        low = np.concatenate([
            fn(q, st.state, torch.as_tensor(st.decodes[idx[i:i + b]],
                                            device=st.dev)).cpu().numpy()
            for i in range(0, len(idx), b)])

    def fast(q, g):
        return euclidean_distmat(torch.as_tensor(q, device=st.dev),
                                 torch.as_tensor(g, device=st.dev),
                                 fast=True)
    lowp = st.one_pass(distmat_fn=fast)
    ids, cams, marks = _labels(st.roidb)
    ref_eval = evaluation.market_eval(lowp['feats'], ids, cams, marks,
                                      device=st.dev)
    return {'emb_gap': _emb_gap(low, ref),
            **_eval_gaps(lowp['results'], ref_eval)}
