"""Export the inference model as a deployable artifact (counterpart of
``tools/export_model.py``): the feature extraction is traced with
``torch.export.export`` and saved as a ``.pt2`` program that runs without
the Python model code.

    python -m pps_tpu_torch.tools.export_model --cfg <yaml> \\
        [--weights model_final.pkl] --out model.pt2 [--batch 64] \\
        [--fold-bn | --int8 (--calib-npy F | --calib-dataset DS)] \\
        [--device cuda|cpu] [KEY VALUE ...]

The program maps a [B, H, W, 3] float32 batch (BGR, mean-subtracted) to
[B, E] embeddings.  ``--fold-bn`` folds the body's and the FPN's BN into
their convs (``models/folding.py``); ``--int8`` exports the int8 serving
body (``models/quantize.py``, folding included), calibrated on a
``[N, H, W, 3]`` float32 ``.npy`` of preprocessed images or on the first
``TPU.INT8_CALIB_IMAGES`` images of a catalog dataset.

The int8 conv is the custom operator ``pps_tpu_torch::conv2d_int8``: a
program that holds it loads and runs only after
``import pps_tpu_torch.kernels.conv2d_int8`` (which registers it), e.g.

    import torch, pps_tpu_torch.kernels.conv2d_int8
    embed = torch.export.load('model.pt2').module()

After saving, the tool runs the program once on a batch of the
calibration images (seeded noise without them) and logs its largest
difference from eager extraction.  ``split_state(program)`` returns the
(params, state) a program holds.
"""

import argparse
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Export a re-ID model')
    parser.add_argument('--cfg', dest='cfg_file', required=True)
    parser.add_argument('--weights', default='')
    parser.add_argument('--out', required=True)
    parser.add_argument('--batch', type=int, default=64)
    parser.add_argument('--fold-bn', dest='fold_bn', action='store_true',
                        help='fold the BN of the body and the FPN into '
                             'their convs before export')
    parser.add_argument('--int8', action='store_true',
                        help='export the int8 serving body (implies BN '
                             'folding); needs --calib-npy or '
                             '--calib-dataset')
    parser.add_argument('--calib-npy', default='',
                        help='[N,H,W,3] float32 .npy of preprocessed '
                             '(BGR mean-subtracted) calibration images')
    parser.add_argument('--calib-dataset', default='',
                        help='calibrate on the first TPU.INT8_CALIB_IMAGES '
                             'images of this catalog dataset')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('opts', nargs=argparse.REMAINDER)
    return parser, parser.parse_args(sys.argv[1:] if argv is None else argv)


def _module(model, params, state):
    """``model.extract_features`` over ``params`` / ``state`` held as
    buffers named ``p__<param>`` / ``s__<state>``, as an ``nn.Module`` for
    ``torch.export`` (``split_state`` reads them back from a program)."""
    import torch

    class Serve(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self._names = []
            for tree, tag in ((params, 'p'), (state, 's')):
                for k, v in sorted(tree.items()):
                    self.register_buffer('{}__{}'.format(tag, k), v)
                    self._names.append((tag, k))

        def forward(self, images):
            trees = {'p': {}, 's': {}}
            for tag, k in self._names:
                trees[tag][k] = getattr(self, '{}__{}'.format(tag, k))
            return model.extract_features(trees['p'], trees['s'], images)

    return Serve()


def split_state(program):
    """(params, state) held by an exported (or reloaded) program."""
    params, state = {}, {}
    for name, t in program.state_dict.items():
        tag, key = name.split('__', 1)
        (params if tag == 'p' else state)[key] = t
    return params, state


def main(argv=None):
    import numpy as np
    import torch

    from pps_tpu_torch.config import (cfg, merge_cfg_from_file,
                                      merge_cfg_from_list,
                                      assert_and_infer_cfg)
    from pps_tpu_torch.engine import checkpoint as ckpt_lib
    from pps_tpu_torch.models.model import build_model
    from pps_tpu_torch.utils.logging import setup_logging

    logger = setup_logging(__name__)
    parser, args = parse_args(argv)
    merge_cfg_from_file(args.cfg_file)
    if args.opts:
        merge_cfg_from_list(args.opts)
    assert_and_infer_cfg(make_immutable=False)

    model = build_model(cfg, device=args.device)
    params, state = model.init(torch.Generator().manual_seed(cfg.RNG_SEED))
    if args.weights:
        params, state, _ = ckpt_lib.load_checkpoint(args.weights, model,
                                                    params, state)
    calib = None
    if args.calib_npy:
        calib = np.load(args.calib_npy).astype(np.float32)
    elif args.calib_dataset:
        from pps_tpu_torch.data.json_dataset import roidb_for_test
        from pps_tpu_torch.engine.test import preprocess_images
        roidb = roidb_for_test(args.calib_dataset)
        n = max(1, min(int(cfg.TPU.INT8_CALIB_IMAGES), len(roidb)))
        calib = preprocess_images(roidb[:n], cfg)
    if args.int8:
        if calib is None:
            parser.error('--int8 requires --calib-npy or --calib-dataset '
                         '(static activation scales need real data)')
        from pps_tpu_torch.models.quantize import quantize_for_eval
        params = quantize_for_eval(model, params, state, calib)
        logger.info('int8 PTQ: quantized %d body convs',
                    sum(1 for k in params if k.endswith('_wq')))
    elif args.fold_bn:
        from pps_tpu_torch.models.folding import fold_conv_bn
        params = fold_conv_bn(params, state)

    w, h = cfg.REID.SCALE
    module = _module(model, params, state)
    example = torch.zeros((args.batch, h, w, 3), device=model.device)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    torch.export.save(program, args.out)
    logger.info('exported %s: batch=%d embedding=%d (torch.export; load '
                'with torch.export.load after importing '
                'pps_tpu_torch.kernels.conv2d_int8)', args.out, args.batch,
                model.embedding_dim)

    if calib is not None and len(calib) >= args.batch:
        check = calib[:args.batch]
    else:
        check = np.random.RandomState(0).randn(args.batch, h, w, 3) * 50
    x = torch.as_tensor(np.asarray(check, np.float32), device=model.device)
    with torch.no_grad():
        got = program.module()(x)
        want = model.extract_features(params, state, x)
    err = float((got - want).abs().max())
    logger.info('exported program vs eager extraction: max abs diff %.3g',
                err)
    return err


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    try:
        main()
    finally:
        write_launch_counts()
