"""Extract features and evaluate a trained re-ID model (counterpart of
``tools/test_net.py``).

    python -m pps_tpu_torch.tools.test_net --cfg <yaml> [--wait]
        [--device cuda|cpu] TEST.WEIGHTS <pkl or .dcp dir> [KEY VALUE ...]

Artifacts (features.pkl) land in <OUTPUT_DIR>/test/<dataset>/.  Under
``torchrun`` (one process per card) the ranks split every batch and rank
0 evaluates and writes; a ``TPU.MESH_SHAPE (n, m)`` model axis is folded
into data (extraction runs no classifier).
"""

import argparse
import os
import pprint
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Test a re-ID network')
    parser.add_argument('--cfg', dest='cfg_file', default=None)
    parser.add_argument('--wait', action='store_true',
                        help='Wait for the weights file to appear')
    parser.add_argument('--multi-gpu-testing', dest='multi_gpu_testing',
                        action='store_true',
                        help='Accepted for CLI compatibility; ignored')
    parser.add_argument('--vis', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('opts', nargs=argparse.REMAINDER)
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        parser.print_help()
        sys.exit(1)
    return parser.parse_args(argv)


def main(argv=None):
    from pps_tpu_torch.config import (cfg, merge_cfg_from_file,
                                      merge_cfg_from_list,
                                      assert_and_infer_cfg)
    from pps_tpu_torch.engine.test import run_inference
    from pps_tpu_torch.evaluation.expected_results import (
        check_expected_results)
    from pps_tpu_torch.parallel.mesh import init_from_env
    from pps_tpu_torch.utils.logging import setup_logging

    logger = setup_logging(__name__)
    args = parse_args(argv)
    logger.info('Called with args: %s', args)
    if args.cfg_file is not None:
        merge_cfg_from_file(args.cfg_file)
    if args.opts:
        merge_cfg_from_list(args.opts)
    if args.vis:
        cfg.REID.VIS = True
    assert_and_infer_cfg()  # frozen from here on
    logger.info('Testing with config:\n%s', pprint.pformat(cfg))

    weights = cfg.TEST.WEIGHTS
    if not weights:
        raise SystemExit('TEST.WEIGHTS must be set')
    while args.wait and not os.path.exists(weights):
        logger.info('Waiting for \'%s\' to exist...', weights)
        time.sleep(10)
    results = run_inference(cfg, weights_file=weights,
                            device=init_from_env(args.device))
    if results:  # rank 0 evaluates
        check_expected_results(cfg, results)


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    from pps_tpu_torch.parallel.mesh import destroy_distributed
    try:
        main()
    finally:
        write_launch_counts()
        destroy_distributed()
