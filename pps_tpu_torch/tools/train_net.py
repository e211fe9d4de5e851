"""Train a re-ID network, then test the final model and each snapshot
(counterpart of ``tools/train_net.py``).

    python -m pps_tpu_torch.tools.train_net --cfg <yaml> [--skip-test]
        [--device cuda|cpu] [KEY VALUE ...]

Checkpoints land in <OUTPUT_DIR>/train/<dataset>/, test artifacts in
<OUTPUT_DIR>/test/<dataset>/.  After a preemption (SIGTERM) the command
exits 75 with a resume checkpoint written: run it again to continue.

Data-parallel over N cards, one process per card:

    torchrun --nproc_per_node N -m pps_tpu_torch.tools.train_net --cfg <yaml>
        NUM_GPUS N [KEY VALUE ...]

(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set the process group up; rank 0 writes and logs.)  A
model axis: ``TPU.MESH_SHAPE (n, m)`` with ``n x m`` ranks (the ranks of
a model group share rows and split the classifier FCs' classes when the
class count divides by m).  ``TPU.CKPT_FORMAT orbax`` writes the epoch
snapshots and the preemption checkpoint as sharded ``*.dcp`` directories;
``PPS_TPU_DUMP_JAXPR=1`` writes ``train_step.graph.txt`` beside them.
"""

import argparse
import pprint
import sys

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train a re-ID network')
    parser.add_argument('--cfg', dest='cfg_file', default=None,
                        help='Config yaml')
    parser.add_argument('--skip-test', action='store_true',
                        help='Do not test the final model')
    parser.add_argument('--multi-gpu-testing', dest='multi_gpu_testing',
                        action='store_true',
                        help='Accepted for CLI compatibility; ignored')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('opts', nargs=argparse.REMAINDER,
                        help='KEY VALUE overrides (see pps_tpu_torch.config)')
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
    from pps_tpu_torch.engine.train import Preempted, train_model
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
    assert_and_infer_cfg()  # frozen from here on
    logger.info('Training with config:\n%s', pprint.pformat(cfg))
    np.random.seed(cfg.RNG_SEED)
    device = init_from_env(args.device)

    try:
        checkpoints = train_model(cfg, device=device)
    except Preempted as p:
        # the resume checkpoint is written; 75 = EX_TEMPFAIL tells a
        # scheduler to run the same command again
        logger.info('%s; run the same command again to resume', p)
        sys.exit(75)

    if not args.skip_test:
        results = run_inference(cfg, weights_file=checkpoints['final'],
                                device=device)
        if results:  # rank 0 evaluates
            check_expected_results(cfg, results)
        print('reprint snapshot name for the result: ', checkpoints['final'])
        cfg.immutable(False)
        cfg.TEST.BBOX_AUG.ENABLED = False
        cfg.REID.VIS = False
        cfg.immutable(True)
        for snapshot in sorted((k for k in checkpoints if k != 'final'),
                               reverse=True):
            run_inference(cfg, weights_file=checkpoints[snapshot],
                          device=device)
            print('reprint snapshot name for the result: ', snapshot,
                  checkpoints[snapshot])


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    from pps_tpu_torch.parallel.mesh import destroy_distributed
    try:
        main()
    finally:
        write_launch_counts()
        destroy_distributed()
