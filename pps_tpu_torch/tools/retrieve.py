"""Retrieval CLI: embed query images and print their top-k gallery
matches (counterpart of ``tools/retrieve.py``).

Loads a trained checkpoint, embeds a gallery directory once (features
cached to gallery_features.npz) or loads a saved index, places it as a
``RetrievalIndex`` (float32 or int8) and answers the query images, plain
or k-reciprocal re-ranked per query (``--rerank``).

    python -m pps_tpu_torch.tools.retrieve --cfg <yaml> --weights <pkl> \
        (--gallery DIR | --load-index idx.npz) --query IMG [IMG ...] \
        [--topk 10] [--rerank] [--ivf] [--vis OUT_DIR] \
        [--save-index idx.npz] [--device cuda|cpu]
"""

import argparse

import numpy as np


def load_model(args):
    """(cfg, model, params, state) from ``--cfg``, the trailing KEY VALUE
    overrides and ``--weights`` on ``--device``; shared with serve."""
    import torch
    from pps_tpu_torch.config import (cfg, merge_cfg_from_file,
                                      merge_cfg_from_list,
                                      assert_and_infer_cfg)
    from pps_tpu_torch.engine import checkpoint as ckpt_lib
    from pps_tpu_torch.models.model import build_model
    merge_cfg_from_file(args.cfg_file)
    if args.opts:
        merge_cfg_from_list(args.opts)
    assert_and_infer_cfg(make_immutable=False)
    model = build_model(cfg, device=args.device)
    params, state = model.init(torch.Generator().manual_seed(cfg.RNG_SEED))
    params, state, _ = ckpt_lib.load_checkpoint(args.weights, model,
                                                params, state)
    return cfg, model, params, state


def main(argv=None):
    parser = argparse.ArgumentParser(description='Retrieve gallery matches')
    parser.add_argument('--cfg', dest='cfg_file', required=True)
    parser.add_argument('--weights', required=True)
    parser.add_argument('--gallery', default=None,
                        help='directory of gallery jpgs (required unless '
                             '--load-index)')
    parser.add_argument('--query', nargs='+', required=True)
    parser.add_argument('--topk', type=int, default=10)
    parser.add_argument('--approx-recall', type=float, default=None,
                        help='accepted for compatibility: the selection '
                             'on this device is exact whatever the value')
    parser.add_argument('--int8-gallery', action='store_true',
                        help='hold the gallery int8-quantized on the '
                             'device (4x fewer bytes than float32)')
    parser.add_argument('--shard-gallery', action='store_true',
                        help='row-shard the gallery over every card this '
                             'process sees (one shard each), merged exactly')
    parser.add_argument('--rerank', action='store_true',
                        help='k-reciprocal re-rank the per-query shortlist '
                             '(the evaluation protocol\'s re-ranking, '
                             'interactive)')
    parser.add_argument('--rerank-shortlist', type=int, default=100)
    parser.add_argument('--rerank-k1', type=int, default=20)
    parser.add_argument('--rerank-k2', type=int, default=6)
    parser.add_argument('--rerank-lambda', type=float, default=0.3)
    parser.add_argument('--load-index', default=None, metavar='NPZ',
                        help='start from a RetrievalIndex.save file '
                             'instead of embedding --gallery')
    parser.add_argument('--save-index', default=None, metavar='NPZ',
                        help='persist the placed index for later runs')
    parser.add_argument('--vis', default=None,
                        help='write rank-list grids to this directory')
    parser.add_argument('--ivf', action='store_true',
                        help='cluster the gallery and probe only the '
                             'nearest cells (persisted by --save-index)')
    parser.add_argument('--ivf-nlist', type=int, default=None)
    parser.add_argument('--ivf-nprobe', type=int, default=8)
    parser.add_argument('--refresh-cache', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('opts', nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from pps_tpu_torch.engine.serving import (build_index_from_args,
                                              embed_paths)
    from pps_tpu_torch.utils.logging import setup_logging

    setup_logging(__name__)
    cfg, model, params, state = load_model(args)
    try:
        index = build_index_from_args(
            cfg, model, params, state,
            gallery=args.gallery, load_index=args.load_index,
            int8=args.int8_gallery, shard=args.shard_gallery,
            weights_path=args.weights, refresh=args.refresh_cache,
            device=args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.ivf and not index.ivf_enabled:
        index.enable_ivf(nlist=args.ivf_nlist, nprobe=args.ivf_nprobe)
    if args.save_index:
        index.save(args.save_index)
    gallery_paths = index.paths

    q_feats = embed_paths(cfg, model, params, state, list(args.query))
    k = min(args.topk, len(index))
    if args.rerank:
        dists, idxs = index.search_reranked(
            q_feats, k, shortlist=args.rerank_shortlist,
            k1=args.rerank_k1, k2=args.rerank_k2,
            lambda_value=args.rerank_lambda,
            recall_target=args.approx_recall)
    else:
        dists, idxs = index.search(q_feats, k,
                                   recall_target=args.approx_recall)

    for qi, qpath in enumerate(args.query):
        print('query: {}'.format(qpath))
        for rank in range(idxs.shape[1]):
            if idxs[qi, rank] < 0:
                break
            print('  #{:<3d} d={:.4f}  {}'.format(
                rank + 1, dists[qi, rank], gallery_paths[idxs[qi, rank]]))

    if args.vis:
        from pps_tpu_torch.evaluation.visualize import visualize_rank_lists
        # visualize with dummy ids (no ground truth at serving time): mark
        # everything as a non-match (red frames) but keep the ranking
        dist_rows = np.full((len(args.query), len(gallery_paths)), np.inf,
                            np.float32)
        for qi in range(len(args.query)):
            valid = idxs[qi] >= 0
            dist_rows[qi, idxs[qi][valid]] = dists[qi][valid]
        visualize_rank_lists(
            dist_rows,
            np.arange(1, len(args.query) + 1),
            -np.ones(len(gallery_paths), np.int64),
            np.zeros(len(args.query), np.int64),
            np.ones(len(gallery_paths), np.int64),
            list(args.query), gallery_paths, args.vis, topk=k,
            skip_no_match=False)


if __name__ == '__main__':
    from pps_tpu_torch.kernels import write_launch_counts
    try:
        main()
    finally:
        write_launch_counts()
