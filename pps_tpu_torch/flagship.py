"""The flagship configuration: PPS + CRM + triplet, ResNet-50, 384x128.

Counterpart of ``__graft_entry__.py:_flagship_cfg``, the configuration the
JAX package's entry point serves: R-50 body in bf16 with f32 params,
RES5_STRIDE 1, 5 strips, 31 power-set combos of 128-d, a 3968-d
L2-normalised embedding.
"""

from pps_tpu_torch.config import (cfg, reset_cfg, merge_cfg_from_list,
                                  assert_and_infer_cfg)


def flagship_cfg(scale=(128, 384), num_classes=752, ims_per_batch=64,
                 p=8, k=8, dtype='bfloat16', depth=50):
    """Reset the port's global cfg to the flagship and return it (frozen).

    ``scale`` is (width, height) as in ``REID.SCALE``.
    """
    reset_cfg()
    merge_cfg_from_list([
        'MODEL.TYPE', 'generalized_reid',
        'MODEL.CONV_BODY', 'ResNet.add_ResNet%d_conv5_body' % depth,
        'MODEL.NUM_CLASSES', str(num_classes),
        'MODEL.USE_BN', 'True',
        'MODEL.DTYPE', dtype,
        'FAST_RCNN.ROI_BOX_HEAD', 'pps_heads.add_pps_part_head',
        'RESNETS.RES5_STRIDE', '1',
        'RESNETS.RES5_DILATION', '1',
        'TRAIN.FREEZE_AT', '0',
        'TRAIN.IMS_PER_BATCH', str(ims_per_batch),
        'SOLVER.BASE_LR', '0.01',
        'SOLVER.WEIGHT_DECAY', '0.0005',
        'REID.SCALE', str(tuple(scale)),
        'REID.BPM_STRIP_NUM', '5',
        'REID.BPM_DIM', '128',
        'REID.CRM', 'True',
        'REID.DROPOUT_FEATURE', 'True',
        'REID.NORMALIZE_FEATURE', 'True',
        'REID.MAX_AVE_FEATURE', 'True',
        'REID.TRIPLET_LOSS', 'True',
        'REID.TRIPLET_LOSS_CROSS', 'True',
        'REID.RANDOM_ERASING_PROB', '0.4',
        'REID.P', str(p),
        'REID.K', str(k),
    ])
    assert_and_infer_cfg()
    return cfg
