"""Model builder: ResNet body + part head, eval-mode extraction.

Counterpart of ``pps_tpu/models/model.py``.  As there, the model is a
static description plus functions over flat ``params`` / ``state`` dicts
keyed by the reference blob names, so the checkpoint mapping stays a name
map (``engine/checkpoint.py``).  The public layouts are the JAX package's:
images NHWC ``[B, H, W, 3]``, embeddings ``[B, R*D]``.

Not in this slice: ``train_forward`` (ROADMAP slice 2: training) and the
FPN body (slice 6: the variants).
"""

import torch

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.models import heads as head_lib
from pps_tpu_torch.models import resnet as resnet_lib


def _depth_from_name(name):
    for d in (152, 101, 50):
        if str(d) in name:
            return d
    return 50


class ReIDModel:
    """Static model description + eval-mode apply functions.

    Attributes:
      device: where ``init`` and ``params_from_numpy`` place tensors.
      resnet_spec / head_spec: static dicts derived from cfg.
      init(generator) -> (params, state)
      extract_features(params, state, images) -> [B, R*D] embeddings
    """

    def __init__(self, cfg, device=None):
        if cfg.FPN.FPN_ON:
            raise NotImplementedError(
                'FPN bodies are not ported yet (ROADMAP slice 6: the '
                'variants)')
        self.cfg = cfg
        self.device = resolve_device(device)
        self.depth = _depth_from_name(cfg.MODEL.CONV_BODY)
        self.resnet_spec = resnet_lib.resnet_spec(cfg, self.depth)
        resnet_lib.check_spec(self.resnet_spec)
        self.head_spec = head_lib.head_spec(
            cfg, self.resnet_spec['spatial_scale'])
        self.masks = torch.as_tensor(head_lib.combo_masks(self.head_spec),
                                     device=self.device)
        # stacked-param prefix: the head kind, as in the JAX package
        self.head_param_prefix = self.head_spec['kind']
        self.num_combos = len(self.head_spec['combos'])
        self.embedding_dim = self.num_combos * self.head_spec['bpm_dim']
        self.use_crm = cfg.REID.CRM
        self.normalize_feature = cfg.REID.NORMALIZE_FEATURE

    # -- init ---------------------------------------------------------------
    def init(self, generator):
        """Random (params, state) from a CPU ``torch.Generator``."""
        params, state = resnet_lib.init_resnet_params(
            generator, self.resnet_spec, self.device)
        hp, hs = head_lib.init_head_params(
            generator, self.head_spec, self.resnet_spec['dim_out'],
            self.device, param_prefix=self.head_param_prefix)
        params.update(hp)
        state.update(hs)
        if self.use_crm:
            params.update(head_lib.init_crm_params(
                generator, self.head_spec, self.device))
        return params, state

    # -- shared trunk -------------------------------------------------------
    def _combo_feats(self, feat, splits):
        ave, mx = head_lib.strip_pools(feat.float(), splits)
        return head_lib.combine_strips(ave, mx, self.masks,
                                       self.head_spec['mode'])

    def _features(self, params, state, images):
        """Returns (features [B, R, D], logits [B, R, K])."""
        # NHWC -> NCHW view; on the card its memory is channels_last
        x = images.float().permute(0, 3, 1, 2)
        feat = resnet_lib.apply_resnet(params, state, x, self.resnet_spec)
        combo_feats = self._combo_feats(feat, self.head_spec['splits'])
        return head_lib.apply_head(params, state, combo_feats,
                                   self.head_spec,
                                   param_prefix=self.head_param_prefix)

    # -- test path ----------------------------------------------------------
    @torch.no_grad()
    def extract_features(self, params, state, images):
        """Test-time embedding.

        images: [B, H, W, 3] preprocessed NHWC (BGR, mean-subtracted)
        tensor on ``self.device``.  Returns [B, R*D] float32 embeddings,
        L2-normalised when REID.NORMALIZE_FEATURE.
        """
        features, _ = self._features(params, state, images)
        return head_lib.test_embedding(features, self.normalize_feature)


def build_model(cfg, device=None):
    """The model for ``cfg`` on ``device`` (default CUDA; raises without
    one unless ``device='cpu'``)."""
    assert cfg.MODEL.TYPE == 'generalized_reid', (
        'only the live re-ID path is supported; got MODEL.TYPE={}'.format(
            cfg.MODEL.TYPE))
    return ReIDModel(cfg, device=device)
