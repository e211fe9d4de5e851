"""Model builder: ResNet body + part head + losses; extraction and the
training forward pass.

Counterpart of ``pps_tpu/models/model.py``.  As there, the model is a
static description plus functions over flat ``params`` / ``state`` dicts
keyed by the reference blob names, so the checkpoint mapping stays a name
map (``engine/checkpoint.py``).  The public layouts are the JAX package's:
images NHWC ``[B, H, W, 3]``, embeddings ``[B, R*D]``.

``TPU.REMAT`` recomputes the conv body in the backward pass instead of
keeping its activations (``torch.utils.checkpoint``, non-reentrant, as
``jax.checkpoint`` in the JAX package): the running-stat updates come from
the first forward pass, and the recomputation writes nothing that
survives.  The body draws no random numbers (dropout is in the head,
outside the checkpoint), so losses, gradients and updates equal those
without it bit for bit on the CPU.

``FPN.FPN_ON`` (the "scale-free" variant, ``models/fpn.py``) needs
``REID.FPN_SHARED``: the head's params are shared by every pyramid level.
Training batch-concatenates the levels level-major (the labels tiled
``FPN_NUM`` times), so one loss set covers them all; extraction reads the
coarsest level only.  With ``TPU.REMAT`` the body is checkpointed with its
stages; ``TRAIN.FREEZE_CONV_BODY`` detaches the pyramid.
"""

import torch
import torch.utils.checkpoint

from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.models import fpn as fpn_lib
from pps_tpu_torch.models import heads as head_lib
from pps_tpu_torch.models import losses as loss_lib
from pps_tpu_torch.models import resnet as resnet_lib
from pps_tpu_torch.parallel import collectives


def _depth_from_name(name):
    for d in (152, 101, 50):
        if str(d) in name:
            return d
    return 50


class ReIDModel:
    """Static model description + apply functions.

    Attributes:
      device: where ``init`` and ``params_from_numpy`` place tensors.
      resnet_spec / head_spec: static dicts derived from cfg.
      init(generator) -> (params, state)
      extract_features(params, state, images) -> [B, R*D] embeddings
      train_forward(params, state, batch, generator, loss_scale_factor)
          -> (total_loss, (state_updates, logs))
    """

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.depth = _depth_from_name(cfg.MODEL.CONV_BODY)
        self.resnet_spec = resnet_lib.resnet_spec(cfg, self.depth)
        self.fpn_spec = None
        if cfg.FPN.FPN_ON:
            self.fpn_spec = fpn_lib.fpn_spec(cfg, self.depth)
            if not cfg.REID.FPN_SHARED:
                raise ValueError(
                    'FPN_ON requires REID.FPN_SHARED: the reference '
                    'non-shared mode is broken by head-name collisions')
        self.head_spec = head_lib.head_spec(
            cfg, self.resnet_spec['spatial_scale'])
        if self.fpn_spec is not None:
            # per-level strip splits at scales (1/16, 1/16, 1/8, 1/4)
            self.level_splits = [
                head_lib.strip_splits(cfg.REID.BPM_STRIP_NUM,
                                      cfg.REID.SCALE[1], sc)
                for sc in self.fpn_spec['spatial_scales']]
            self.head_spec['splits'] = self.level_splits[0]
        self.masks = torch.as_tensor(head_lib.combo_masks(self.head_spec),
                                     device=self.device)
        # stacked-param prefix: the head kind, as in the JAX package
        self.head_param_prefix = self.head_spec['kind']
        self.num_combos = len(self.head_spec['combos'])
        self.embedding_dim = self.num_combos * self.head_spec['bpm_dim']
        self.use_triplet = cfg.REID.TRIPLET_LOSS
        self.use_crm = cfg.REID.CRM
        self.normalize_feature = cfg.REID.NORMALIZE_FEATURE
        # stop-gradient on the body output; the optimizer-side freeze is
        # solver/optimizer.trainable_from_cfg
        self.freeze_conv_body = bool(cfg.TRAIN.FREEZE_CONV_BODY)

    # -- init ---------------------------------------------------------------
    def init(self, generator):
        """Random (params, state) from a CPU ``torch.Generator``."""
        params, state = resnet_lib.init_resnet_params(
            generator, self.resnet_spec, self.device)
        head_dim_in = self.resnet_spec['dim_out']
        if self.fpn_spec is not None:
            fp, fs = fpn_lib.init_fpn_params(generator, self.fpn_spec,
                                             self.device)
            params.update(fp)
            state.update(fs)
            head_dim_in = self.fpn_spec['fpn_dim']
        hp, hs = head_lib.init_head_params(
            generator, self.head_spec, head_dim_in,
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

    def _features(self, params, state, images, train=False,
                  dropout_mask=None, generator=None):
        """Returns (features [B', R, D], logits [B', R, K], updates); the
        updates are {} in eval mode.  B' = B, or B * FPN_NUM in FPN
        training (the levels batch-concatenated, level-major)."""
        # NHWC -> NCHW view; on the card its memory is channels_last
        x = images.float().permute(0, 3, 1, 2)
        fpn = self.fpn_spec is not None
        if not train:
            if fpn:
                _, stages = resnet_lib.apply_resnet(
                    params, state, x, self.resnet_spec, return_stages=True)
                # test: the coarsest level only
                feat = fpn_lib.apply_fpn(params, state, stages,
                                         self.fpn_spec, levels=1)[0]
            else:
                feat = resnet_lib.apply_resnet(params, state, x,
                                               self.resnet_spec)
            combo_feats = self._combo_feats(feat, self.head_spec['splits'])
            features, logits = head_lib.apply_head(
                params, state, combo_feats, self.head_spec,
                param_prefix=self.head_param_prefix)
            return features, logits, {}

        stages_kw = {'return_stages': True} if fpn else {}

        def body(p, s, im):
            return resnet_lib.apply_resnet(p, s, im, self.resnet_spec,
                                           train=True, **stages_kw)
        if self.cfg.TPU.REMAT:
            # the body's RNG is not saved: it draws nothing
            out = torch.utils.checkpoint.checkpoint(
                body, params, state, x, use_reentrant=False,
                preserve_rng_state=False)
        else:
            out = body(params, state, x)
        if fpn:
            _, stages, updates = out
            pyramid, fpn_upd = fpn_lib.apply_fpn(params, state, stages,
                                                 self.fpn_spec, train=True)
            updates.update(fpn_upd)
            if self.freeze_conv_body:
                # with FPN_ON the pyramid is the conv body's output
                pyramid = [p.detach() for p in pyramid]
            combo_feats = torch.cat(
                [self._combo_feats(p, sp)
                 for p, sp in zip(pyramid, self.level_splits)], dim=0)
        else:
            feat, updates = out
            if self.freeze_conv_body:
                feat = feat.detach()
            combo_feats = self._combo_feats(feat, self.head_spec['splits'])
        features, logits, upd = head_lib.apply_head(
            params, state, combo_feats, self.head_spec, train=True,
            param_prefix=self.head_param_prefix, dropout_mask=dropout_mask,
            generator=generator)
        updates.update(upd)
        return features, logits, updates

    # -- test path ----------------------------------------------------------
    @torch.no_grad()
    def extract_features(self, params, state, images):
        """Test-time embedding.

        images: [B, H, W, 3] preprocessed NHWC (BGR, mean-subtracted)
        tensor on ``self.device``.  Returns [B, R*D] float32 embeddings,
        L2-normalised when REID.NORMALIZE_FEATURE.
        """
        features, _, _ = self._features(params, state, images)
        return head_lib.test_embedding(features, self.normalize_feature)

    # -- train path ---------------------------------------------------------
    def train_forward(self, params, state, batch, generator,
                      loss_scale_factor, dropout_mask=None):
        """Returns (total_loss, (state_updates, logs)).

        batch: {'data': [B, H, W, 3], 'labels_int32': [B],
        'labels_oh': [B, K]} on ``self.device``.  ``generator`` draws the
        dropout mask unless ``dropout_mask`` [B', R, D] (bool) is given
        (B' = B * FPN_NUM under FPN).
        loss_scale_factor: scalar (tensor or float) multiplying the triplet
        term under REID.TRIPLET_LOSS_CROSS.  The log keys are the JAX
        package's; each value is a 0-d tensor.

        Under an active mesh (``parallel/collectives.data_parallel``)
        ``batch`` is the rows of this rank's data slot, the returned loss is
        this rank's share of the global-batch loss (their sum over ranks is
        the global loss) and every log is the global value.  Under a model
        axis the classifier FCs in ``params`` may be this rank's class
        slices (``parallel/mesh.param_shardings``); the CE and the CRM then
        reduce over the model group, and ``labels_oh`` may be the full
        one-hot or this rank's class slice of it.
        """
        features, logits, updates = self._features(
            params, state, batch['data'], train=True,
            dropout_mask=dropout_mask, generator=generator)
        labels = batch['labels_int32']
        labels_oh = batch['labels_oh']
        if self.fpn_spec is not None:
            # level-major batch concat: the labels tiled FPN_NUM times
            n = self.fpn_spec['fpn_num']
            labels = labels.repeat(n)
            labels_oh = labels_oh.repeat(n, 1)
        # under a mesh each rank's loss is its share of the global batch's
        # (parallel/collectives.py, the rule): per-sample sums over the
        # global count (the data group's rows), every term a model group
        # computes alike over n_model, and the triplet term (computed in
        # full on every rank over the features gathered over the data
        # group) over the world size
        n_data, n_model = collectives.data_size(), collectives.model_size()
        denom = None if n_data == 1 else labels.shape[0] * n_data
        fc_sharded = (params[self.head_param_prefix + '_fc_w'].shape[-1]
                      < self.head_spec['num_logits'])
        ce, acc = loss_lib.softmax_ce_losses(logits, labels, denom,
                                             sharded=fc_sharded)
        total = torch.sum(ce)
        logs = {'accuracy_cls': torch.mean(acc)}
        # per-combo logs in reference blob naming ({prefix}_loss/_accuracy)
        combos = self.head_spec['combos']
        for r, (prefix, _) in enumerate(combos):
            logs[prefix + '_loss'] = ce[r]
            logs[prefix + '_accuracy'] = acc[r]

        if self.use_crm:
            crm_sharded = (params['crm_fc8c_w'].shape[-1]
                           < self.head_spec['num_logits'])
            if crm_sharded:
                labels_oh = self._class_slice(labels_oh,
                                              params['crm_fc8c_w'])
            probs = head_lib.apply_crm(params, features, sharded=crm_sharded)
            crm, crm_acc = loss_lib.crm_loss(probs, labels_oh, labels, denom,
                                             sharded=crm_sharded)
            total = total + crm
            logs['crm_loss'] = crm
            logs['crm_accuracy'] = crm_acc
        if n_model > 1:
            total = total / n_model

        global_logs = {}
        if self.use_triplet:
            mrc, ap_mean, an_mean = loss_lib.triplet_losses(
                collectives.all_gather(features),
                collectives.all_gather(labels),
                normalize=self.normalize_feature)
            tri = (mrc * loss_scale_factor if self.cfg.REID.TRIPLET_LOSS_CROSS
                   else mrc)
            total = total + loss_lib.TRIPLET_WEIGHT * torch.sum(tri) / (
                n_data * n_model)
            for r, (prefix, _) in enumerate(combos):
                global_logs[prefix + '_triplet_loss'] = tri[r]
                global_logs[prefix + '_dist_ap_mean'] = ap_mean[r]
                global_logs[prefix + '_dist_an_mean'] = an_mean[r]

        logs['loss'] = total
        if n_data * n_model > 1:
            # the shares summed over every rank (the class terms' 1/n_model
            # undone first, so each log is the global value): one
            # collective for every log
            keys = list(logs)
            vals = collectives.all_reduce(torch.stack(
                [logs[k].detach().reshape(()) * (1 if k == 'loss' else
                                                 1.0 / n_model)
                 for k in keys]), axis='world')
            logs = dict(zip(keys, vals.unbind(0)))
        logs.update(global_logs)
        return total, (updates, logs)

    def _class_slice(self, labels_oh, w):
        """This rank's class slice of a full one-hot [B, K]; a slice
        already (``parallel/train_step.shard_batch``) passes as it is."""
        k_local = w.shape[-1]
        if labels_oh.shape[-1] == k_local:
            return labels_oh
        lo = collectives.active().model_index * k_local
        return labels_oh[:, lo:lo + k_local]


def build_model(cfg, device=None):
    """The model for ``cfg`` on ``device`` (default CUDA; raises without
    one unless ``device='cpu'``)."""
    assert cfg.MODEL.TYPE == 'generalized_reid', (
        'only the live re-ID path is supported; got MODEL.TYPE={}'.format(
            cfg.MODEL.TYPE))
    return ReIDModel(cfg, device=device)
