"""Plain float32 PyTorch reference of the PPS re-ID model (IJCAI 2019) on a
ResNet body: the forward pass, the three losses, momentum-SGD, the int8
serving body, and the test embedding.

It follows the published model (the reference's Market-1501 yaml) and
nothing of the program under test: parameters live in a flat dict under
the published blob names (``conv1_w``, ``res2_0_branch2a_bn_s``,
``pps_fc_w``, ``crm_fc8c_w``), convolution weights OIHW.  Every product
runs in float32 with TF32 off (``strict_float32``), whatever the program
does, unless ``body`` asks for the lower precision of a control:

* ``'fp8'``: each body conv as float8 training runs it: input and weight
  rounded to e4m3 on the forward pass, the output's gradient to e5m2 on
  the backward pass (per-tensor scales to the formats' largest values);
* the int8 serving body (``quantize_body``; ``bits=4`` for the int4
  control).

Departures from the published model: none in the arithmetic; the batch
statistics of train-mode BN are the biased variance ``E[x^2] - mean^2``
clamped at 0, as Caffe2's SpatialBN takes them.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
TRIPLET_WEIGHT = 0.14
TRIPLET_MARGIN = 1.4
DROPOUT = 0.2
LOG_THRESHOLD = 1e-20
DIFF_THRESHOLD = 1e4
NEW_PARAM_MARKERS = ('bpm', 'apm', 'crm', 'ekc', 'pps', 'youtu')
BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
# rows of each strip of a 24-row map (input height 384), the published table
STRIP_ROWS = {5: (5, 5, 4, 5, 5)}


def strict_float32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Spec:
    """The static shape of the model, from a configuration's sizes."""

    def __init__(self, depth=50, num_classes=752, strips=5, bpm_dim=128,
                 res5_stride=1, height=384, width=128, lr_scale_new=10.0,
                 lr_scale_new_fc=10.0, weight_decay=0.0005, momentum=0.9):
        self.depth = depth
        self.num_logits = num_classes - 1
        self.strips = strips
        self.bpm_dim = bpm_dim
        self.height, self.width = height, width
        self.stages = [('res2', BLOCKS[depth][0], 256, 64, 1),
                       ('res3', BLOCKS[depth][1], 512, 128, 2),
                       ('res4', BLOCKS[depth][2], 1024, 256, 2),
                       ('res5', BLOCKS[depth][3], 2048, 512, res5_stride)]
        self.map_rows = height // (16 * res5_stride)
        self.combos = [tuple(j for j in range(strips) if i & (1 << j))
                       for i in range(1, 1 << strips)]
        self.lr_scale_new = lr_scale_new
        self.lr_scale_new_fc = lr_scale_new_fc
        self.weight_decay = weight_decay
        self.momentum = momentum

    @property
    def embedding_dim(self):
        return len(self.combos) * self.bpm_dim

    def strip_rows(self):
        if self.strips in STRIP_ROWS and self.height == 384:
            return STRIP_ROWS[self.strips]
        return (self.map_rows // self.strips,) * self.strips

    def convs(self):
        """[(name, c_out, c_in, k, stride)] of every body conv, in order;
        ``name`` + '_w' is its weight, its BN is ``res_conv1_bn`` for the
        stem and ``name + '_bn'`` elsewhere."""
        out = [('conv1', 64, 3, 7, 2)]
        dim_in = 64
        for stage, n, dim_out, inner, stride in self.stages:
            for i in range(n):
                p = '{}_{}'.format(stage, i)
                s = stride if i == 0 else 1
                if i == 0:
                    out.append((p + '_branch1', dim_out, dim_in, 1, s))
                out.append((p + '_branch2a', inner, dim_in, 1, s))
                out.append((p + '_branch2b', inner, inner, 3, 1))
                out.append((p + '_branch2c', dim_out, inner, 1, 1))
                dim_in = dim_out
        return out

    def leaves(self):
        """[(name, shape, init)] of every parameter; init is ('normal',
        std), ('uniform', limit), ('zeros',) or ('ones',)."""
        out = []
        for name, c_out, c_in, k, _ in self.convs():
            out.append((name + '_w', (c_out, c_in, k, k),
                        ('normal', math.sqrt(2.0 / (k * k * c_out)))))
            bn = bn_name(name)
            out += [(bn + '_s', (c_out,), ('ones',)),
                    (bn + '_b', (c_out,), ('zeros',))]
        r, d, k = len(self.combos), self.bpm_dim, self.num_logits
        out += [('pps_conv_w', (r, 2048, d), ('normal', math.sqrt(2.0 / d))),
                ('pps_conv_b', (r, d), ('zeros',)),
                ('pps_bn_s', (r, d), ('ones',)),
                ('pps_bn_b', (r, d), ('zeros',)),
                ('pps_fc_w', (r, d, k), ('normal', 0.001)),
                ('pps_fc_b', (r, k), ('zeros',))]
        lim = math.sqrt(3.0 / d)
        for fc in ('crm_fc8c', 'crm_fc8d'):
            out += [(fc + '_w', (d, k), ('uniform', lim)),
                    (fc + '_b', (k,), ('zeros',))]
        return out

    def bn_state(self):
        """[(name, shape)] of the running statistics (``*_rm``/``*_riv``)."""
        out = []
        for name, c_out, _, _, _ in self.convs():
            out.append((bn_name(name), (c_out,)))
        out.append(('pps_bn', (len(self.combos), self.bpm_dim)))
        return out


def bn_name(conv):
    return 'res_conv1_bn' if conv == 'conv1' else conv + '_bn'


# ---------------------------------------------------------------------------
# input: flip, erasing, mean subtraction, cv2-style bicubic resize
# ---------------------------------------------------------------------------


def bicubic_matrix(in_size, out_size, a=-0.75):
    """[out, in] float32 matrix of cv2's INTER_CUBIC resize: source
    position (o + 0.5) * in / out - 0.5, Keys' kernel, edges replicated."""
    def keys(d):
        d = abs(d)
        if d <= 1:
            return (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1
        if d < 2:
            return a * (d ** 3 - 5 * d ** 2 + 8 * d - 4)
        return 0.0
    m = np.zeros((out_size, in_size))
    for o in range(out_size):
        src = (o + 0.5) * in_size / out_size - 0.5
        i0 = math.floor(src)
        for tap in range(-1, 3):
            m[o, min(max(i0 + tap, 0), in_size - 1)] += keys(tap - (src - i0))
    return torch.tensor(m, dtype=torch.float32)


def preprocess(u8, means, out_hw):
    """uint8 BGR [B, h, w, 3] -> float32 NCHW [B, 3, H, W]: minus the
    pixel means, then the bicubic resize."""
    x = u8.float() - torch.as_tensor(means, dtype=torch.float32,
                                     device=u8.device)
    rh = bicubic_matrix(u8.shape[1], out_hw[0]).to(u8.device)
    rw = bicubic_matrix(u8.shape[2], out_hw[1]).to(u8.device)
    x = torch.einsum('Hh,bhwc->bHwc', rh, x)
    x = torch.einsum('Ww,bHwc->bHWc', rw, x)
    return x.permute(0, 3, 1, 2).contiguous()


def augment(u8, flipped, draws, means, out_hw):
    """The training input: flip, random erasing (the box filled with the
    uint8 truncation of the means), then ``preprocess``.  ``draws`` holds
    [B] tensors ``erase_on``, ``er_y``, ``er_x``, ``er_h``, ``er_w``."""
    x = torch.where(flipped[:, None, None, None], torch.flip(u8, (2,)), u8)
    rows = torch.arange(x.shape[1], device=x.device)[None]
    cols = torch.arange(x.shape[2], device=x.device)[None]
    y0, x0 = draws['er_y'][:, None], draws['er_x'][:, None]
    inside = (((rows >= y0) & (rows < y0 + draws['er_h'][:, None]))[:, :, None]
              & ((cols >= x0) & (cols < x0 + draws['er_w'][:, None]))[:, None])
    inside = inside & draws['erase_on'][:, None, None]
    fill = torch.as_tensor(np.asarray(means).astype(np.uint8),
                           device=x.device)
    x = torch.where(inside[..., None], fill, x)
    return preprocess(x, means, out_hw)


# ---------------------------------------------------------------------------
# the body
# ---------------------------------------------------------------------------


def _fp8(x, dtype):
    """``x`` rounded to a float8 format at a per-tensor scale that maps its
    absmax to the format's largest value (bfloat16: no scale)."""
    if dtype == torch.bfloat16:
        return x.to(dtype).float()
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Conv(torch.autograd.Function):
    """A conv as float8 training runs it: input and weight in e4m3 on the
    forward pass, the output's gradient in e5m2 on the backward pass, every
    product summed in float32."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, low=torch.float8_e4m3fn,
                grad=torch.float8_e5m2):
        xq = _fp8(x, low)
        wq = _fp8(w, low)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, grad)
        return F.conv2d(xq, wq, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, grad = ctx.conf
        gq = _fp8(g, grad)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride=stride,
                                        padding=padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride=stride,
                                         padding=padding)
        return gx, gw, None, None, None, None


def conv(x, w, stride, body='f32'):
    k = w.shape[-1]
    if body == 'fp8':
        return _Fp8Conv.apply(x, w, stride, (k - 1) // 2)
    if body == 'bf16':
        return _Fp8Conv.apply(x, w, stride, (k - 1) // 2, torch.bfloat16,
                              torch.bfloat16)
    return F.conv2d(x, w, stride=stride, padding=(k - 1) // 2)


def bn_train(x, s, b):
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + BN_EPS) * s
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] + \
        b[None, :, None, None]


def bn_eval(x, s, b, rm, riv):
    inv = torch.rsqrt(riv + BN_EPS) * s
    return (x - rm[None, :, None, None]) * inv[None, :, None, None] + \
        b[None, :, None, None]


def conv_unit(x, p, st, name, stride, mode, body):
    """One conv and what follows it before the ReLU: train-mode BN
    (``mode`` 'train'), eval BN ('eval'), BN folded into the conv
    ('folded': ``p[name + '_q']`` holds ``w`` and ``fb``) or the int8 body
    ('int8': it holds ``wq``, ``xinv``, ``osc``, ``fb``, ``qmax``; see
    ``quantize_body``)."""
    if mode == 'folded':
        q = p[name + '_q']
        return F.conv2d(x, q['w'], stride=stride,
                        padding=(q['w'].shape[-1] - 1) // 2) + \
            q['fb'][None, :, None, None]
    if mode == 'int8':
        q = p[name + '_q']
        xq = torch.clamp(torch.round(x * q['xinv']), -q['qmax'], q['qmax'])
        acc = F.conv2d(xq, q['wq'], stride=stride,
                       padding=(q['wq'].shape[-1] - 1) // 2)
        return acc * q['osc'][None, :, None, None] + \
            q['fb'][None, :, None, None]
    y = conv(x, p[name + '_w'], stride, body)
    bn = bn_name(name)
    if mode == 'train':
        return bn_train(y, p[bn + '_s'], p[bn + '_b'])
    return bn_eval(y, p[bn + '_s'], p[bn + '_b'], st[bn + '_rm'],
                   st[bn + '_riv'])


def body_forward(spec, p, st, x, mode='train', body='f32', record=None):
    """The ResNet body on NCHW float32 input; returns the res5 map.
    ``record``: a dict that receives each conv's input absmax (over the
    whole tensor) under its name, for calibration."""
    def unit(x, name, stride):
        if record is not None:
            record[name] = max(record.get(name, 0.0),
                               float(x.detach().abs().amax()))
        return conv_unit(x, p, st, name, stride, mode, body)

    x = F.relu(unit(x, 'conv1', 2))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n, _, _, stride in spec.stages:
        for i in range(n):
            pre = '{}_{}'.format(stage, i)
            s = stride if i == 0 else 1
            short = unit(x, pre + '_branch1', s) if i == 0 else x
            y = F.relu(unit(x, pre + '_branch2a', s))
            y = F.relu(unit(y, pre + '_branch2b', 1))
            y = unit(y, pre + '_branch2c', 1)
            x = F.relu(y + short)
    return x


# ---------------------------------------------------------------------------
# the head and the losses
# ---------------------------------------------------------------------------


def combo_features(spec, feat):
    """[B, R, C]: per combination, the mean of its strips' average pools
    plus the max of their max pools."""
    aves, maxs, r0 = [], [], 0
    for rows in spec.strip_rows():
        s = feat[:, :, r0:r0 + rows]
        aves.append(s.mean(dim=(2, 3)))
        maxs.append(s.amax(dim=(2, 3)))
        r0 += rows
    out = []
    for members in spec.combos:
        ave = sum(aves[j] for j in members) / len(members)
        mx = maxs[members[0]]
        for j in members[1:]:
            mx = torch.maximum(mx, maxs[j])
        out.append(ave + mx)
    return torch.stack(out, dim=1)


def head(spec, p, st, combo, train, keep_mask=None):
    """(features [B, R, D] post-ReLU, logits [B, R, K])."""
    x = torch.einsum('brc,rcd->brd', combo, p['pps_conv_w']) + p['pps_conv_b']
    if train:
        mean = x.mean(dim=0)
        var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
    else:
        mean, var = st['pps_bn_rm'], st['pps_bn_riv']
    x = (x - mean) * (torch.rsqrt(var + BN_EPS) * p['pps_bn_s']) + \
        p['pps_bn_b']
    feats = F.relu(x)
    fc_in = feats
    if train:
        fc_in = torch.where(keep_mask, feats / (1.0 - DROPOUT), 0.0)
    logits = torch.einsum('brd,rdk->brk', fc_in, p['pps_fc_w']) + \
        p['pps_fc_b']
    return feats, logits


class _ClippedCE(torch.autograd.Function):
    """Caffe2's CrossEntropyWithLogits on probabilities: logs clipped at
    1e-20, the gradient clipped above at 1e4."""

    @staticmethod
    def forward(ctx, probs, onehot):
        ctx.save_for_backward(probs, onehot)
        p = torch.clamp(probs, min=LOG_THRESHOLD)
        q = torch.clamp(1.0 - probs, min=LOG_THRESHOLD)
        return -torch.sum(onehot * torch.log(p) + (1 - onehot) * torch.log(q)
                          ) / probs.shape[0]

    @staticmethod
    def backward(ctx, dy):
        probs, onehot = ctx.saved_tensors
        p = torch.clamp(probs, min=LOG_THRESHOLD)
        q = torch.clamp(1.0 - probs, min=LOG_THRESHOLD)
        g = dy * (-onehot / p + (1 - onehot) / q)
        return torch.clamp(g, max=DIFF_THRESHOLD) / probs.shape[0], None


def triplet(feats, labels, stats=None):
    """[R]: per combination, the batch-hard margin ranking loss over
    L2-normalised features; the gradient reaches only the hardest positive
    and negative of each row (the first on ties).  ``stats``, a dict,
    receives the mean hardest-positive and hardest-negative distances per
    combination ('ap', 'an': [R])."""
    x = feats.transpose(0, 1)
    x = x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-12)
    xx = (x * x).sum(-1, keepdim=True)
    d2 = xx + xx.transpose(1, 2) - 2.0 * torch.bmm(x, x.transpose(1, 2))
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    same = labels[:, None] == labels[None, :]
    pos = torch.where(same, dist, float('-inf'))
    neg = torch.where(same, float('inf'), dist)
    ap = torch.gather(pos, -1, pos.argmax(-1, keepdim=True))[..., 0]
    an = torch.gather(neg, -1, neg.argmin(-1, keepdim=True))[..., 0]
    ap = torch.clamp(ap, min=0.0)
    if stats is not None:
        stats['ap'], stats['an'] = ap.detach().mean(1), an.detach().mean(1)
    return F.relu(ap - an + TRIPLET_MARGIN).mean(1)


def loss(spec, p, images, labels, keep_mask, loss_scale, body='f32',
         stats=None):
    """The total training loss of one batch (NCHW float32 images);
    ``stats`` as ``triplet``'s."""
    feat = body_forward(spec, p, None, images, 'train', body)
    feats, logits = head(spec, p, None, combo_features(spec, feat), True,
                         keep_mask)
    lab = labels.long()
    ce = -torch.gather(F.log_softmax(logits, -1), 2,
                       lab[:, None, None].expand(-1, logits.shape[1], 1))
    total = ce[..., 0].mean(0).sum()
    a_cls = torch.softmax(feats @ p['crm_fc8c_w'] + p['crm_fc8c_b'], dim=2)
    a_det = torch.softmax(feats @ p['crm_fc8d_w'] + p['crm_fc8d_b'], dim=1)
    probs = (a_cls * a_det).sum(1)
    total = total + _ClippedCE.apply(
        probs, F.one_hot(lab, spec.num_logits).float())
    return total + TRIPLET_WEIGHT * (triplet(feats, labels, stats) *
                                     loss_scale).sum()


def lr_scale(spec, name):
    new = any(m in name for m in NEW_PARAM_MARKERS)
    if new and 'fc' in name:
        return spec.lr_scale_new_fc
    return spec.lr_scale_new if new or 'fpn' in name else 1.0


def effective_grads(spec, p, grads):
    """What momentum-SGD feeds its velocity before the LR: biases twice
    their gradient, every other leaf its gradient plus weight decay."""
    return {k: 2.0 * g if k.endswith('_b') else g + spec.weight_decay * p[k]
            for k, g in grads.items()}


def train_steps(spec, params, batches, body='f32'):
    """Momentum-SGD steps from ``params`` (zero velocity).  ``batches``:
    dicts of 'images' (NCHW float32), 'labels', 'keep_mask', 'lr',
    'loss_scale'.  Returns (losses, first effective gradients, params after
    the last step, the first step's triplet distances as ``triplet``'s
    ``stats``)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first, stats = [], None, {}
    for b in batches:
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        total = loss(spec, leaves, b['images'], b['labels'], b['keep_mask'],
                     b['loss_scale'], body, stats if first is None else None)
        names = list(leaves)
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        losses.append(float(total.detach()))
        with torch.no_grad():
            g = effective_grads(spec, p, dict(zip(names, grads)))
            if first is None:
                first = g
            for k in names:
                vel[k] = spec.momentum * vel[k] + \
                    b['lr'] * lr_scale(spec, k) * g[k]
                p[k] = p[k].detach() - vel[k]
    return losses, first, p, stats


# ---------------------------------------------------------------------------
# the test embedding and the int8 body
# ---------------------------------------------------------------------------


@torch.no_grad()
def embed(spec, p, st, images, mode='eval', body='f32'):
    """[B, R * D] L2-normalised test embeddings of NCHW float32 images."""
    feat = body_forward(spec, p, st, images, mode, body)
    feats, _ = head(spec, p, st, combo_features(spec, feat), False)
    e = feats.reshape(feats.shape[0], -1)
    return e / torch.clamp(e.norm(dim=1, keepdim=True), min=1e-12)


@torch.no_grad()
def quantize_body(spec, p, st, calib_images, bits=8, batch=64):
    """The int8 serving body, worked out from the float weights: BN folded
    into each body conv (``w * s / sqrt(riv + eps)``, bias ``b - rm * s /
    sqrt(riv + eps)``), one static input scale per conv from the absmax of
    its input over the calibration images run through the folded float32
    body, per-output-channel symmetric weights.  Returns a params dict for
    ``body_forward(mode='int8')`` (the head's params unchanged)."""
    qmax = float(2 ** (bits - 1) - 1)
    folded = dict(p)
    for name, *_ in spec.convs():
        bn = bn_name(name)
        inv = p[bn + '_s'] / torch.sqrt(st[bn + '_riv'].double() + BN_EPS
                                        ).float()
        folded[name + '_q'] = {
            'w': p[name + '_w'] * inv[:, None, None, None],
            'fb': p[bn + '_b'] - st[bn + '_rm'] * inv}
    amax = {}
    for i in range(0, calib_images.shape[0], batch):
        body_forward(spec, folded, st, calib_images[i:i + batch], 'folded',
                     record=amax)
    out = dict(p)
    for name, *_ in spec.convs():
        f = folded[name + '_q']
        s_x = max(amax[name], 1e-12) / qmax
        s_w = torch.clamp(f['w'].abs().amax(dim=(1, 2, 3)) / qmax, min=1e-12)
        out[name + '_q'] = {
            'wq': torch.clamp(torch.round(f['w'] / s_w[:, None, None, None]),
                              -qmax, qmax),
            'xinv': torch.tensor(1.0 / s_x, dtype=torch.float32,
                                 device=f['fb'].device),
            'osc': (s_w * s_x).float(), 'fb': f['fb'], 'qmax': qmax}
    return out
