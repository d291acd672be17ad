"""Plain float32 bottom-up-attention Faster R-CNN training, the benchmark's
reference for the detector cell.

Written from the published description: Anderson et al., "Bottom-Up and
Top-Down Attention for Image Captioning and Visual Question Answering"
(arXiv:1707.07998), the configuration of MILVLG/bottom-up-attention.pytorch
(``configs/bua-caffe/extract-bua-caffe-r101.yaml``) and detectron2's
Faster R-CNN training rules, as functions of a dict of parameters under
detectron2's key names (the released checkpoint's):

- Caffe ResNet-101 through res4, stride 16: a 7×7/2 stem and 3×3/2 max
  pool, bottlenecks whose stride sits on the first 1×1, every batch norm a
  frozen affine (``x · weight + bias`` a channel);
- the RPN head: 3×3 convolution of 512 channels and ReLU, then two
  objectness logits (background, foreground; Caffe's two-way softmax) and
  four box deltas for each of 12 anchors a cell: py-faster-rcnn's anchors
  of stride 16, scales 4 / 8 / 16 / 32 × ratios 0.5 / 1 / 2;
- detectron2's ROIAlign (``aligned=True``, sampling ratio 2) on res4 as
  four bilinear gathers a sample;
- res5 (3 bottlenecks, stride 1, dilation 2) on each ROI, averaged over
  its 14 × 14 map; the 1601-way classifier, 1601 × 4 box deltas and the
  attribute head (the feature beside the embedding of the top foreground
  class, 512 wide, ReLU, 401 ways);
- matching: an anchor is positive at IoU ≥ 0.7 with its best ground
  truth, negative under 0.3, and each ground truth's best anchors are
  positive; a proposal is foreground at IoU ≥ 0.5 and takes its best
  ground truth's class (background 0, classes from 1). Sampling, per
  image, with dynamic index sets: 64 a set, the positives up to half of
  them, then negatives for the rest;
- losses: the RPN's objectness cross-entropy and smooth-L1 (β = 1/9) box
  loss over the sampled anchors; the ROI class cross-entropy, the smooth-L1
  of the ground-truth class's deltas on the sampled foreground and the
  attribute cross-entropy on the sampled foreground that has an attribute,
  each over its sampled count; boxes encoded as detectron2's
  ``Box2BoxTransform`` with weights (1, 1, 1, 1);
- the optimizer: ``optax.chain(clip_by_global_norm(5.0), sgd(lr,
  momentum=0.9))`` written out, a leaf at a time.

The weights are its own: :func:`param_spec` lists every parameter's name
and shape from the configuration's published widths (``stem_out_channels``,
``res2_out_channels``, ``width_per_group``, ``res5_dilation``,
``rpn_channels``, ``num_classes``, ``cls_embed_dim``, ``attr_hidden_dim``,
``num_attributes``) and :func:`make_weights` draws them from the seed. The
benchmark loads them into the program by name and shape, so a width the
program builds otherwise fails there.

It imports nothing of the program and has no kernels. Departures, each the
program's training recipe:

- the ROI training proposals are the ground truth plus jittered copies
  (the valid boxes cycled to 64, each coordinate moved by a uniform in
  [−0.1, 0.1) of the box's width or height), not NMS-filtered RPN
  proposals;
- the frozen batch norms and the stem are trained (every parameter has a
  gradient);
- one attribute an instance (single-label cross-entropy);
- ROIAlign, not ROIPool, inside the step;
- the sampled members of a set are those of highest uniform, from the
  step's three draws (a uniform an anchor, a uniform a proposal, the
  jitter), drawn from the step's generator in that order;
- the ROI losses take ``log(max(p, 1e-9))`` of the heads' softmax as
  their logits (a softmax cross-entropy over them): where a probability
  is clipped, the renormalisation passes a gradient to every class.

``precision("tf32")`` runs every product and convolution with TF32
allowed, and ``fault="detached_pool"`` drops the gradient that reaches the
res4 map from the ROI stage: the controls that must read as not correct
(``portbench/calibrate.py``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.train import leaf_norms, step_generator

STAGES = {101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
# the deviation of a standard normal truncated at ±2
TRUNCATED_STD = 0.87962566103423978
LOSS_KEYS = ("rpn_objectness", "rpn_box", "roi_cls", "roi_box", "roi_attr")
DECISION_KEYS = ("anchor_labels", "anchor_sampled", "proposal_labels",
                 "proposal_sampled")
SMOOTH_L1_BETA = 1.0 / 9.0
BATCH_PER_IMAGE = 64
POSITIVE_FRACTION = 0.5


@contextlib.contextmanager
def precision(kind: str = "float32"):
    """Convolutions and products in float32 (TF32 off) or with TF32 on
    (``"tf32"``), with cuDNN's deterministic algorithms and no autotuning;
    the previous settings are restored after the block."""
    if kind not in ("float32", "tf32"):
        raise ValueError("no precision %r" % kind)
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
           b.cudnn.deterministic, b.cudnn.benchmark)
    tf32 = kind == "tf32"
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = old


# ------------------------------------------------------------------ network

def stages(cfg: dict) -> List[tuple]:
    """(name, blocks, in, out, bottleneck, stride, dilation) of res2-res5
    from the configuration's published widths: each stage twice the
    previous one's width; res2 stride 1, res3 and res4 stride 2, res5 on
    the ROIs at ``res5_dilation`` (stride 1 where it dilates)."""
    names = ("backbone.res2", "backbone.res3", "backbone.res4",
             "roi_heads.res5")
    cin, out, mid = (cfg["stem_out_channels"], cfg["res2_out_channels"],
                     cfg["width_per_group"])
    rows = []
    for i, (name, blocks) in enumerate(zip(names, STAGES[cfg["depth"]])):
        dilation = cfg["res5_dilation"] if i == 3 else 1
        stride = 1 if i == 0 or dilation > 1 else 2
        rows.append((name, blocks, cin, out << i, mid << i, stride,
                     dilation))
        cin = out << i
    return rows


def param_spec(cfg: dict) -> List[tuple]:
    """(name, shape, init) of every parameter of the detector under
    detectron2's key names, from the configuration's widths; init one of
    ``lecun`` (a convolution's or Linear's weight), ``embed`` (the class
    embedding), ``zeros``, ``ones``."""
    spec = []

    def conv_norm(name, cout, cin, k):
        spec.extend([(name + ".weight", (cout, cin, k, k), "lecun"),
                     (name + ".norm.weight", (cout,), "ones"),
                     (name + ".norm.bias", (cout,), "zeros")])

    def layer(name, shape):
        spec.extend([(name + ".weight", shape, "lecun"),
                     (name + ".bias", shape[:1], "zeros")])

    conv_norm("backbone.stem.conv1", cfg["stem_out_channels"], 3, 7)
    for name, blocks, cin, cout, mid, _, _ in stages(cfg):
        for i in range(blocks):
            p = "%s.%d" % (name, i)
            if i == 0:
                conv_norm(p + ".shortcut", cout, cin, 1)
            conv_norm(p + ".conv1", mid, cin if i == 0 else cout, 1)
            conv_norm(p + ".conv2", mid, mid, 3)
            conv_norm(p + ".conv3", cout, mid, 1)
    A = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    c, feat = cfg["rpn_channels"], stages(cfg)[2][3]
    p = "proposal_generator.rpn_head."
    layer(p + "conv", (c, feat, 3, 3))
    layer(p + "objectness_logits", (2 * A, c, 1, 1))
    layer(p + "anchor_deltas", (4 * A, c, 1, 1))
    k, top = cfg["num_classes"], stages(cfg)[3][3]
    emb, hid = cfg["cls_embed_dim"], cfg["attr_hidden_dim"]
    p = "roi_heads.box_predictor."
    layer(p + "cls_score", (k, top))
    layer(p + "bbox_pred", (4 * k, top))
    spec.append((p + "cls_embedding.weight", (k, emb), "embed"))
    layer(p + "attr_linear1", (hid, top + emb))
    layer(p + "attr_linear2", (cfg["num_attributes"], hid))
    return spec


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed``, by :func:`param_spec`, from one generator
    on ``device``: every convolution and Linear weight lecun-normal (a
    normal truncated at two deviations, rescaled to variance 1 / fan_in:
    flax's initializer) from one uniform draw, sliced in spec order; then
    the class embedding normal of deviation 1 / √width; zero biases, unit
    frozen batch norms; then each weight the configuration's
    ``decision_scale`` names multiplied by its factor. The same seed gives
    the same weights."""
    spec = param_spec(cfg)
    g = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    n = sum(math.prod(s) for _, s, k in spec if k == "lecun")
    # a uniform u to the normal truncated at ±2: √2 · erfinv((2u − 1)·erf(√2))
    flat = torch.rand(n, generator=g, device=device)
    flat = torch.erfinv(flat.mul_(2.0).sub_(1.0).mul_(math.erf(math.sqrt(
        2.0)))).mul_(math.sqrt(2.0) / TRUNCATED_STD)
    out, off = {}, 0
    for name, shape, kind in spec:
        if kind == "lecun":
            size = math.prod(shape)
            out[name] = flat[off:off + size].view(shape).mul_(
                math.sqrt(1.0 / math.prod(shape[1:])))
            off += size
        elif kind == "embed":
            out[name] = torch.randn(shape, generator=g, device=device).mul_(
                1.0 / math.sqrt(shape[1]))
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    for name, factor in cfg["decision_scale"].items():
        out[name].mul_(factor)
    return out


def _conv_norm(w, x, name, stride=1, padding=0, dilation=1):
    y = F.conv2d(x, w[name + ".weight"], None, stride, padding, dilation)
    return (y * w[name + ".norm.weight"][:, None, None]
            + w[name + ".norm.bias"][:, None, None])


def _bottleneck(w, x, name, stride, dilation):
    if name + ".shortcut.weight" in w:
        shortcut = _conv_norm(w, x, name + ".shortcut", stride)
    else:
        shortcut = x
    y = F.relu(_conv_norm(w, x, name + ".conv1", stride))
    y = F.relu(_conv_norm(w, y, name + ".conv2", 1, dilation, dilation))
    return F.relu(_conv_norm(w, y, name + ".conv3") + shortcut)


def _stage(w, x, row):
    name, blocks, _, _, _, stride, dilation = row
    for i in range(blocks):
        x = _bottleneck(w, x, "%s.%d" % (name, i), stride if i == 0 else 1,
                        dilation)
    return x


def backbone(w, images, cfg: dict):
    """images [1, 3, H, W] → the res4 map [1, 1024, H/16, W/16]."""
    x = F.relu(_conv_norm(w, images, "backbone.stem.conv1", 2, 3))
    x = F.max_pool2d(x, 3, 2, 1)
    for row in stages(cfg)[:3]:
        x = _stage(w, x, row)
    return x


def rpn_head(w, feat):
    p = "proposal_generator.rpn_head."
    t = F.relu(F.conv2d(feat, w[p + "conv.weight"], w[p + "conv.bias"],
                        padding=1))
    return (F.conv2d(t, w[p + "objectness_logits.weight"],
                     w[p + "objectness_logits.bias"]),
            F.conv2d(t, w[p + "anchor_deltas.weight"],
                     w[p + "anchor_deltas.bias"]))


def roi_heads(w, pooled, cfg: dict) -> dict:
    """pooled [R, 1024, 14, 14] → class and attribute probabilities, box
    deltas."""
    x = _stage(w, pooled, stages(cfg)[3])
    feats = x.mean(dim=(2, 3))
    p = "roi_heads.box_predictor."
    cls_prob = torch.softmax(F.linear(feats, w[p + "cls_score.weight"],
                                      w[p + "cls_score.bias"]), dim=-1)
    deltas = F.linear(feats, w[p + "bbox_pred.weight"],
                      w[p + "bbox_pred.bias"])
    top = torch.argmax(cls_prob[:, 1:], dim=-1) + 1
    a = torch.cat([feats, w[p + "cls_embedding.weight"][top]], dim=-1)
    a = F.relu(F.linear(a, w[p + "attr_linear1.weight"],
                        w[p + "attr_linear1.bias"]))
    attr_prob = torch.softmax(F.linear(a, w[p + "attr_linear2.weight"],
                                       w[p + "attr_linear2.bias"]), dim=-1)
    return {"cls_prob": cls_prob, "bbox_deltas": deltas,
            "attr_prob": attr_prob}


# ------------------------------------------------------------ boxes, ROIAlign

def anchors(cfg: dict, feat_h: int, feat_w: int) -> np.ndarray:
    """py-faster-rcnn's ``generate_anchors`` around the base box
    [0, 0, stride − 1, stride − 1] (ratios first, then scales), shifted
    by the stride over the map, cell by cell in row-major order:
    [feat_h · feat_w · A, 4] in image coordinates."""
    base = cfg["anchor_base"]
    ctr = 0.5 * (base - 1)
    cell = []
    for ratio in cfg["anchor_ratios"]:
        ws = np.round(np.sqrt(base * base / ratio))
        hs = np.round(ws * ratio)
        for scale in cfg["anchor_scales"]:
            w, h = ws * scale, hs * scale
            cell.append([ctr - 0.5 * (w - 1), ctr - 0.5 * (h - 1),
                         ctr + 0.5 * (w - 1), ctr + 0.5 * (h - 1)])
    cell = np.asarray(cell)
    sy, sx = np.meshgrid(np.arange(feat_h) * base, np.arange(feat_w) * base,
                         indexing="ij")
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4).astype(np.float32)


def iou(a, b):
    """detectron2's ``pairwise_iou`` of xyxy boxes [N, 4] × [M, 4]."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    wh = (torch.min(a[:, None, 2:], b[None, :, 2:])
          - torch.max(a[:, None, :2], b[None, :, :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return torch.where(inter > 0, inter / (area_a[:, None] + area_b - inter),
                       torch.zeros_like(inter))


def encode(src, dst):
    """detectron2 ``Box2BoxTransform.get_deltas``, weights (1, 1, 1, 1)."""
    sw, sh = src[:, 2] - src[:, 0], src[:, 3] - src[:, 1]
    dw, dh = dst[:, 2] - dst[:, 0], dst[:, 3] - dst[:, 1]
    return torch.stack([
        (dst[:, 0] + 0.5 * dw - (src[:, 0] + 0.5 * sw)) / sw,
        (dst[:, 1] + 0.5 * dh - (src[:, 1] + 0.5 * sh)) / sh,
        torch.log(dw / sw), torch.log(dh / sh)], dim=1)


def smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < SMOOTH_L1_BETA, 0.5 * x * x / SMOOTH_L1_BETA,
                       ax - 0.5 * SMOOTH_L1_BETA)


def roi_align(feat, rois, scale: float, size: int, sampling_ratio: int = 2):
    """detectron2's ``ROIAlign(aligned=True)`` of ``feat`` [C, H, W] over
    ``rois`` [R, 4] (image coordinates) → [R, C, size, size]: each bin the
    mean of sampling_ratio² bilinear samples; a sample more than a pixel
    outside the map reads 0, one inside the border clamps to it."""
    C, H, W = feat.shape
    n = size * sampling_ratio
    grid = torch.arange(size, dtype=feat.dtype, device=feat.device)
    sub = torch.arange(sampling_ratio, dtype=feat.dtype,
                       device=feat.device) + 0.5

    def samples(lo, hi, extent):
        start, end = lo * scale - 0.5, hi * scale - 0.5
        bin_size = ((end - start) / size)[:, None, None]
        pos = (start[:, None, None] + grid[None, :, None] * bin_size
               + sub[None, None, :] * bin_size / sampling_ratio)
        pos = pos.reshape(-1, n)                              # [R, n]
        outside = (pos < -1.0) | (pos > extent)
        pos = pos.clamp(min=0.0)
        low = pos.floor().long()
        at_end = low >= extent - 1
        low = torch.where(at_end, torch.full_like(low, extent - 1), low)
        high = torch.where(at_end, low, low + 1)
        pos = torch.where(at_end, low.to(pos.dtype), pos)
        frac = pos - low
        return outside, low, high, frac

    out_y, y0, y1, ly = samples(rois[:, 1], rois[:, 3], H)
    out_x, x0, x1, lx = samples(rois[:, 0], rois[:, 2], W)
    flat = feat.reshape(C, H * W)

    def gather(ys, xs):                                       # [C, R, n, n]
        return flat[:, (ys[:, :, None] * W + xs[:, None, :])]

    hy, ly = (1.0 - ly)[:, :, None], ly[:, :, None]
    hx, lx = (1.0 - lx)[:, None, :], lx[:, None, :]
    v = (hy * hx * gather(y0, x0) + hy * lx * gather(y0, x1)
         + ly * hx * gather(y1, x0) + ly * lx * gather(y1, x1))
    v = torch.where(out_y[:, :, None] | out_x[:, None, :],
                    torch.zeros_like(v), v)
    R = rois.shape[0]
    v = v.reshape(C, R, size, sampling_ratio, size, sampling_ratio)
    v = v.sum(dim=(3, 5)) / float(sampling_ratio * sampling_ratio)
    return v.permute(1, 0, 2, 3)


# ----------------------------------------------------- matching and sampling

def sample(labels, uniform):
    """(positive, negative) indices of a set: of the positives (label 1)
    those of highest uniform, up to half of 64; of the negatives (label 0)
    those of highest uniform, up to 64 less the positives taken."""
    pos = torch.nonzero(labels == 1).flatten()
    neg = torch.nonzero(labels == 0).flatten()
    n_pos = min(pos.numel(), int(BATCH_PER_IMAGE * POSITIVE_FRACTION))
    pos = pos[torch.argsort(uniform[pos], descending=True)[:n_pos]]
    n_neg = min(neg.numel(), BATCH_PER_IMAGE - n_pos)
    neg = neg[torch.argsort(uniform[neg], descending=True)[:n_neg]]
    return pos, neg


def anchor_labels(boxes, gt):
    """1 positive, 0 negative, −1 ignored; and each anchor's best ground
    truth."""
    q = iou(boxes, gt)                                        # [N, G]
    best, matched = q.max(dim=1)
    labels = torch.full_like(matched, -1)
    labels[best < 0.3] = 0
    labels[best >= 0.7] = 1
    # each ground truth's best anchors (ties included), where it overlaps
    top = q.max(dim=0).values
    low_quality = ((q == top[None, :]) & (top[None, :] > 0)).any(dim=1)
    labels[low_quality] = 1
    return labels, matched


def step_losses(w: dict, batch: dict, draws, cfg: dict,
                fault: Optional[str] = None):
    """The five losses of one image and the decisions they took."""
    dev = w["backbone.stem.conv1.weight"].device
    images = torch.as_tensor(np.asarray(batch["images"]), device=dev)
    mask = np.asarray(batch["gt_mask"]).astype(bool)
    gt = torch.as_tensor(np.asarray(batch["gt_boxes"])[mask], device=dev)
    gt_cls = torch.as_tensor(np.asarray(batch["gt_classes"])[mask],
                             device=dev).long()
    gt_attr = torch.as_tensor(np.asarray(batch["gt_attrs"])[mask],
                              device=dev).long()
    rpn_u, roi_u, jitter = draws

    feat = backbone(w, images.permute(0, 3, 1, 2).contiguous(), cfg)
    obj, deltas = rpn_head(w, feat)
    A = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    fh, fw = feat.shape[2:]
    # per cell, anchor by anchor: (bg, fg) logits and 4 deltas
    obj = obj[0].permute(1, 2, 0).reshape(fh * fw, 2, A)
    obj = obj.permute(0, 2, 1).reshape(-1, 2)
    deltas = deltas[0].permute(1, 2, 0).reshape(-1, 4)
    boxes = torch.as_tensor(anchors(cfg, fh, fw), device=dev)

    labels, matched = anchor_labels(boxes, gt)
    pos, neg = sample(labels, rpn_u)
    chosen = torch.cat([pos, neg])
    n = max(chosen.numel(), 1)
    losses = {"rpn_objectness": F.cross_entropy(
        obj[chosen], (labels[chosen] == 1).long(), reduction="sum") / n}
    target = encode(boxes[pos], gt[matched[pos]])
    losses["rpn_box"] = smooth_l1(deltas[pos] - target).sum() / n
    a_sampled = torch.zeros_like(labels, dtype=torch.bool)
    a_sampled[chosen] = True

    # the proposals: the ground truth cycled to P, each side jittered
    P = jitter.shape[0]
    base = gt[torch.arange(P, device=dev) % gt.shape[0]]
    w_, h_ = base[:, 2] - base[:, 0], base[:, 3] - base[:, 1]
    props = base + jitter * torch.stack([w_, h_, w_, h_], dim=1)
    R = cfg["pooler_resolution"]
    source = feat[0].detach() if fault == "detached_pool" else feat[0]
    pooled = roi_align(source, props, 1.0 / cfg["anchor_base"], R)
    out = roi_heads(w, pooled, cfg)

    q = iou(props, gt)
    best, best_gt = q.max(dim=1)
    fg = best >= 0.5
    cls = torch.where(fg, gt_cls[best_gt] + 1, torch.zeros_like(best_gt))
    pos, neg = sample(fg.long(), roi_u)
    chosen = torch.cat([pos, neg])
    n = max(chosen.numel(), 1)
    logp = F.log_softmax(torch.log(out["cls_prob"].clamp(1e-9, 1.0)), -1)
    losses["roi_cls"] = -logp[chosen, cls[chosen]].sum() / n
    picked = out["bbox_deltas"].reshape(P, -1, 4)[pos, cls[pos]]
    target = encode(props[pos], gt[best_gt[pos]])
    losses["roi_box"] = smooth_l1(picked - target).sum() / n
    attr = gt_attr[best_gt[pos]]
    has = pos[attr >= 0]
    alogp = F.log_softmax(torch.log(out["attr_prob"].clamp(1e-9, 1.0)),
                          -1)
    losses["roi_attr"] = (-alogp[has, gt_attr[best_gt[has]] + 1].sum()
                          / max(has.numel(), 1))
    p_sampled = torch.zeros_like(fg)
    p_sampled[chosen] = True
    decisions = {"anchor_labels": labels, "anchor_sampled": a_sampled,
                 "proposal_labels": cls, "proposal_sampled": p_sampled}
    return losses, decisions


def draw(n_anchors: int, num_proposals: int, jitter: float, generator,
         device):
    """The step's three draws from its generator: a uniform an anchor, a
    uniform a proposal, the jitter [P, 4] in [−jitter, jitter)."""
    rpn = torch.rand(n_anchors, generator=generator, device=device)
    roi = torch.rand(num_proposals, generator=generator, device=device)
    noise = torch.rand((num_proposals, 4), generator=generator,
                       device=device)
    return rpn, roi, noise * (2.0 * jitter) - jitter


def feat_size(n: int) -> int:
    """A side of the res4 map: four stride-2 steps, each rounding up."""
    for _ in range(4):
        n = (n + 1) // 2
    return n


# -------------------------------------------------------------- the steps

def sgd_step(w: dict, grads: dict, trace: dict, train: dict) -> None:
    """``optax.chain(clip_by_global_norm(max_grad_norm), sgd(lr,
    momentum))`` on ``w`` in place: the gradients scaled by
    ``max_grad_norm / norm`` where their global norm reaches it, the
    momentum trace ``g + momentum · trace``, the weights less ``lr`` times
    the trace."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    clip = bool(norm >= train["max_grad_norm"])
    for name, g in grads.items():
        if clip:
            g = g / norm * train["max_grad_norm"]
        trace[name] = g + train["momentum"] * trace[name]
        w[name] -= train["lr"] * trace[name]


def train_steps(weights: Dict[str, torch.Tensor], batches: List[dict],
                seed: int, cfg: dict, train: dict, device,
                precision_kind: str = "float32",
                fault: Optional[str] = None) -> dict:
    """The run's first optimizer steps from ``weights`` (name → tensor),
    one image of ``batches`` a step, step ``i`` drawing from the recipe's
    generator of (``seed``, ``i``). Returns each step's five losses, the
    decisions of the first step, the norm of each leaf's first gradient as
    the optimizer took it (clipped: the momentum trace after one step) and
    of each leaf's change over the steps."""
    P, jit = train["num_proposals"], train["jitter"]
    A = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    with precision(precision_kind):
        w = {n: t.detach().to(device, torch.float32, copy=True)
             .requires_grad_(True) for n, t in weights.items()}
        trace = {n: torch.zeros_like(t) for n, t in w.items()}
        losses, decisions, grad = [], None, None
        for i, batch in enumerate(batches):
            h, wd = np.asarray(batch["images"]).shape[1:3]
            gen = step_generator(seed, i, device)
            draws = draw(feat_size(h) * feat_size(wd) * A, P, jit, gen,
                         device)
            parts, dec = step_losses(w, batch, draws, cfg, fault)
            names = list(w)
            grads = torch.autograd.grad(sum(parts[k] for k in LOSS_KEYS),
                                        [w[k] for k in names])
            with torch.no_grad():
                sgd_step(w, dict(zip(names, grads)), trace, train)
            losses.append([float(parts[k].detach()) for k in LOSS_KEYS])
            if i == 0:
                decisions = {k: v.cpu().numpy() for k, v in dec.items()}
                grad = leaf_norms(trace)
        delta = leaf_norms({n: w[n].detach() - weights[n].to(device)
                            for n in w})
    return {"loss": np.asarray(losses), "grad": grad, "delta": delta,
            **decisions}
