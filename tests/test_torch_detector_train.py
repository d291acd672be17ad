"""The port's detector training against the JAX package, in one process on
the CPU, at the JAX test's small configuration (tests/test_detector_train.py:
depth 101, 7 classes, 6 attributes, pooler 7, 64 × 64 to 96 × 96 images, 8
or 16 proposals): the matching and the losses, ROIAlign's gradient, one
full train step on JAX's own draws, the clip + SGD-momentum chain, the VG
loader, ``vg_eval``, ``evaluate`` and the CLI.

The weights go across through ``detector_state_from_jax``, with the
decision layers rescaled as in tests/test_torch_detector.py: the random
stack's outputs are in the hundreds, and every softmax would saturate. The
train step's comparison first asserts the decisions it takes have margin:
the same anchor and proposal labels in both frameworks, the heads'
probabilities away from the ``log(clip(p, 1e-9, 1))`` edges, and a top-2
gap in ``cls_prob[:, 1:]`` (the argmax that picks the attribute head's
class embedding)."""
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meme_challenge_tpu.extract import detector as jd
from meme_challenge_tpu.extract import detector_train as jt
from meme_challenge_tpu.extract import train_detector as jtd
from meme_challenge_tpu.extract import vg_data as jvg
from meme_challenge_tpu.extract import vg_eval as jve
from meme_challenge_tpu.extract.ops import roi_align_jax
from meme_challenge_tpu.train.steps import TrainState
from meme_challenge_tpu_torch.extract import detector as td
from meme_challenge_tpu_torch.extract import resnet
from meme_challenge_tpu_torch.extract import detector_train as tt
from meme_challenge_tpu_torch.extract import train_detector as ttd
from meme_challenge_tpu_torch.extract import vg_data as tvg
from meme_challenge_tpu_torch.extract import vg_eval as tve
from meme_challenge_tpu_torch.extract.convert_detector import (
    detector_state_from_jax,
    load_detector_weights,
)
from meme_challenge_tpu_torch.extract.ops import roi_align

SMALL = dict(depth=101, num_classes=7, num_attributes=6,
             pooler_resolution=7, min_size=64, max_size=96)
# the same weights serve evaluation: fewer proposals, all of them kept
EVAL = dict(SMALL, post_nms_topk=20, min_boxes=3,
            max_boxes=20, conf_thresh=0.0)
DECISION_SCALE = {("rpn", "objectness"): 0.02,
                  ("rpn", "anchor_deltas"): 0.001,
                  ("roi_head", "bbox_pred"): 0.001,
                  ("roi_head", "cls_score"): 0.002,
                  ("roi_head", "attr_score"): 0.002}
LOSS_TOL = 1e-5     # relative, each loss part
UPDATE_TOL = 1e-4   # of each leaf's largest change
NUM_PROPOSALS = 16
LR = 1e-3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (tests/test_torch_detector.py: several test
    workers share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    """One flax init at the small configuration (numpy leaves), with the
    decision layers rescaled."""
    init = jax.jit(jd.init_detector_params, static_argnums=(0, 2))
    tree = jax.tree_util.tree_map(
        np.asarray, init(jd.DetectorConfig(**SMALL), jax.random.PRNGKey(0),
                         (64, 64)))
    for (mod, leaf), factor in DECISION_SCALE.items():
        tree[mod][leaf]["kernel"] = tree[mod][leaf]["kernel"] * factor
    return tree


def _batch():
    """One 64 × 64 training batch with three gt rows and five padding
    rows (the JAX test's boxes)."""
    rng = np.random.RandomState(7)
    gt = np.zeros((8, 4), np.float32)
    gt[:3] = [[4, 4, 30, 40], [20, 10, 60, 60], [5, 35, 45, 62]]
    return {"images": (rng.randn(1, 64, 64, 3) * 30).astype(np.float32),
            "gt_boxes": gt,
            "gt_classes": np.array([1, 3, 5, 0, 0, 0, 0, 0], np.int32),
            "gt_attrs": np.array([2, -1, 4, -1, -1, -1, -1, -1], np.int32),
            "gt_mask": np.arange(8) < 3}


def _jax_draws(rng, n_anchors, num_proposals, jitter=0.1):
    """The three draws of JAX's step for ``rng`` (detector_train.py:213
    and the uniforms of ``subsample_labels``)."""
    r_rpn, r_roi, r_jit = jax.random.split(rng, 3)
    return (np.array(jax.random.uniform(r_rpn, (n_anchors,))),
            np.array(jax.random.uniform(r_roi, (num_proposals,))),
            np.array(jax.random.uniform(r_jit, (num_proposals, 4),
                                          minval=-jitter, maxval=jitter)))


@pytest.fixture(scope="module")
def jax_step(params):
    """One JAX train step (the CLI's optax chain) on ``_batch`` — compiled
    once for the module — with the ReLU decisions it took (``x > 0`` of
    every ``jax.nn.relu`` in call order, NCHW like the port's), reported
    from inside the compiled step by ``jax.debug.callback``."""
    jcfg = jd.DetectorConfig(**SMALL)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.sgd(LR, momentum=0.9))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
    step = jt.make_detector_train_step(jd.BUADetector(jcfg), jcfg, tx,
                                       num_proposals=NUM_PROPOSALS)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    rng = jax.random.PRNGKey(3)
    decisions, relu = {}, jax.nn.relu

    def recording_relu(x):
        i = len(decisions)
        decisions[i] = None
        jax.debug.callback(
            lambda m, i=i: decisions.__setitem__(i, np.array(m)), x > 0)
        return relu(x)

    jax.nn.relu = recording_relu
    try:
        new_state, losses = step(state, batch, rng)
        jax.block_until_ready(new_state)
        jax.effects_barrier()
    finally:
        jax.nn.relu = relu
    (trace,) = [s.trace for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    masks = [decisions[i] for i in range(len(decisions))]
    return {"rng": rng,
            "params": jax.tree_util.tree_map(np.asarray, new_state.params),
            "trace": jax.tree_util.tree_map(np.asarray, trace),
            "losses": {k: float(v) for k, v in losses.items()},
            "relu": [torch.from_numpy(np.ascontiguousarray(
                m.transpose(0, 3, 1, 2) if m.ndim == 4 else m))
                for m in masks]}


# --------------------------------------------------------- matching, losses

def test_encode_boxes_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(50, 2).astype(np.float32) * 80
    anchors = np.concatenate([a, a + rng.rand(50, 2) * 60 + 1], 1
                             ).astype(np.float32)
    t = rng.rand(50, 2).astype(np.float32) * 80
    targets = np.concatenate([t, t + rng.rand(50, 2) * 60 + 1], 1
                             ).astype(np.float32)
    targets[0] = [10, 10, 10, 30]                # zero width: the 1e-6 floor
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = tt.encode_boxes(torch.from_numpy(anchors),
                              torch.from_numpy(targets), weights).numpy()
        want = np.asarray(jt.encode_boxes(jnp.asarray(anchors),
                                          jnp.asarray(targets), weights))
        assert _rel(got, want) <= 1e-6


def _anchor_case():
    """Dense anchors of a 4 × 6 map and a padded gt array with a small box
    whose best anchor is below 0.3 IoU (a low-quality match)."""
    cfg = td.DetectorConfig(**SMALL)
    anchors = td.make_anchors(cfg, 4, 6)
    gt = np.zeros((6, 4), np.float32)
    gt[:4] = [[4, 4, 60, 50], [30, 10, 90, 60], [2, 2, 9, 7],
              [40, 30, 95, 63]]
    return anchors, gt, np.arange(6) < 4


def test_match_anchors_matches_jax():
    """Padded gt rows never match; the low-quality rule promotes each gt's
    best anchor; labels and matched indices equal JAX's."""
    anchors, gt, mask = _anchor_case()
    got_l, got_m = tt.match_anchors(torch.from_numpy(anchors),
                                    torch.from_numpy(gt),
                                    torch.from_numpy(mask))
    want_l, want_m = jt.match_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                                      jnp.asarray(mask))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert (got_m.numpy() < 4).all()
    labels = got_l.numpy()
    assert {-1, 0, 1} <= set(labels.tolist())
    # the small gt row 2 has no anchor at 0.7: its best ones (tied) are
    # promoted
    iou = np.asarray(jt.pairwise_iou(jnp.asarray(anchors), jnp.asarray(gt)))
    assert iou[:, 2].max() < 0.3
    assert (labels[iou[:, 2] == iou[:, 2].max()] == 1).all()


_subsample = jax.jit(jt.subsample_labels,
                     static_argnames=("batch_size", "positive_fraction"))


@pytest.mark.parametrize("counts,batch_size", [
    ((100, 500, 50), 64),     # both budgets bind
    ((10, 500, 50), 64),      # fewer positives than num_pos
    ((6, 6, 4), 64),          # P = 16 < num_pos = 32: JAX clamps the index
    ((3, 4, 1), 16),          # P = 8 (tests/test_detector_train.py:235)
    ((0, 0, 16), 64),         # nothing to sample
])
def test_subsample_labels_matches_jax(counts, batch_size):
    """On JAX's own uniforms, the same weights exactly, including a label
    array shorter than ``batch_size · positive_fraction`` (JAX's static
    index past the end, clamped under jit)."""
    pos, neg, ign = counts
    labels = np.concatenate([np.ones(pos), np.zeros(neg), -np.ones(ign)]
                            ).astype(np.int32)
    labels = labels[np.random.RandomState(pos + neg).permutation(len(labels))]
    key = jax.random.PRNGKey(len(labels) + batch_size)
    uniform = np.array(jax.random.uniform(key, labels.shape))
    want = np.asarray(_subsample(jnp.asarray(labels), key,
                                 batch_size=batch_size))
    got = tt.subsample_labels(torch.from_numpy(labels).long(),
                              torch.from_numpy(uniform), batch_size).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() <= batch_size and got[labels == -1].sum() == 0


def test_rpn_losses_match_jax():
    anchors, gt, mask = _anchor_case()
    rng = np.random.RandomState(1)
    obj = (rng.randn(len(anchors)) * 2).astype(np.float32)
    deltas = (rng.randn(len(anchors), 4) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    uniform = np.array(jax.random.uniform(key, (len(anchors),)))
    want = jt.rpn_losses(jnp.asarray(anchors), jnp.asarray(obj),
                         jnp.asarray(deltas), jnp.asarray(gt),
                         jnp.asarray(mask), key, batch_size=32)
    got = tt.rpn_losses(*(torch.from_numpy(x) for x in (
        anchors, obj, deltas, gt, mask, uniform)), batch_size=32)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL * abs(
            float(want[k])), k


def test_roi_losses_match_jax():
    """Classification, per-class box and attribute losses on sampled
    proposals (gt ⊕ jitter, background included), labels compared
    first."""
    rng = np.random.RandomState(2)
    _, gt, mask = _anchor_case()
    C, A_, P = 7, 6, 24
    base = gt[np.arange(P) % 4]
    wh = np.concatenate([base[:, 2:] - base[:, :2]] * 2, 1)
    proposals = (base + rng.uniform(-0.4, 0.4, (P, 4)) * wh).astype(
        np.float32)
    classes = np.array([0, 2, 5, 1, 0, 0], np.int32)
    attrs = np.array([3, -1, 0, 4, -1, -1], np.int32)
    cls_logits = rng.randn(P, C).astype(np.float32)
    deltas = (rng.randn(P, C * 4) * 0.2).astype(np.float32)
    attr_logits = rng.randn(P, A_).astype(np.float32)
    key = jax.random.PRNGKey(12)
    uniform = np.array(jax.random.uniform(key, (P,)))

    got_labels, got_fg, _ = tt.roi_labels(
        torch.from_numpy(proposals), torch.from_numpy(gt),
        torch.from_numpy(classes), torch.from_numpy(mask))
    iou = np.where(mask[None], np.asarray(jt.pairwise_iou(
        jnp.asarray(proposals), jnp.asarray(gt))), -1.0)
    fg = iou.max(1) >= 0.5
    np.testing.assert_array_equal(got_fg.numpy(), fg)
    np.testing.assert_array_equal(
        got_labels.numpy(), np.where(fg, classes[iou.argmax(1)] + 1, 0))
    assert 0 < fg.sum() < P

    want = jt.roi_losses(*(jnp.asarray(x) for x in (
        proposals, cls_logits, deltas, attr_logits, gt, classes, attrs,
        mask)), key, batch_size=16)
    got = tt.roi_losses(*(torch.from_numpy(x) for x in (
        proposals, cls_logits, deltas, attr_logits, gt, classes, attrs, mask,
        uniform)), batch_size=16)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL * abs(
            float(want[k])), k


def test_roi_align_gradient_matches_jax():
    """ROIAlign's gradient with respect to the map, against ``jax.grad`` of
    ``roi_align_jax``, with ROIs inside, across and past the border."""
    rng = np.random.RandomState(3)
    feat = rng.randn(8, 10, 12).astype(np.float32)
    rois = np.array([[16, 16, 120, 100], [-40, -30, 60, 50],
                     [150, 120, 260, 230], [300, 300, 400, 380],
                     [5, 90, 190, 170], [30, 30, 31, 31]], np.float32)
    cot = rng.randn(len(rois), 8, 7, 7).astype(np.float32)
    scale = 1.0 / 16

    def loss(f):
        return jnp.sum(roi_align_jax(f, jnp.asarray(rois), scale, (7, 7))
                       * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(feat)))
    f = torch.from_numpy(feat).requires_grad_()
    out = roi_align(f, torch.from_numpy(rois), scale, (7, 7))
    (out * torch.from_numpy(cot)).sum().backward()
    assert np.abs(want).max() > 0
    assert _rel(f.grad.numpy(), want) <= 1e-6
    # the ROI wholly past the border takes no gradient
    np.testing.assert_array_equal(
        out[3].detach().numpy(), np.zeros((8, 7, 7), np.float32))


# -------------------------------------------------------------- train step

def _port_step(params, cfg=None):
    cfg = cfg or td.DetectorConfig(**SMALL)
    model = td.BUADetector(cfg)
    model.load_state_dict(detector_state_from_jax(params), strict=True)
    return tt.make_detector_train_step(model, cfg,
                                       ttd.detector_optimizer(LR),
                                       num_proposals=NUM_PROPOSALS)


def test_train_step_matches_jax(params, jax_step, monkeypatch):
    """One full step on JAX's draws: the decisions first (anchor and
    proposal labels, probability edges, the class argmax's margin), then
    the five losses within 1e-5 relative and each parameter's change
    (−lr · the momentum trace) within 1e-4 of its leaf's largest change,
    leaf by leaf.

    The ReLUs decide too: pre-activations run to the hundreds, and the odd
    one that the two frameworks round to opposite signs routes its gradient
    differently (with one intra-op thread, enough to move a res5 leaf past
    the tolerance). So the port's step replays JAX's ReLU decisions
    (chip_smoke's ``_ReluTape``), and at most one element in 10^5 may
    decide otherwise on its own."""
    from chip_smoke import _ReluTape
    step = _port_step(params)
    batch = _batch()
    n_anchors = 4 * 4 * step.num_anchors
    draws = _jax_draws(jax_step["rng"], n_anchors, NUM_PROPOSALS)

    with torch.no_grad():
        _, aux = step.losses(batch, tuple(torch.from_numpy(d)
                                          for d in draws), aux=True)
    jcfg = jd.DetectorConfig(**SMALL)
    anchors = jnp.asarray(jd.make_anchors(jcfg, 4, 4))
    gt, mask = jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["gt_mask"])
    want_labels, _ = jt.match_anchors(anchors, gt, mask)
    np.testing.assert_array_equal(aux["anchor_labels"].numpy(),
                                  np.asarray(want_labels))
    assert (np.asarray(want_labels) == 1).any()
    # the JAX step's proposals (detector_train.py:221-228)
    order = np.argsort(~batch["gt_mask"], kind="stable")
    base = batch["gt_boxes"][order[np.arange(NUM_PROPOSALS) % 3]]
    wh = np.stack([base[:, 2] - base[:, 0], base[:, 3] - base[:, 1]], 1)
    props = jnp.asarray(base) + jnp.asarray(draws[2]) * jnp.asarray(
        np.concatenate([wh, wh], 1))
    np.testing.assert_allclose(aux["proposals"].numpy(), np.asarray(props),
                               rtol=1e-6, atol=1e-5)
    iou = np.where(batch["gt_mask"][None],
                   np.asarray(jt.pairwise_iou(props, gt)), -1.0)
    fg = iou.max(1) >= 0.5
    np.testing.assert_array_equal(
        aux["proposal_labels"].numpy(),
        np.where(fg, batch["gt_classes"][iou.argmax(1)] + 1, 0))
    assert fg.any()
    assert np.abs(iou.max(1) - 0.5).min() > 1e-4
    for name in ("cls_prob", "attr_prob"):
        p = aux[name].numpy()
        assert p.min() > 1e-8 and p.max() < 1 - 1e-6, name
    top = np.sort(aux["cls_prob"].numpy()[:, 1:], axis=1)
    assert (top[:, -1] - top[:, -2]).min() > 1e-4

    tape = _ReluTape(torch.nn.functional)
    tape.masks, tape.replay = jax_step["relu"], True
    monkeypatch.setattr(td, "F", tape)
    monkeypatch.setattr(resnet, "F", tape)
    got = tt.loss_values(step.step_with_draws(
        batch, *(torch.from_numpy(d) for d in draws)))
    assert tape.pos == len(tape.masks) and tape.seen > 10 ** 6
    assert tape.flips <= 1e-5 * tape.seen, (tape.flips, tape.seen)
    assert set(got) == set(jax_step["losses"]) == {
        "rpn_objectness", "rpn_box", "roi_cls", "roi_box", "roi_attr"}
    for k, want in jax_step["losses"].items():
        assert abs(got[k] - want) <= LOSS_TOL * abs(want), (k, got[k], want)

    # the change is −lr · the momentum trace (the clipped gradient after
    # one step); a difference of the fp32 weights would round it to their
    # spacing
    trace = detector_state_from_jax(jax_step["trace"])
    after_jax = detector_state_from_jax(jax_step["params"])
    assert set(trace) == set(step.params)
    worst = {}
    for name, p in step.params.items():
        want = -LR * trace[name].numpy()
        worst[name] = _rel(-LR * step.opt_state["trace"][name].numpy(), want)
        # the weights themselves: the same update, up to their rounding
        w = after_jax[name].numpy()
        assert np.abs(p.detach().numpy() - w).max() <= (
            UPDATE_TOL * np.abs(want).max()
            + 2 * np.spacing(np.abs(w).max())), name
    assert max(worst.values()) <= UPDATE_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    # every parameter trains, the stem and the FrozenBN affines included
    for name in ("backbone.stem.conv1.weight",
                 "backbone.stem.conv1.norm.weight",
                 "backbone.res2.0.conv1.norm.bias",
                 "roi_heads.box_predictor.cls_embedding.weight"):
        assert step.opt_state["trace"][name].abs().max() > 0, name


def test_train_step_draws_from_its_generator():
    """``step(batch, generator)`` draws the three streams in order from the
    generator: the same seed gives the same losses as the draws handed
    over, a different seed other losses; the losses stay tensors."""
    cfg = td.DetectorConfig(**SMALL)
    state = td.init_detector(cfg, torch.Generator().manual_seed(1)
                             ).state_dict()
    batch = _batch()

    def fresh():
        model = td.BUADetector(cfg)
        model.load_state_dict(state)
        return tt.make_detector_train_step(model, cfg,
                                           ttd.detector_optimizer(LR),
                                           num_proposals=8)

    step = fresh()
    a = step(batch, torch.Generator().manual_seed(5))
    assert all(isinstance(v, torch.Tensor) and not v.requires_grad
               for v in a.values())
    n_anchors = 4 * 4 * step.num_anchors
    draws = fresh().draw(n_anchors, torch.Generator().manual_seed(5))
    assert draws[2].abs().max() <= 0.1 and draws[2].shape == (8, 4)
    b = fresh().step_with_draws(batch, *draws)
    c = fresh()(batch, torch.Generator().manual_seed(6))
    assert tt.loss_values(a) == tt.loss_values(b)
    assert tt.loss_values(a) != tt.loss_values(c)


def test_optimizer_matches_optax_chain():
    """Three updates of the CLI's chain (clip 5.0 → SGD momentum 0.9)
    against ``optax.chain``, the first gradient above norm 5."""
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 3)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * f).astype(np.float32)
              for k, s in shapes.items()} for f in (4.0, 0.3, 0.5)]
    assert np.sqrt(sum((g ** 2).sum() for g in grads[0].values())) > 5
    assert np.sqrt(sum((g ** 2).sum() for g in grads[1].values())) < 5
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.sgd(0.1, momentum=0.9))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    opt = ttd.detector_optimizer(0.1)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    for g in grads:
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- VG data

def _coco(n_images=5, seed=0):
    """A COCO-format VG table: non-contiguous category ids, attributes,
    crowd and degenerate annotations, one image with no usable box, one
    with more boxes than max_gt."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    aid = 0
    for iid in range(1, n_images + 1):
        h, w = 48 + 4 * iid, 64 + 6 * iid
        images.append({"id": iid, "file_name": "%d.jpg" % iid,
                       "height": h, "width": w})
        n = {2: 0, 3: 11}.get(iid, 3)
        for _ in range(n):
            x, y = rng.randint(0, w // 2), rng.randint(0, h // 2)
            ann = {"id": aid, "image_id": iid,
                   "bbox": [int(x), int(y), int(rng.randint(5, w // 2)),
                            int(rng.randint(5, h // 2))],
                   "category_id": int(rng.choice([3, 7, 9]))}
            if rng.rand() < 0.6:
                ann["attribute"] = [int(a) for a in rng.randint(1, 5, 2)]
            anns.append(ann)
            aid += 1
        if iid == 2:
            anns.append({"id": aid, "image_id": iid, "bbox": [1, 1, 10, 0],
                         "category_id": 3})
            anns.append({"id": aid + 1, "image_id": iid,
                         "bbox": [2, 2, 20, 20], "category_id": 7,
                         "iscrowd": 1})
            aid += 2
    return {"images": images[::-1], "annotations": anns,
            "categories": [{"id": i, "name": str(i)} for i in (3, 7, 9)]}


def _fake_reader(rec):
    return (np.random.RandomState(rec["image_id"]).rand(
        rec["height"], rec["width"], 3) * 255).astype(np.uint8)


def test_load_vg_json_matches_jax(tmp_path):
    jf = tmp_path / "vg.json"
    jf.write_text(json.dumps(_coco()))
    got = tvg.load_vg_json(str(jf), str(tmp_path))
    want = jvg.load_vg_json(str(jf), str(tmp_path))
    assert [r["image_id"] for r in got] == [1, 2, 3, 4, 5]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]
    assert got[1]["boxes"].shape == (0, 4)
    assert (got[0]["attrs"] >= -1).all() and got[2]["boxes"].shape[0] == 11
    bad = _coco()
    bad["annotations"][0]["category_id"] = 4
    jf.write_text(json.dumps(bad))
    with pytest.raises(ValueError):
        tvg.load_vg_json(str(jf), str(tmp_path))


@pytest.mark.parametrize("seed", [0, 3])
def test_loader_batches_match_jax(tmp_path, seed):
    """Two epochs of training batches, byte-identical to JAX's for the
    seed: the shuffle, the flip, the blob, the truncation to max_gt and the
    empty-gt filter; then the evaluation order (no shuffle, no flip)."""
    jf = tmp_path / "vg.json"
    jf.write_text(json.dumps(_coco()))
    records = tvg.load_vg_json(str(jf), str(tmp_path))
    cfg = dict(num_classes=4, num_attributes=5, min_size=32, max_size=64,
               size_divisibility=32)
    for is_train in (True, False):
        got_l = tvg.VGDetectionLoader(records, td.DetectorConfig(**cfg),
                                      max_gt=8, is_train=is_train, seed=seed,
                                      image_reader=_fake_reader)
        want_l = jvg.VGDetectionLoader(records, jd.DetectorConfig(**cfg),
                                       max_gt=8, is_train=is_train,
                                       seed=seed, image_reader=_fake_reader)
        for _ in range(2 if is_train else 1):
            got, want = list(got_l), list(want_l)
            assert len(got) == len(want) == (4 if is_train else 5)
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    if k == "image_id":
                        assert g[k] == w[k]
                        continue
                    assert g[k].dtype == w[k].dtype and g[k].shape == w[
                        k].shape, k
                    assert g[k].tobytes() == w[k].tobytes(), k
            truncated = [b for b in got if b["image_id"] == 3]
            assert truncated and truncated[0]["gt_mask"].all()


# ------------------------------------------------------------------ vg_eval

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vg_eval_matches_jax(seed):
    """voc_ap (both metrics), eval_class and evaluate_detections on random
    detections: the same floats."""
    rng = np.random.RandomState(seed)
    rec = np.sort(rng.rand(20))
    prec = rng.rand(20)
    for use_07 in (False, True):
        assert tve.voc_ap(rec, prec, use_07) == jve.voc_ap(rec, prec, use_07)
    preds, gts = [], []
    for iid in range(6):
        n_gt, n_det = rng.randint(0, 6), rng.randint(0, 12)
        gb = rng.rand(n_gt, 2) * 50
        gt_boxes = np.concatenate([gb, gb + rng.rand(n_gt, 2) * 40 + 5], 1)
        gt_cls = rng.randint(0, 4, n_gt)
        # half the detections near a gt box, half anywhere
        near = gt_boxes[rng.randint(0, max(n_gt, 1), n_det)] if n_gt else \
            np.zeros((n_det, 4))
        db = rng.rand(n_det, 2) * 50
        anywhere = np.concatenate([db, db + rng.rand(n_det, 2) * 40 + 5], 1)
        use_near = (rng.rand(n_det) < 0.5)[:, None] & (n_gt > 0)
        boxes = np.where(use_near, near + rng.randn(n_det, 4) * 2, anywhere)
        preds.append({"image_id": iid, "boxes": boxes,
                      "scores": rng.rand(n_det),
                      "labels": rng.randint(0, 4, n_det)})
        gts.append({"image_id": iid, "boxes": gt_boxes, "classes": gt_cls})
    got = tve.evaluate_detections(preds, gts, num_classes=4)
    want = jve.evaluate_detections(preds, gts, num_classes=4)
    assert got == want
    gt_by_image = {g["image_id"]: g["boxes"][g["classes"] == 1] for g in gts}
    ids = [p["image_id"] for p in preds for _ in range(len(p["scores"]))]
    scores = np.concatenate([p["scores"] for p in preds])
    boxes = np.concatenate([p["boxes"] for p in preds])
    for g, w in zip(tve.eval_class(ids, scores, boxes, gt_by_image),
                    jve.eval_class(ids, scores, boxes, gt_by_image)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --------------------------------------------------------------- evaluate

def test_evaluate_matches_jax(params, monkeypatch):
    """``evaluate`` (mode-2 detection + vg_eval) on the same weights: mAP
    and weighted mAP within 1e-6 of JAX's, once every image's decisions
    are shown to have margin. Ground truth is drawn around the port's own
    detections, so the APs are not all zero."""
    from test_torch_detector import assert_decision_margins

    cfg, jcfg = td.DetectorConfig(**EVAL), jd.DetectorConfig(**EVAL)
    jx = jd.FeatureExtractor(jcfg, params)
    tx = td.FeatureExtractor(cfg, detector_state_from_jax(params),
                             device="cpu")
    imgs = {i: np.random.RandomState(20 + i).randint(
        0, 255, (80, 100, 3)).astype(np.uint8) for i in range(1, 4)}
    records = []
    rng = np.random.RandomState(9)
    for i, img in imgs.items():
        assert_decision_margins(jx, tx, img)
        out = tx.extract(img, mode=2)
        labels = out["cls_prob"][:, 1:].argmax(1)
        pick = rng.choice(len(labels), 4, replace=False)
        boxes = out["bbox"][pick] + rng.randn(4, 4).astype(np.float32)
        records.append({"image_id": i, "height": 80, "width": 100,
                        "boxes": boxes.astype(np.float32),
                        "classes": labels[pick].astype(np.int32)})
    reader = lambda rec: imgs[rec["image_id"]]  # noqa: E731
    want = jtd.evaluate(jcfg, params, records, image_reader=reader)
    got = ttd.evaluate(cfg, detector_state_from_jax(params), records,
                       image_reader=reader, device="cpu")
    assert want["mAP"] > 0
    assert abs(got["mAP"] - want["mAP"]) <= 1e-6
    assert abs(got["weighted_mAP"] - want["weighted_mAP"]) <= 1e-6
    assert set(got["per_class_ap"]) == set(want["per_class_ap"])
    # a caller-owned extractor keeps its own weights
    own = tx.model
    ttd.evaluate(cfg, detector_state_from_jax(params), records[:1],
                 image_reader=reader, extractor=tx)
    assert tx.model is own


# ---------------------------------------------------------------------- CLI

CLI_CFG = dict(num_classes=4, num_attributes=5, min_size=32, max_size=64,
               size_divisibility=32, pre_nms_topk=50, post_nms_topk=10,
               min_boxes=2, max_boxes=5)


def test_train_detector_cli(tmp_path, monkeypatch):
    """The CLI on the CPU: one epoch of training with evaluation, the
    ``detector.pth`` dump, ``--eval-only`` on the dump reproducing the
    epoch's metrics, and the dump loading in ``load_detector_weights``."""
    coco = _coco(n_images=3, seed=5)
    coco["categories"] = [{"id": i, "name": str(i)} for i in (3, 7, 9)]
    jf = tmp_path / "ann.json"
    jf.write_text(json.dumps(coco))
    sizes = {im["id"]: (im["height"], im["width"]) for im in coco["images"]}

    def read(path):
        iid = int(os.path.basename(path).split(".")[0])
        h, w = sizes[iid]
        return _fake_reader({"image_id": iid, "height": h, "width": w})

    monkeypatch.setattr(tvg, "_read_image_bgr", read)
    monkeypatch.setattr(ttd, "DetectorConfig", lambda depth: td.DetectorConfig(
        depth=depth, **CLI_CFG))
    out = tmp_path / "out"
    common = ["--val-json", str(jf), "--image-root", str(tmp_path),
              "--out-dir", str(out), "--eval-images", "2", "--device", "cpu"]
    history = ttd.main(common + ["--train-json", str(jf), "--epochs", "1",
                                 "--max-gt", "8", "--num-proposals", "8",
                                 "--log-every", "1"])
    dump = out / "detector.pth"
    assert dump.is_file()
    assert [it for it, _ in history["losses"]] == [1, 2]   # image 2: no gt
    assert all(np.isfinite(v) for _, d in history["losses"]
               for v in d.values())
    (last,) = history["epochs"]
    assert np.isfinite(last["mAP"]) and np.isfinite(last["weighted_mAP"])
    metrics = ttd.main(common + ["--eval-only", "--weights", str(dump)])
    assert metrics["mAP"] == last["mAP"]
    assert metrics["weighted_mAP"] == last["weighted_mAP"]
    cfg = td.DetectorConfig(**CLI_CFG)
    state = load_detector_weights(str(dump), cfg)
    init = td.init_detector(cfg, torch.Generator().manual_seed(0)
                            ).state_dict()
    assert list(state) == list(init)
    assert not torch.equal(state["backbone.stem.conv1.weight"],
                           init["backbone.stem.conv1.weight"])
    with pytest.raises(ValueError, match="--weights"):
        ttd.main(common + ["--eval-only"])


def test_train_returns_the_trained_module(tmp_path):
    """``train`` on in-memory records with an image reader (the JAX test's
    library route): the returned module is the one dumped."""
    records = [{"file_name": "", "image_id": i, "height": 48, "width": 64,
                "boxes": np.array([[4, 4, 30, 30], [20, 10, 60, 40]],
                                  np.float32),
                "classes": np.array([0, 2], np.int32),
                "attrs": np.array([1, -1], np.int32)} for i in (1, 2)]
    ns = argparse.Namespace(out_dir=str(tmp_path), weights="", epochs=1,
                            lr=1e-3, seed=0, max_gt=4, num_proposals=8,
                            log_every=100, eval_images=0, device="cpu")
    cfg = td.DetectorConfig(**CLI_CFG)
    model, history = ttd.train(ns, cfg, records, [],
                               image_reader=_fake_reader)
    assert history == {"losses": [], "epochs": []}
    saved = torch.load(str(tmp_path / "detector.pth"))
    assert all(torch.equal(saved[k], v) for k, v in model.state_dict().items())
