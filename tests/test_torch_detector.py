"""The port's BUA detector and its extraction pipeline against the JAX
package, in one process on the CPU, at the JAX tests' small configuration
(tests/test_detector.py: depth 101, shortest side 64, longest 96, 200 / 20
proposals, 3-8 boxes) with 23 classes and 11 attributes.

The weights go across through ``detector_state_from_jax``. Random weights
make near-ties (flat or saturated scores), so the decision layers are
rescaled in the flax tree before it crosses (``DECISION_SCALE``: spread RPN
scores and class probabilities, small box deltas), and every whole-pipeline
comparison first asserts that each decision has margin: sorted score gaps
above twice the measured port-vs-JAX difference, and equal threshold
decisions (``assert_decision_margins``)."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_challenge_tpu.extract import detector as jd
from meme_challenge_tpu.extract import native as jax_native
from meme_challenge_tpu.extract.ops import roi_bin_quantize
from meme_challenge_tpu_torch.extract import detector as td
from meme_challenge_tpu_torch.extract.convert_detector import (
    detector_keys,
    detector_state_from_jax,
    detector_state_from_torch,
    load_detector_weights,
)

SMALL = dict(depth=101, pre_nms_topk=200, post_nms_topk=20, min_boxes=3,
             max_boxes=8, conf_thresh=0.0, min_size=64, max_size=96,
             num_classes=23, num_attributes=11)
# flax leaf → factor: the random stack's outputs are in the hundreds, which
# saturates the RPN's sigmoid and the softmaxes and decodes every anchor to
# the whole image
DECISION_SCALE = {("rpn", "objectness"): 0.02,
                  ("rpn", "anchor_deltas"): 0.001,
                  ("roi_head", "bbox_pred"): 0.001,
                  ("roi_head", "cls_score"): 0.002,
                  ("roi_head", "attr_score"): 0.002}
NET_TOL = 1e-4   # of each output's largest magnitude


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the test runner puts several workers on one
    machine, and a convolution stack whose every op spreads over all cores
    slows many times over when the workers' threads outnumber the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    """One flax init at the small configuration (numpy leaves), with the
    decision layers rescaled."""
    cfg = jd.DetectorConfig(**SMALL)
    init = jax.jit(jd.init_detector_params, static_argnums=(0, 2))
    key = jax.random.key(0, impl="threefry2x32")
    tree = jax.tree_util.tree_map(np.asarray, init(cfg, key, (64, 64)))
    for (mod, leaf), factor in DECISION_SCALE.items():
        tree[mod][leaf]["kernel"] = tree[mod][leaf]["kernel"] * factor
    return tree


@pytest.fixture(scope="module")
def state(params):
    return detector_state_from_jax(params)


@pytest.fixture(scope="module")
def extractors(params, state):
    """(JAX FeatureExtractor, port FeatureExtractor on the CPU) on the same
    weights; one JAX instance, so its programs compile once."""
    return (jd.FeatureExtractor(jd.DetectorConfig(**SMALL), params),
            td.FeatureExtractor(td.DetectorConfig(**SMALL), state,
                                device="cpu"))


@pytest.fixture(scope="module")
def margins(extractors):
    """``assert_decision_margins`` on the shared extractors, once an
    image."""
    seen = {}

    def check(img):
        key = (img.shape, img.tobytes())
        if key not in seen:
            seen[key] = assert_decision_margins(*extractors, img)
        return seen[key]

    return check


def _image(seed, hw=(80, 100)):
    return np.random.RandomState(seed).randint(
        0, 255, hw + (3,)).astype(np.uint8)


# ------------------------------------------------------------------ network

@pytest.mark.parametrize("hw", [(64, 96), (67, 93)])
def test_backbone_and_rpn_match_jax(params, state, hw):
    """res4 map, objectness and deltas at an even and an odd input size
    (the stride-2 1×1 convs pad nothing at either)."""
    img = np.random.RandomState(hw[0]).randn(1, *hw, 3).astype(
        np.float32) * 50
    jm = jd.BUADetector(jd.DetectorConfig(**SMALL))
    want = jm.apply({"params": params}, jnp.asarray(img),
                    method=jd.BUADetector.backbone_rpn)
    tm = td.BUADetector(td.DetectorConfig(**SMALL))
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = tm.backbone_rpn(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert got[0].shape == (1, 1024, (hw[0] + 15) // 16, (hw[1] + 15) // 16)
    for g, w in zip(got, want):
        assert _rel(g.permute(0, 2, 3, 1).numpy(), w) <= NET_TOL


def test_roi_head_matches_jax(params, state):
    pooled = np.random.RandomState(2).randn(5, 14, 14, 1024).astype(
        np.float32) * 0.5
    jm = jd.BUADetector(jd.DetectorConfig(**SMALL))
    want = jm.apply({"params": params}, jnp.asarray(pooled),
                    method=jd.BUADetector.roi_forward)
    tm = td.BUADetector(td.DetectorConfig(**SMALL))
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = tm.roi_forward(torch.from_numpy(pooled).permute(0, 3, 1, 2))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        assert _rel(got[k].numpy(), want[k]) <= NET_TOL, k


# ------------------------------------------------------------- host helpers

@pytest.mark.parametrize("hw", [(120, 240), (80, 100), (64, 96), (97, 61)])
def test_blob_helpers_match_jax_exactly(hw):
    """Blobs in the three transfer dtypes (bfloat16 bit-equal to the
    ml_dtypes cast of the JAX package), scale and true size."""
    img = _image(hw[0], hw)
    cfg, jcfg = td.DetectorConfig(**SMALL), jd.DetectorConfig(**SMALL)
    for port_fn, jax_fn in ((td.get_image_blob, jd.get_image_blob),
                            (td.get_image_blob_u8, jd.get_image_blob_u8)):
        got, want = port_fn(img, cfg), jax_fn(img, jcfg)
        assert got[1:] == want[1:]
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])
    assert td._blob_scale(img.shape, cfg) == jd._blob_scale(img.shape, jcfg)
    for dt in ("float32", "bfloat16", "uint8"):
        blob, scale, size = td.transfer_blob(
            img, dataclasses.replace(cfg, blob_transfer_dtype=dt))
        ref, ref_scale, ref_size = (
            jd.get_image_blob_u8 if dt == "uint8" else jd.get_image_blob)(
                img, jcfg)
        ref = jnp.asarray(ref).astype(jnp.dtype(dt))
        assert (scale, size) == (ref_scale, ref_size)
        if dt == "bfloat16":
            np.testing.assert_array_equal(
                blob.view(torch.int16).numpy(),
                np.asarray(ref).view(np.int16))
        else:
            np.testing.assert_array_equal(blob.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        td.transfer_blob(img, dataclasses.replace(
            cfg, blob_transfer_dtype="float16"))


def test_anchors_and_box_decoding_match_jax():
    cfg, jcfg = td.DetectorConfig(**SMALL), jd.DetectorConfig(**SMALL)
    for fh, fw in ((2, 3), (5, 7)):
        np.testing.assert_array_equal(td.make_anchors(cfg, fh, fw),
                                      jd.make_anchors(jcfg, fh, fw))
    rng = np.random.RandomState(5)
    anchors = td.make_anchors(cfg, 4, 6)
    deltas = rng.randn(len(anchors), 4).astype(np.float32)
    deltas[:3, 2:] = 6.0                        # past the 4.135 clamp
    np.testing.assert_array_equal(td._decode_boxes_np(anchors, deltas),
                                  jd._decode_boxes_np(anchors, deltas))
    got = td.decode_boxes(torch.from_numpy(anchors),
                          torch.from_numpy(deltas)).numpy()
    want = np.asarray(jd.decode_boxes(jnp.asarray(anchors),
                                      jnp.asarray(deltas)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_init_detector_draws_flax_distributions():
    """init_detector: the port's key layout, lecun-normal kernels (std
    1 / sqrt(fan_in), truncated at two deviations), zero biases, FrozenBN
    1 / 0."""
    cfg = td.DetectorConfig(**SMALL)
    a = td.init_detector(cfg, torch.Generator().manual_seed(3)).state_dict()
    assert list(a) == detector_keys(cfg)
    w = a["backbone.res4.5.conv2.weight"]                 # fan_in 256 · 9
    std = (1.0 / (256 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 * std / .87962566103423978
    assert (a["backbone.res2.1.conv1.norm.weight"] == 1).all()
    assert (a["roi_heads.res5.0.shortcut.norm.bias"] == 0).all()
    assert (a["proposal_generator.rpn_head.conv.bias"] == 0).all()
    emb = a["roi_heads.box_predictor.cls_embedding.weight"]
    assert abs(float(emb.std()) * 16.0 - 1.0) < 0.05


# ---------------------------------------------------------------- weights

def test_detector_state_from_torch_matches_the_jax_converter():
    """A torch oracle in detectron2's key layout (as the JAX oracle test
    builds it): the port reads its state dict as JAX's converter does, and
    the port's model reproduces the oracle's forward."""
    from test_detector_oracle import _TorchBUA

    from meme_challenge_tpu.extract.convert_detector import (
        detector_params_from_torch,
    )

    cfg = td.DetectorConfig(num_classes=23, num_attributes=11)
    torch.manual_seed(5)
    oracle = _TorchBUA(cfg).eval()
    sd = {k: v.detach().numpy() for k, v in oracle.state_dict().items()}
    got = detector_state_from_torch(sd, cfg)
    want = detector_state_from_jax(detector_params_from_torch(
        sd, jd.DetectorConfig(num_classes=23, num_attributes=11)))
    assert list(got) == detector_keys(cfg) and set(want) == set(got)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    model = td.BUADetector(cfg)
    model.load_state_dict(got, strict=True)
    img = torch.from_numpy(np.random.RandomState(0).randn(
        1, 3, 48, 64).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model.backbone(img), oracle.backbone(img),
                                   rtol=0, atol=0)

    partial = {k: v for k, v in sd.items() if "attr_linear" not in k}
    assert not any("attr_linear" in k
                   for k in detector_state_from_torch(partial, cfg))
    del partial["backbone.res3.1.conv2.weight"]
    with pytest.raises(KeyError):
        detector_state_from_torch(partial, cfg)


def test_load_detector_weights_reads_torch_and_flax_files(tmp_path, params,
                                                          state):
    from meme_challenge_tpu.train.checkpoint import ModelSaver

    cfg = td.DetectorConfig(**SMALL)
    flax_file = str(tmp_path / "det.msgpack")
    ModelSaver(flax_file).save(params)
    torch_file = str(tmp_path / "det.pth")
    torch.save({"model": state}, torch_file)
    for path in (flax_file, torch_file):
        got = load_detector_weights(path, cfg)
        assert list(got) == detector_keys(cfg)
        for k in got:
            assert torch.equal(got[k], state[k]), (path, k)
    # no file: random weights, deterministic in the seed
    fresh = load_detector_weights("", cfg, seed=1)
    again = td.init_detector(cfg, torch.Generator().manual_seed(1)
                             ).state_dict()
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)
    with pytest.raises(ValueError):
        load_detector_weights(torch_file, td.DetectorConfig(
            **{**SMALL, "num_classes": 24}))


# ---------------------------------------------------------------- pipeline

def _top2_gap(prob) -> float:
    p = np.sort(np.asarray(prob, np.float64), axis=1)
    return float((p[:, -1] - p[:, -2]).min())


def _cut_gap(values, cut) -> float:
    """Gap between the ``cut``-th and the next largest value (inf when
    nothing is cut)."""
    v = np.sort(np.asarray(values, np.float64))[::-1]
    return float(v[cut - 1] - v[cut]) if len(v) > cut else np.inf


def assert_decision_margins(jx, tx, img):
    """The pipeline's decisions on ``img`` have margin, stage by stage on
    equal inputs: the score gap at every cut (the RPN's pre-NMS top-k, the
    box budget) and at every argmax (class, attribute) is above twice the
    port-vs-JAX difference measured on the same inputs, and the NMS
    decisions taken from either framework's scores agree (the same
    proposals, post-NMS cut included; the same boxes kept in every
    class). Where these hold, a
    differing selection is the port's fault, not a near-tie."""
    cfg = jx.cfg
    blob, scale, (h, w) = jd.get_image_blob(img, cfg)
    feat, jl, jdl, _ = jx._backbone_rpn_chained(
        jx.params, jnp.asarray(blob), jnp.zeros((), jnp.float32))
    jl, jdl = np.asarray(jl), np.asarray(jdl)
    with torch.no_grad():
        _, tl, tdl = tx.model.backbone_rpn(
            torch.from_numpy(blob).permute(0, 3, 1, 2))
    tl, tdl = tl.permute(0, 2, 3, 1).numpy(), tdl.permute(0, 2, 3, 1).numpy()
    A = jl.shape[-1] // 2

    def scores(logits):
        # the proposal stage's pairwise softmax (fp64, then fp32)
        z = (logits[0, ..., A:] - logits[0, ..., :A]).reshape(-1).astype(
            np.float64)
        e = np.exp(-np.abs(z))
        return np.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e)).astype(
            np.float32)

    sj, st = scores(jl), scores(tl)
    d = 2 * np.abs(sj - st).max()
    assert _cut_gap(sj, cfg.pre_nms_topk) > d
    props = jx._proposals(jl, jdl, h, w)
    np.testing.assert_allclose(tx._proposals(tl, tdl, h, w), props,
                               rtol=1e-5, atol=1e-3)

    # the JAX ROI stage on exactly these R rows (its extract pads to 64)
    P = cfg.pooler_resolution
    x1, y1, bh, bw = roi_bin_quantize(props, 1.0 / cfg.anchor_base, (P, P))
    jo = jx._roi_stage(jx.params, feat, jnp.asarray(x1), jnp.asarray(y1),
                       jnp.asarray(bh), jnp.asarray(bw))
    with torch.no_grad():
        to = tx._roi_stage(torch.from_numpy(np.array(feat)).permute(
            0, 3, 1, 2), props)
    R = len(props)
    cj, ct = np.asarray(jo["cls_prob"])[:R], to["cls_prob"].numpy()
    aj, at = np.asarray(jo["attr_prob"])[:R], to["attr_prob"].numpy()
    assert _top2_gap(cj[:, 1:]) > 2 * np.abs(cj - ct).max()
    assert _top2_gap(aj[:, 1:]) > 2 * np.abs(aj - at).max()
    boxes = props / scale
    for c in range(1, cj.shape[1]):
        np.testing.assert_array_equal(
            np.sort(jax_native.nms(boxes, cj[:, c], cfg.test_nms_thresh)),
            np.sort(jax_native.nms(boxes, ct[:, c], cfg.test_nms_thresh)))
    mj = jax_native.nms_max_conf(boxes, cj, cfg.test_nms_thresh)
    mt = jax_native.nms_max_conf(boxes, ct, cfg.test_nms_thresh)
    np.testing.assert_array_equal(mj >= cfg.conf_thresh,
                                  mt >= cfg.conf_thresh)
    n_above = int((mj >= cfg.conf_thresh).sum())
    cut = (cfg.min_boxes if n_above < cfg.min_boxes else
           cfg.max_boxes if n_above > cfg.max_boxes else None)
    # the budget's order: max confidence up to the cut (stable sorts)
    if cut is not None:
        top = np.sort(mj)[::-1][:cut + 1]
        assert (-np.diff(top) > 2 * np.abs(mj - mt).max()).all()
    return R


def _assert_same_output(got, want, mode):
    assert set(got) == set(want)
    np.testing.assert_allclose(got["bbox"], want["bbox"], rtol=1e-5,
                               atol=1e-5 * np.abs(want["bbox"]).max())
    if mode == 2:
        assert _rel(got["cls_prob"], want["cls_prob"]) <= NET_TOL
        return
    assert _rel(got["x"], want["x"]) <= NET_TOL
    for k in ("num_bbox", "image_h", "image_w"):
        assert got[k] == want[k]
    for k in ("objects_id", "attrs_id", "image_h", "image_w"):
        np.testing.assert_array_equal(got["info"][k], want["info"][k])
    for k in ("objects_conf", "attrs_conf"):
        assert _rel(got["info"][k], want["info"][k]) <= NET_TOL


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_pipeline_matches_jax(extractors, margins, mode):
    """FeatureExtractor modes 1-3: ``native_batched`` and ``device`` give
    the same selection bit for bit (``host_loop`` the same max
    confidence), and the port matches JAX once the decisions are shown to
    have margin."""
    jx, tx = extractors
    img = _image(0)
    assert margins(img) == SMALL["post_nms_topk"]
    gt = (np.array([[5, 5, 60, 60], [20, 10, 90, 70], [0, 0, 99, 79]],
                   np.float32) if mode == 3 else None)
    want = jx.extract(img, mode=mode, gt_boxes=gt)
    impls = ("native_batched", "device") if mode != 3 else (
        "native_batched",)
    outs = {}
    try:
        for impl in impls:
            tx.nms_impl = impl
            outs[impl] = tx.extract(img, mode=mode, gt_boxes=gt)
    finally:
        tx.nms_impl = "native_batched"
    got = outs["native_batched"]
    if mode != 3:
        for k in got:
            if k != "info":
                np.testing.assert_array_equal(outs["device"][k], got[k])
    _assert_same_output(got, want, mode)
    if mode == 1:
        assert 3 <= got["num_bbox"] <= 8 and got["x"].shape[1] == 2048
        rng = np.random.RandomState(1)
        cls_prob = rng.rand(20, SMALL["num_classes"]).astype(np.float32)
        boxes = np.abs(rng.randn(20, 4)).astype(np.float32) * 30
        boxes[:, 2:] += boxes[:, :2] + 5
        conf = {}
        try:
            for impl in td.NMS_IMPLS:
                tx.nms_impl = impl
                conf[impl] = tx._max_conf(cls_prob, boxes)
        finally:
            tx.nms_impl = "native_batched"
        for impl in td.NMS_IMPLS:
            np.testing.assert_array_equal(conf[impl], jx._max_conf(
                cls_prob, boxes))
    elif mode == 3:
        np.testing.assert_array_equal(got["bbox"], want["bbox"])
        assert got["num_bbox"] == 3


@pytest.mark.parametrize("conf_thresh", [0.0, 0.5, 0.99])
def test_select_boxes_matches_jax(extractors, conf_thresh):
    """The box budget (threshold ∩ [min, max]) picks the same boxes in the
    same order from the same probabilities."""
    jx, tx = extractors
    rng = np.random.RandomState(0)
    n, C = 30, SMALL["num_classes"]
    boxes = np.stack([np.arange(n) * 50.0, np.zeros(n),
                      np.arange(n) * 50.0 + 40, np.full(n, 40.0)],
                     axis=1).astype(np.float32)
    boxes[10] = boxes[11] + 1.0     # one overlapping pair
    cls_prob = rng.rand(n, C).astype(np.float32) * 0.01
    cls_prob[:5, 10] = 0.9
    jcfg, tcfg = jx.cfg, tx.cfg
    try:
        jx.cfg = dataclasses.replace(jcfg, conf_thresh=conf_thresh)
        tx.cfg = dataclasses.replace(tcfg, conf_thresh=conf_thresh)
        np.testing.assert_array_equal(tx._select_boxes(cls_prob, boxes),
                                      jx._select_boxes(cls_prob, boxes))
    finally:
        jx.cfg, tx.cfg = jcfg, tcfg


def test_extract_batch_equals_extract(extractors):
    """Streaming with lookahead 1 and 2 gives per-image ``extract``'s
    results bit for bit, images of several sizes, modes 1 and 3 (6
    proposals an image keep the ROI stage small)."""
    _, tx = extractors
    images = [_image(s, hw) for s, hw in
              ((1, (80, 100)), (2, (70, 90)), (3, (97, 61)))]
    gts = [np.array([[5, 5, 40, 50], [10, 3, 60, 44]], np.float32)] * 3
    cfg = tx.cfg
    try:
        tx.cfg = dataclasses.replace(cfg, post_nms_topk=6)
        for mode, gt in ((1, None), (3, gts)):
            single = [tx.extract(im, mode=mode,
                                 gt_boxes=None if gt is None else gt[i])
                      for i, im in enumerate(images)]
            for lookahead in (1, 2):
                batch = tx.extract_batch(images, mode=mode,
                                         gt_boxes_list=gt,
                                         lookahead=lookahead)
                for s, b in zip(single, batch):
                    for k in ("x", "bbox", "num_bbox"):
                        np.testing.assert_array_equal(b[k], s[k])
                    np.testing.assert_array_equal(b["info"]["objects_id"],
                                                  s["info"]["objects_id"])
    finally:
        tx.cfg = cfg
    with pytest.raises(ValueError):
        tx.extract(images[0], mode=3)
    with pytest.raises(ValueError):
        td.FeatureExtractor(tx.cfg, tx.model.state_dict(), nms_impl="fast",
                            device="cpu")


@pytest.mark.parametrize("dt", ["bfloat16", "uint8"])
def test_blob_transfer_dtypes_match_fp32(state, dt):
    """bf16/uint8 blob transfer give features within the JAX tests' bound
    (2e-2 of the largest magnitude) of the fp32 path, in mode 3."""
    img = _image(2)
    gt = np.array([[5, 5, 60, 60], [20, 10, 90, 70]], np.float32)
    cfg = td.DetectorConfig(**SMALL)
    ref = td.FeatureExtractor(cfg, state, device="cpu").extract(
        img, mode=3, gt_boxes=gt)
    got = td.FeatureExtractor(
        dataclasses.replace(cfg, blob_transfer_dtype=dt), state,
        device="cpu").extract(img, mode=3, gt_boxes=gt)
    assert _rel(got["x"], ref["x"]) < 2e-2


# ------------------------------------------------------------ CLI and tool

def _write_images(directory, shapes):
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    images = {}
    for i, hw in enumerate(shapes):
        img = _image(10 + i, hw)          # BGR
        Image.fromarray(img[:, :, ::-1]).save(
            os.path.join(directory, "%05d.png" % (i + 1)))
        images["%05d" % (i + 1)] = img
    return images


def _small_config(monkeypatch, module):
    monkeypatch.setattr(module, "DetectorConfig", functools.partial(
        module.DetectorConfig, **{k: v for k, v in SMALL.items()
                                  if k not in ("min_boxes", "max_boxes",
                                               "conf_thresh", "depth")}))


def test_extract_features_cli_matches_jax(tmp_path, monkeypatch, margins,
                                          state):
    """Both CLIs on 3 PNG images with the same torch weights file: the same
    npz files and keys, the same boxes, features within 1e-4. The port's
    mode 3 from mode 1's boxes gives mode 1's features, mode 2 writes boxes
    and probabilities, and a second mode-1 run writes nothing."""
    from meme_challenge_tpu.extract import extract_features as jcli
    from meme_challenge_tpu_torch.extract import extract_features as tcli
    from meme_challenge_tpu_torch.tools import convert_feature_export
    from meme_challenge_tpu_torch.data.meme_dataset import load_img_feature

    images = _write_images(str(tmp_path / "img"),
                           [(80, 100), (70, 90), (64, 96)])
    for img in images.values():
        margins(img)
    weights = str(tmp_path / "det.pth")
    torch.save({"model": state}, weights)
    _small_config(monkeypatch, jcli)
    _small_config(monkeypatch, tcli)
    common = ["--image-dir", str(tmp_path / "img"), "--weights", weights,
              "--min-boxes", "3", "--max-boxes", "8", "--conf-thresh", "0"]
    runs = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        out = runs[name] = str(tmp_path / name)
        cli.main(common + ["--out-dir", out] + extra)

    def load(path):
        z = np.load(path, allow_pickle=True)
        out = {k: z[k] for k in z.files if k != "info"}
        out["info"] = z["info"].item()
        return sorted(z.files), out

    names = sorted(os.listdir(runs["port"]))
    assert names == sorted(os.listdir(runs["jax"])) == [
        "00001.npz", "00002.npz", "00003.npz"]
    for f in names:
        keys, got = load(os.path.join(runs["port"], f))
        want_keys, want = load(os.path.join(runs["jax"], f))
        assert keys == want_keys == sorted(
            ["x", "bbox", "num_bbox", "image_h", "image_w", "info"])
        _assert_same_output(got, want, 1)
    # mode 3 reads mode 1's boxes back and pools the same regions
    mode3 = str(tmp_path / "port3")
    tcli.main(common + ["--out-dir", mode3, "--mode", "3", "--bbox-dir",
                        runs["port"], "--device", "cpu"])
    for f in names:
        _, got = load(os.path.join(mode3, f))
        _, one = load(os.path.join(runs["port"], f))
        np.testing.assert_allclose(got["bbox"], one["bbox"], rtol=1e-6)
        assert _rel(got["x"], one["x"]) <= NET_TOL

    tcli.main(common + ["--out-dir", str(tmp_path / "port2"), "--mode", "2",
                        "--device", "cpu"])
    for f in sorted(os.listdir(tmp_path / "port2")):
        got = np.load(os.path.join(tmp_path / "port2", f))
        assert sorted(got.files) == ["bbox", "cls_prob"]
        assert got["bbox"].shape[0] <= 8 and got["bbox"].shape[1] == 4

    stamps = {f: os.stat(os.path.join(runs["port"], f)).st_mtime_ns
              for f in names}
    calls = []
    monkeypatch.setattr(td.FeatureExtractor, "extract",
                        lambda *a, **k: calls.append(1))
    tcli.main(common + ["--out-dir", runs["port"], "--device", "cpu"])
    assert not calls and stamps == {
        f: os.stat(os.path.join(runs["port"], f)).st_mtime_ns
        for f in names}

    # the hand-off: npz → {id}.npy + {id}_info.npy → load_img_feature
    conv = str(tmp_path / "npy")
    convert_feature_export.main(["--input_dir", runs["port"],
                                 "--output_dir", conv])
    feat, pos, objects, conf = load_img_feature(conv, 2)
    npz = np.load(os.path.join(runs["port"], "00002.npz"),
                  allow_pickle=True)
    np.testing.assert_array_equal(feat, npz["x"])
    assert pos.shape == (int(npz["num_bbox"]), 7)
    np.testing.assert_array_equal(objects, npz["info"].item()["objects_id"])


def test_visualize_boxes_matches_jax(tmp_path, monkeypatch, capsys,
                                     margins, params, state):
    """Both tools on one image with the same weights file: the same
    annotated paths and box counts, and the same labels (what each tool's
    ``annotate_image`` returned, read from its ``box_labels``)."""
    from meme_challenge_tpu.extract import detector as jdet
    from meme_challenge_tpu.extract import train_detector
    from meme_challenge_tpu.tools import visualize_boxes as jvis
    from meme_challenge_tpu_torch.tools import visualize_boxes as tvis

    images = _write_images(str(tmp_path / "img"), [(80, 100)])
    margins(images["00001"])
    weights = str(tmp_path / "det.pth")
    torch.save({"model": state}, weights)
    _small_config(monkeypatch, jdet)
    _small_config(monkeypatch, td)
    # JAX load_weights draws a full init before it reads the file
    monkeypatch.setattr(train_detector, "init_detector_params",
                        lambda cfg, key: params)
    printed, labels = {}, {}
    for name, tool, extra in (("jax", jvis, []),
                              ("port", tvis, ["--device", "cpu"])):
        box_labels = tool.box_labels

        def record(*a, _name=name, _labels=box_labels, **k):
            labels[_name] = _labels(*a, **k)
            return labels[_name]

        monkeypatch.setattr(tool, "box_labels", record)
        out = str(tmp_path / name)
        tool.main(["--image-dir", str(tmp_path / "img"), "--out-dir", out,
                   "--weights", weights, "--conf-thresh", "0",
                   "--min-boxes", "3", "--max-boxes", "8"] + extra)
        printed[name] = capsys.readouterr().out.replace(out, "OUT")
        assert os.listdir(out) == ["00001_annotated.png"]
    assert printed["port"] == printed["jax"]
    assert printed["port"] == "OUT/00001_annotated.png: boxes=%d\n" % len(
        labels["port"])
    assert labels["port"] == labels["jax"] and labels["port"]
    classes = {i: "class%d" % i for i in range(0, SMALL["num_classes"], 2)}
    info = {"objects_id": np.array([0, 1, 2]), "attrs_id": np.array([4, 0, 3]),
            "attrs_conf": np.array([0.5, 0.05, 0.2])}
    assert tvis.box_labels(info, classes) == jvis.box_labels(info, classes)
    assert tvis.annotated_path("a/b.c.jpg", "o") == jvis.annotated_path(
        "a/b.c.jpg", "o")
