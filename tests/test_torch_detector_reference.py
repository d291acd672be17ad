"""PyTorch port: the detector's train step against the benchmark's plain
reference (``portbench/reference/detector.py``) on the CPU, at
``DetectorConfig()``'s widths (Caffe ResNet-101, 1601 classes, 401
attributes) on a 128 × 192 blob, from the reference's own weights of a seed
(the decision layers scaled as the benchmark's configuration scales them)
loaded into the port by name and shape, on the same three draws: the
decisions (anchor and proposal labels and samples), the five losses, every
gradient, one optimizer step's change, and ROIAlign alone, forward and
gradient.

The reference is written apart from the port (detectron2's IoU, matching,
sampling by dynamic index sets, ROIAlign as four gathers), so the two agree
to rounding, and exactly where the result is a decision."""
import json
import os

import numpy as np
import pytest
import torch

from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.extract import detector as td
from meme_challenge_tpu_torch.extract.detector_train import (
    make_detector_train_step,
    subsample_labels,
)
from meme_challenge_tpu_torch.extract.ops import roi_align
from meme_challenge_tpu_torch.extract.train_detector import (
    detector_optimizer,
)
from meme_challenge_tpu_torch.extract.vg_data import VGDetectionLoader
from portbench.drivers.detector_train import detector_config
from portbench.reference import detector as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 19
PROPOSALS = 6       # ROIs a step: res5 on each is most of a CPU step
LR = 1e-2           # large enough that a change is not lost to the
#                     rounding of the fp32 weights it is added to


def _config() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "bua-caffe-r101.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (several test workers share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def case():
    """The detector at the published widths with the weights of SEED, one
    128 × 192 image with 7 boxes (one crossing the border's last pixels,
    two overlapping), its batch through the port's loader, and the step's
    draws."""
    raw = _config()
    raw.update(min_size=128, max_size=192)
    cfg = detector_config(raw)
    state = ref.make_weights(raw, SEED, "cpu")
    rng = np.random.RandomState(3)
    rec = {"file_name": "", "image_id": 1, "height": 128, "width": 192,
           "boxes": np.array([[4, 6, 60, 70], [30, 20, 120, 110],
                              [100, 2, 190, 126], [10, 80, 40, 120],
                              [120, 40, 150, 90], [125, 45, 160, 95],
                              [0, 0, 191.5, 127.5]], np.float32),
           "classes": np.array([0, 5, 1599, 17, 3, 3, 1], np.int32),
           "attrs": np.array([2, -1, 399, -1, 0, 7, -1], np.int32)}
    img = (rng.rand(128, 192, 3) * 255).astype(np.uint8)
    loader = VGDetectionLoader([rec], cfg, max_gt=10, is_train=False,
                               image_reader=lambda r: img)
    batch = loader._one(rec)
    model = td.BUADetector(cfg)
    model.load_state_dict(state, strict=True)
    step = make_detector_train_step(model, cfg, detector_optimizer(LR),
                                    num_proposals=PROPOSALS)
    n = ref.feat_size(128) * ref.feat_size(192) * step.num_anchors
    draws = step.draw(n, dropout_generator(SEED, 0, "cpu"))
    return {"raw": raw, "cfg": cfg, "state": state, "batch": batch,
            "step": step, "draws": draws}


@pytest.fixture(scope="module")
def passes(case):
    """One gradient pass of the port and of the reference on the same
    draws, and one optimizer update of each."""
    step, raw = case["step"], case["raw"]
    losses, aux = step.losses(case["batch"], case["draws"], aux=True)
    names = list(step.params)
    grads = torch.autograd.grad(sum(losses.values()),
                                [step.params[k] for k in names])
    port = {"losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": dict(zip(names, grads)), "aux": aux}
    w = {k: v.clone().requires_grad_(True) for k, v in case["state"].items()}
    rlosses, dec = ref.step_losses(w, case["batch"], case["draws"], raw)
    rgrads = torch.autograd.grad(sum(rlosses[k] for k in ref.LOSS_KEYS),
                                 [w[k] for k in names])
    want = {"losses": {k: float(v.detach()) for k, v in rlosses.items()},
            "grads": dict(zip(names, rgrads)), "decisions": dec}
    before = {k: v.detach().clone() for k, v in step.params.items()}
    step.optimizer.step(step.params, port["grads"], step.opt_state)
    port["change"] = {k: step.params[k].detach() - before[k] for k in names}
    trace = {k: torch.zeros_like(v) for k, v in w.items()}
    with torch.no_grad():
        ref.sgd_step(w, want["grads"], trace,
                     {"lr": LR, "momentum": 0.9, "max_grad_norm": 5.0})
    want["change"] = {k: w[k].detach() - case["state"][k] for k in names}
    return port, want


def test_decisions_are_equal(case, passes):
    """Anchor labels (positive, negative, ignored), the sampled anchors,
    the proposals' classes and the sampled proposals: decisions on the
    boxes and the draws alone, so equal, not close."""
    port, want = passes
    rpn_u, roi_u, _ = case["draws"]
    aux, dec = port["aux"], want["decisions"]
    labels = aux["anchor_labels"]
    assert (labels == 1).any() and (labels == 0).any()
    assert torch.equal(labels, dec["anchor_labels"])
    assert torch.equal(subsample_labels(labels, rpn_u) > 0,
                       dec["anchor_sampled"])
    assert torch.equal(aux["proposal_labels"], dec["proposal_labels"])
    fg = (aux["proposal_labels"] > 0).long()
    assert torch.equal(subsample_labels(fg, roi_u) > 0,
                       dec["proposal_sampled"])


def test_losses_match(passes):
    """The five losses within 1e-5 relative: the same float32 products in
    another order (the objectness as a two-way softmax, not a sigmoid of
    the logits' difference; ROIAlign's gathers), a few units of float32's
    1.2e-7 through the 26 residual blocks."""
    port, want = passes
    assert set(port["losses"]) == set(ref.LOSS_KEYS)
    for k in ref.LOSS_KEYS:
        assert port["losses"][k] == pytest.approx(want["losses"][k],
                                                  rel=1e-5), k


def test_gradients_match(passes):
    """Every leaf's gradient within 1e-4 of its largest element: the
    losses' rounding carried back through the 104 convolutions; a ReLU
    whose input rounds to the other side moves a few elements further,
    which this bound holds (chip_smoke 13a's bound, card against CPU)."""
    port, want = passes
    for k, g in want["grads"].items():
        got = port["grads"][k]
        scale = float(g.abs().max())
        assert float((got - g).abs().max()) <= 1e-4 * scale, (
            k, float((got - g).abs().max()), scale)


def test_one_optimizer_step_matches(case, passes):
    """The change of every leaf after one clipped SGD step: within 1e-4 of
    its largest element, as the gradients, plus one unit in the last place
    of the weights it was added to (each side rounds its own sum)."""
    port, want = passes
    for k, d in want["change"].items():
        p0 = case["state"][k].abs()
        ulp = float((torch.nextafter(p0, torch.full_like(p0, np.inf))
                     - p0).max())
        got = port["change"][k]
        assert float((got - d).abs().max()) <= (
            1e-4 * float(d.abs().max()) + ulp), k


@pytest.mark.parametrize("sampling_ratio", [2, 1])
def test_roi_align_matches_the_gathers(sampling_ratio):
    """The port's ROIAlign against the reference's four gathers, forward
    and gradient of the map: within 1e-5 of the largest element (the same
    bilinear weights summed in another order). ROIs inside, crossing each
    border, beyond it by more than a pixel, and thinner than a cell."""
    gen = torch.Generator().manual_seed(5)
    feat = torch.randn(6, 9, 13, generator=gen, requires_grad=True)
    rois = torch.tensor([[8.0, 8.0, 150.0, 100.0], [-30.0, -20.0, 60.0, 40.0],
                         [150.0, 100.0, 260.0, 190.0],
                         [230.0, 160.0, 300.0, 220.0],
                         [40.0, 50.0, 44.0, 51.0], [0.0, 0.0, 208.0, 144.0]])
    cot = torch.randn(len(rois), 6, 7, 7, generator=gen)
    got = roi_align(feat, rois, 1 / 16, (7, 7), sampling_ratio)
    want = ref.roi_align(feat, rois, 1 / 16, 7, sampling_ratio)
    assert float((got - want).detach().abs().max()) <= 1e-5 * float(
        want.detach().abs().max())
    (g_got,) = torch.autograd.grad(got, feat, cot)
    (g_want,) = torch.autograd.grad(want, feat, cot)
    assert float((g_got - g_want).abs().max()) <= 1e-5 * float(
        g_want.abs().max())
    assert float(want[3].detach().abs().max()) == 0.0  # beyond the map
