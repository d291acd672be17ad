"""The detector cell on the CPU: its traffic generator, its FLOP count, its
files, and whole runs at a tiny size, sound and with the res4 map's
gradient from the ROI stage dropped in the program."""
import json
import os

import numpy as np
import pytest
import torch

from portbench import flops_detector, harness
from portbench.drivers.detector_train import detector_config
from portbench.traffic import vg

CELL = "detector_train_600x800"
SEED = 2 ** 31 + 23


@pytest.fixture
def small_mix():
    mix = harness.mix("vg_train_600x800")
    mix.update(images=48, image_size={"width": 200, "height": 150})
    return mix


def test_traffic_repeats_by_seed(tmp_path, small_mix):
    small_mix["images"] = 3
    a = vg.generate(small_mix, SEED, str(tmp_path / "a"))
    b = vg.generate(small_mix, SEED, str(tmp_path / "b"))
    c = vg.generate(small_mix, SEED + 1, str(tmp_path / "c"))

    def files(corpus):
        names = sorted(os.listdir(corpus.image_root))
        return [open(corpus.json_file, "rb").read()] + [
            open(os.path.join(corpus.image_root, n), "rb").read()
            for n in names]

    assert files(a) == files(b)
    assert files(a)[0] != files(c)[0] and files(a)[1] != files(c)[1]


def test_traffic_has_its_stated_distributions(tmp_path, monkeypatch):
    """At the mix's own image size: box counts of median 25 within 2-64,
    sides within 16-600 px and inside the image, log-uniform (as many under
    the geometric middle as above), Zipf-ranked classes (rank 1 holds
    1 / H(1600) ≈ 12.6 %), half the instances with one attribute, and JPEGs
    the program's loader reads."""
    from meme_challenge_tpu_torch.extract.vg_data import load_vg_json

    mix = harness.mix("vg_train_600x800")
    mix["images"] = 200
    # the boxes alone: a blank image a file
    monkeypatch.setattr(vg, "texture",
                        lambda rng, h, w: np.zeros((8, 8, 3), np.uint8))
    corpus = vg.generate(mix, SEED, str(tmp_path))
    coco = json.load(open(corpus.json_file))
    counts = np.bincount([a["image_id"] for a in coco["annotations"]])[1:]
    assert len(counts) == 200 and counts.min() >= 2 and counts.max() <= 64
    assert 21 <= np.median(counts) <= 29
    box = np.array([a["bbox"] for a in coco["annotations"]])
    assert box[:, 2:].min() >= 16 - 0.01
    assert box[:, 2].max() <= 600 and box[:, 3].max() <= 600
    assert (box[:, 0] >= 0).all() and (box[:, 0] + box[:, 2] <= 800.01).all()
    assert (box[:, 1] >= 0).all() and (box[:, 1] + box[:, 3] <= 600.01).all()
    below = np.mean(box[:, 3] < np.sqrt(16 * 600))
    assert 0.45 < below < 0.55
    cls = np.array([a["category_id"] for a in coco["annotations"]])
    assert 0.10 < np.mean(cls == 1) < 0.15
    assert np.mean(cls == 2) < np.mean(cls == 1)
    has = np.mean(["attribute" in a for a in coco["annotations"]])
    assert 0.45 < has < 0.55
    records = load_vg_json(corpus.json_file, corpus.image_root)
    assert len(records) == 200 and records[0]["boxes"].shape[1] == 4


def test_texture_is_a_photograph_sized_jpeg(tmp_path, small_mix):
    import cv2

    small_mix.update(images=1, image_size={"width": 800, "height": 600})
    corpus = vg.generate(small_mix, SEED, str(tmp_path))
    (name,) = os.listdir(corpus.image_root)
    path = os.path.join(corpus.image_root, name)
    assert 60e3 < os.path.getsize(path) < 400e3
    img = cv2.imread(path)
    assert img.shape == (600, 800, 3) and img.std() > 20


def test_flops_agree_with_the_flop_counter():
    """The count of every convolution and Linear of the program's forward,
    against torch's own counter on the same forward at a tiny blob."""
    from torch.utils.flop_counter import FlopCounterMode

    from meme_challenge_tpu_torch.extract.detector import BUADetector

    cfg = harness.resolve(CELL).cfg
    model = BUADetector(detector_config(cfg)).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.backbone_rpn(torch.zeros(1, 3, 70, 100))
        model.roi_forward(torch.zeros(3, 1024, 14, 14))
    assert counter.get_total_flops() == flops_detector.forward_flops(
        cfg, 70, 100, 3)
    assert flops_detector.step_flops(cfg, 640, 832, 64) == 3 * \
        flops_detector.forward_flops(cfg, 640, 832, 64)
    # the map at 640 x 832 is 40 x 52, and ROIAlign moves it and the output
    assert flops_detector.roi_align_bytes(cfg, 640, 832, 64) == \
        4 * 1024 * (40 * 52 + 64 * 14 * 14)


def test_the_reference_makes_the_weights_the_program_loads():
    """The reference's weights of a seed: the same again for the seed,
    others for the next; they load into the program at the configuration's
    widths by name and shape, and not into a program built to another
    width; lecun-normal (truncated at two deviations), the decision layers
    scaled."""
    import dataclasses

    from meme_challenge_tpu_torch.extract.detector import BUADetector
    from portbench.reference import detector as ref

    cfg = harness.resolve(CELL).cfg
    w = ref.make_weights(cfg, SEED, "cpu")
    again = ref.make_weights(cfg, SEED, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    k = "backbone.res4.5.conv2.weight"
    assert not torch.equal(w[k], ref.make_weights(cfg, SEED + 1, "cpu")[k])
    BUADetector(detector_config(cfg)).load_state_dict(w, strict=True)
    narrow = dataclasses.replace(detector_config(cfg), rpn_channels=256)
    with pytest.raises(RuntimeError, match="size mismatch"):
        BUADetector(narrow).load_state_dict(w, strict=True)
    std = (1.0 / (256 * 9)) ** 0.5
    assert float(w[k].std()) == pytest.approx(std, rel=0.01)
    assert float(w[k].abs().max()) <= 2 * std / ref.TRUNCATED_STD
    scaled = "roi_heads.box_predictor.cls_score.weight"
    assert float(w[scaled].std()) == pytest.approx(
        cfg["decision_scale"][scaled] / 2048 ** 0.5, rel=0.01)
    assert float(w["backbone.res3.0.conv1.norm.weight"].min()) == 1.0


def test_the_cell_is_found_as_files():
    cell = harness.resolve(CELL)
    assert cell.chips == 1 and cell.mix["driver"] == "detector_train"
    assert cell.limits["label_gap"] == 0
    assert {m["name"] for m in cell.end_to_end} == {
        "train_samples_per_s", "peak_gib", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"rpn_launches_per_step.train", "roi_launches_per_step.train",
            "roi_align_ms.train", "mfu.train"} <= names
    assert "attn_roofline.train" not in names
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.fixture
def tiny_detector_cell():
    """The cell at the published widths on 6 images of 160 × 120 (blob
    96 × 128), 6 proposals a step."""
    cell = harness.resolve(CELL)
    cell.cfg.update(min_size=96, max_size=160)
    cell.mix.update(images=6, image_size={"width": 160, "height": 120})
    cell.mix["gt_boxes"].update(median=6, max=12)
    cell.mix["train"].update(num_proposals=6, max_gt=12)
    return cell


@pytest.fixture
def detached_pool(monkeypatch):
    """The program's ROIAlign reads the res4 map detached: the ROI stage's
    gradient no longer reaches the backbone."""
    from meme_challenge_tpu_torch.extract import detector_train

    real = detector_train.roi_align
    monkeypatch.setattr(detector_train, "roi_align",
                        lambda feat, *a, **k: real(feat.detach(), *a, **k))


def _run(cell):
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    try:
        return harness.run(cell, SEED, 0.2, False, "cpu", 0.0)
    finally:
        torch.set_num_threads(before)


def test_a_sound_run_is_correct(tiny_detector_cell):
    r = _run(tiny_detector_cell)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"loss_gap", "label_gap", "grad_gap",
                                "delta_gap"}
    assert r["checks"]["label_gap"]["value"] == 0
    assert r["metrics"]["train_samples_per_s"]["value"] > 0


def test_a_detached_pool_is_not_correct(tiny_detector_cell, detached_pool):
    r = _run(tiny_detector_cell)
    assert not r["correct"], r["checks"]
    assert r["checks"]["grad_gap"]["value"] > \
        r["checks"]["grad_gap"]["limit"]
