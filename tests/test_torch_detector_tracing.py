"""PyTorch port: the named host ranges of detector training
(``extract/detector_train.py``, ``extract/vg_data.py``,
``extract/train_detector.train_iteration``) as a CPU ``torch.profiler``
records them: each range once in a step, nested as the step nests its
phases, none a user annotation (the profiler would mirror one onto the
device's timeline, where a trace's reader counts it as a kernel), every
operation of the step inside its forward, backward or optimizer phase; and
the ``train_detector`` CLI's losses the same as the loop body it had before
that body became ``train_iteration``."""
import argparse

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.extract import detector as td
from meme_challenge_tpu_torch.extract import train_detector as ttd
from meme_challenge_tpu_torch.extract.detector_train import (
    loss_values,
    make_detector_train_step,
)
from meme_challenge_tpu_torch.extract.vg_data import VGDetectionLoader

CFG = td.DetectorConfig(num_classes=11, num_attributes=5, min_size=64,
                        max_size=96, size_divisibility=32)
PROPOSALS = 4
SEED = 3
STEP_RANGES = ("meme.step.forward", "meme.step.backward",
               "meme.step.optimizer")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (several test workers share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _records():
    return [{"file_name": "", "image_id": i, "height": 48, "width": 72,
             "boxes": np.array([[4, 4, 30, 30], [20, 10, 60, 40],
                                [8, 20, 50, 46]], np.float32),
             "classes": np.array([0, 2, 9], np.int32),
             "attrs": np.array([1, -1, 3], np.int32)} for i in (1, 2)]


def _reader(rec):
    return (np.random.RandomState(rec["image_id"]).rand(
        rec["height"], rec["width"], 3) * 255).astype(np.uint8)


def _step():
    model = td.init_detector(CFG, torch.Generator().manual_seed(SEED))
    return make_detector_train_step(model, CFG, ttd.detector_optimizer(1e-5),
                                    num_proposals=PROPOSALS)


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.fixture(scope="module")
def traced():
    """One iteration of the CLI's loop, the loader's first batch included,
    under the profiler."""
    step = _step()
    loader = VGDetectionLoader(_records(), CFG, max_gt=8, is_train=True,
                               seed=SEED, image_reader=_reader)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = next(iter(loader))
        ttd.train_iteration(step, batch, SEED, 0, "cpu", 1)
    return list(prof.events())


def test_each_range_once(traced):
    names = [e.name for e in traced if e.name.startswith("meme.")]
    assert sorted(names) == sorted([
        "meme.loader.order", "meme.loader.batch", "meme.upload", "meme.rng",
        "meme.step", *STEP_RANGES, "meme.det.rpn", "meme.det.roi"])
    assert not [e.name for e in traced
                if e.name.startswith("meme.") and e.is_user_annotation]


def test_ranges_nest_as_the_step(traced):
    """The loader's order then its batch, closed before the upload; the
    upload and the generator before the step; forward, backward and
    optimizer inside the step, one after the other; the RPN's and the ROI
    stage's ranges inside the forward."""
    by = {e.name: e for e in traced if e.name.startswith("meme.")}
    order = ["meme.loader.order", "meme.loader.batch", "meme.upload",
             "meme.rng", "meme.step"]
    for a, b in zip(order, order[1:]):
        assert by[a].time_range.end <= by[b].time_range.start, (a, b)
    phases = [by[n] for n in STEP_RANGES]
    assert all(_inside(p, by["meme.step"]) for p in phases)
    assert all(a.time_range.end <= b.time_range.start
               for a, b in zip(phases, phases[1:]))
    rpn, roi = by["meme.det.rpn"], by["meme.det.roi"]
    assert _inside(rpn, by["meme.step.forward"])
    assert _inside(roi, by["meme.step.forward"])
    assert rpn.time_range.end <= roi.time_range.start


def test_every_operation_of_the_step_lies_in_a_phase(traced):
    """The step's own work starts inside forward, backward or optimizer,
    so the launch counts of the three add up to the step's."""
    (step,) = [e for e in traced if e.name == "meme.step"]
    phases = [e for e in traced if e.name in STEP_RANGES]
    ops = [e for e in traced if e.name.startswith("aten::")
           and step.time_range.start <= e.time_range.start
           <= step.time_range.end]
    assert ops
    outside = [e.name for e in ops
               if not any(p.time_range.start <= e.time_range.start
                          <= p.time_range.end for p in phases)]
    assert outside == []


@pytest.fixture
def one_thread():
    """One intra-op thread: with two, the CPU's backward accumulates in an
    order that changes from run to run, and two identical runs part in
    the losses' sixth digit from the second step on."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_cli_losses_as_the_loop_was(tmp_path, one_thread):
    """``train`` (every step's losses read) against the loop body it had
    before: the loader's batch without ``image_id``, the step called with
    the iteration's generator; bit for bit."""
    ns = argparse.Namespace(out_dir=str(tmp_path), weights="", epochs=1,
                            lr=1e-5, seed=SEED, max_gt=8,
                            num_proposals=PROPOSALS, log_every=1,
                            eval_images=0, device="cpu")
    _, history = ttd.train(ns, CFG, _records(), [], image_reader=_reader)

    model = td.BUADetector(CFG)
    model.load_state_dict(ttd.load_weights("", CFG, seed=SEED), strict=True)
    step = make_detector_train_step(model, CFG, ttd.detector_optimizer(1e-5),
                                    num_proposals=PROPOSALS)
    loader = VGDetectionLoader(_records(), CFG, max_gt=8, is_train=True,
                               seed=SEED, image_reader=_reader)
    want = []
    for it, batch in enumerate(loader):
        batch = {k: v for k, v in batch.items() if k != "image_id"}
        losses = step(batch, dropout_generator(SEED, it, "cpu"))
        want.append((it + 1, loss_values(losses)))
    assert len(want) == 2
    assert history["losses"] == want
