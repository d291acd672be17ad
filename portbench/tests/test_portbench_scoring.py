"""The scoring cell at a size the CPU holds: sound, it is correct; an answer
altered or half of a batch's answers left out makes it not correct. And a
whole run in a process of its own loads no JAX."""
import json
import os
import subprocess
import sys

from portbench import harness

SEED = 2 ** 31 + 13


def _run(cell):
    return harness.run(cell, SEED, 0.3, False, "cpu", 0.0)


def test_scoring_sound_run_is_correct(tiny_cell):
    r = _run(tiny_cell("base_infer_fp32"))
    assert r["correct"], r["checks"]
    assert r["attempted"] % 150 == 0 and r["failed"] == 0
    assert r["metrics"]["infer_samples_per_s"]["value"] > 0


def test_altered_answer_is_not_correct(tiny_cell, monkeypatch):
    from meme_challenge_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "sigmoid_probs",
                        lambda logits: trainer.torch.sigmoid(
                            logits.reshape(logits.shape[0], -1)[:, 0].float())
                        + 1e-2)
    r = _run(tiny_cell("base_infer_fp32"))
    assert not r["correct"]


def test_half_of_each_batch_left_out_is_not_correct(tiny_cell, monkeypatch):
    from meme_challenge_tpu_torch.data import meme_dataset

    it = meme_dataset.BatchLoader.__iter__

    def half(self):
        for b in it(self):
            b["sample_mask"] = b["sample_mask"].copy()
            b["sample_mask"][len(b["sample_mask"]) // 2:] = 0
            yield b

    monkeypatch.setattr(meme_dataset.BatchLoader, "__iter__", half)
    r = _run(tiny_cell("base_infer_fp32"))
    assert not r["correct"]
    assert r["checks"]["prob_gap"]["value"] == 1.0


CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from portbench import harness
from conftest import tiny_cell
make = tiny_cell.__wrapped__()
r = harness.run(make("base_ft_fp32"), 5, 0.2, False, "cpu", 0.0)
sys.path.insert(0, {pb!r})
import run
print(json.dumps({{"bad": run.forbidden_modules(), "correct": r["correct"]}}))
"""


def test_a_run_loads_no_jax():
    root = harness.ROOT
    code = CHILD.format(root=root, tests=os.path.dirname(__file__),
                        pb=os.path.join(root, "portbench"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "correct": True}
