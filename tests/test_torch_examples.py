"""PyTorch port, the two quickstarts (``examples/torch_quickstart.py``,
``examples/torch_pretrain_quickstart.py``): each runs as a script with
``--device cpu`` into a temporary directory, in a process of its own with
two intra-op threads, writes its artifacts, prints finite AUROCs or
logits, and loads no module of JAX or of the JAX package."""
import json
import math
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax")


def _run(script: str, out_dir: str) -> tuple:
    """(stdout, modules loaded) of ``script out_dir --device cpu``."""
    code = (
        "import json, runpy, sys\n"
        "sys.argv = [%r, %r, '--device', 'cpu']\n"
        "runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "print('MODULES ' + json.dumps(sorted(sys.modules)))\n"
        % (os.path.join(ROOT, "examples", script), out_dir))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=out_dir, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    modules = json.loads(lines[-1][len("MODULES "):])
    bad = [m for m in modules if m.split(".")[0] in FORBIDDEN
           or m == "meme_challenge_tpu" or m.startswith("meme_challenge_tpu.")]
    assert not bad, bad
    assert "meme_challenge_tpu_torch" in modules
    return "\n".join(lines[:-1]), modules


def _numbers(stdout: str, label: str) -> list:
    return [float(x) for x in re.findall(label + r"[^\d]*([-\d.]+|nan|inf)",
                                         stdout)]


def test_quickstart_runs_on_cpu(tmp_path):
    stdout, _ = _run("torch_quickstart.py", str(tmp_path))
    aucs = (_numbers(stdout, "mean fold AUROC:")
            + _numbers(stdout, "fold-stacked mean AUROC:")
            + _numbers(stdout, r"ensemble:"))
    assert len(aucs) == 3, stdout
    assert all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs), stdout
    for run in ("ckpt", "ckpt_fp"):
        files = set(os.listdir(tmp_path / run))
        for fold in (0, 1):
            assert {"quick_fold_%d.ckpt" % fold,
                    "quick_fold_%d_metrics.json" % fold,
                    "quick_fold_%d_test_seen_preds.csv" % fold} <= files
        assert {"quick_%s_ensemble.csv" % s for s in (
            "dev_seen", "dev_unseen", "test_seen", "test_unseen")} <= files
        with open(tmp_path / run / "quick_fold_0_metrics.json") as f:
            assert math.isfinite(json.load(f)["dev"]["aucroc"])


def test_pretrain_quickstart_runs_on_cpu(tmp_path):
    stdout, _ = _run("torch_pretrain_quickstart.py", str(tmp_path))
    losses = {t: _numbers(stdout, r"%s\s+final-epoch loss:" % t)
              for t in ("mlm", "itm", "mrfr", "mrc")}
    assert all(len(v) == 1 and math.isfinite(v[0])
               for v in losses.values()), stdout
    assert "shape=(8, 1), finite=True" in stdout, stdout
    assert os.path.isfile(tmp_path / "ck" / "pretrained.ckpt")


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_pretrain_quickstart.py"])
def test_quickstart_defaults_to_cuda_and_raises_without_card(script,
                                                              tmp_path):
    """Without ``--device cpu`` a quickstart runs on the card; without one
    it raises before it writes anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script),
         str(tmp_path / "out")], capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr, out.stderr[-2000:]
    assert not os.path.exists(tmp_path / "out")
