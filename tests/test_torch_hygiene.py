"""PyTorch port: imports nothing of JAX or of the JAX package, and its entry
points run on CUDA unless asked for the CPU (raising here, without a card)."""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "meme_challenge_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax")


def _forbidden(name: str) -> bool:
    # meme_challenge_tpu_torch starts with meme_challenge_tpu: match the
    # package itself and its submodules only
    top = name.split(".")[0]
    return (top in FORBIDDEN or name == "meme_challenge_tpu"
            or name.startswith("meme_challenge_tpu."))


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_forbidden_name_check_respects_the_prefix():
    assert _forbidden("meme_challenge_tpu")
    assert _forbidden("meme_challenge_tpu.ops.attention")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("meme_challenge_tpu_torch")
    assert not _forbidden("meme_challenge_tpu_torch.ops.attention")
    assert not _forbidden("jaxtyping_free")


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "meme_challenge_tpu_torch.train.train_uniter" in mods
    # modules an interpreter start-up hook may preload are not the port's
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n" % mods)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert "meme_challenge_tpu_torch.ops.attention" in loaded
    assert not bad, bad


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")))
def test_no_forbidden_import_statement(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)], path


def test_cli_defaults_to_cuda_and_raises_without_card():
    from meme_challenge_tpu_torch.train import train_uniter

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_uniter.main(["--vocab_file", "unused.txt"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_uniter.build_entry(None, None, "unused.txt")


def test_resolve_device():
    from meme_challenge_tpu_torch.core.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
