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
    assert {"meme_challenge_tpu_torch.train.train_uniter",
            "meme_challenge_tpu_torch.train.crossval_driver",
            "meme_challenge_tpu_torch.data.crossval_splits",
            "meme_challenge_tpu_torch.ops.device_metrics",
            "meme_challenge_tpu_torch.ensemble.ensemble",
            "meme_challenge_tpu_torch.parallel.mesh",
            "meme_challenge_tpu_torch.parallel.fold_parallel",
            "meme_challenge_tpu_torch.parallel.crossval_parallel",
            "meme_challenge_tpu_torch.data.pretrain",
            "meme_challenge_tpu_torch.models.ot",
            "meme_challenge_tpu_torch.train.pretrain_init",
            "meme_challenge_tpu_torch.train.pretrain_driver",
            "meme_challenge_tpu_torch.train.pretrain_uniter",
            "meme_challenge_tpu_torch.tools.prep_memotion",
            "meme_challenge_tpu_torch.tools.misclassification",
            "meme_challenge_tpu_torch.tools.convert_feature_export",
            "meme_challenge_tpu_torch.data.hatespeech",
            "meme_challenge_tpu_torch.data.object_text",
            "meme_challenge_tpu_torch.models.text_models",
            "meme_challenge_tpu_torch.models.oscar",
            "meme_challenge_tpu_torch.train.train_pure_text",
            "meme_challenge_tpu_torch.train.train_hatespeech",
            "meme_challenge_tpu_torch.train.train_object_text",
            "meme_challenge_tpu_torch.train.train_oscar"} <= set(mods)
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


def test_parallel_modules_import_no_jax_and_default_to_cuda():
    """parallel/*: no import statement of jax or of the JAX package, and
    the fold-parallel driver runs on CUDA unless asked for the CPU."""
    from meme_challenge_tpu_torch.parallel import crossval_parallel

    parallel = os.path.join(PORT, "parallel")
    files = sorted(f for f in os.listdir(parallel) if f.endswith(".py"))
    assert {"mesh.py", "fold_parallel.py", "crossval_parallel.py"} <= set(
        files)
    for f in files:
        test_no_forbidden_import_statement(
            os.path.relpath(os.path.join(parallel, f), ROOT))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        crossval_parallel.train_crossval_fold_parallel(None, None, {})


def test_pretrain_cli_defaults_to_cuda_and_raises_without_card():
    """The pretraining CLI runs on CUDA unless asked for the CPU; without a
    card it raises before it reads any data."""
    from meme_challenge_tpu_torch.train import pretrain_uniter

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pretrain_uniter.main(["--vocab_file", "unused.txt"])


@pytest.mark.parametrize("cli,argv", [
    ("train_pure_text", ["--vocab_file", "unused.txt"]),
    ("train_hatespeech", ["--vocab_file", "unused.txt", "--train_csv",
                          "unused.csv", "--val_csv", "unused.csv"]),
    ("train_object_text", ["--vocab_file", "unused.txt", "--object_file",
                           "unused.npz", "--object_to_text_file",
                           "unused.json"]),
    ("train_oscar", ["--vocab_file", "unused.txt"]),
])
def test_text_and_oscar_clis_default_to_cuda_and_raise_without_card(cli,
                                                                     argv):
    """The text-only and Oscar CLIs run on CUDA unless asked for the CPU;
    without a card they raise before they read any file."""
    import importlib

    module = importlib.import_module("meme_challenge_tpu_torch.train." + cli)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(argv)
