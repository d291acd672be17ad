"""PyTorch port: imports nothing of JAX or of the JAX package (nor do its
examples, ``examples/torch_*.py``), and its entry points run on CUDA unless
asked for the CPU (raising here, without a card)."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
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
            "meme_challenge_tpu_torch.parallel.dryrun",
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
            "meme_challenge_tpu_torch.train.train_oscar",
            "meme_challenge_tpu_torch.extract.native",
            "meme_challenge_tpu_torch.extract.ops",
            "meme_challenge_tpu_torch.extract.resnet",
            "meme_challenge_tpu_torch.extract.detector",
            "meme_challenge_tpu_torch.extract.convert_detector",
            "meme_challenge_tpu_torch.extract.extract_features",
            "meme_challenge_tpu_torch.extract.vg_eval",
            "meme_challenge_tpu_torch.extract.vg_data",
            "meme_challenge_tpu_torch.extract.detector_train",
            "meme_challenge_tpu_torch.extract.train_detector",
            "meme_challenge_tpu_torch.ops.iou",
            "meme_challenge_tpu_torch.ops.nms",
            "meme_challenge_tpu_torch.tools.visualize_boxes"} <= set(mods)
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


EXAMPLES = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.startswith("torch_") and f.endswith(".py"))


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_imports_no_jax(script):
    """The port's examples (``examples/torch_*.py``) hold no import
    statement of JAX or of the JAX package."""
    test_no_forbidden_import_statement(os.path.join("examples", script))


def test_port_examples_exist():
    assert EXAMPLES == ["torch_pretrain_quickstart.py", "torch_quickstart.py"]


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
    the fold-parallel driver and the dry run run on CUDA unless asked for
    the CPU."""
    from meme_challenge_tpu_torch.parallel import crossval_parallel, dryrun

    parallel = os.path.join(PORT, "parallel")
    files = sorted(f for f in os.listdir(parallel) if f.endswith(".py"))
    assert {"mesh.py", "fold_parallel.py", "crossval_parallel.py",
            "dryrun.py"} <= set(files)
    for f in files:
        test_no_forbidden_import_statement(
            os.path.relpath(os.path.join(parallel, f), ROOT))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        crossval_parallel.train_crossval_fold_parallel(None, None, {})
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--spawn", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.entry()


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


@pytest.mark.parametrize("tool,argv", [
    ("extract.extract_features", ["--image-dir", "unused", "--out-dir",
                                  "unused"]),
    ("tools.visualize_boxes", ["--image-dir", "unused", "--weights",
                               "unused.pth"]),
    ("extract.train_detector", ["--image-root", "unused", "--train-json",
                                "unused.json"]),
])
def test_extraction_clis_default_to_cuda_and_raise_without_card(tool, argv):
    """The extraction CLI, the box visualizer and the detector-training CLI
    run on CUDA unless asked for the CPU; without a card they raise before
    they read any file."""
    import importlib

    module = importlib.import_module("meme_challenge_tpu_torch." + tool)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(argv)


def test_resolve_device_pins_fp32_on_cuda(monkeypatch):
    """A cuda device turns TF32 off for matmuls and for cuDNN (on by
    default), so the detector's convolutions compute in fp32."""
    from meme_challenge_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    resolve_device("cpu")
    assert torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("cuda") == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _tree_state(root):
    state = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in (".git", "build", "__pycache__",
                                                ".pytest_cache",
                                                "chiprun_out")]
        for f in files:
            path = os.path.join(dirpath, f)
            st = os.stat(path)
            state[path] = (st.st_size, st.st_mtime_ns)
    return state


def test_native_library_builds_only_under_build():
    """Building the port's native ops leaves the JAX package's tracked
    native/libbua_ops.so byte for byte as it was and writes nothing outside
    build/."""
    import hashlib

    from meme_challenge_tpu_torch.extract import native

    tracked = os.path.join(ROOT, "native", "libbua_ops.so")

    def digest():
        with open(tracked, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before, tree = digest(), _tree_state(ROOT)
    path = native.build_library(force=True)
    assert digest() == before
    assert _tree_state(ROOT) == tree
    assert os.path.isfile(path)
    assert os.path.commonpath([path, os.path.join(ROOT, "build")]) == \
        os.path.join(ROOT, "build")
    assert native.nms(np.array([[0, 0, 10, 10]], np.float32),
                      np.array([0.9], np.float32), 0.3).tolist() == [0]
