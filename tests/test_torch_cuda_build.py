"""PyTorch port, ops/cuda_build.py: a library's file name hashes every file
under csrc/, so an edited or added source or header is rebuilt and a stale
library is never loaded. Nothing is compiled here (no nvcc on the CPU)."""
import os
import shutil

import pytest

from meme_challenge_tpu_torch.ops import cuda_build

CSRC_FILES = sorted(os.listdir(cuda_build.CSRC_DIR))


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, copy)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(copy))
    return copy


def _paths():
    return {name: cuda_build.library_path(name)
            for name in cuda_build.LIBRARIES}


def test_csrc_holds_the_sources_and_headers():
    assert {"fused_attention.cu", "fused_attention_bwd.cu",
            "attention_common.cuh", "mma_bf16.cuh"} <= set(CSRC_FILES)


def test_library_path_is_stable_and_per_library(csrc_copy):
    first = _paths()
    assert _paths() == first
    assert len(set(first.values())) == len(first)
    for name, path in first.items():
        assert os.path.dirname(path) == cuda_build.BUILD_DIR
        assert os.path.basename(path).startswith("lib%s-" % name)


@pytest.mark.parametrize("fname", CSRC_FILES)
def test_editing_any_csrc_file_changes_every_library_path(csrc_copy, fname):
    before = _paths()
    with open(csrc_copy / fname, "a") as f:
        f.write("\n// edited\n")
    after = _paths()
    for name in cuda_build.LIBRARIES:
        assert after[name] != before[name], (fname, name)


def test_adding_a_header_changes_every_library_path(csrc_copy):
    before = _paths()
    (csrc_copy / "new_helpers.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[n] != before[n] for n in cuda_build.LIBRARIES)
