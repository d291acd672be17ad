"""Build the port's CUDA sources into shared libraries and load them.

Each library under ``ops/csrc/`` exposes a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` (Hopper) at first use, into ``build/torch_kernels/``
at the repository root, and loaded with ``ctypes``. The file name carries a
hash of the flags and of every file under ``csrc/`` (name and content), so
an edited or added source or header is rebuilt and a stale library is never
loaded. Nothing here runs at import time: this module is imported on
machines without ``nvcc`` or a card.

``build()`` starts one ``nvcc`` per library, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")

# library name -> its sources under csrc/
LIBRARIES: Dict[str, tuple] = {
    "fused_attention": ("fused_attention.cu",),
    "fused_attention_bwd": ("fused_attention_bwd.cu",),
    "fused_adam": ("fused_adam.cu",),
}

# -split-compile 0: optimise a source's kernels in parallel on every core (a
# library holds several template instantiations; chip_smoke.py prints the
# build's seconds)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile", "0")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels are built at first use)")


def _sources(name: str) -> list:
    return [os.path.join(CSRC_DIR, s) for s in LIBRARIES[name]]


def library_path(name: str) -> str:
    """Where library ``name`` is built: its name, then a hash of the flags,
    its sources and every file under ``CSRC_DIR`` (any of which a source may
    include)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS + LIBRARIES[name]).encode())
    for dirpath, dirs, files in os.walk(CSRC_DIR):
        dirs.sort()
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            h.update(os.path.relpath(path, CSRC_DIR).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:12]))


def _start(name: str) -> Optional[subprocess.Popen]:
    path = library_path(name)
    if os.path.isfile(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
           *_sources(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.target, proc.tmp = path, tmp
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    with open(proc.target + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for %s (rc %d):\n%s"
                           % (name, proc.returncode, log))
    os.replace(proc.tmp, proc.target)  # atomic: readers never see a partial .so


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named libraries (all by default) in parallel; returns the
    wall seconds each took (0.0 when it was already built)."""
    names = list(names or LIBRARIES)
    with _lock:
        t0 = time.time()
        procs = {n: _start(n) for n in names}
        secs = {}
        for n, p in procs.items():
            if p is not None:
                _finish(n, p)
            secs[n] = time.time() - t0 if p is not None else 0.0
    return secs


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of ``name``; empty when it was built by another process
    without a log."""
    path = library_path(name) + ".log"
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(library_path(name))
                _loaded[name] = lib
    return lib
