"""ctypes bindings for the native extraction ops (NMS, ROIAlign, ROIPool).

A copy of ``meme_challenge_tpu/extract/native.py`` with one change: the
library is built from the port's own copy of the source
(``extract/csrc/bua_ops.cpp``) with ``g++`` at first use, into a file under
``build/bua_ops/`` at the repository root whose name hashes the flags and
the source, so an edited source is rebuilt and a stale library never
loaded. Nothing is built at import time, and the JAX package's
``native/libbua_ops.so`` is never written.

The ops are host-side: the proposal NMS and the per-class selection NMS of
the extractor run here on numpy arrays.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("meme_challenge_tpu_torch.extract.native")

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "bua_ops.cpp")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "bua_ops")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the library is built: a hash of the flags and the source."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode() + b"\0")
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "libbua_ops-%s.so" % h.hexdigest()[:12])


def build_library(force: bool = False) -> str:
    """Compile ``csrc/bua_ops.cpp`` into :func:`library_path` (idempotent);
    a failed build raises with the compiler's output."""
    path = library_path()
    with _lock:
        if force or not os.path.isfile(path):
            logger.info("Building native ops library %s", path)
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.%d.tmp" % (path, os.getpid())
            proc = subprocess.run(
                ["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("g++ failed to build %s (rc %d):\n%s%s"
                                   % (SOURCE, proc.returncode, proc.stdout,
                                      proc.stderr))
            os.replace(tmp, path)  # atomic: readers never see a partial .so
    return path


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.nms_f32.restype = ctypes.c_int
        lib.nms_f32.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float,
                                i32p]
        lib.nms_max_conf_f32.restype = None
        lib.nms_max_conf_f32.argtypes = [f32p, f32p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_float, f32p]
        lib.roi_align_f32.restype = None
        lib.roi_align_f32.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
        lib.roi_pool_f32.restype = None
        lib.roi_pool_f32.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, f32p]
        _lib = lib
    return _lib


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_threshold: float) -> np.ndarray:
    """Greedy NMS; returns kept indices in descending-score order
    (the ``models.bua.layers.nms.nms`` API, reference
    utils/extract_utils.py:6,71)."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    keep = np.zeros(n, dtype=np.int32)
    count = _get_lib().nms_f32(boxes, scores, n, float(iou_threshold), keep)
    return keep[:count].astype(np.int64)


def roi_align(feat: np.ndarray, rois: np.ndarray, spatial_scale: float,
              output_size: Tuple[int, int], sampling_ratio: int = 0,
              aligned: bool = True) -> np.ndarray:
    """ROIAlign forward. feat [C,H,W], rois [R,4] → [R,C,ph,pw]."""
    feat = np.ascontiguousarray(feat, dtype=np.float32)
    rois = np.ascontiguousarray(rois, dtype=np.float32)
    C, H, W = feat.shape
    R = rois.shape[0]
    ph, pw = output_size
    out = np.zeros((R, C, ph, pw), dtype=np.float32)
    if R:
        _get_lib().roi_align_f32(feat, C, H, W, rois, R,
                                 float(spatial_scale), ph, pw,
                                 int(sampling_ratio), int(aligned), out)
    return out


def roi_pool(feat: np.ndarray, rois: np.ndarray, spatial_scale: float,
             output_size: Tuple[int, int]) -> np.ndarray:
    """ROIPool (max) forward, Caffe semantics. feat [C,H,W] → [R,C,ph,pw]."""
    feat = np.ascontiguousarray(feat, dtype=np.float32)
    rois = np.ascontiguousarray(rois, dtype=np.float32)
    C, H, W = feat.shape
    R = rois.shape[0]
    ph, pw = output_size
    out = np.zeros((R, C, ph, pw), dtype=np.float32)
    if R:
        _get_lib().roi_pool_f32(feat, C, H, W, rois, R,
                                float(spatial_scale), ph, pw, out)
    return out


def nms_max_conf(boxes: np.ndarray, cls_prob: np.ndarray,
                 iou_threshold: float) -> np.ndarray:
    """Per-box max confidence surviving per-class NMS, all classes in one
    native call (reference utils/extract_utils.py:68-74 semantics; IoU
    matrix shared across classes)."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    cls_prob = np.ascontiguousarray(cls_prob, dtype=np.float32)
    n, num_classes = cls_prob.shape
    out = np.zeros(n, dtype=np.float32)
    if n:
        _get_lib().nms_max_conf_f32(boxes, cls_prob, n, num_classes,
                                    float(iou_threshold), out)
    return out
