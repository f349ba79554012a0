"""ctypes bindings of the port's native host library (port of
ocrjax/postprocess/native_boxes.py).

`csrc/ocr_native.cpp` (a copy of ocrjax's) is compiled with g++ (or $CXX)
at first use into `_build/`, under a file name that carries a hash of the
source and the flags, as ops/_cuda.py builds the .cu sources; nothing is
built at import. It holds the classic DB box extraction (the host oracle
of db_boxes.extract_boxes), the Bayer 4-bit pack and the fused canvas
decode that the host path takes (preprocess.pack_nibbles,
preprocess.decode_chunk_to_gray). Without a compiler every caller keeps
running: extract_boxes_native falls back to host_boxes, the host path to
its numpy twins, and one warning says so.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

from ocrjax_torch.utils.logging import get_logger, log_fields

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ocr_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_disabled = False
build_seconds: Optional[float] = None   # of the last build in this process

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: set CXX or install g++")
    return cxx


def library_path(build_dir: str = BUILD_DIR) -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(build_dir, f"libocr_native-{digest}.so")


def build_library(build_dir: str = BUILD_DIR) -> str:
    """Compiles csrc/ocr_native.cpp unless a build of this exact source
    exists in build_dir; -> the library's path. Raises on failure."""
    global build_seconds
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for ocr_native.cpp:\n{res.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def open_library(path: str) -> ctypes.CDLL:
    """Loads a built library and sets the C signatures."""
    lib = ctypes.CDLL(path)
    lib.occ_label.restype = ctypes.c_int32
    lib.occ_label.argtypes = [_u8p, ctypes.c_int32, ctypes.c_int32, _i32p]
    lib.occ_extract_boxes.restype = ctypes.c_int32
    lib.occ_extract_boxes.argtypes = [
        _f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        _f32p, _f32p]
    lib.occ_pack_nibbles.restype = None
    lib.occ_pack_nibbles.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                     _u8p]
    lib.occ_decode_canvas.restype = None
    lib.occ_decode_canvas.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, _u8p, _i64p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at first use; None (with one warning)
    when it cannot be built or loaded."""
    global _lib, _build_failed
    if _disabled:
        return None
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            _lib = open_library(build_library())
        except Exception as e:  # noqa: BLE001 - any failure: numpy route
            _build_failed = True
            log_fields(get_logger("ocrjax_torch.native"), "warning",
                       "native host library unavailable: the host path "
                       "runs its numpy twins",
                       error=f"{type(e).__name__}: {e}")
        return _lib


@contextlib.contextmanager
def disabled():
    """Within the block every caller takes its fallback (the numpy twins,
    host_boxes), as where the library does not build: to time the two
    routes against each other."""
    global _disabled
    _disabled = True
    try:
        yield
    finally:
        _disabled = False


def native_available() -> bool:
    return _load() is not None


def label_components_native(bitmap: np.ndarray) -> Tuple[np.ndarray, int]:
    """(H, W) bool/uint8 -> (labels int32 with -1 background, components
    numbered in raster order of their first pixel, n_components)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    bm = np.ascontiguousarray(bitmap.astype(np.uint8))
    H, W = bm.shape
    labels = np.empty((H, W), np.int32)
    n = lib.occ_label(bm.ctypes.data_as(_u8p), H, W,
                      labels.ctypes.data_as(_i32p))
    return labels, int(n)


def extract_boxes_native(
    prob: np.ndarray,
    thresh: float = 0.3,
    box_thresh: float = 0.6,
    unclip_ratio: float = 1.5,
    max_candidates: int = 256,
    min_box_size: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Classic DB postprocess in C++; falls back to host_boxes without a
    toolchain. -> (boxes (N, 4, 2) float32, scores (N,) float32)."""
    lib = _load()
    if lib is None:
        from ocrjax_torch.postprocess.host_boxes import extract_boxes_host
        return extract_boxes_host(prob, thresh, box_thresh, unclip_ratio,
                                  max_candidates, min_box_size)
    p = np.ascontiguousarray(prob.astype(np.float32))
    H, W = p.shape
    boxes = np.empty((max_candidates, 4, 2), np.float32)
    scores = np.empty((max_candidates,), np.float32)
    n = lib.occ_extract_boxes(
        p.ctypes.data_as(_f32p), H, W, ctypes.c_float(thresh),
        ctypes.c_float(box_thresh), ctypes.c_float(unclip_ratio),
        ctypes.c_float(min_box_size), max_candidates,
        boxes.ctypes.data_as(_f32p), scores.ctypes.data_as(_f32p))
    return boxes[:n].copy(), scores[:n].copy()
