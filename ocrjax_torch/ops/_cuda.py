"""Builds and loads the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc` for Hopper (sm_90a) into `_build/` at first use, then loaded with
ctypes. The library's file name carries a hash of its source, so an edited
kernel is rebuilt and a stale build is never loaded. Nothing here runs at
import time: the CPU tests import every module without a CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], Callable[..., int]] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to build the kernels")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compiles csrc/<name>.cu unless a build of this exact source exists."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build(name))
    return _libs[name]


def entry(lib: str, name: str, argtypes: Sequence) -> Callable[..., int]:
    """The C function `name` of library `lib` (built and loaded at first
    use), returning a CUDA error code; its argument types are set once. Each
    pointer and the stream must be a ctypes.c_void_p, or ctypes cuts it to 32
    bits."""
    fn = _entries.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(lib, name)] = fn
    return fn


def on_device(device: torch.device):
    """Context in which `device` is the current CUDA device, where a kernel
    launches; free when it already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
