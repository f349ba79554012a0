"""Connected-component labeling: the three CUDA kernels (labels in one
block's shared memory for small grids, in a thread-block cluster's
distributed shared memory for the C5 tile grids, in device memory for the
rest), their plain version, and the wrapper that picks kernel or plain
version by the tensor's device.

Counterpart of ocrjax/ops/pallas/cc_label.py (the TPU kernel) and of
ocrjax/postprocess/db_boxes.py::label_components (its XLA formulation).
Contract: (B, H, W) bool/uint8 bitmap -> (B, H, W) int32 labels, 8-connected,
label = the smallest linear index reached in exactly `n_iters` sweeps
(row run-min, column run-min, 3x3 min), BIG = 2**30 on background. This is a
fixed-sweep labeling, not a converged CCL.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ocrjax_torch import graphs
from ocrjax_torch.ops import _cuda

BIG = 2 ** 30


def _shift(x: torch.Tensor, k: int, dim: int, fill, reverse: bool):
    """x moved k places along dim (toward higher indices, or lower when
    reverse); the k vacated places take `fill`."""
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = min(k, n)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if reverse:
        return torch.cat([x.narrow(dim, k, n - k), pad], dim) if k < n else pad
    return torch.cat([pad, x.narrow(dim, 0, n - k)], dim) if k < n else pad


def _seg_scan(lab: torch.Tensor, fg: torch.Tensor, dim: int, reverse: bool):
    """Inclusive segmented min-scan along dim (Hillis-Steele doubling);
    background elements are segment boundaries. Out-of-range neighbours
    read (BIG, no boundary), which keeps an element as it is."""
    v = lab
    f = ~fg
    k = 1
    while k < lab.shape[dim]:
        v_n = _shift(v, k, dim, BIG, reverse)
        f_n = _shift(f, k, dim, False, reverse)
        v = torch.where(f, v, torch.minimum(v, v_n))
        f = f | f_n
        k *= 2
    return v


def _run_min(lab, fg, dim: int):
    fwd = _seg_scan(lab, fg, dim, reverse=False)
    bwd = _seg_scan(lab, fg, dim, reverse=True)
    return torch.where(fg, torch.minimum(fwd, bwd), BIG)


def _neighbor_min(lab: torch.Tensor) -> torch.Tensor:
    """3x3 window min, BIG outside the grid."""
    H, W = lab.shape[-2:]
    p = F.pad(lab, (1, 1, 1, 1), value=BIG)
    out = lab
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, p[..., dy:dy + H, dx:dx + W])
    return out


def label_components_torch(bitmap: torch.Tensor, n_iters: int = 4
                           ) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W) -> (B, H, W) int32 labels."""
    fg = bitmap.bool()
    H, W = fg.shape[-2:]
    lin = torch.arange(H * W, dtype=torch.int32,
                       device=fg.device).reshape(H, W)
    lab = torch.where(fg, lin, BIG)
    for _ in range(n_iters):
        lab = _run_min(lab, fg, dim=-1)
        lab = _run_min(lab, fg, dim=-2)
        lab = torch.where(fg, torch.minimum(lab, _neighbor_min(lab)), BIG)
    return lab


# The shared-memory kernel keeps uint16 labels (0xFFFF is background), rows
# padded to 8 pixels, and each of its 1024 threads holds at most 9 chunks of
# 8 pixels in registers during the 3x3 min (csrc/cc_label.cu).
SHARED_MAX_PIXELS = 65535
SHARED_MAX_CHUNKS = 9 * 1024
SHARED_MEMORY_LIMIT = 232448
# The cluster kernel splits a grid's rows over a cluster of 8 CTAs; each
# keeps its band as uint32 labels in rows padded to 16 pixels, with 4 words
# of padding after every 32 pixels (so that a warp's 16-byte loads of 16
# consecutive pixels a lane meet no bank conflict), plus two such rows of
# halos and three unpadded rows of summaries; a warp holds a whole row in
# registers (at most 2 rounds of 512 pixels).
CLUSTER_SIZE = 8
CLUSTER_MAX_WIDTH = 1024
PATHS = ("shared", "cluster", "global")
_PATH_CODES = {"global": 0, "shared": 1, "cluster": 2}


def shared_bytes(H: int, W: int) -> int:
    """Shared memory the shared path takes for an (H, W) grid."""
    return H * (-(-W // 8)) * 16


def cluster_bytes(H: int, W: int) -> int:
    """Shared memory a CTA of the cluster path takes for an (H, W) grid:
    its band of ceil(H / 8) rows and two halo rows, Wp words each, and
    three summary rows of Ws words."""
    ws = -(-W // 16) * 16
    wp = ws + -(-ws // 32) * 4
    return ((-(-H // CLUSTER_SIZE) + 2) * wp + 3 * ws) * 4


def fits_shared(H: int, W: int) -> bool:
    return H * W <= SHARED_MAX_PIXELS and H * (-(-W // 8)) <= SHARED_MAX_CHUNKS


def fits_cluster(H: int, W: int) -> bool:
    return (W <= CLUSTER_MAX_WIDTH
            and cluster_bytes(H, W) <= SHARED_MEMORY_LIMIT)


def ccl_path(H: int, W: int) -> str:
    """Which hand-written kernel labels an (H, W) grid on the card:
    "shared" (uint16 labels stay in one block's shared memory for all
    sweeps) where the grid fits it; "cluster" (int32 labels stay in the
    shared memory of a cluster of 8 CTAs, a band of rows each) for a grid
    of more than 65,535 pixels whose band fits a CTA and whose row fits the
    row pass's registers; else "global" (labels in device memory, any
    size)."""
    if fits_shared(H, W):
        return "shared"
    if H * W > SHARED_MAX_PIXELS and fits_cluster(H, W):
        return "cluster"
    return "global"


def label_components_cuda(bitmap: torch.Tensor, n_iters: int = 4,
                          path: Optional[str] = None) -> torch.Tensor:
    """Launches csrc/cc_label.cu on the current stream; (B, H, W) CUDA
    bool/uint8 -> int32. `path` forces one of PATHS (tests and
    measurements; the lanes leave it None and get ccl_path(H, W)); forcing
    a path that cannot take the grid raises, and so does a cluster
    configuration of which the card can hold no cluster. Counts each
    launch in `label_components_cuda.launches` and, by path, in
    `.launches_by_path`; a launch inside a captured program
    (graphs.Program) counts at every replay of its graph."""
    if bitmap.dim() != 3:
        raise ValueError(f"expected a (B, H, W) tensor, got "
                         f"{tuple(bitmap.shape)}")
    B, H, W = bitmap.shape
    fits = {"shared": fits_shared, "cluster": fits_cluster}
    if path is None:
        path = ccl_path(H, W)
    elif path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    elif path in fits and not fits[path](H, W):
        raise ValueError(f"a {H} x {W} grid does not fit the {path} path")
    if not bitmap.is_cuda:
        raise ValueError(f"expected a CUDA tensor, got one on "
                         f"{bitmap.device}")
    if bitmap.dtype not in (torch.bool, torch.uint8):
        bitmap = bitmap.to(torch.uint8)
    bm = bitmap.contiguous()
    if bm.dtype == torch.bool:
        bm = bm.view(torch.uint8)                 # same bytes, no copy
    fn = _cuda.entry("cc_label", "ocj_cc_label", [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    out = torch.empty((B, H, W), dtype=torch.int32, device=bm.device)
    scratch = torch.empty_like(out) if path == "global" else None
    with _cuda.on_device(bm.device):
        err = fn(bm.data_ptr(), out.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 B, H, W, int(n_iters), _PATH_CODES[path],
                 torch.cuda.current_stream(bm.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cc_label kernel launch failed on the {path} "
                           f"path: CUDA error {err}")
    # inside a captured program, counted at every replay of its graph
    graphs.launched(_count_launch, path)
    return out


def _count_launch(path: str) -> None:
    label_components_cuda.launches += 1
    label_components_cuda.launches_by_path[path] += 1


label_components_cuda.launches = 0
label_components_cuda.launches_by_path = {p: 0 for p in PATHS}


def empty_launch_cuda() -> None:
    """Launches an empty kernel on the current stream: the yardstick for
    what a launch alone costs. Counts nowhere."""
    err = _cuda.entry("cc_label", "ocj_empty_launch", [ctypes.c_void_p])(
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def label_components(bitmap: torch.Tensor, n_iters: int = 4) -> torch.Tensor:
    """The wrapper: a kernel for a CUDA tensor, the plain version for a
    CPU tensor, and an error for anything else."""
    if bitmap.is_cuda:
        return label_components_cuda(bitmap, n_iters)
    if bitmap.device.type == "cpu":
        return label_components_torch(bitmap, n_iters)
    raise ValueError(f"no CCL for device {bitmap.device}")
