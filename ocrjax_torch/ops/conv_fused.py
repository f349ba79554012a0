"""Fused 3x3 conv + folded BatchNorm + ReLU (NHWC x HWIO): the CUDA kernels
(wgmma fed by a TMA ring, a SIMT kernel for Cin <= 4, the general wmma
kernel), the pure functions that pick among them and plan the tiles, the
plain version, the cuDNN call they are timed against, and the wrapper that
picks kernel or plain version by the tensor's device.

Counterpart of ocrjax/ops/pallas/conv_fused.py. Contract: x (B, H, W, Cin)
float32 or bfloat16, w (3, 3, Cin, Cout) float32, scale and bias (Cout,)
float32 -> (B, H, W, Cout) in x.dtype: stride 1, SAME padding, x and w
rounded to bf16, float32 accumulation over the 9 * Cin products,
max(acc * scale + bias, 0). No pipeline module calls it (the reference
retired its kernel from serving too); ocrjax_torch.bench_conv runs it at the
production conv shapes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ocrjax_torch.ops import _cuda


def fuse_bn(gamma, beta, mean, var, eps: float = 1e-5) -> Tuple:
    """BatchNorm (inference) -> per-channel (scale, bias); tensors or numpy
    arrays."""
    scale = gamma * (var + eps) ** -0.5
    return scale, beta - mean * scale


def _check(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 \
            or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"expected x (B, H, W, Cin) and w (3, 3, Cin, Cout),"
                         f" got {tuple(x.shape)} and {tuple(w.shape)}")
    cout = w.shape[3]
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"scale and bias must be ({cout},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _epilogue(y_nchw: torch.Tensor, scale, bias, dtype) -> torch.Tensor:
    y = y_nchw.permute(0, 2, 3, 1).float()
    return torch.relu(y * scale + bias).to(dtype).contiguous()


def conv_bn_relu_torch(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: operands rounded to bf16, the
    convolution itself in float32 (TF32 off), then the epilogue."""
    _check(x, w, scale, bias)
    xr = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wr = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(xr, wr, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return _epilogue(y, scale, bias, x.dtype)


def conv_bn_relu_cudnn(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """The library call for the same function: F.conv2d on bf16
    channels-last operands plus the epilogue. Counterpart of the
    reference's conv_bn_relu_xla; it is there to be timed against and no
    path of the port calls it."""
    _check(x, w, scale, bias)
    xr = x.to(torch.bfloat16).permute(0, 3, 1, 2)     # channels-last view
    wr = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return _epilogue(F.conv2d(xr, wr, padding=1), scale, bias, x.dtype)


def cout_tile(cout: int) -> int:
    """Output channels a block of the general kernel owns."""
    return 32 if cout <= 32 else 64


PATHS = ("wgmma", "small_cin", "generic")
SHARED_MEMORY_LIMIT = 232448        # bytes of shared memory a block may use
WGMMA_CHUNK = 32                    # input channels a ring stage holds
# (rows, columns) of a patch: 128 pixels of one image, or 64 (then a block
# takes the same patch of twice as many images)
WGMMA_TILES = ((8, 16), (4, 32), (2, 64), (4, 16))
WGMMA_MAX_STAGES = 6
SMALL_CIN_MAX = 4
SMALL_CIN_SHARED_LIMIT = 48 * 1024


@functools.lru_cache(maxsize=256)
def conv_path(B: int, H: int, W: int, cin: int, cout: int,
              aligned: bool = True) -> str:
    """Which hand-written kernel takes a shape on the card. "small_cin":
    Cin <= 4 with Cout a multiple of 8 (bytes, not products: SIMT with 16-byte
    stores). "wgmma": Cin and Cout multiples of 8 (TMA needs 16-byte strides).
    "generic": everything else, ragged channels and pointers that are not
    16-byte aligned (`aligned` False) included."""
    if aligned and cout % 8 == 0 and 0 < cin <= SMALL_CIN_MAX \
            and 9 * cin * cout * 4 <= SMALL_CIN_SHARED_LIMIT \
            and B * H < 2 ** 31:
        return "small_cin"
    if aligned and cin > 0 and cin % 8 == 0 and cout % 8 == 0:
        return "wgmma"
    return "generic"


@functools.lru_cache(maxsize=256)
def conv_plan(B: int, H: int, W: int, cin: int, cout: int,
              out_itemsize: int = 2) -> Dict[str, int]:
    """The wgmma kernel's tile plan for one shape: the Cout tile bn (24, 64
    or 128), the pixels a block takes (256 at bn 128 where the batch has two
    images: a weight tile loaded from L2 then serves twice as many), the
    patch (th x tw, the one of WGMMA_TILES that computes the fewest padded
    pixels, ties to the earlier) and with it the images a block takes the
    patch of, the padded sizes of the packed weights, the ring's depth and
    the shared memory it takes.
    The blocks are persistent and the ring runs on across a block's tiles,
    so its depth does not depend on Cin. Narrow Cout tiles keep a block
    within half an SM's shared memory, so that two blocks share an SM."""
    bn = 24 if cout <= 24 else 64 if cout <= 64 else 128
    pixels = 256 if B >= 2 and bn == 128 else 128     # a block's

    def padded(tile):
        th, tw = tile
        return (-(-H // th) * th) * (-(-W // tw) * tw)

    def work(tile):        # pixels computed, padding and idle images included
        per_block = pixels // (tile[0] * tile[1])
        return -(-B // per_block) * per_block * padded(tile)
    th, tw = min(WGMMA_TILES, key=work)       # min keeps the first of a tie
    images = pixels // (th * tw)
    cin_pad = -(-cin // WGMMA_CHUNK) * WGMMA_CHUNK
    cout_pad = -(-cout // bn) * bn
    stage_bytes = (images * (th + 2) * tw + 3 * bn) * 2 * WGMMA_CHUNK
    # each of the 8 consumer warps stages 16 pixel rows x up to 64 channels
    staging_bytes = 8 * 16 * (min(bn, 64) * out_itemsize + 16)
    fixed = 1024 + 16 * WGMMA_MAX_STAGES + staging_bytes   # + slack, barriers
    half = SHARED_MEMORY_LIMIT // 2 - 1024
    two_blocks = pixels == 128 and bn <= 64 \
        and fixed + 2 * stage_bytes <= half
    budget = half if two_blocks else SHARED_MEMORY_LIMIT
    stages = max(2, min(WGMMA_MAX_STAGES, (budget - fixed) // stage_bytes))
    return {"th": th, "tw": tw, "bn": bn, "images": images,
            "cin_pad": cin_pad, "cout_pad": cout_pad, "stages": stages,
            "stage_bytes": stage_bytes, "staging_bytes": staging_bytes,
            "smem_bytes": fixed + stages * stage_bytes,
            "blocks_per_sm": 2 if two_blocks else 1,
            "padded_pixels": padded((th, tw)),
            "tiles": -(-B // images) * -(-H // th) * -(-W // tw)
            * (cout_pad // bn)}


def pack_weights_torch(w: torch.Tensor, cin_pad: int, cout_pad: int
                       ) -> torch.Tensor:
    """Plain version of the wgmma path's weight pre-kernel: w (3, 3, Cin,
    Cout) float32 -> (9, cout_pad, cin_pad) bf16, [tap][Cout][Cin] (K-major),
    zero filled."""
    cin, cout = w.shape[2], w.shape[3]
    out = torch.zeros((9, cout_pad, cin_pad), dtype=torch.bfloat16,
                      device=w.device)
    out[:, :cout, :cin] = w.reshape(9, cin, cout).permute(0, 2, 1).to(
        torch.bfloat16)
    return out


def pack_weights_cuda(w: torch.Tensor, cin_pad: int, cout_pad: int
                      ) -> torch.Tensor:
    """The weight pre-kernel alone, as the wgmma path launches it (counts
    nowhere): held against pack_weights_torch bit for bit."""
    if not w.is_cuda or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("expected a contiguous float32 CUDA tensor")
    fn = _cuda.entry("conv_fused", "ocj_pack_weights_kmajor",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    out = torch.empty((9, cout_pad, cin_pad), dtype=torch.bfloat16,
                      device=w.device)
    with _cuda.on_device(w.device):
        err = fn(w.data_ptr(), out.data_ptr(), w.shape[2], w.shape[3],
                 cin_pad, cout_pad,
                 torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pack_weights kernel launch failed: CUDA error "
                           f"{err}")
    return out


def conv3x3_bn_relu_cuda(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         path: Optional[str] = None) -> torch.Tensor:
    """Launches csrc/conv_fused.cu on the current stream. `path` forces one
    of PATHS (tests and measurements; callers leave it None and get
    conv_path's choice); forcing a path that cannot take the shape raises.
    Counts each call in `conv3x3_bn_relu_cuda.launches` and, by path, in
    `.launches_by_path`."""
    _check(x, w, scale, bias)
    if not x.is_cuda:
        raise ValueError(f"expected CUDA tensors, got x on {x.device}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, W, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, scale, bias, y))
    fits = conv_path(B, H, W, cin, cout, aligned)
    if path is None:
        path = fits
    elif path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    elif path != "generic" and path != fits:
        raise ValueError(f"the {path} path does not take x {tuple(x.shape)} "
                         f"-> {cout} (it goes to {fits})")
    is_bf16 = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with _cuda.on_device(x.device):
        if path == "wgmma":
            plan = conv_plan(B, H, W, cin, cout, x.element_size())
            packed_w = torch.empty((9, plan["cout_pad"], plan["cin_pad"]),
                                   dtype=torch.bfloat16, device=x.device)
            x_bf16 = None if is_bf16 else torch.empty(
                x.shape, dtype=torch.bfloat16, device=x.device)
            fn = _cuda.entry("conv_fused", "ocj_conv3x3_wgmma",
                             [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                             + [ctypes.c_void_p])
            err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), y.data_ptr(), packed_w.data_ptr(),
                     None if x_bf16 is None else x_bf16.data_ptr(), B, H, W,
                     cin, cout, plan["cin_pad"], plan["cout_pad"], plan["bn"],
                     plan["th"], plan["tw"], plan["images"], plan["stages"],
                     is_bf16, stream)
        elif path == "small_cin":
            fn = _cuda.entry("conv_fused", "ocj_conv3x3_small_cin",
                             [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p])
            err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), y.data_ptr(), B, H, W, cin, cout,
                     is_bf16, stream)
        else:
            tile = cout_tile(cout)
            cin_pad = -(-cin // 16) * 16
            cout_pad = -(-cout // tile) * tile
            packed_w = torch.empty((9, cin_pad, cout_pad),
                                   dtype=torch.bfloat16, device=x.device)
            fn = _cuda.entry("conv_fused", "ocj_conv3x3_bn_relu",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p])
            err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), y.data_ptr(), packed_w.data_ptr(), B, H,
                     W, cin, cout, tile, is_bf16, stream)
    if err != 0:
        raise RuntimeError(f"conv_fused kernel launch failed on the {path} "
                           f"path: CUDA error {err} for x {tuple(x.shape)} "
                           f"-> {cout}")
    conv3x3_bn_relu_cuda.launches += 1
    conv3x3_bn_relu_cuda.launches_by_path[path] += 1
    return y


conv3x3_bn_relu_cuda.launches = 0
conv3x3_bn_relu_cuda.launches_by_path = {p: 0 for p in PATHS}


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The wrapper: a kernel for a CUDA tensor, the plain version for a
    CPU tensor, an error for anything else. Every shape of the contract
    goes to one of the three kernels; nothing is handed to cuDNN."""
    if x.is_cuda:
        return conv3x3_bn_relu_cuda(x, w, scale, bias)
    if x.device.type == "cpu":
        return conv_bn_relu_torch(x, w, scale, bias)
    raise ValueError(f"no fused conv for device {x.device}")
