"""Fused 3x3 conv + folded BatchNorm + ReLU (NHWC x HWIO): the CUDA kernel,
its plain version, the cuDNN call it is timed against, and the wrapper that
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
from typing import Tuple

import torch
import torch.nn.functional as F


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
    """Output channels a block of the kernel owns."""
    return 32 if cout <= 32 else 64


def conv3x3_bn_relu_cuda(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor
                         ) -> torch.Tensor:
    """Launches csrc/conv_fused.cu on the current stream. Counts each launch
    in `conv3x3_bn_relu_cuda.launches`."""
    _check(x, w, scale, bias)
    if not x.is_cuda:
        raise ValueError(f"expected CUDA tensors, got x on {x.device}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from ocrjax_torch.ops import _cuda
    lib = _cuda.load("conv_fused")
    fn = lib.ocj_conv3x3_bn_relu
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, W, cin = x.shape
    cout = w.shape[3]
    tile = cout_tile(cout)
    cin_pad = -(-cin // 16) * 16
    cout_pad = -(-cout // tile) * tile
    y = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    packed_w = torch.empty((9, cin_pad, cout_pad), dtype=torch.bfloat16,
                           device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), y.data_ptr(), packed_w.data_ptr(), B, H, W,
                 cin, cout, tile, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_fused kernel launch failed: CUDA error "
                           f"{err} for x {tuple(x.shape)} -> {cout}")
    conv3x3_bn_relu_cuda.launches += 1
    return y


conv3x3_bn_relu_cuda.launches = 0


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor, an error for anything else. Every shape of the contract
    goes to the kernel; nothing is handed to cuDNN."""
    if x.is_cuda:
        return conv3x3_bn_relu_cuda(x, w, scale, bias)
    if x.device.type == "cpu":
        return conv_bn_relu_torch(x, w, scale, bias)
    raise ValueError(f"no fused conv for device {x.device}")
