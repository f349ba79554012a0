"""SVTR text-line recognizer (Du et al., "SVTR: Scene Text Recognition with
a Single Visual Model", IJCAI 2022, arXiv:2205.00159; PaddleOCR's
SVTRNet), in the CRNN's slot: the same input, frame rule and contract.

forward(images (B, 1, H, W) normalized luma strips, widths (B,) valid
pixel widths) -> (logits (B, W / 4, C) float32, frame_lengths (B,) int32),
frame_lengths = ceil(widths / 4) clamped to [0, W / 4], as the CRNN's.

The network (SVTR-L at the config's defaults):
  * patch embedding: conv 3x3 stride 2 pad 1 (1 -> D0 / 2) + BN + GELU,
    conv 3x3 stride 2 pad 1 (D0 / 2 -> D0) + BN + GELU: an (H / 4) x
    (W / 4) grid, tokens in row-major order, plus a learned positional
    embedding of (H / 4) x (widest width bucket / 4) x D0, sliced to the
    grid's columns;
  * blocks, post-norm: x = LN(x + Mix(x)); x = LN(x + MLP(x)), LayerNorm
    eps 1e-6, MLP Linear(D, rD) -> GELU (erf) -> Linear(rD, D), Mix
    multi-head attention of D / heads a head over a boolean mask: a
    "local" block opens key (h', w') to query (h, w) iff |h - h'| <=
    window_h // 2 and |w - w'| <= window_w // 2, a "global" block every
    key; both close every key column w' >= ceil(valid width / 4), except
    the query's own position (so a query in the padding, whose window may
    hold no valid key, attends to itself alone and stays finite);
  * three stages of svtr_depths blocks at svtr_dims / svtr_heads, the first
    svtr_local_blocks blocks of all local; between stages a merge: conv
    3x3 stride (2, 1) pad 1 with bias + LayerNorm (eps 1e-5, PaddleOCR's
    SubSample), halving the grid's height;
  * combining: mean over the grid's height, Linear(D2 -> out, no bias),
    Hardswish (dropout is the identity at inference), then the CTC head
    Linear(out -> num_classes).

Precision: parameters stay float32 and are cast to the recognizer's
compute dtype (rec_compute_dtype, else compute_dtype) in each layer, as
the CRNN's; convolutions, linears, attention (torch's
scaled_dot_product_attention, its float32 softmax accumulation; the mask
built on the device from `widths` inside the captured program, no host
read), the residual sums and LayerNorm's output run in that dtype, with
LayerNorm's statistics in float32 (torch's kernel takes them so); the mean
over the height and the CTC head run in float32, so the logits are
float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ocrjax_torch.models.crnn import (INPUT_HEIGHT, WIDTH_STRIDE, BatchNorm,
                                      Conv2d, rec_dtype)

BLOCK_EPS = 1e-6
MERGE_EPS = 1e-5
_PAD1 = ((1, 1), (1, 1))


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


def _norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in x's dtype: torch's kernel takes the statistics in
    float32 whatever the dtype."""
    return F.layer_norm(x, layer.normalized_shape, layer.weight.to(x.dtype),
                        layer.bias.to(x.dtype), layer.eps)


def attention_mask(grid_h: int, cols: int, lengths: torch.Tensor,
                   window: Optional[Tuple[int, int]]) -> torch.Tensor:
    """(B, 1, L, L) boolean mask, True where a key is open to a query, over
    the grid_h x cols grid in row-major order (L = grid_h * cols): within
    the window (None: everywhere) at a valid key column (< lengths[b]), or
    the query's own position."""
    dev = lengths.device
    L = grid_h * cols
    col = torch.arange(cols, device=dev).repeat(grid_h)
    valid = col[None, :] < lengths[:, None]                   # (B, L) keys
    eye = torch.eye(L, dtype=torch.bool, device=dev)
    if window is None:
        m = valid[:, None, :]
    else:
        row = torch.arange(grid_h, device=dev).repeat_interleave(cols)
        near = (((row[:, None] - row[None, :]).abs() <= window[0] // 2)
                & ((col[:, None] - col[None, :]).abs() <= window[1] // 2))
        m = near[None] & valid[:, None, :]
    return (m | eye[None])[:, None]


class Block(nn.Module):
    """One post-norm transformer block over (B, L, D) tokens."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.fc1 = nn.Linear(dim, mlp_ratio * dim)
        self.fc2 = nn.Linear(mlp_ratio * dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=BLOCK_EPS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        h = self.heads
        q, k, v = _linear(x, self.qkv).view(B, L, 3, h, D // h).permute(
            2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        a = _linear(a.transpose(1, 2).reshape(B, L, D), self.proj)
        x = _norm(x + a, self.norm1)
        return _norm(x + _linear(F.gelu(_linear(x, self.fc1)), self.fc2),
                     self.norm2)


class Merge(nn.Module):
    """Conv 3x3 stride (2, 1) pad 1 over the token grid + LayerNorm: the
    grid's height halves, its width stays."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, (2, 1), _PAD1, dtype=dtype)
        self.norm = nn.LayerNorm(cout, eps=MERGE_EPS)

    def forward(self, x: torch.Tensor, grid_h: int, cols: int):
        B, _, D = x.shape
        y = self.conv(x.transpose(1, 2).reshape(B, D, grid_h, cols))
        return _norm(y.flatten(2).transpose(1, 2), self.norm)


class SVTR(nn.Module):
    """Patch embedding -> three stages of local and global blocks with two
    merges -> mean over the height -> Linear + Hardswish -> CTC head; see
    the module's docstring."""

    arch = "svtr"

    def __init__(self, num_classes: int,
                 dims: Sequence[int] = (192, 256, 512),
                 depths: Sequence[int] = (3, 9, 9),
                 heads: Sequence[int] = (6, 8, 16), local_blocks: int = 10,
                 window: Tuple[int, int] = (7, 11), mlp_ratio: int = 4,
                 out_channels: int = 384, input_height: int = INPUT_HEIGHT,
                 max_width: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(dims) != 3 or len(depths) != 3 or len(heads) != 3:
            raise ValueError("SVTR has three stages: dims, depths and heads "
                             "take three values each")
        if input_height % 16 or max_width % WIDTH_STRIDE:
            raise ValueError(f"input_height {input_height} must be a "
                             f"multiple of 16 and max_width {max_width} "
                             f"of {WIDTH_STRIDE}")
        self.input_height = input_height
        self.dtype = dtype
        self.window = tuple(window)
        self.local_blocks = local_blocks
        self.depths = tuple(depths)
        d0 = dims[0]
        self.embed0 = Conv2d(1, d0 // 2, 3, 2, _PAD1, bias=False, dtype=dtype)
        self.bn0 = BatchNorm(d0 // 2)
        self.embed1 = Conv2d(d0 // 2, d0, 3, 2, _PAD1, bias=False,
                             dtype=dtype)
        self.bn1 = BatchNorm(d0)
        self.pos_embed = nn.Parameter(torch.zeros(
            input_height // 4, max_width // WIDTH_STRIDE, d0))
        self.blocks = nn.ModuleList(
            Block(d, h, mlp_ratio)
            for d, h, n in zip(dims, heads, depths) for _ in range(n))
        self.merges = nn.ModuleList(
            Merge(dims[i], dims[i + 1], dtype) for i in range(2))
        self.combine = nn.Linear(dims[2], out_channels, bias=False)
        self.fc = nn.Linear(out_channels, num_classes)

    def forward(self, images: torch.Tensor,
                widths: Optional[torch.Tensor] = None):
        B, _, H, W = images.shape
        if H != self.input_height:
            raise ValueError(f"SVTR expects height {self.input_height}, "
                             f"got {H}")
        cols = W // WIDTH_STRIDE
        if W % WIDTH_STRIDE or cols > self.pos_embed.shape[1]:
            raise ValueError(f"width {W} must be a multiple of "
                             f"{WIDTH_STRIDE} and at most "
                             f"{self.pos_embed.shape[1] * WIDTH_STRIDE}")
        if widths is None:
            widths = torch.full((B,), W, dtype=torch.int32,
                                device=images.device)
        dt = self.dtype
        x = F.gelu(self.bn0(self.embed0(images)))
        x = F.gelu(self.bn1(self.embed1(x)))         # (B, D0, H / 4, W / 4)
        grid_h = x.shape[2]
        pos = self.pos_embed[:, :cols].reshape(1, grid_h * cols, -1)
        x = x.flatten(2).transpose(1, 2) + pos.to(dt)
        frame_lengths = torch.clamp(
            -(-widths.long() // WIDTH_STRIDE), 0, cols).to(torch.int32)
        lengths = frame_lengths.long()
        k = 0
        for stage, depth in enumerate(self.depths):
            if stage:
                x = self.merges[stage - 1](x, grid_h, cols)
                grid_h //= 2
            masks = {}          # one mask a kind of block a stage
            for _ in range(depth):
                local = k < self.local_blocks
                if local not in masks:
                    # additive, in the compute dtype: made once, not in
                    # every block's attention
                    m = attention_mask(grid_h, cols, lengths,
                                       self.window if local else None)
                    masks[local] = torch.zeros(
                        m.shape, dtype=dt, device=m.device).masked_fill_(
                            ~m, float("-inf"))
                x = self.blocks[k](x, masks[local])
                k += 1
        x = x.float().view(B, grid_h, cols, -1).mean(dim=1)     # (B, T, D)
        x = F.hardswish(_linear(x.to(dt), self.combine)).float()
        return _linear(x, self.fc), frame_lengths


def create_svtr(config, num_classes: int) -> SVTR:
    return SVTR(num_classes=num_classes, dims=tuple(config.svtr_dims),
                depths=tuple(config.svtr_depths),
                heads=tuple(config.svtr_heads),
                local_blocks=config.svtr_local_blocks,
                window=tuple(config.svtr_window),
                mlp_ratio=config.svtr_mlp_ratio,
                out_channels=config.svtr_out_channels,
                input_height=config.rec_height,
                max_width=max(config.rec_width_buckets),
                dtype=rec_dtype(config))
