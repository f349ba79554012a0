"""SVTR (arXiv:2205.00159, PaddleOCR's SVTRNet) behind the interface of
reference/recognizers.py: plain float32, written out from the equations,
independent of the program's code.

The configuration states the widths (`svtr_*` keys of its ocr_config;
SVTR-L: dims 192/256/512, depths 3/9/9, heads 6/8/16, the first 10 blocks
local in a 7 x 11 window, MLP ratio 4, combining width 384). Semantics:
  * patch embedding: conv 3x3 stride 2 pad 1 + BatchNorm (eps 1e-5) +
    GELU, twice (1 -> D0 / 2 -> D0): an (H / 4) x (W / 4) grid of tokens
    in row-major order, plus the positional embedding's first W / 4
    columns;
  * post-norm blocks x = LN(x + Mix(x)); x = LN(x + MLP(x)) (eps 1e-6),
    MLP Linear -> GELU (erf) -> Linear, Mix softmax(q k^T / sqrt(d) +
    mask) v over heads of d = D / heads. A key is open to a query iff it
    lies in the query's window (local blocks: rows within window_h // 2,
    columns within window_w // 2; global blocks: anywhere) at a column
    below ceil(valid width / 4), or is the query's own position;
  * merges between stages: conv 3x3 stride (2, 1) pad 1 with bias, then
    LayerNorm (eps 1e-5) over channels;
  * mean over the grid's height, Linear (no bias), Hardswish, the CTC head
    Linear.
Local attention gathers each query's window explicitly (unfold, zero
padding outside the grid, closed by the mask) and counts its FLOPs from
the in-grid pairs of the window, not a dense masked matrix; global
attention and every linear run through models._mm, the convolutions count
as models.conv does. With p.lowp == "fp8" the operands of every
convolution and linear are rounded to float8 e4m3 (models.round_fp8): one
step below the configuration's bf16, the check's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import models as M

BLOCK_EPS = 1e-6
MERGE_EPS = 1e-5
BN_EPS = 1e-5
# keys gathered a query in a local block at most, so many queries at a time
_GATHER = 1 << 25


def _count(flops: int) -> None:
    if M._count is not None:
        M._count.flops += int(flops)


def _conv(p: M.Params, mod: str, x: torch.Tensor, stride, bias: bool):
    """3x3 conv, padding 1, flax kernel (kh, kw, I, O)."""
    w = p[f"params/{mod}/kernel"].permute(3, 2, 0, 1)
    if p.lowp:
        x, w = M.round_fp8(x), M.round_fp8(w)
    y = F.conv2d(x, w, p[f"params/{mod}/bias"] if bias else None,
                 stride=stride, padding=1)
    _count(2 * y.numel() * w[0].numel())
    return y


def _dense(p: M.Params, mod: str, x: torch.Tensor, bias: bool = True):
    k = p[f"params/{mod}/kernel"]
    if p.lowp:
        x, k = M.round_fp8(x), M.round_fp8(k)
    y = M._mm(x, k)
    return y + p[f"params/{mod}/bias"] if bias else y


def _ln(p: M.Params, mod: str, x: torch.Tensor, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[f"params/{mod}/scale"],
                        p[f"params/{mod}/bias"], eps)


def _bn(p: M.Params, mod: str, x: torch.Tensor):
    shape = (1, -1, 1, 1)
    mean = p[f"batch_stats/{mod}/mean"].view(shape)
    var = p[f"batch_stats/{mod}/var"].view(shape)
    mul = torch.rsqrt(var + BN_EPS) * p[f"params/{mod}/scale"].view(shape)
    return (x - mean) * mul + p[f"params/{mod}/bias"].view(shape)


def _pairs(n: int, r: int) -> int:
    """Ordered pairs (i, j) of 0 <= i, j < n with |i - j| <= r."""
    return n * n - max(n - r - 1, 0) * max(n - r, 0)


def _global(q, k, v, lengths, gh, T):
    """q, k, v (N, h, L, d) -> (N, h, L, d): every valid key and the
    query itself."""
    L = gh * T
    col = torch.arange(T, device=q.device).repeat(gh)
    open_ = (col[None, :] < lengths[:, None])[:, None, None, :] \
        | torch.eye(L, dtype=torch.bool, device=q.device)
    s = M._mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~open_, float("-inf"))
    return M._mm(torch.softmax(s, dim=-1), v)


def _local(q, k, v, lengths, gh, T, window):
    """q, k, v (N, h, L, d) -> (N, h, L, d): the window's valid keys and
    the query itself, the window gathered by unfold."""
    N, h, L, d = q.shape
    wh, ww = window
    dev = q.device
    # the window's offsets in unfold's order; which lie in the grid, and
    # at which key column each lands
    rows = torch.arange(gh, device=dev).repeat_interleave(T)
    cols = torch.arange(T, device=dev).repeat(gh)
    dr = torch.arange(wh, device=dev).repeat_interleave(ww) - wh // 2
    dc = torch.arange(ww, device=dev).repeat(wh) - ww // 2
    kr, kc = rows[None] + dr[:, None], cols[None] + dc[:, None]   # (O, L)
    inside = (kr >= 0) & (kr < gh) & (kc >= 0) & (kc < T)
    centre = (dr == 0) & (dc == 0)
    _count(4 * h * d * N * _pairs(gh, wh // 2) * _pairs(T, ww // 2))
    out = torch.empty_like(q)
    step = max(1, _GATHER // (h * d * wh * ww * L))
    for lo in range(0, N, step):
        sl = slice(lo, lo + step)
        n = q[sl].shape[0]

        def gather(t):
            g = F.unfold(t.transpose(-1, -2).reshape(n * h, d, gh, T),
                         (wh, ww), padding=(wh // 2, ww // 2))
            return g.view(n, h, d, wh * ww, L)
        kg, vg = gather(k[sl]), gather(v[sl])
        valid = inside[None] & (kc[None] < lengths[sl, None, None])
        open_ = (valid | centre[None, :, None])[:, None]    # (n, 1, O, L)
        s = (q[sl].transpose(-1, -2)[:, :, :, None] * kg).sum(2) \
            / math.sqrt(d)                                   # (n, h, O, L)
        a = torch.softmax(s.masked_fill(~open_, float("-inf")), dim=2)
        out[sl] = (a[:, :, None] * vg).sum(3).transpose(-1, -2)
    return out


def _block(p: M.Params, k: int, x, heads: int, lengths, gh, T, window):
    N, L, D = x.shape
    m = f"Block_{k}"
    qkv = _dense(p, f"{m}/Attention_0/qkv", x).view(N, L, 3, heads,
                                                     D // heads)
    q, kk, v = qkv.permute(2, 0, 3, 1, 4)
    if window is None:
        a = _global(q, kk, v, lengths, gh, T)
    else:
        a = _local(q, kk, v, lengths, gh, T, window)
    a = _dense(p, f"{m}/Attention_0/proj",
               a.transpose(1, 2).reshape(N, L, D))
    x = _ln(p, f"{m}/LayerNorm_0", x + a, BLOCK_EPS)
    y = _dense(p, f"{m}/Mlp_0/Dense_1",
               F.gelu(_dense(p, f"{m}/Mlp_0/Dense_0", x)))
    return _ln(p, f"{m}/LayerNorm_1", x + y, BLOCK_EPS)


def logits(p: M.Params, cfg, strips: torch.Tensor, widths: torch.Tensor):
    """(N, H, W) normalized strips, W a multiple of 4, (N,) valid widths ->
    (logits (N, W / 4, C), frame lengths (N,))."""
    N, H, W = strips.shape
    if W % 4:
        raise ValueError(f"width {W} is not a multiple of 4")
    T = W // 4
    x = strips[:, None]
    for i in range(2):
        x = F.gelu(_bn(p, f"PatchEmbed_0/BatchNorm_{i}",
                       _conv(p, f"PatchEmbed_0/Conv_{i}", x, 2, False)))
    gh = x.shape[2]
    x = x.flatten(2).transpose(1, 2) \
        + p["params/pos_embed"][:, :T].reshape(1, gh * T, -1)
    lengths = torch.clamp(-(-widths.long() // 4), 0, T)
    window = tuple(cfg.svtr_window)
    k = 0
    for stage, (depth, heads) in enumerate(zip(cfg.svtr_depths,
                                                cfg.svtr_heads)):
        if stage:
            D = x.shape[-1]
            y = _conv(p, f"SubSample_{stage - 1}/Conv_0",
                      x.transpose(1, 2).reshape(N, D, gh, T), (2, 1), True)
            gh = y.shape[2]
            x = _ln(p, f"SubSample_{stage - 1}/LayerNorm_0",
                    y.flatten(2).transpose(1, 2), MERGE_EPS)
        for _ in range(depth):
            local = k < cfg.svtr_local_blocks
            x = _block(p, k, x, heads, lengths, gh, T,
                       window if local else None)
            k += 1
    x = x.view(N, gh, T, -1).mean(dim=1)
    x = F.hardswish(_dense(p, "Dense_0", x, bias=False))
    return _dense(p, "Dense_1", x), lengths


def _flops(cfg, widths, classes: int) -> np.ndarray:
    """The closed form of what logits counts, a strip at each width."""
    T = np.ceil(np.asarray(widths, np.float64) / 4.0)
    H = cfg.rec_height
    dims, depths = list(cfg.svtr_dims), list(cfg.svtr_depths)
    wh, ww = cfg.svtr_window
    r = cfg.svtr_mlp_ratio
    pair_cols = np.array([_pairs(int(t), ww // 2) for t in T], np.float64)
    d0 = dims[0]
    f = 2.0 * (H // 2) * (2 * T) * (d0 // 2) * 9 \
        + 2.0 * (H // 4) * T * d0 * (d0 // 2) * 9
    gh, k = H // 4, 0
    for stage, (D, depth) in enumerate(zip(dims, depths)):
        if stage:
            gh //= 2
            f = f + 2.0 * gh * T * D * dims[stage - 1] * 9
        L = gh * T
        for _ in range(depth):
            f = f + 2.0 * L * D * D * (4 + 2 * r)
            if k < cfg.svtr_local_blocks:
                f = f + 4.0 * D * _pairs(gh, wh // 2) * pair_cols
            else:
                f = f + 4.0 * L * L * D
            k += 1
    out = cfg.svtr_out_channels
    return f + 2.0 * T * dims[-1] * out + 2.0 * T * out * classes


def flops(p: M.Params, cfg, widths) -> np.ndarray:
    return _flops(cfg, widths, p["params/Dense_1/kernel"].shape[1])


def parts(cfg, widths):
    """{"svtr": (FLOPs, bytes)} a strip: the FLOPs without the CTC head
    (the interface gives parts no class count; the head is 0.05% of them),
    and the bytes of the bf16 tokens each block and merge reads and writes
    once."""
    T = np.ceil(np.asarray(widths, np.float64) / 4.0)
    gh, nbytes = cfg.rec_height // 4, 0.0
    for stage, (D, depth) in enumerate(zip(cfg.svtr_dims, cfg.svtr_depths)):
        if stage:
            gh //= 2
        nbytes = nbytes + (depth + (stage > 0)) * 2 * 2.0 * gh * T * D
    return {"svtr": (_flops(cfg, widths, 0), nbytes)}


def init(cfg, num_classes: int):
    """The flat names, shapes and seeded rules of an SVTR's parameters, in
    the program's layout (ocrjax_torch/weights.py reads the same names):
    "normal" for conv and linear kernels, ("normal", 0.02) for the
    positional embedding, ones and zeros for the norms, and a fifth of
    "normal"'s std for the attention's output projections: at "normal",
    random global attention averages the tokens of a strip together block
    after block (their spread across the strip fell from 38% of their
    variance to under 0.1% over SVTR-L's 21 blocks) and every line reads
    one repeated character."""
    dims, depths, r = list(cfg.svtr_dims), list(cfg.svtr_depths), \
        cfg.svtr_mlp_ratio
    d0 = dims[0]
    out = []

    def bn(mod, c):
        out.extend([(f"params/{mod}/scale", (c,), "ones"),
                    (f"params/{mod}/bias", (c,), "zeros"),
                    (f"batch_stats/{mod}/mean", (c,), "zeros"),
                    (f"batch_stats/{mod}/var", (c,), "ones")])

    def ln(mod, c):
        out.extend([(f"params/{mod}/scale", (c,), "ones"),
                    (f"params/{mod}/bias", (c,), "zeros")])

    def dense(mod, i, o, bias=True):
        out.append((f"params/{mod}/kernel", (i, o), "normal"))
        if bias:
            out.append((f"params/{mod}/bias", (o,), "zeros"))

    out.append(("params/PatchEmbed_0/Conv_0/kernel", (3, 3, 1, d0 // 2),
                "normal"))
    bn("PatchEmbed_0/BatchNorm_0", d0 // 2)
    out.append(("params/PatchEmbed_0/Conv_1/kernel", (3, 3, d0 // 2, d0),
                "normal"))
    bn("PatchEmbed_0/BatchNorm_1", d0)
    out.append(("params/pos_embed", (cfg.rec_height // 4,
                                     max(cfg.rec_width_buckets) // 4, d0),
                ("normal", 0.02)))
    k = 0
    for stage, (D, depth) in enumerate(zip(dims, depths)):
        if stage:
            m = f"SubSample_{stage - 1}"
            out.append((f"params/{m}/Conv_0/kernel", (3, 3, dims[stage - 1],
                                                      D), "normal"))
            out.append((f"params/{m}/Conv_0/bias", (D,), "zeros"))
            ln(f"{m}/LayerNorm_0", D)
        for _ in range(depth):
            m = f"Block_{k}"
            dense(f"{m}/Attention_0/qkv", D, 3 * D)
            out.append((f"params/{m}/Attention_0/proj/kernel", (D, D),
                        ("normal", 0.2 / math.sqrt(D))))
            out.append((f"params/{m}/Attention_0/proj/bias", (D,), "zeros"))
            ln(f"{m}/LayerNorm_0", D)
            dense(f"{m}/Mlp_0/Dense_0", D, r * D)
            dense(f"{m}/Mlp_0/Dense_1", r * D, D)
            ln(f"{m}/LayerNorm_1", D)
            k += 1
    dense("Dense_0", dims[-1], cfg.svtr_out_channels, bias=False)
    dense("Dense_1", cfg.svtr_out_channels, num_classes)
    return out
