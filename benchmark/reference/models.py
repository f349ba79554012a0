"""Plain float32 forwards of the DB detector and the CRNN recognizer, read
straight from the flax-layout parameters of a safetensors file.

Written out layer by layer from the published architectures (DB,
arXiv:1911.08947; CRNN, arXiv:1507.05717) as the shipped assets lay them
out: XLA's SAME padding (stride 2 on an even size pads (0, 1)), BatchNorm
in eval mode as (x - mean) * (rsqrt(var + eps) * scale) + bias, flax's
OptimizedLSTMCell (gates i, f, g, o; input kernels without bias, hidden
kernels with it) with a reverse direction that reads each sample's valid
prefix only, and ConvTranspose with flax's unflipped kernel (a torch
conv_transpose2d takes it flipped). Everything runs in float32 with TF32
off; nothing is cast, folded or fused.
"""

from __future__ import annotations

import json
import hashlib
import struct
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
_DTYPES = {"F32": np.float32, "F16": np.float16, "I32": np.int32,
           "I64": np.int64, "U8": np.uint8}


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def read_safetensors(path: str) -> Tuple[Dict[str, np.ndarray],
                                         Dict[str, str]]:
    """-> ({flax path: array}, metadata)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    meta = header.pop("__metadata__", None) or {}
    out = {}
    for key, info in header.items():
        lo, hi = info["data_offsets"]
        out[key] = np.frombuffer(data[lo:hi], _DTYPES[info["dtype"]]
                                 ).reshape(info["shape"]).copy()
    return out, meta


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude at 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


# multiply-adds counted while a `counting` block runs (2 FLOPs each)
_count = None


class counting:
    """FLOPs of the convolutions and matrix products run inside the block,
    from their shapes."""

    def __enter__(self):
        global _count
        self.flops, self._prev, _count = 0, _count, self
        return self

    def __exit__(self, *exc):
        global _count
        _count = self._prev


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _count is not None:
        _count.flops += 2 * a.numel() // a.shape[-1] * a.shape[-1] \
            * b.shape[-1]
    return a @ b


class Params:
    """Flax parameters and batch statistics on a device, float32.
    lowp="fp8" makes the forwards one step below the configuration's
    precision (bfloat16 convolutions, float32 LSTM): every convolution's
    input and weights rounded to float8 e4m3 (one scale a tensor), the
    LSTM and projection products' operands to bfloat16."""

    def __init__(self, flat: Mapping[str, np.ndarray], device,
                 lowp: str = None):
        if lowp not in (None, "fp8"):
            raise ValueError(f"unknown precision {lowp!r}")
        self.lowp = lowp
        self.t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                  for k, v in flat.items()}

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.t[key]

    def has(self, key: str) -> bool:
        return key in self.t


def _same(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int]):
    pads = []
    for n, kk, ss in zip(x.shape[-2:], k, s):
        out = -(-n // ss)
        total = max((out - 1) * ss + kk - n, 0)
        pads.append((total // 2, total - total // 2))
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b))


def conv(p: Params, mod: str, x: torch.Tensor, stride: int = 1,
         padding=None) -> torch.Tensor:
    """flax nn.Conv of `mod` (kernel (kh, kw, I, O)), SAME by default."""
    k = p[f"params/{mod}/kernel"]
    w = k.permute(3, 2, 0, 1)
    s = (stride, stride)
    if padding is None:
        x = _same(x, tuple(w.shape[-2:]), s)
    else:
        (t, b), (l, r) = padding
        x = F.pad(x, (l, r, t, b))
    bias = p[f"params/{mod}/bias"] if p.has(f"params/{mod}/bias") else None
    if p.lowp:
        x, w = round_fp8(x), round_fp8(w)
    y = F.conv2d(x, w, bias, stride=s)
    if _count is not None:
        _count.flops += 2 * y.numel() * w[0].numel()
    return y


def bn(p: Params, mod: str, x: torch.Tensor) -> torch.Tensor:
    shape = (1, -1, 1, 1)
    mean = p[f"batch_stats/{mod}/mean"].view(shape)
    var = p[f"batch_stats/{mod}/var"].view(shape)
    mul = torch.rsqrt(var + BN_EPS) * p[f"params/{mod}/scale"].view(shape)
    return (x - mean) * mul + p[f"params/{mod}/bias"].view(shape)


def conv_bn_relu(p: Params, mod: str, x: torch.Tensor, stride: int = 1,
                 padding=None) -> torch.Tensor:
    x = conv(p, f"{mod}/Conv_0", x, stride, padding)
    if p.has(f"params/{mod}/BatchNorm_0/scale"):
        x = bn(p, f"{mod}/BatchNorm_0", x)
    return F.relu(x)


def conv_transpose(p: Params, mod: str, x: torch.Tensor) -> torch.Tensor:
    """flax nn.ConvTranspose, kernel 2, stride 2."""
    k = p[f"params/{mod}/kernel"]                       # (kh, kw, I, O)
    w = k.flip(0, 1).permute(2, 3, 0, 1)
    if p.lowp:
        x, w = round_fp8(x), round_fp8(w)
    if _count is not None:
        _count.flops += 2 * x.numel() * w[0].numel()
    return F.conv_transpose2d(x, w, p[f"params/{mod}/bias"], stride=2)


# ---------------------------------------------------------------------------
# DB
# ---------------------------------------------------------------------------

def db_prob(p: Params, arch: Mapping, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, S, S) normalized images -> (B, S, S) float32 probabilities
    (head stride 1: two learned x2 upsamplings)."""
    channels = list(arch["channels"])
    bps = int(arch["blocks_per_stage"])
    if int(arch.get("head_stride", 1)) != 1:
        raise ValueError("the reference covers head stride 1 only")
    x = conv_bn_relu(p, "Backbone_0/ConvBNRelu_0", x, 2)
    x = conv_bn_relu(p, "Backbone_0/ConvBNRelu_1", x, 2)
    feats, cin, k = [], channels[0], 0
    for i, ch in enumerate(channels):
        for j in range(bps):
            stride = 2 if (i > 0 and j == 0) else 1
            m = f"Backbone_0/ResBlock_{k}"
            y = conv_bn_relu(p, f"{m}/ConvBNRelu_0", x, stride)
            y = bn(p, f"{m}/BatchNorm_0", conv(p, f"{m}/Conv_0", y))
            if (cin if j == 0 else ch) != ch or stride != 1:
                r = bn(p, f"{m}/BatchNorm_1",
                       conv(p, f"{m}/Conv_1", x, stride))
            else:
                r = x
            x = F.relu(y + r)
            cin = ch
            k += 1
        feats.append(x)
    n = len(channels)
    lat = [conv(p, f"FPN_0/Conv_{i}", f) for i, f in enumerate(feats)]
    td = list(lat)
    for i in range(n - 2, -1, -1):
        td[i] = lat[i] + F.interpolate(td[i + 1], size=lat[i].shape[-2:],
                                       mode="nearest")
    outs = []
    for i, t in enumerate(td):
        t = conv(p, f"FPN_0/Conv_{n + i}", t)
        if i > 0:
            t = F.interpolate(t, size=td[0].shape[-2:], mode="nearest")
        outs.append(t)
    x = torch.cat(outs, dim=1)
    x = conv_bn_relu(p, "DBHead_0/ConvBNRelu_0", x)
    x = F.relu(bn(p, "DBHead_0/BatchNorm_0",
                  conv_transpose(p, "DBHead_0/ConvTranspose_0", x)))
    x = conv_transpose(p, "DBHead_0/ConvTranspose_1", x)
    return torch.sigmoid(x[:, 0])


# ---------------------------------------------------------------------------
# CRNN
# ---------------------------------------------------------------------------

_GATES = ("i", "f", "g", "o")


def _lstm(p: Params, cell: str, x: torch.Tensor) -> torch.Tensor:
    """flax OptimizedLSTMCell over (B, T, F), zero initial carry."""
    wi = torch.cat([p[f"params/{cell}/i{g}/kernel"] for g in _GATES], 1)
    wh = torch.cat([p[f"params/{cell}/h{g}/kernel"] for g in _GATES], 1)
    bh = torch.cat([p[f"params/{cell}/h{g}/bias"] for g in _GATES])
    B, T, _ = x.shape
    H = wh.shape[0]
    lo = round_bf16 if p.lowp else (lambda t: t)
    wi, wh = lo(wi), lo(wh)
    xw = _mm(lo(x), wi)
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = []
    for t in range(T):
        z = xw[:, t] + _mm(lo(h), wh) + bh
        i, f, g, o = z.split(H, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


def _flip_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths.long()[:, None]
    idx = torch.where(t < L, L - 1 - t, t)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _bilstm(p: Params, mod: str, x: torch.Tensor, lengths: torch.Tensor):
    yf = _lstm(p, f"{mod}/OptimizedLSTMCell_0", x)
    yb = _lstm(p, f"{mod}/OptimizedLSTMCell_1", _flip_valid(x, lengths))
    return torch.cat([yf, _flip_valid(yb, lengths)], dim=-1)


def crnn_logits(p: Params, strips: torch.Tensor, widths: torch.Tensor):
    """(N, H, W) normalized strips, (N,) valid widths -> (logits (N, T, C),
    frame lengths (N,)), T = W / 4."""
    x = strips[:, None]
    height = x.shape[2]
    x = F.max_pool2d(conv_bn_relu(p, "ConvBNRelu_0", x), 2, 2)
    x = F.max_pool2d(conv_bn_relu(p, "ConvBNRelu_1", x), 2, 2)
    x = conv_bn_relu(p, "ConvBNRelu_3", conv_bn_relu(p, "ConvBNRelu_2", x))
    x = F.max_pool2d(x, (2, 1), (2, 1))
    x = conv_bn_relu(p, "ConvBNRelu_5", conv_bn_relu(p, "ConvBNRelu_4", x))
    x = F.max_pool2d(x, (2, 1), (2, 1))
    assert x.shape[2] == height // 16
    x = conv_bn_relu(p, "ConvBNRelu_6", x, padding=((0, 0), (1, 1)))
    feats = x[:, :, 0].permute(0, 2, 1)                     # (N, T, C)
    lengths = torch.clamp(-(-widths.long() // 4), 0, feats.shape[1])
    feats = _bilstm(p, "BiLSTM_0", feats, lengths)
    feats = _bilstm(p, "BiLSTM_1", feats, lengths)
    kernel = p["params/Dense_0/kernel"]
    if p.lowp:
        feats, kernel = round_bf16(feats), round_bf16(kernel)
    logits = _mm(feats, kernel) + p["params/Dense_0/bias"]
    return logits, lengths


def ctc_greedy(logits: torch.Tensor, lengths: torch.Tensor,
               max_tokens: int, blank: int = 0):
    """Best path, repeats collapsed, blanks dropped -> (list of id lists,
    confidences: mean max-softmax over the kept frames, 1 if none)."""
    ids = logits.argmax(dim=-1).cpu().numpy()
    conf_f = torch.softmax(logits, dim=-1).amax(dim=-1).cpu().numpy()
    L = lengths.cpu().numpy()
    out, confs = [], []
    for b in range(ids.shape[0]):
        seq, cs, prev = [], [], -1
        for t in range(int(L[b])):
            c = int(ids[b, t])
            if c != blank and c != prev:
                seq.append(c)
                cs.append(conf_f[b, t])
            prev = c
        out.append(seq[:max_tokens])
        confs.append(float(np.mean(cs)) if cs else 1.0)
    return out, confs


def load_charset(path: str) -> Sequence[str]:
    """One character a line, "<space>" for a space; id 0 is the blank."""
    chars = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line:
                chars.append(" " if line == "<space>" else line)
    return chars
