"""Int8 inference path of the DB detector (port of ocrjax/models/db_int8.py).

The backbone and FPN convolutions run on int8 operands with exact int32
accumulation; the probability head stays on the float path. The recipe is
the reference's:
  * BatchNorm folded into the conv before quantization;
  * activations quantized per INPUT channel with a scale shared by the whole
    batch (abs-max over batch, height and width), folded into the weights
    (conv(w, x) = conv(w * sx, x / sx));
  * weights quantized per OUTPUT channel (abs-max / 127);
  * int32 accumulation, then dequantization `y * ws + bias` in float32 and
    the cast to the compute dtype.
The activation scale spans the batch, so a page's prob map depends on the
other pages of its call: callers must batch pages as the reference does.

The int8 product on the card is `torch._int_mm` (int8 x int8 -> int32) over
an im2col unfold; its plain version, for the CPU, is the same convolution in
float64, where every sum of int8 products is an exact integer (float32 is
not: 9 * 127^2 * Cin passes 2^24 from Cin = 115).

Rounding of the reference, reproduced where it can be:
  * XLA divides by the constant 127 as a multiply by float32(1/127);
  * XLA folds the BN scale as scale * rsqrt(var + eps) with its own rsqrt;
    the port takes the correctly rounded rsqrt, which agrees on about 89% of
    channels (measured with XLA:CPU), so a folded weight may sit one ulp
    off and flip an int8 code that lies at a .5; the lanes are held to the
    goldens bar, not to bit equality;
  * the bias terms `bias - mean * g` and `y * ws + bias` are fused
    multiply-adds in XLA: one float64 evaluation rounded once gives the
    same bits on any device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ocrjax_torch.models.crnn import BN_EPS, BatchNorm, same_pads
from ocrjax_torch.models.db import DBDetector

QMAX = 127.0
_INV_QMAX = float(np.float32(1.0 / QMAX))


def fold_bn(weight: torch.Tensor, bn: BatchNorm):
    """Conv weight (O, I, kh, kw) + inference BatchNorm -> (w', bias')."""
    inv = (1.0 / torch.sqrt((bn.running_var.float() + BN_EPS).double())
           ).float()
    g = bn.weight.float() * inv
    bias = (bn.bias.double() - bn.running_mean.double() * g.double()).float()
    return weight.float() * g[:, None, None, None], bias


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int
                    ) -> torch.Tensor:
    """SAME int8 convolution (B, I, H, W) x (O, I, kh, kw) -> int32 (B, O,
    H', W'), as a float64 convolution: exact."""
    pads = same_pads(xq.shape[-2:], wq.shape[-2:], (stride, stride))
    y = F.conv2d(F.pad(xq.double(), pads), wq.double(), stride=stride)
    return y.to(torch.int32)


def int8_conv_int_mm(xq: torch.Tensor, wq: torch.Tensor, stride: int
                     ) -> torch.Tensor:
    """The same convolution through torch._int_mm on an NHWC im2col unfold
    (columns ordered tap by tap, channels within a tap). _int_mm wants more
    than 16 rows and K, N multiples of 8, and cuBLASLt refuses row counts
    that are not multiples of 8 (27 rows failed on the H100): every
    dimension is zero-padded to a multiple of 8, the rows to at least 24
    (exact: zero rows and columns add nothing)."""
    B, Ci, H, W = xq.shape
    Co, _, kh, kw = wq.shape
    pads = same_pads((H, W), (kh, kw), (stride, stride))
    x = F.pad(xq, pads).permute(0, 2, 3, 1)                 # (B, Hp, Wp, Ci)
    Ho, Wo = -(-H // stride), -(-W // stride)
    taps = [x[:, dy:dy + stride * (Ho - 1) + 1:stride,
              dx:dx + stride * (Wo - 1) + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    cols = (torch.cat(taps, dim=-1) if len(taps) > 1 else taps[0]
            ).reshape(B * Ho * Wo, kh * kw * Ci)
    w = wq.permute(2, 3, 1, 0).reshape(kh * kw * Ci, Co)   # (K, O), tap-major
    M, K = cols.shape
    Kp, Np, Mp = _round8(K), _round8(Co), max(_round8(M), 24)
    if (Kp, Mp) != (K, M):
        cols = F.pad(cols, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, Co):
        w = F.pad(w, (0, Np - Co, 0, Kp - K))
    y = torch._int_mm(cols.contiguous(), w.contiguous())[:M, :Co]
    return y.reshape(B, Ho, Wo, Co).permute(0, 3, 1, 2)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int
              ) -> torch.Tensor:
    """The int8 convolution: _int_mm on a card, the exact float64 plain
    version for a tensor on the CPU."""
    if xq.is_cuda:
        return int8_conv_int_mm(xq, wq, stride)
    return int8_conv_plain(xq, wq, stride)


def qconv(x: torch.Tensor, w: torch.Tensor, bias, stride: int, relu: bool,
          out_dtype: torch.dtype) -> torch.Tensor:
    """Quantized SAME conv: x (B, I, H, W) float, w (O, I, kh, kw) float32
    (BN-folded), bias (O,) float32 or None -> (B, O, H', W') out_dtype."""
    xf = x.float()                  # quantize in float32: bf16's ulp at 127 is 0.5
    sx = torch.clamp(xf.abs().amax(dim=(0, 2, 3)), min=1e-8) * _INV_QMAX
    xq = torch.clamp(torch.round(xf / sx[None, :, None, None]),
                     -QMAX, QMAX).to(torch.int8)
    w_eff = w * sx[None, :, None, None]
    ws = torch.clamp(w_eff.abs().amax(dim=(1, 2, 3)), min=1e-8) * _INV_QMAX
    wq = torch.clamp(torch.round(w_eff / ws[:, None, None, None]),
                     -QMAX, QMAX).to(torch.int8)
    y = int8_conv(xq, wq, stride).float()
    if bias is None:
        y = y * ws[None, :, None, None]
    else:
        y = (y.double() * ws.double()[None, :, None, None]
             + bias.double()[None, :, None, None]).float()
    y = y.to(out_dtype)
    return F.relu(y) if relu else y


def prob_int8(model: DBDetector, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for model(x)["prob"] with the backbone and FPN in int8:
    x (B, 3, S, S) normalized -> (B, S/hs, S/hs) float32."""
    dt = model.head.dtype

    def conv_bn(conv, bn, xx, relu):
        w, b = fold_bn(conv.weight, bn)
        return qconv(xx, w, b, conv.stride[0], relu, dt)

    bb = model.backbone
    x = x.to(dt)
    x = conv_bn(bb.stem0.conv, bb.stem0.bn, x, True)
    x = conv_bn(bb.stem1.conv, bb.stem1.bn, x, True)
    feats = []
    for stage in bb.stages:
        for blk in stage:
            y = conv_bn(blk.conv1.conv, blk.conv1.bn, x, True)
            y = conv_bn(blk.conv2, blk.bn2, y, False)
            r = conv_bn(blk.conv_p, blk.bn_p, x, False) if blk.project else x
            x = F.relu(y + r)
        feats.append(x)

    fpn = model.fpn
    lat = [qconv(f, m.weight, None, 1, False, dt)
           for m, f in zip(fpn.lateral, feats)]
    p = list(lat)
    for i in range(len(lat) - 2, -1, -1):
        p[i] = lat[i] + F.interpolate(p[i + 1], size=lat[i].shape[-2:],
                                      mode="nearest")
    outs = []
    for i, t in enumerate(p):
        t = qconv(t, fpn.smooth[i].weight, None, 1, False, dt)
        if i > 0:
            t = F.interpolate(t, size=p[0].shape[-2:], mode="nearest")
        outs.append(t)
    # the head stays on the float path, as in the reference
    return torch.sigmoid(model.head(torch.cat(outs, dim=1)))


def apply_prob(model: DBDetector, x: torch.Tensor, int8: bool
               ) -> torch.Tensor:
    """The detection forward: the float model or its int8 mirror."""
    if int8:
        return prob_int8(model, x)
    return model(x)["prob"]
