"""DB (Differentiable Binarization) text detector (port of
ocrjax/models/db.py). Backbone -> FPN -> prob head; NCHW; float32
parameters computed in the compute dtype, with the head's last layer in
float32 as in the reference. The threshold head runs when asked and in
train mode, which also returns the differentiable binarization
sigmoid(k (prob - thresh)), k = 50, for train.det_trainer.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ocrjax_torch.models.crnn import BatchNorm, Conv2d, ConvBNRelu, \
    compute_dtype

DB_K = 50.0  # steepness of the differentiable binarization


class ResBlock(nn.Module):
    """Two 3x3 conv+BN(+ReLU) with an identity or projection shortcut."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNRelu(cin, cout, stride=stride, dtype=dtype)
        self.conv2 = Conv2d(cout, cout, 3, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(cout)
        self.project = cin != cout or stride != 1
        if self.project:
            self.conv_p = Conv2d(cin, cout, 1, stride, bias=False, dtype=dtype)
            self.bn_p = BatchNorm(cout)

    def forward(self, x):
        y = self.bn2(self.conv2(self.conv1(x)))
        r = self.bn_p(self.conv_p(x)) if self.project else x.to(y.dtype)
        return F.relu(y + r)


class Backbone(nn.Module):
    """Stride-4 stem, then 4 ResBlock stages: features at strides 4..32."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512),
                 blocks_per_stage: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c1 = channels[0]
        self.stem0 = ConvBNRelu(3, c1 // 2, stride=2, dtype=dtype)
        self.stem1 = ConvBNRelu(c1 // 2, c1, stride=2, dtype=dtype)
        stages, cin = [], c1
        for i, ch in enumerate(channels):
            blocks = [ResBlock(cin, ch, 1 if i == 0 else 2, dtype)]
            blocks += [ResBlock(ch, ch, 1, dtype)
                       for _ in range(blocks_per_stage - 1)]
            stages.append(nn.ModuleList(blocks))
            cin = ch
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        x = self.stem1(self.stem0(x))
        feats = []
        for stage in self.stages:
            for blk in stage:
                x = blk(x)
            feats.append(x)
        return feats


class FPN(nn.Module):
    """Top-down pyramid fused to one stride-4 map of `inner` channels.
    Nearest resizes are by integer factors (canvases are multiples of 32),
    where they equal jax.image.resize's nearest."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512),
                 inner: int = 96, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lateral = nn.ModuleList(
            [Conv2d(c, inner, 1, bias=False, dtype=dtype) for c in channels])
        self.smooth = nn.ModuleList(
            [Conv2d(inner, inner // 4, 3, bias=False, dtype=dtype)
             for _ in channels])

    def forward(self, feats):
        lat = [m(f) for m, f in zip(self.lateral, feats)]
        p = list(lat)
        for i in range(len(lat) - 2, -1, -1):
            p[i] = lat[i] + F.interpolate(p[i + 1], size=lat[i].shape[-2:],
                                          mode="nearest")
        outs = []
        for i, t in enumerate(p):
            t = self.smooth[i](t)
            if i > 0:
                t = F.interpolate(t, size=p[0].shape[-2:], mode="nearest")
            outs.append(t)
        return torch.cat(outs, dim=1)


class DBHead(nn.Module):
    """conv (+ learned ConvTranspose upsampling) -> 1-channel logit map at
    canvas stride `out_stride` (1: two x2 ConvTransposes; 2: one; 4: none).
    ConvTranspose weights are (in, out, kh, kw), already spatially flipped
    from the flax kernel by weights.py."""

    def __init__(self, inner: int = 96, out_stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if out_stride not in (1, 2, 4):
            raise ValueError(f"head stride must be 1, 2 or 4, got {out_stride}")
        q = inner // 4
        self.out_stride = out_stride
        self.dtype = dtype
        self.conv0 = ConvBNRelu(inner, q, dtype=dtype)
        if out_stride in (1, 2):
            self.up1 = nn.ConvTranspose2d(q, q, 2, stride=2)
            self.bn1 = BatchNorm(q)
        if out_stride == 1:
            self.up2 = nn.ConvTranspose2d(q, 1, 2, stride=2)
        else:
            self.out = Conv2d(q, 1, 1, bias=True, dtype=torch.float32)

    def forward(self, x):
        x = self.conv0(x)
        if self.out_stride in (1, 2):
            dt = self.dtype
            x = F.conv_transpose2d(x.to(dt), self.up1.weight.to(dt),
                                   self.up1.bias.to(dt), stride=2)
            x = F.relu(self.bn1(x))
        if self.out_stride == 1:
            x = F.conv_transpose2d(x.float(), self.up2.weight,
                                   self.up2.bias, stride=2)
        else:
            x = self.out(x.float())
        return x[:, 0]                                      # float32 logits


class DBDetector(nn.Module):
    """forward(images (B, 3, S, S) normalized) -> {'prob': (B, S/hs, S/hs)
    float32} (+ 'thresh' when with_thresh or in train mode, + 'binary' in
    train mode)."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512),
                 inner: int = 96, blocks_per_stage: int = 2,
                 head_stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.arch = dict(channels=tuple(channels), inner=inner,
                         blocks_per_stage=blocks_per_stage,
                         head_stride=head_stride)
        self.backbone = Backbone(channels, blocks_per_stage, dtype)
        self.fpn = FPN(channels, inner, dtype)
        self.head = DBHead(inner, head_stride, dtype)
        self.thresh_head = DBHead(inner, head_stride, dtype)

    def forward(self, images: torch.Tensor, with_thresh: bool = False
                ) -> Dict[str, torch.Tensor]:
        fused = self.fpn(self.backbone(images))
        out = {"prob": torch.sigmoid(self.head(fused))}
        if with_thresh or self.training:
            out["thresh"] = torch.sigmoid(self.thresh_head(fused))
        if self.training:
            out["binary"] = torch.sigmoid(DB_K * (out["prob"]
                                                  - out["thresh"]))
        return out


DB_ARCHS = {
    "flagship": dict(channels=(64, 128, 256, 512), blocks_per_stage=2,
                     inner=96, head_stride=1),
    "tile": dict(channels=(32, 64, 128, 256), blocks_per_stage=1,
                 inner=64, head_stride=1),
}


def create_db(config, arch: Dict = None) -> DBDetector:
    """The flagship detector at the config's head stride, or an explicit
    architecture (a DB_ARCHS preset or an asset's `arch` metadata)."""
    arch = dict(arch or DB_ARCHS["flagship"],
                **({} if arch else {"head_stride": config.det_head_stride}))
    return DBDetector(
        channels=tuple(arch.get("channels", (64, 128, 256, 512))),
        inner=int(arch.get("inner", 96)),
        blocks_per_stage=int(arch.get("blocks_per_stage", 2)),
        head_stride=int(arch.get("head_stride", 1)),
        dtype=compute_dtype(config))
