"""Orientation classifier (port of ocrjax/models/cls.py, inference only):
whether a rectified text strip is upside down, and the 180-degree rotation
of the strips it flags. rec_try_flip runs it in front of the CRNN on every
lane (api_det._cls_flip_strips).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ocrjax_torch.models.crnn import Conv2d, compute_dtype


class OrientationClassifier(nn.Module):
    """(B, 1, H, W) normalized strips + (B,) widths -> (B,) logit of
    "flipped": three stride-2 convs, width-masked mean||max pool over W,
    two dense layers."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128),
                 input_height: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        convs, cin = [], 1
        for ch in channels:
            convs.append(Conv2d(cin, ch, 3, 2, dtype=dtype))
            cin = ch
        self.convs = nn.ModuleList(convs)
        self.stride = 2 ** len(channels)
        self.fc1 = nn.Linear((input_height // self.stride) * cin * 2, 64)
        self.fc2 = nn.Linear(64, 1)

    def forward(self, x, widths):
        for c in self.convs:
            x = F.relu(c(x))
        x = x.float()                                       # (B, C, H', W')
        w_cols = torch.div(widths.float() + self.stride - 1, self.stride,
                           rounding_mode="floor")
        cols = torch.arange(x.shape[3], device=x.device, dtype=torch.float32)
        m = (cols[None, :] < w_cols[:, None]).float()[:, None, None, :]
        mean = (x * m).sum(3) / m.sum(3).clamp(min=1.0)     # (B, C, H')
        mx = x.masked_fill(m == 0, float("-inf")).amax(dim=3)
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        pooled = torch.cat([mean, mx], dim=1).permute(0, 2, 1)  # (B, H', 2C)
        h = F.relu(self.fc1(pooled.reshape(pooled.shape[0], -1)))
        return self.fc2(h)[:, 0]


def create_cls(config) -> OrientationClassifier:
    return OrientationClassifier(input_height=config.rec_height,
                                 dtype=compute_dtype(config))


def flip_strips_by_width(strips: torch.Tensor, widths: torch.Tensor,
                         flip: torch.Tensor, pad_value: float
                         ) -> torch.Tensor:
    """Rotate the flagged strips 180 degrees, content kept left-aligned.

    strips (N, H, W), widths (N,) valid columns, flip (N,) bool. Column j of
    a flipped strip is column w-1-j of the row-reversed strip; columns >= w
    stay at pad_value. An index gather, where the reference multiplies by a
    one-hot shift matrix on the TPU: both copy every element exactly."""
    N, H, W = strips.shape
    cols = torch.arange(W, device=strips.device)
    w = widths.to(strips.device).long()[:, None]
    src = torch.clamp(w - 1 - cols[None, :], 0, W - 1)        # (N, W)
    flipped = torch.gather(strips.flip(1), 2,
                           src[:, None, :].expand(N, H, W))
    flipped = torch.where(cols[None, None, :] < w[:, :, None], flipped,
                          torch.full_like(flipped, pad_value))
    return torch.where(flip.to(strips.device)[:, None, None], flipped, strips)
