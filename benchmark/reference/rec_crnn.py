"""The CRNN recognizer (arXiv:1507.05717) behind the interface of
reference/recognizers.py: models.crnn_logits, counted per strip column."""

from __future__ import annotations

import numpy as np
import torch

from . import models as M

# the CRNN is convolutions, pools that every stride of 4 divides, and an
# LSTM over W / 4 frames: its FLOPs grow by the same amount each column
_COUNT_WIDTH = 128


def logits(p: M.Params, cfg, strips: torch.Tensor, widths: torch.Tensor):
    return M.crnn_logits(p, strips, widths)


def flops(p: M.Params, cfg, widths) -> np.ndarray:
    W = _COUNT_WIDTH
    dev = p["params/Dense_0/kernel"].device
    with torch.inference_mode(), M.counting() as c:
        M.crnn_logits(p, torch.zeros(1, cfg.rec_height, W, device=dev),
                      torch.full((1,), W, device=dev))
    return float(c.flops) / W * np.asarray(widths, np.float64)
