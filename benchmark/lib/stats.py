"""The benchmark's own arithmetic: percentiles, the card's peaks, and the
operations and bytes that a page's work needs, counted on the reference's
models whatever the program runs.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
H100_BF16_PEAK_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def percentile(xs: Iterable[float], q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(list(xs), np.float64), q))


def rnn_flops(T: int, B: int, n_in: int, hidden: int, num_layers: int,
              bidirectional: bool) -> int:
    """2 FLOPs a MAC over 4 gates of (in -> H) and (H -> H), every step,
    layer and direction; layers after the first read the H * dirs
    output."""
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        i = n_in if layer == 0 else hidden * dirs
        total += dirs * T * B * 2 * 4 * hidden * (i + hidden)
    return total


def crnn_bilstm_flops(hidden: int, conv_out: int, n: int, width: int
                      ) -> float:
    """Matmul FLOPs of the CRNN's 2-layer BiLSTM over n strips of `width`
    pixels: T = width / 4 steps."""
    T = max(width // 4, 1)
    return float(rnn_flops(T, n, conv_out, hidden, 2, True))


def counted_flops(fn, *args) -> float:
    """FLOPs of the convolutions and matrix products that a reference
    forward runs (reference/models.counting), read from their shapes."""
    from benchmark.reference.models import counting
    with counting() as c:
        fn(*args)
    return float(c.flops)


def strip_widths(quads: np.ndarray, rec_height: int) -> np.ndarray:
    """The width of each line's strip at the recognizer's height, from its
    box, aspect kept, rounded up to the recognizer's stride of 4 (the
    CRNN's and SVTR's: a frame every 4 columns)."""
    q = np.asarray(quads, np.float64).reshape(-1, 4, 2)
    top = np.linalg.norm(q[:, 1] - q[:, 0], axis=-1)
    left = np.linalg.norm(q[:, 3] - q[:, 0], axis=-1)
    w = np.round(np.maximum(top, 1.0) * rec_height / np.maximum(left, 1.0))
    return (np.ceil(w / 4.0) * 4).astype(np.int64)


def ccl_bytes(grids: Sequence[tuple]) -> float:
    """Bytes a labelling of these (H, W) grids needs: the bitmap read once
    (one byte a cell) and int32 labels written once."""
    return float(sum(5 * h * w for h, w in grids))
