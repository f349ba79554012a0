"""Host-side box geometry (a frozen copy): reading order,
tilt, the 90-degree frame map, canvas-to-page scaling, and the hull IoU and
merge of the tile seams."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def sort_reading_order(quads: Sequence[np.ndarray]) -> List[int]:
    """Indices of quads in reading order: rows top to bottom, left to right.

    Two boxes share a row when their vertical overlap exceeds half the
    smaller box height.
    """
    n = len(quads)
    if n == 0:
        return []
    tops = np.array([q[:, 1].min() for q in quads])
    bots = np.array([q[:, 1].max() for q in quads])
    lefts = np.array([q[:, 0].min() for q in quads])
    order = np.argsort(tops, kind="stable")
    rows: List[List[int]] = []
    for i in order:
        for row in rows:
            j = row[0]
            overlap = min(bots[i], bots[j]) - max(tops[i], tops[j])
            min_h = max(min(bots[i] - tops[i], bots[j] - tops[j]), 1e-6)
            if overlap > 0.5 * min_h:
                row.append(int(i))
                break
        else:
            rows.append([int(i)])
    out: List[int] = []
    for row in rows:
        out.extend(sorted(row, key=lambda k: lefts[k]))
    return out


def quad_tilt_deg(quads: np.ndarray) -> np.ndarray:
    """Per-quad tilt in [0, 90]: angle of the TL->TR edge from the nearest
    image axis."""
    q = np.asarray(quads, np.float32).reshape(-1, 4, 2)
    e = q[:, 1] - q[:, 0]
    a = np.abs(np.degrees(np.arctan2(e[:, 1], e[:, 0]))) % 180.0
    return np.minimum(a, 180.0 - a)


def rot90_ccw_to_orig(quads: np.ndarray, orig_w: int) -> np.ndarray:
    """Map (..., 4, 2) points from the np.rot90(img) (counter-clockwise)
    frame back to the original frame: (x', y') -> (orig_w - 1 - y', x')."""
    q = np.asarray(quads, np.float32)
    out = np.empty_like(q)
    out[..., 0] = orig_w - 1 - q[..., 1]
    out[..., 1] = q[..., 0]
    return out


def scale_quads(quads: np.ndarray, scale: float) -> np.ndarray:
    """Map quads from canvas to original image coords (divide by scale)."""
    return np.asarray(quads, np.float32) / float(scale)


def quad_iou_aabb(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of the axis-aligned hulls of two quads."""
    ax0, ay0 = a[:, 0].min(), a[:, 1].min()
    ax1, ay1 = a[:, 0].max(), a[:, 1].max()
    bx0, by0 = b[:, 0].min(), b[:, 1].min()
    bx1, by1 = b[:, 0].max(), b[:, 1].max()
    iw = min(ax1, bx1) - max(ax0, bx0)
    ih = min(ay1, by1) - max(ay0, by0)
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    union = ((ax1 - ax0) * (ay1 - ay0)
             + (bx1 - bx0) * (by1 - by0) - inter)
    return float(inter / max(union, 1e-9))


def merge_quads(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Axis-aligned hull of two quads (the tile-seam merge)."""
    x0 = min(a[:, 0].min(), b[:, 0].min())
    y0 = min(a[:, 1].min(), b[:, 1].min())
    x1 = max(a[:, 0].max(), b[:, 0].max())
    y1 = max(a[:, 1].max(), b[:, 1].max())
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)
