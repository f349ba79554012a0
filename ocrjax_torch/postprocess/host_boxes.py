"""Classic DB postprocess on the host with cv2 (port of
ocrjax/postprocess/host_boxes.py).

threshold -> contours -> score filter -> polygon unclip -> min-area rect:
a CPU oracle of db_boxes.extract_boxes and of the native route
(native_boxes.extract_boxes_native). No serving path runs it. cv2 is
imported where it is used, so importing this module works on a machine
without it (the card's); a call there raises ImportError naming cv2.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("host_boxes needs cv2 (opencv-python), which is "
                          "not installed") from e
    return cv2


def unclip_polygon(poly: np.ndarray, ratio: float) -> np.ndarray:
    """Expand a polygon by delta = area * ratio / perimeter: each edge
    shifted outward along its normal, neighbouring edges intersected (a
    miter join); for a rectangle this is the Vatti offset's min-area
    rect."""
    cv2 = _cv2()
    poly = np.asarray(poly, np.float64)
    area = abs(cv2.contourArea(poly.astype(np.float32)))
    perim = cv2.arcLength(poly.astype(np.float32), True)
    if perim <= 1e-6:
        return poly.astype(np.float32)
    delta = area * ratio / perim

    n = len(poly)
    signed = 0.0                    # counter-clockwise: positive signed area
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        signed += x1 * y2 - x2 * y1
    if signed < 0:
        poly = poly[::-1]

    out = []
    for i in range(n):
        p_prev, p_cur, p_next = poly[(i - 1) % n], poly[i], poly[(i + 1) % n]
        # outward normals of the two adjacent edges (CCW: (dy, -dx))
        lines = []
        for a, b in ((p_prev, p_cur), (p_cur, p_next)):
            d = b - a
            ln = np.hypot(*d)
            if ln < 1e-9:
                continue
            nvec = np.array([d[1], -d[0]]) / ln
            lines.append((a + nvec * delta, b + nvec * delta))
        if len(lines) == 1:
            out.append(lines[0][1])
            continue
        (a1, b1), (a2, b2) = lines
        d1, d2 = b1 - a1, b2 - a2
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-9:       # collinear edges: offset the vertex
            out.append((b1 + a2) / 2)
        else:
            t = ((a2[0] - a1[0]) * d2[1] - (a2[1] - a1[1]) * d2[0]) / denom
            out.append(a1 + t * d1)
    res = np.asarray(out, np.float32)
    if signed < 0:
        res = res[::-1]
    return res


def order_quad(pts: np.ndarray) -> np.ndarray:
    """Order 4 points TL, TR, BR, BL."""
    pts = np.asarray(pts, np.float32)
    s = pts.sum(axis=1)
    d = pts[:, 0] - pts[:, 1]
    return np.stack([pts[np.argmin(s)], pts[np.argmax(d)],
                     pts[np.argmax(s)], pts[np.argmin(d)]])


def extract_boxes_host(
    prob: np.ndarray,
    thresh: float = 0.3,
    box_thresh: float = 0.6,
    unclip_ratio: float = 1.5,
    max_candidates: int = 256,
    min_box_size: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Classic DB postprocess. prob (H, W) float -> (boxes (N, 4, 2),
    scores (N,)) float32."""
    cv2 = _cv2()
    prob = np.asarray(prob, np.float32)
    H, W = prob.shape
    bitmap = (prob > thresh).astype(np.uint8)
    contours, _ = cv2.findContours(
        bitmap, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
    boxes: List[np.ndarray] = []
    scores: List[float] = []
    for contour in contours[:max_candidates]:
        mask = np.zeros((H, W), np.uint8)       # the component's mean score
        cv2.drawContours(mask, [contour], -1, 1, thickness=-1)
        score = float((prob * mask).sum() / max(mask.sum(), 1))
        if score < box_thresh:
            continue
        rect = cv2.minAreaRect(contour)
        if min(rect[1]) < min_box_size:
            continue
        expanded = unclip_polygon(cv2.boxPoints(rect), unclip_ratio)
        rect2 = cv2.minAreaRect(expanded.astype(np.float32))
        quad = order_quad(cv2.boxPoints(rect2))
        quad[:, 0] = np.clip(quad[:, 0], 0, W - 1)
        quad[:, 1] = np.clip(quad[:, 1], 0, H - 1)
        boxes.append(quad)
        scores.append(score)
    if not boxes:
        return np.zeros((0, 4, 2), np.float32), np.zeros((0,), np.float32)
    return np.stack(boxes), np.asarray(scores, np.float32)
