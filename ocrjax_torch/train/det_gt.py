"""DB ground-truth map generation from quads (host NumPy, per batch; the
port's copy of ocrjax/train/det_gt.py, equal to it exactly).

Builds the three training targets of the DB formulation on synthetic pages
(axis-aligned line quads from train.synth.render_page):

  * gt_shrink: text polygons shrunk by δ = A(1-r²)/P (r=0.4) — the positive
    region for the prob/binary heads;
  * gt_thresh + thresh_mask: the border band around each polygon where the
    threshold head regresses the normalized distance to the polygon edge,
    scaled into [thresh_min, thresh_max].

Rect-exact implementation (our synthetic quads are rects); distances are
computed with vectorized NumPy, no per-pixel Python loops.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SHRINK_RATIO = 0.4
THRESH_MIN = 0.3
THRESH_MAX = 0.7


def _rect_of_quad(quad: np.ndarray) -> Tuple[float, float, float, float]:
    return (float(quad[:, 0].min()), float(quad[:, 1].min()),
            float(quad[:, 0].max()), float(quad[:, 1].max()))


def db_gt_maps(quads: List[np.ndarray], shape: Tuple[int, int]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (gt_shrink, gt_thresh, thresh_mask), each (H, W) float32.

    Quads may be ROTATED rects (synth.render_page with max_rotation > 0):
    all distances are computed in each quad's own (u, v) frame, which is
    exact for rects at any angle and reduces to the axis-aligned math at 0°.
    """
    H, W = shape
    gt_shrink = np.zeros((H, W), np.float32)
    gt_thresh = np.zeros((H, W), np.float32)
    thresh_mask = np.zeros((H, W), np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)

    for quad in quads:
        c = quad.mean(axis=0)
        ex = quad[1] - quad[0]
        w = float(np.hypot(*ex))
        ey = quad[3] - quad[0]
        h = float(np.hypot(*ey))
        if w <= 2 or h <= 2:
            continue
        ex, ey = ex / w, ey / h
        hw, hh = w / 2.0, h / 2.0
        area, perim = w * h, 2 * (w + h)
        delta = area * (1 - SHRINK_RATIO ** 2) / perim

        # window: AABB of the quad grown by the band width
        x0, y0, x1, y1 = _rect_of_quad(quad)
        bx0 = max(0, int(x0 - delta) - 1)
        by0 = max(0, int(y0 - delta) - 1)
        bx1 = min(W, int(np.ceil(x1 + delta)) + 2)
        by1 = min(H, int(np.ceil(y1 + delta)) + 2)
        if bx1 <= bx0 or by1 <= by0:
            continue
        px = xs[by0:by1, bx0:bx1] - c[0]
        py = ys[by0:by1, bx0:bx1] - c[1]
        u = np.abs(px * ex[0] + py * ex[1])   # |local coords|
        v = np.abs(px * ey[0] + py * ey[1])

        # shrunk positive region
        if hw > delta and hh > delta:
            region_s = gt_shrink[by0:by1, bx0:bx1]
            np.maximum(region_s, ((u <= hw - delta) & (v <= hh - delta))
                       .astype(np.float32), out=region_s)

        # border band: |signed distance to rect| <= delta
        du = np.maximum(u - hw, 0)
        dv = np.maximum(v - hh, 0)
        outside = np.hypot(du, dv)
        inside = np.minimum(hw - u, hh - v)
        sdist = np.where(outside > 0, outside, -np.clip(inside, 0, None))
        band = np.abs(sdist) <= delta
        # 1 at the edge → 0 at band rim, scaled into [min, max]
        val = 1.0 - np.abs(sdist) / max(delta, 1e-6)
        val = THRESH_MIN + (THRESH_MAX - THRESH_MIN) * np.clip(val, 0, 1)
        region_t = gt_thresh[by0:by1, bx0:bx1]
        region_m = thresh_mask[by0:by1, bx0:bx1]
        region_t[band] = np.maximum(region_t[band], val[band])
        region_m[band] = 1.0

    return gt_shrink, gt_thresh, thresh_mask


def make_det_batch(rng: np.random.RandomState, charset, batch_size: int,
                   size: int, n_lines=(3, 8),
                   p_word: float = 0.0, degrade: float = 0.0,
                   p_dense: float = 0.0) -> Tuple[np.ndarray, ...]:
    """Rendered pages + GT maps: (images u8 (B,S,S,3), gt_shrink, gt_thresh,
    thresh_mask) — images are RGB broadcast of the gray page. p_word: see
    synth.word_text (kernel continuity across '_'-joined x-height words).
    degrade: probability of pushing the PAGE through synth.degrade_image at
    a random level (blur/noise/JPEG/contrast/illumination) AFTER the GT
    maps are computed — degradation never moves geometry, so the targets
    stay exact (the ICDAR-scan robustness proxy: the clean-trained detector
    measured recall 0.54 at level 0.25, VERDICT r2 missing #2/#3).
    p_dense: probability of a DENSE page (synth.render_page_dense scaled to
    `size` — the C5 hundreds-of-lines layout) instead of the sparse one."""
    from ocrjax_torch.train import synth

    imgs = np.zeros((batch_size, size, size, 3), np.uint8)
    g_shrink = np.zeros((batch_size, size, size), np.float32)
    g_thresh = np.zeros((batch_size, size, size), np.float32)
    g_mask = np.zeros((batch_size, size, size), np.float32)
    for b in range(batch_size):
        if p_dense > 0 and rng.rand() < p_dense:
            # line/page count scaled so density matches the 2048px C5 page
            page, quads, _ = synth.render_page_dense(
                rng, charset, size=(size, size),
                n_lines=max(8, int(200 * (size / 2048.0) ** 2)),
                text_height=(14, 24), max_len=8, p_word=p_word)
        else:
            page, quads, _ = synth.render_page(
                rng, charset, size=(size, size), n_lines=n_lines,
                p_word=p_word)
        if degrade > 0 and rng.rand() < degrade:
            page = synth.degrade_image(page, rng,
                                       level=rng.uniform(0.25, 1.0))
        imgs[b] = page[..., None]
        s, t, m = db_gt_maps(quads, (size, size))
        g_shrink[b], g_thresh[b], g_mask[b] = s, t, m
    return imgs, g_shrink, g_thresh, g_mask
