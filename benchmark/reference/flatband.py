"""Flat-band gate constants (a frozen copy).

A strip's ink band is "flat" when its ink columns split (by blank columns)
into at most FLAT_MAX_GLYPHS runs whose tops and bottoms agree within
max(2, FLAT_TOL_FRAC * band height); with the case gate on, the band must
also be at most FLAT_CASE_MAX_FRAC of the line height. ops.warp.ink_boxes
reads the constants.
"""

from __future__ import annotations

import numpy as np

FLAT_TOL_FRAC = 0.18
FLAT_MAX_GLYPHS = 3
FLAT_CASE_MAX_FRAC = 0.46


def flat_band_gate(band_ink: np.ndarray, line_h: float = 0.0) -> bool:
    """band_ink: (band_h, W) bool ink mask of the row band; the numpy twin
    of the gate in ops.warp.ink_boxes. line_h > 0 adds the case condition
    (band_h <= FLAT_CASE_MAX_FRAC * line_h)."""
    band_h, _ = band_ink.shape
    if line_h > 0 and band_h > FLAT_CASE_MAX_FRAC * line_h:
        return False
    cols = band_ink.sum(axis=0) >= 1
    if not cols.any():
        return False
    col_top = np.where(cols, band_ink.argmax(axis=0), band_h)
    col_bot = np.where(cols, band_h - 1 - band_ink[::-1].argmax(axis=0), -1)
    on = cols & ~np.concatenate([[False], cols[:-1]])
    ng = int(on.sum())
    if ng == 0 or ng > FLAT_MAX_GLYPHS:
        return False
    seg = np.cumsum(on) - 1
    gtop = [col_top[(seg == g) & cols].min() for g in range(ng)]
    gbot = [col_bot[(seg == g) & cols].max() for g in range(ng)]
    tol = max(2.0, FLAT_TOL_FRAC * band_h)
    return (max(gtop) - min(gtop)) <= tol and \
        (max(gbot) - min(gbot)) <= tol
