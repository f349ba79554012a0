"""End-to-end evaluation on synthetic pages: exact line match, detection
recall and character error rate (port of ocrjax/train/e2e_eval.py).

Split in two so the card can score pages rendered elsewhere: render_e2e
draws the pages and their ground truth with train.synth (host only: PIL
and cv2), score_e2e runs engine.ocr on given pages and scores them.
evaluate_e2e is the two together, with ocrjax's signature and results.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def render_e2e(charset, n_pages: int = 8, size: int = 640, seed: int = 123,
               max_rotation: float = 0.0, degrade_level: float = 0.0,
               supersample: int = 1, projective: float = 0.0,
               curl: float = 0.0) -> Tuple[List[np.ndarray], List[List[str]]]:
    """-> (uint8 (size, size) pages, each page's ground-truth texts), as
    ocrjax's evaluate_e2e draws them from RandomState(seed)."""
    from ocrjax_torch.train.synth import (degrade_image, render_page,
                                          warp_page_projective)
    rng = np.random.RandomState(seed)
    pages, gts = [], []
    for _ in range(n_pages):
        page, quads, texts = render_page(
            rng, charset, size=(size, size),
            max_rotation=max_rotation, supersample=supersample)
        if projective > 0 or curl > 0:
            page, quads = warp_page_projective(
                page, quads, rng, severity=projective, curl=curl)
        if degrade_level > 0:
            page = degrade_image(page, rng, level=degrade_level)
        pages.append(page)
        gts.append(list(texts))
    return pages, gts


def score_e2e(engine, pages: Sequence[np.ndarray],
              gts: Sequence[Sequence[str]], beam: bool = False
              ) -> Dict[str, float]:
    """engine.ocr on each (H, W) uint8 page -> dict(line_exact_match,
    det_recall, char_error_rate) against its ground-truth texts."""
    total_gt = matched_boxes = exact = 0
    char_errs = char_total = 0
    for page, texts in zip(pages, gts):
        img = np.repeat(page[..., None], 3, axis=2)
        res = engine.ocr(img, beam=beam)
        total_gt += len(texts)
        matched_boxes += min(len(res.lines), len(texts))
        remaining = list(texts)
        for line in res.lines:
            if line.text in remaining:
                remaining.remove(line.text)
                exact += 1
        # greedy char-level alignment for CER (order-insensitive pairing by
        # best match keeps this robust to reading-order differences)
        preds = [line.text for line in res.lines]
        for t in texts:
            if not preds:
                char_errs += len(t)
                char_total += len(t)
                continue
            dists = [_levenshtein(t, p) for p in preds]
            k = int(np.argmin(dists))
            char_errs += dists[k]
            char_total += max(len(t), len(preds[k]))
            preds.pop(k)
        for p in preds:  # spurious detections
            char_errs += len(p)
            char_total += len(p)
    return {
        "line_exact_match": exact / max(total_gt, 1),
        "det_recall": matched_boxes / max(total_gt, 1),
        "char_error_rate": char_errs / max(char_total, 1),
    }


def evaluate_e2e(engine, n_pages: int = 8, size: int = 640,
                 seed: int = 123, beam: bool = False,
                 max_rotation: float = 0.0,
                 degrade_level: float = 0.0,
                 supersample: int = 1,
                 projective: float = 0.0,
                 curl: float = 0.0) -> Dict[str, float]:
    """-> dict(line_exact_match, det_recall, char_error_rate) on n_pages
    rendered pages. max_rotation rotates each line by a uniform angle in
    +-deg; degrade_level > 0 pushes the page through synth.degrade_image;
    supersample > 1 renders through the held-out rasterization path;
    projective / curl > 0 warp the page through
    synth.warp_page_projective (see ocrjax's evaluate_e2e)."""
    pages, gts = render_e2e(engine.charset, n_pages, size, seed,
                            max_rotation, degrade_level, supersample,
                            projective, curl)
    return score_e2e(engine, pages, gts, beam=beam)


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]
