"""The tiled lane's seam merge (ocrjax_torch/tiling.py: _merge_page and
_merge_seam_boxes) against ocrjax/tiling.py's _merge_seam_boxes, bit for
bit: the same groups in the same order, the same float32 corners and the
same scores.

The port tests only the pairs whose y-ranges overlap and hulls each group
in one reduction; the reference tests every pair in (n, n) matrices and
hulls pairwise. Held at A4 scale (word boxes of a 300-dpi page cut into
tile_plan's four 2048-pixel tiles, as the tile detector returns them at its
384 cap) and on the edge cases of the pair window: no box, one, touching
rows, equal tops, zero heights, a tilted singleton, and IoU thresholds of
0 and below. The counter of the merge's work (tiling.seam_counts) and its
reader, the CLI's --profile, close the file.
"""

import os
import types

import numpy as np
import pytest

from ocrjax import tiling as jax_tiling
from ocrjax_torch import tiling
from ocrjax_torch.config import OcrConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A4_H, A4_W = 3508, 2480
CAP = 384


def _a4_words(rng):
    """Word boxes (x0, y0, x1, y1) of a dense A4 body page at 300 dpi:
    rows of 44-52 px text in 2 cm margins, words 40-200 px wide, and a
    word at each corner of the page, which the page's edges clip."""
    words = [(0, 0, 180, 48), (A4_W - 200, 0, A4_W, 48),
             (0, A4_H - 48, 150, A4_H), (A4_W - 160, A4_H - 48, A4_W, A4_H)]
    y = 236.0
    while y < A4_H - 300:
        h = float(rng.randint(44, 53))
        x = 236.0 + rng.uniform(0, 30)
        while True:
            w = rng.uniform(40, 200)
            if x + w > A4_W - 236:
                break
            words.append((x, y, x + w, y + h))
            x += w + rng.uniform(16, 34)
        y += h + rng.uniform(8, 24)
    return words


def _a4_candidates(seed):
    """tile_plan's four A4 tiles and, per tile, the (boxes, scores, valid)
    rows the tile detector returns at its cap: every word that meets the
    tile, cut at the tile's edge, with a pixel of jitter, some tilted, a
    few rows left empty between candidates."""
    rng = np.random.RandomState(seed)
    cfg = OcrConfig(tile_size=2048, tile_overlap=128)
    corners = tiling.tile_plan(A4_H, A4_W, cfg)
    assert len(corners) == 4
    words = _a4_words(rng)
    T = len(corners)
    boxes = np.zeros((T, CAP, 4, 2), np.float32)
    scores = np.zeros((T, CAP), np.float32)
    valid = np.zeros((T, CAP), bool)
    for t, (ty, tx, th, tw) in enumerate(corners):
        k = 0
        for (x0, y0, x1, y1) in words:
            cx0, cy0 = max(x0, tx) - tx, max(y0, ty) - ty
            cx1, cy1 = min(x1, tx + tw) - tx, min(y1, ty + th) - ty
            if cx1 - cx0 < 6 or cy1 - cy0 < 6 or k >= CAP:
                continue
            q = np.asarray([[cx0, cy0], [cx1, cy0], [cx1, cy1], [cx0, cy1]],
                           np.float32)
            q += rng.uniform(-1.5, 1.5, (4, 2)).astype(np.float32)
            if rng.rand() < 0.1:                        # a tilted box
                q[:, 1] += np.float32(rng.uniform(-0.03, 0.03)) * (
                    q[:, 0] - q[0, 0])
            boxes[t, k] = q - np.float32(rng.uniform(0, 3))
            scores[t, k] = rng.uniform(0.6, 1.0)
            valid[t, k] = True
            k += 1 + (rng.rand() < 0.05)                # a row left empty
    return corners, boxes, scores, valid


def _reference_frame(corners, boxes, scores, valid, h, w):
    """ocrjax.tiling._merge_page's candidates in the page frame."""
    quads, ss, tids = [], [], []
    for t, (y, x, _, _) in enumerate(corners):
        for i in np.where(valid[t])[0]:
            q = boxes[t, i] + np.array([x, y], np.float32)
            q[:, 0] = np.clip(q[:, 0], 0, w - 1)
            q[:, 1] = np.clip(q[:, 1], 0, h - 1)
            quads.append(q)
            ss.append(float(scores[t, i]))
            tids.append(t)
    return quads, ss, tids


def _assert_same(got, want):
    (gq, gs), (wq, ws) = got, want
    assert len(gq) == len(wq) == len(gs)
    if wq:
        assert all(q.shape == (4, 2) and q.dtype == np.float32 for q in gq)
        np.testing.assert_array_equal(np.stack(gq), np.stack(wq))
    assert gs == ws


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2024])
@pytest.mark.parametrize("with_tiles", [False, True])
def test_a4_seam_merge_is_bit_for_bit(seed, with_tiles, monkeypatch):
    """With tile ids: the port's _merge_page, over an engine that holds
    only the config, against the reference's frame loop and merge; without:
    _merge_seam_boxes on the reference's page-frame candidates."""
    corners, boxes, scores, valid = _a4_candidates(seed)
    quads, ss, tids = _reference_frame(corners, boxes, scores, valid,
                                       A4_H, A4_W)
    cfg = OcrConfig(tile_size=2048, tile_overlap=128)
    x_bands, _ = tiling._seam_bands(corners)
    want = jax_tiling._merge_seam_boxes(
        quads, ss, cfg.tile_merge_iou, x_bands,
        tile_ids=tids if with_tiles else None)
    assert 700 < len(quads) and len(want[0]) < len(quads)
    if with_tiles:
        monkeypatch.setattr(tiling, "_tile_forward", lambda engine:
                            types.SimpleNamespace(tcfg=engine.config.replace(
                                det_max_candidates=CAP)))
        got, saturated = tiling._merge_page(
            types.SimpleNamespace(config=cfg), corners, boxes, scores,
            valid, A4_H, A4_W)
        assert not saturated
    else:
        got = tiling._merge_seam_boxes(quads, ss, cfg.tile_merge_iou,
                                       x_bands)
    _assert_same(got, want)


def _box(x0, y0, x1, y1):
    return np.asarray([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)


def _tilted():
    return np.asarray([[400.5, 30.25], [520.75, 41.5], [519.25, 60.125],
                       [399.0, 49.0]], np.float32)


# name -> (quads, tile ids or None, iou threshold)
EDGE_CASES = {
    "none": ([], None, 0.3),
    "one": ([_box(3.5, 4.25, 90.0, 40.0)], None, 0.3),
    "one_group": ([_box(10 + 60 * k, 100, 80 + 60 * k, 140) for k in
                   range(9)] + [_box(12, 101, 600, 139)], [0, 1] * 5, 0.3),
    "touching_rows": ([_box(10, 0, 200, 40), _box(10, 40, 200, 80),
                       _box(10, 80, 200, 120), _box(150, 40, 400, 80)],
                      [0, 1, 0, 1], 0.3),
    "equal_tops": ([_box(10, 50, 100, 90), _box(98, 50, 200, 90),
                    _box(300, 50, 400, 90), _box(302, 50, 401, 91),
                    _box(700, 50, 800, 60)], [0, 1, 0, 1, 1], 0.3),
    "zero_heights": ([_box(10, 50, 100, 50), _box(20, 50, 110, 50),
                      _box(10, 50, 100, 80), _box(0, 80, 40, 80)],
                     [0, 1, 0, 1], 0.3),
    "tilted_singleton": ([_tilted(), _box(10, 30, 100, 60),
                          _box(99, 31, 200, 61)], [0, 0, 1], 0.3),
    "iou_zero": ([_box(10, 10, 100, 50), _box(99, 49, 150, 90),
                  _box(149, 200, 160, 210), _box(100, 10, 200, 50)],
                 None, 0.0),
    "iou_negative": ([_box(10, 10, 100, 50), _box(500, 400, 600, 450),
                      _tilted()], [0, 1, 2], -0.1),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_seam_merge_edge_cases(case):
    quads, tids, iou = EDGE_CASES[case]
    scores = [0.5 + 0.01 * k for k in range(len(quads))][::-1]
    bands = [(90, 210)]
    got = tiling._merge_seam_boxes(quads, scores, iou, bands, tids)
    want = jax_tiling._merge_seam_boxes(quads, scores, iou, bands, tids)
    _assert_same(got, want)
    if case == "tilted_singleton":
        np.testing.assert_array_equal(got[0][0], _tilted())
    if case in ("one_group", "iou_negative"):
        assert len(got[0]) == 1


def test_cli_profile_prints_the_seam_counts(tmp_path):
    """The counter's reader: the CLI's --profile prints the pairs the seam
    merge tested after a tiled run, as counted by tiling.seam_counts."""
    import contextlib
    import io
    import re

    import cv2

    from ocrjax_torch import cli
    from ocrjax_torch.charset import Charset
    from ocrjax_torch.train import synth
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))
    page = synth.render_page(np.random.RandomState(2401), charset,
                             size=(600, 420), n_lines=(4, 6),
                             text_height=(24, 36))[0]
    path = str(tmp_path / "page.png")
    cv2.imwrite(path, page)
    before = dict(tiling.seam_counts)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["detect", path, "--tiled", "--cpu", "--profile",
                       str(tmp_path / "prof")])
    assert rc == 0
    n = {k: tiling.seam_counts[k] - before.get(k, 0)
         for k in ("pages", "candidates", "pairs", "pairs_tested",
                   "pairs_merged", "groups")}
    m = re.search(r"seam merge: (\d+) of (\d+) pairs tested \(([\d.]+)%\), "
                  r"(\d+) merged, (\d+) candidates -> (\d+) boxes, 1 pages",
                  err.getvalue())
    assert m, err.getvalue()
    assert [int(m[k]) for k in (1, 2, 4, 5, 6)] == [
        n["pairs_tested"], n["pairs"], n["pairs_merged"], n["candidates"],
        n["groups"]]
    assert n["pages"] == 1 and n["groups"] >= 1
