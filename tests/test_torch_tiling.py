"""Tiled OCR in the port (ocrjax_torch/tiling.py) against ocrjax/tiling.py:
the plan, seam and assignment functions on random inputs, the host tile
prep with its blank-tile prescreen, the tiled and dense goldens through
detect_tiled and ocr_tiled (the goldens' tile config,
scripts/freeze_goldens.py:48-55: 512-pixel tiles on 768-pixel pages), a
windowed ocr_tiled_batch with the host fallback, and OOM halving. Both
engines in float32.

Bar: the plan, merge and prep functions equal; strings and order
identical, box corners within 0.011 px, scores within 2e-3. Line
confidences are not held: a box corner 0.0023 px off the reference's (inside
the bar) moves one strip of the dense golden by a pixel step of the ink
refine, which reads the same string at confidence 0.8167 against 0.8328;
fed the reference's boxes, the port's recognition gives its confidences.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ocrjax import geometry as jax_geometry
from ocrjax import tiling as jax_tiling
from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.charset import Charset
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.train import synth
from ocrjax_torch import geometry, tiling
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.config import OcrConfig
from test_torch_fixture import few_torch_threads, jax_fields  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", range(3))
def test_plans_match_ocrjax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(200):
        total = int(rng.randint(1, 9000))
        tile = int(rng.choice([256, 512, 1024, 2048]))
        overlap = int(rng.choice([0, 32, 64, 128]))
        q = max(tile // 8, 32)
        assert tiling.axis_plan(total, tile, overlap, q) == \
            jax_tiling.axis_plan(total, tile, overlap, q)
        h, w = (int(v) for v in rng.randint(1, 7000, 2))
        cfg = OcrConfig(tile_size=tile, tile_overlap=overlap)
        jcfg = JaxConfig(tile_size=tile, tile_overlap=overlap)
        corners = tiling.tile_plan(h, w, cfg)
        assert corners == jax_tiling.tile_plan(h, w, jcfg)
        assert tiling.tile_grid(h, w, tile, overlap) == \
            jax_tiling.tile_grid(h, w, tile, overlap)
        assert tiling._seam_bands(corners) == jax_tiling._seam_bands(corners)
    for mb in (256, 1536, 4096):
        assert tiling.max_pool_tiles(OcrConfig(tile_window_hbm_mb=mb)) == \
            jax_tiling.max_pool_tiles(JaxConfig(tile_window_hbm_mb=mb))


def _random_quads(rng, n):
    """Rows of line boxes, some cut at a seam near x = 500, some
    duplicated, some tilted."""
    out = []
    for _ in range(n):
        x0, y0 = rng.uniform(0, 900), rng.uniform(0, 900)
        w, h = rng.uniform(10, 300), rng.uniform(8, 40)
        q = np.asarray([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h],
                        [x0, y0 + h]], np.float32)
        q += rng.uniform(-2, 2, (4, 2)).astype(np.float32)
        out.append(q)
        if rng.rand() < 0.3:      # a duplicate or a fragment beside it
            out.append(q + np.asarray([rng.choice([1.0, w + 3.0]), 0.5],
                                      np.float32))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("with_tiles", [False, True])
def test_seam_merge_matches_ocrjax(seed, with_tiles):
    rng = np.random.RandomState(seed)
    quads = _random_quads(rng, 60)
    scores = [float(s) for s in rng.rand(len(quads))]
    tids = list(rng.randint(0, 4, len(quads))) if with_tiles else None
    bands = [(448, 512), (896, 960)]
    gq, gs = tiling._merge_seam_boxes(quads, scores, 0.3, bands, tids)
    wq, ws = jax_tiling._merge_seam_boxes(quads, scores, 0.3, bands, tids)
    assert len(gq) == len(wq) < len(quads)
    np.testing.assert_array_equal(np.stack(gq), np.stack(wq))
    assert gs == ws
    for a, b in zip(quads[:20], quads[1:21]):
        assert geometry.quad_iou_aabb(a, b) == jax_geometry.quad_iou_aabb(a, b)
        np.testing.assert_array_equal(geometry.merge_quads(a, b),
                                      jax_geometry.merge_quads(a, b))
    np.testing.assert_array_equal(
        geometry.rot90_ccw_to_orig(np.stack(quads), 777),
        jax_geometry.rot90_ccw_to_orig(np.stack(quads), 777))


@pytest.fixture(scope="module")
def cfg():
    """The goldens' tile config (freeze_goldens.build_tiled_engine)."""
    return asset_config(det_max_side=512, compute_dtype="float32",
                        tile_size=512, tile_overlap=64,
                        tile_max_candidates=128)


@pytest.fixture(scope="module")
def engines(cfg):
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**jax_fields(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


def test_tile_detector_is_loaded(engines):
    _, port = engines
    assert port.tile_det_arch == {"channels": [32, 64, 128, 256],
                                  "blocks_per_stage": 1, "inner": 64,
                                  "head_stride": 1}
    fwd = tiling._tile_forward(port)
    assert fwd.model is port.tile_det_model
    assert fwd.tcfg.det_max_candidates == 256     # max(256, 128)
    assert port.config.det_head_stride == 1     # the arch never feeds it


@pytest.mark.parametrize("kind", ["text", "blank_band", "blank"])
def test_prep_page_matches_ocrjax(engines, kind):
    """Corners and tile stacks, the prescreen dropping tiles without ink
    (the bottom band of "blank_band", all but one tile of "blank")."""
    jax_engine, port = engines
    rng = np.random.RandomState(4)
    img = np.full((1100, 900), 255, np.uint8)
    if kind != "blank":
        img[:300] = rng.randint(0, 256, (300, 900))
    if kind == "text":
        img[300:] = rng.randint(200, 256, (800, 900))
    got_c, got_g, _ = tiling._prep_page(port, img)
    want_c, want_g = jax_tiling._prep_page(jax_engine, img)
    assert got_c == want_c
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        np.testing.assert_array_equal(g, w)
    n_plan = len(tiling.tile_plan(1100, 900, port.config))
    assert len(got_c) == {"text": n_plan, "blank": 1}.get(kind, len(got_c))
    if kind == "blank_band":
        assert 1 < len(got_c) < n_plan


def test_assign_quads_to_tiles_matches_ocrjax(engines):
    _, port = engines
    corners = tiling.tile_plan(1000, 1300, port.config)
    rng = np.random.RandomState(2)
    quads = _random_quads(rng, 40)
    quads.append(np.asarray([[10, 500], [700, 500], [700, 530], [10, 530]],
                            np.float32))          # longer than any tile
    got = tiling._assign_quads_to_tiles(port.config, corners, quads, 1000,
                                        1300)
    want = jax_tiling._assign_quads_to_tiles(port.config, corners, quads,
                                             1000, 1300)
    assert got[0] == want[0] and got[3] == want[3] and got[4] == want[4]
    assert len(got[4]) >= 1
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert got[2] == want[2]


@pytest.fixture(scope="module")
def routed():
    sys.path.insert(0, ROOT)
    from scripts.freeze_goldens import render_routed_cases
    return render_routed_cases(Charset.from_file(
        os.path.join(ROOT, "assets", "rec.charset.txt")))


def _assert_boxes(got, want, min_boxes=2):
    assert len(got) == len(want) >= min_boxes
    assert np.abs(np.stack([b.quad for b in got])
                  - np.stack([b.quad for b in want])).max() <= 0.011
    assert np.abs(np.asarray([b.score for b in got])
                  - np.asarray([b.score for b in want])).max() <= 2e-3


def _assert_same(got, want, min_lines=2):
    assert [line.text for line in got.lines] == \
        [line.text for line in want.lines]
    assert len(want.lines) >= min_lines
    assert got.truncated == want.truncated
    _assert_boxes([line.box for line in got.lines],
                  [line.box for line in want.lines], min_lines)


@pytest.mark.parametrize("page", ["tiled", "dense"])
def test_tiled_goldens(engines, routed, page):
    jax_engine, port = engines
    _assert_same(port.ocr_tiled(routed[page]),
                 jax_engine.ocr_tiled(routed[page]),
                 min_lines=40 if page == "dense" else 6)
    if page == "tiled":
        _assert_boxes(port.detect_tiled(routed[page]),
                      jax_engine.detect_tiled(routed[page]))


def _batch_pages(charset):
    rng = np.random.RandomState(1301)
    text = synth.render_page(rng, charset, size=(768, 700), n_lines=(4, 6),
                             text_height=(24, 36))[0]
    sparse = np.full((1000, 900), 255, np.uint8)      # text in a top band
    sparse[:300] = synth.render_page(rng, charset, size=(300, 900),
                                     n_lines=(2, 3), text_height=(24, 30))[0]
    long_line = np.full((400, 900), 255, np.uint8)    # wider than a tile
    line = synth.render_line(synth.random_text(rng, charset, 30, 30), 40)
    long_line[150:150 + line.shape[0], 60:60 + line.shape[1]] = line
    return [text, sparse, long_line]


def test_ocr_tiled_batch_in_windows_matches_ocrjax(engines, cfg):
    """Three pages with tile_pipeline_tiles=1: several windows, a page
    whose blank tiles the prescreen drops, and a line no tile contains
    (the host fallback). The engines take the config in place, as
    scripts/freeze_goldens.py sets it, so JAX reuses its programs."""
    jax_engine, port = engines
    pages = _batch_pages(port.charset)
    calls = {"dispatch": 0, "fallback": 0}
    dispatch, fallback = tiling._dispatch_group, tiling._host_fallback_strips

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    tiling._dispatch_group = count("dispatch", dispatch)
    tiling._host_fallback_strips = count("fallback", fallback)
    port.config = cfg.replace(tile_pipeline_tiles=1)
    jax_engine.config = JaxConfig(**jax_fields(port.config))
    try:
        got = port.ocr_tiled_batch(pages)
        want = jax_engine.ocr_tiled_batch(pages)
    finally:
        tiling._dispatch_group, tiling._host_fallback_strips = \
            dispatch, fallback
        port.config = cfg
        jax_engine.config = JaxConfig(**jax_fields(cfg))
    assert calls["fallback"] == 1 and calls["dispatch"] >= 5
    for g, w in zip(got, want):
        _assert_same(g, w, min_lines=1)
    assert len(tiling._prep_page(port, pages[1])[0]) < len(
        tiling.tile_plan(1000, 900, port.config))
    assert port.ocr_tiled_batch([np.zeros((4, 4), np.float32)])[0].lines \
        == []


def test_seam_counts_follow_a_windowed_batch(engines):
    """tiling.seam_counts over one page of ocr_tiled_batch (four tiles, no
    rot90 reroute): the pairs tested are a part of the page's pairs, and
    the groups are the lines returned."""
    _, port = engines
    page = _batch_pages(port.charset)[0]
    assert len(tiling.tile_plan(*page.shape, port.config)) == 4
    before = dict(tiling.seam_counts)
    res = port.ocr_tiled_batch([page])[0]
    n = {k: tiling.seam_counts[k] - before.get(k, 0)
         for k in ("pages", "candidates", "pairs", "pairs_tested",
                   "pairs_merged", "groups")}
    c = n["candidates"]
    assert n["pages"] == 1 and n["pairs"] == c * (c - 1) // 2
    assert n["pairs_merged"] <= n["pairs_tested"] <= n["pairs"]
    assert n["groups"] == len(res.lines) >= 4


def test_oom_halves_the_tile_batch(engines, monkeypatch):
    """A forward that runs out of device memory once: the group of two
    full tiles is redone as two halves, with the same result."""
    _, port = engines
    rng = np.random.RandomState(1401)
    page = synth.render_page(rng, port.charset, size=(512, 1100),
                             n_lines=(3, 5), text_height=(24, 36))[0]
    assert [c[2:] for c in tiling._prep_page(port, page)[0]].count(
        (512, 512)) == 2
    want = port.detect_tiled(page)
    fwd = tiling._tile_forward(port)
    seen = []
    real = type(fwd).forward

    def forward(self, tiles_up):
        seen.append(tiles_up.shape[0])
        if seen.count(2) == 1 and tiles_up.shape[0] == 2:
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return real(self, tiles_up)

    monkeypatch.setattr(type(fwd), "forward", forward)
    got = port.detect_tiled(page)
    assert seen == [1, 2, 1, 1]          # the 512 x 256 tile, then the pair
    _assert_boxes(got, want)


def test_boxes_far_from_the_centre_match_exact_moment_sums():
    """Short tilted bars near the corners of a 2048-pixel prob map (a C5
    tile): the port's boxes equal ocrjax's extract_boxes evaluated with
    exact moment sums (test_torch_fixture.exact_moments) within 0.00025
    px, which needs the port's float64 sums and its variances rounded as
    XLA's fused multiply-add (separately rounded, 0.0122 px off). The
    reference's own float32 sums sit 0.054 px off here."""
    import jax.numpy as jnp
    from test_torch_fixture import exact_moments

    from ocrjax.postprocess import db_boxes as jax_db
    from ocrjax_torch.postprocess import db_boxes
    rng = np.random.RandomState(9)
    prob = np.full((2048, 2048), 0.05, np.float32)
    for _ in range(40):
        y = rng.choice([rng.randint(20, 300), rng.randint(1700, 2000)])
        x = rng.choice([rng.randint(4, 300), rng.randint(1700, 1960)])
        h, w = rng.randint(8, 24), rng.randint(30, 90)
        slope = rng.uniform(-0.06, 0.06)
        for c in range(w):
            y0 = y + int(round(c * slope))
            prob[y0:y0 + h, x + c] = rng.uniform(0.7, 0.95)
    kw = dict(thresh=0.3, box_thresh=0.6, unclip_ratio=1.5, min_box_size=3,
              max_candidates=64, cc_iters=4, cc_downsample=4)
    got = db_boxes.extract_boxes(torch.from_numpy(prob[None]), **kw)
    with exact_moments():
        want = jax_db.extract_boxes(jnp.asarray(prob), **kw)
    valid = got["valid"][0].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want["valid"]))
    assert valid.sum() >= 20
    assert np.abs(got["boxes"][0].numpy()[valid]
                  - np.asarray(want["boxes"])[valid]).max() <= 0.011
