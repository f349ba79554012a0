"""Pages kept in the form they arrive in (ocrjax_torch.preprocess.load_page).

The tiled lane and the fused fast path load a 2-D page as 2-D luma and make
its luma once; every route that needs RGB reloads it through load_image.
The 601 luma coefficients sum to 2**15, so a grey pixel's luma is its
value, and the mean of three equal uint8 values is exact: the RGB stack
changes no bit. Held here, bit for bit, against the RGB route: the loader
on five pages (2-D, one channel, a grey page stacked to RGB, a colour page,
an inverted 2-D page), the tile prep with its blank-tile prescreen, the
host fallback's crops, the counter of the forms kept, and both lanes'
results on a 2-D page and on its RGB stack.
"""

import os

import numpy as np
import pytest

from ocrjax_torch import preprocess, tiling
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.charset import Charset
from ocrjax_torch.train import synth
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256


def _rgb(g):
    return np.stack([g] * 3, axis=-1)


def _colour(g):
    """Blue-tinted paper and ink: three unequal channels."""
    rgb = _rgb(g)
    rgb[..., 0] = (rgb[..., 0].astype(np.uint16) * 3 // 5).astype(np.uint8)
    rgb[..., 1] = (rgb[..., 1].astype(np.uint16) * 4 // 5).astype(np.uint8)
    return rgb


# the five pages, made from one grey page, and the form load_page keeps
CASES = {
    "2d": (lambda g: g, "luma"),
    "hw1": (lambda g: g[..., None].copy(), "luma"),
    "grey_rgb": (_rgb, "rgb"),
    "colour": (_colour, "rgb"),
    "inverted": (lambda g: 255 - g, "luma"),
}


@pytest.fixture(scope="module")
def cfg():
    return asset_config(det_max_side=SIZE, compute_dtype="float32",
                        tile_size=SIZE, tile_overlap=32,
                        tile_max_candidates=128)


@pytest.fixture(scope="module")
def charset():
    return Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))


@pytest.fixture(scope="module")
def banded(charset):
    """A 600 x 520 page with text in its top band (the prescreen drops the
    blank tiles below it) and the band's line quads in the page frame."""
    band, quads, _ = synth.render_page(
        np.random.RandomState(2201), charset, size=(280, 520),
        n_lines=(3, 5), text_height=(20, 30))
    page = np.full((600, 520), 255, np.uint8)
    page[:280] = band
    return page, [np.asarray(q, np.float32) for q in quads]


class _Config:
    """The tile prep and the host fallback read only the engine's config."""

    def __init__(self, config):
        self.config = config


def _forms_counted(fn):
    before = dict(preprocess.page_forms)
    out = fn()
    return out, {k: preprocess.page_forms[k] - before.get(k, 0)
                 for k in ("luma", "rgb")}


@pytest.mark.parametrize("case", list(CASES))
def test_load_page_keeps_the_form_and_the_luma(case, banded, cfg):
    """load_page against load_image: the same page (stacked where kept
    2-D), the same luma, the same tile plan and tiles after the prescreen,
    the same host-fallback strips from the prep's luma as from the RGB
    page; page_forms counts the form kept."""
    make, form = CASES[case]
    page, quads = banded
    src = make(page)
    kept, counted = _forms_counted(lambda: preprocess.load_page(src))
    assert counted == {"luma": int(form == "luma"), "rgb": int(form == "rgb")}
    rgb = preprocess.load_image(src)
    assert rgb.shape == page.shape + (3,) and kept.dtype == np.uint8
    assert kept.ndim == (2 if form == "luma" else 3)
    np.testing.assert_array_equal(_rgb(kept) if kept.ndim == 2 else kept,
                                  rgb)
    np.testing.assert_array_equal(preprocess.to_gray(kept),
                                  preprocess.to_gray(rgb))
    # dark ink on light paper: the inverted page comes back as the page
    np.testing.assert_array_equal(
        preprocess.to_gray(kept),
        preprocess.to_gray(src) if case == "colour" else page)

    eng = _Config(cfg)
    assert cfg.tile_blank_skip
    corners, groups, luma = tiling._prep_page(eng, kept)
    want_c, want_g, want_l = tiling._prep_page(eng, rgb)
    assert corners == want_c
    assert len(corners) < len(tiling.tile_plan(*page.shape, cfg))
    assert [g.shape for g in groups] == [g.shape for g in want_g]
    for g, w in zip(groups, want_g):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(luma, want_l)
    assert luma.ndim == 2 and (kept.ndim == 3 or luma is kept)

    idx = list(range(len(quads)))
    got = tiling._host_fallback_strips(eng, luma, quads, idx)
    want = tiling._host_fallback_strips(eng, rgb, quads, idx)
    assert len(got) == len(want) == len(quads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_load_page_refuses_what_load_image_refuses():
    for bad in (np.zeros((8, 8), np.float32), np.zeros((8, 8, 2), np.uint8),
                np.zeros((8,), np.uint8)):
        for load in (preprocess.load_page, preprocess.load_image):
            with pytest.raises(ValueError):
                load(bad)


# ------------------------------------------------------ the two lanes --

@pytest.fixture(scope="module")
def eng(cfg):
    return OcrEngine.from_pretrained(config=cfg, device="cpu")


def _same_results(got, want):
    assert len(got.lines) == len(want.lines) > 0
    assert got.truncated == want.truncated
    for g, w in zip(got.lines, want.lines):
        np.testing.assert_array_equal(g.box.quad, w.box.quad)
        assert (g.box.score, g.text, g.confidence) == \
            (w.box.score, w.text, w.confidence)


def test_tiled_lane_reads_a_2d_page_as_its_rgb_stack(eng, charset,
                                                     monkeypatch):
    """ocr_tiled_batch on a page of several tiles with a line wider than a
    tile: the 2-D page and its RGB stack give the same boxes, texts and
    confidences; the host fallback crops the prep's 2-D luma in both."""
    rng = np.random.RandomState(2202)
    page = np.full((420, 560), 255, np.uint8)
    page[:200] = synth.render_page(rng, charset, size=(200, 560),
                                   n_lines=(2, 3), text_height=(22, 28))[0]
    line = synth.render_line(synth.random_text(rng, charset, 24, 24), 36)
    page[260:260 + line.shape[0], 20:20 + line.shape[1]] = line
    assert line.shape[1] > SIZE
    seen = []
    fallback = tiling._host_fallback_strips

    def wrapped(engine, img, quads, host_idx):
        seen.append(img.ndim)
        return fallback(engine, img, quads, host_idx)

    monkeypatch.setattr(tiling, "_host_fallback_strips", wrapped)
    (got,), counted = _forms_counted(lambda: eng.ocr_tiled_batch([page]))
    assert counted == {"luma": 1, "rgb": 0}
    (want,), counted = _forms_counted(
        lambda: eng.ocr_tiled_batch([_rgb(page)]))
    assert counted == {"luma": 0, "rgb": 1}
    assert seen == [2, 2]
    _same_results(got, want)
    assert [(b.quad.tolist(), b.score) for b in eng.detect_tiled(page)] == \
        [(b.quad.tolist(), b.score) for b in eng.detect_tiled(_rgb(page))]


def test_fused_path_reads_a_2d_page_as_its_rgb_stack(eng, charset):
    """ocr()'s fused fast path hands the 2-D page to the fused lane; the
    result equals that of its RGB stack."""
    page = synth.render_page(np.random.RandomState(2203), charset,
                             size=(SIZE - 16, SIZE), n_lines=(3, 4),
                             text_height=(18, 24))[0]
    assert eng.config.ocr_single_fused
    got, counted = _forms_counted(lambda: eng.ocr(page))
    assert counted == {"luma": 1, "rgb": 0}
    want, counted = _forms_counted(lambda: eng.ocr(_rgb(page)))
    assert counted == {"luma": 0, "rgb": 1}
    _same_results(got, want)
