"""The slice as a whole on the CPU: the staged, bucketed, full-resolution
and rerouted lanes of the port against ocrjax, both engines on the shipped
assets in float32 at det_max_side=512.

Bar (tests/test_goldens.py): identical strings in identical reading order,
box corners within 0.011 px, scores within 2e-3; line confidences within
2e-3 as well.
"""

import dataclasses
import os

import numpy as np
import pytest

from ocrjax import api_det as jax_api_det
from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.charset import Charset
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.train import synth
from ocrjax_torch import api_det, bucketing, fused
from ocrjax_torch.api import OcrEngine, asset_config
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = ("straight", "tilted", "color", "dense", "bigtilt")
BUCKETED = ("straight", "tilted", "big")


def _rgb(gray):
    return np.repeat(gray[..., None], 3, 2)


@pytest.fixture(scope="module")
def pages():
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))

    def page(seed, size=(512, 512), **kw):
        return synth.render_page(np.random.RandomState(seed), charset,
                                 size=size, **kw)[0]

    ink = page(901, n_lines=(3, 5), text_height=(22, 36))
    return {
        "straight": _rgb(page(101, n_lines=(3, 6), text_height=(20, 40))),
        "tilted": _rgb(page(201, n_lines=(2, 4), text_height=(22, 36),
                            max_rotation=8.0)),
        # saturated yellow ink on white: 601 luma washes it out
        "color": np.stack([np.full_like(ink, 255), np.full_like(ink, 255),
                           ink], -1),
        "inverted": _rgb(np.asarray(
            255 - page(1001, n_lines=(3, 5), text_height=(22, 36)),
            np.uint8)),
        "dense": _rgb(synth.render_page_dense(
            np.random.RandomState(601), charset, size=(512, 512),
            n_lines=40, text_height=(14, 18))[0]),
        "big": page(1201, size=(760, 600), n_lines=(5, 8),
                    text_height=(26, 44)),
        "bigtilt": _rgb(page(1202, size=(700, 640), n_lines=(3, 5),
                             text_height=(30, 44), max_rotation=8.0)),
    }


@pytest.fixture(scope="module")
def engines():
    cfg = asset_config(det_max_side=512, compute_dtype="float32")
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**dataclasses.asdict(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


def _assert_same(got, want, min_lines=1):
    assert [line.text for line in got.lines] == \
        [line.text for line in want.lines]
    assert len(want.lines) >= min_lines
    g = np.stack([line.box.quad for line in got.lines])
    w = np.stack([line.box.quad for line in want.lines])
    assert np.abs(g - w).max() <= 0.011
    for attr in ("score", None):
        gs = np.asarray([line.box.score if attr else line.confidence
                         for line in got.lines])
        ws = np.asarray([line.box.score if attr else line.confidence
                         for line in want.lines])
        assert np.abs(gs - ws).max() <= 2e-3
    assert got.truncated == want.truncated


@pytest.fixture(scope="module")
def fused_mixed(engines, pages):
    """ocr_batch(fused=True) of both engines on the mixed batch, with the
    port's reroute calls recorded."""
    jax_engine, port = engines
    batch = [pages[k] for k in MIXED]
    calls = []
    spied = [(api_det, "ocr"), (bucketing, "ocr_pages"),
             (api_det, "ocr_fullres_batch")]
    saved = [getattr(m, n) for m, n in spied]

    def spy(name, fn):
        def wrapped(engine, images, *a, **kw):
            calls.append((name, len(images) if name != "ocr" else 1, kw))
            return fn(engine, images, *a, **kw)
        return wrapped

    for (m, n), fn in zip(spied, saved):
        setattr(m, n, spy(n, fn))
    try:
        got = port.ocr_batch(batch, fused=True)
    finally:
        for (m, n), fn in zip(spied, saved):
            setattr(m, n, fn)
    return got, jax_engine.ocr_batch(batch, fused=True), calls


def test_every_reroute_of_the_fused_lane_fires(fused_mixed):
    _, _, calls = fused_mixed
    greedy = {"beam": False}
    assert ("ocr", 1, {**greedy, "color": True}) in calls     # colour page
    # the tilted page and the 40-line page pool on the bucketed lane
    assert ("ocr_pages", 2, greedy) in calls
    # the oversize tilted page goes to the full-resolution lane
    assert ("ocr_fullres_batch", 1, greedy) in calls


@pytest.mark.parametrize("name", MIXED)
def test_fused_batch_with_reroutes_matches_jax(fused_mixed, name):
    got, want, _ = fused_mixed
    k = MIXED.index(name)
    _assert_same(got[k], want[k], min_lines=32 if name == "dense" else 2)


@pytest.fixture(scope="module")
def bucketed(engines, pages):
    jax_engine, port = engines
    batch = [pages[k] for k in BUCKETED]
    return (port.ocr_batch(batch, fused=False),
            jax_engine.ocr_batch(batch, fused=False))


@pytest.mark.parametrize("name", BUCKETED)
def test_bucketed_batch_matches_jax(bucketed, name):
    got, want = bucketed
    k = BUCKETED.index(name)
    _assert_same(got[k], want[k], min_lines=2)


def test_bucketed_batch_isolates_a_page_that_fails_to_decode(engines, pages):
    _, port = engines
    res = port.ocr_batch([np.zeros((8, 8), np.float32), pages["straight"]],
                         fused=False)
    assert res[0].lines == [] and len(res[1].lines) >= 3
    assert port.ocr_batch([], fused=False) == []


@pytest.mark.parametrize("name", ["big", "inverted"])
def test_single_page_ocr_matches_jax(engines, pages, name):
    """An oversize page takes the staged lane with full-resolution crops;
    a light-on-dark page is canonicalized and takes the fused lane."""
    jax_engine, port = engines
    _assert_same(port.ocr(pages[name]), jax_engine.ocr(pages[name]),
                 min_lines=3)


@pytest.mark.parametrize("name,kw", [("straight", {"force_staged": True}),
                                     ("tilted", {"force_staged": True}),
                                     ("color", {"color": True})])
def test_staged_ocr_matches_jax(engines, pages, name, kw):
    """The staged body itself: exact homography crops with the ink refine."""
    jax_engine, port = engines
    _assert_same(api_det.ocr(port, pages[name], **kw),
                 jax_api_det.ocr(jax_engine, pages[name], **kw), min_lines=2)


@pytest.mark.parametrize("name", ["straight", "tilted", "big"])
def test_detect_matches_jax(engines, pages, name):
    jax_engine, port = engines
    want = jax_engine.detect(pages[name])
    got = port.detect(pages[name])
    assert len(got) == len(want) >= 2
    assert np.abs(np.stack([b.quad for b in got])
                  - np.stack([b.quad for b in want])).max() <= 0.011
    assert np.abs(np.asarray([b.score for b in got])
                  - np.asarray([b.score for b in want])).max() <= 2e-3


def test_fullres_batch_matches_jax(engines, pages):
    jax_engine, port = engines
    batch = [pages["big"], np.zeros((3, 3), np.float32), pages["bigtilt"]]
    want = jax_api_det.ocr_fullres_batch(jax_engine, batch)
    got = api_det.ocr_fullres_batch(port, batch)
    assert got[1].lines == [] and want[1].lines == []
    _assert_same(got[0], want[0], min_lines=3)
    _assert_same(got[2], want[2], min_lines=3)


def test_saturated_page_is_flagged_before_its_redo(engines, pages):
    """With a capacity of 4 lines the fused program saturates on the
    straight page; ocr_pages_fused answers from the bucketed redo."""
    jax_engine, port = engines
    from ocrjax import fused as jax_fused
    want = jax_fused.ocr_pages_fused(jax_engine, [pages["straight"]],
                                     lines_per_page=4)[0]
    got = fused.ocr_pages_fused(port, [pages["straight"]],
                                lines_per_page=4)[0]
    assert len(want.lines) > 4
    _assert_same(got, want, min_lines=5)
