"""The whole slice: the port's fused page lane on the shipped assets equals
ocrjax's on the CPU, both engines in float32 at det_max_side=512.

Bar (tests/test_goldens.py): identical strings in identical reading
order, box corners within 0.011 px, scores within 2e-3.
"""

import dataclasses
import os

import numpy as np
import pytest

from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.charset import Charset
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.train import synth
from ocrjax_torch.api import OcrEngine, asset_config
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (101, 102, 103)


def _page(seed, **kw):
    """A 512x512 RGB page from ocrjax's renderer, as the goldens make them."""
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))
    page, _, _ = synth.render_page(np.random.RandomState(seed), charset,
                                   size=(512, 512), **kw)
    return np.repeat(page[..., None], 3, 2)


@pytest.fixture(scope="module")
def config():
    return asset_config(det_max_side=512, compute_dtype="float32")


@pytest.fixture(scope="module")
def engines(config):
    jax_engine = JaxEngine.from_pretrained(
        config=JaxConfig(**dataclasses.asdict(config)))
    return jax_engine, OcrEngine.from_pretrained(config=config, device="cpu")


@pytest.fixture(scope="module")
def pages():
    return [_page(s, n_lines=(3, 6), text_height=(20, 40)) for s in SEEDS]


def _assert_same(got, want):
    assert [line.text for line in got.lines] == \
        [line.text for line in want.lines]
    if want.lines:
        g = np.stack([line.box.quad for line in got.lines])
        w = np.stack([line.box.quad for line in want.lines])
        assert np.abs(g - w).max() <= 0.011
        gs = np.asarray([line.box.score for line in got.lines])
        ws = np.asarray([line.box.score for line in want.lines])
        assert np.abs(gs - ws).max() <= 2e-3


def test_fused_batch_matches_jax(engines, pages):
    jax_engine, port = engines
    want = jax_engine.ocr_batch(pages, fused=True)
    got = port.ocr_batch(pages, fused=True)
    assert sum(len(r.lines) for r in want) >= 9
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_single_page_ocr_matches_jax(engines, pages):
    jax_engine, port = engines
    _assert_same(port.ocr(pages[1]), jax_engine.ocr(pages[1]))


def test_rotated_page_needs_a_later_lane(engines):
    """A tilted page is rerouted by ocrjax to the bucketed lane (exact
    homography crops); the port reroutes it the same way and answers as
    ocrjax does."""
    jax_engine, port = engines
    page = _page(201, n_lines=(2, 4), text_height=(22, 36),
                 max_rotation=8.0)
    from ocrjax_torch import fused
    res = port.ocr_batch([page], fused=True)[0]
    quads = np.stack([line.box.quad for line in res.lines])
    assert fused.should_reroute_rotation(quads, port.config)
    _assert_same(res, jax_engine.ocr_batch([page], fused=True)[0])


def test_unported_options_raise(engines, config, pages):
    """No option is refused any more: det_int8 and rec_dewarp_curl run and
    read the page as ocrjax with the same flag does; beam CTC answers on
    every lane, and the lanes beside the fused one (the bucketed batch, an
    oversize page, the staged lane with ocr_single_fused off) answer."""
    _, port = engines
    beam = [line.text for line in port.ocr(pages[0], beam=True).lines]
    assert beam == [line.text for line in port.ocr_batch(
        pages[:1], beam=True, fused=True)[0].lines]
    assert beam == [line.text for line in port.ocr_batch(
        pages[:1], beam=True)[0].lines]
    for flag in ("det_int8", "rec_dewarp_curl"):
        cfg = config.replace(**{flag: True})
        got = OcrEngine(config=cfg, device="cpu")     # constructs
        assert getattr(got.config, flag)
        got = OcrEngine.from_pretrained(config=cfg, device="cpu").ocr(
            pages[2])
        want = JaxEngine.from_pretrained(config=JaxConfig(
            **dataclasses.asdict(cfg))).ocr(pages[2])
        # strings, order and boxes (test_torch_int8.py holds the scores)
        assert [line.text for line in got.lines] == \
            [line.text for line in want.lines] != []
        assert np.abs(np.stack([line.box.quad for line in got.lines])
                      - np.stack([line.box.quad for line in want.lines])
                      ).max() <= 0.011
    want = [line.text for line in port.ocr(pages[0]).lines]
    assert [line.text for line in
            port.ocr_batch(pages[:1], fused=False)[0].lines] == want
    staged = OcrEngine.from_pretrained(
        config=config.replace(ocr_single_fused=False), device="cpu")
    assert [line.text for line in staged.ocr(pages[0]).lines] == want
    assert port.ocr(np.full((600, 400), 255, np.uint8)).lines == []
