"""The port's end-to-end evaluation (ocrjax_torch/train/e2e_eval.py) against
ocrjax.train.e2e_eval: on 2 pages at 512 the three numbers
(line_exact_match, det_recall, char_error_rate) are equal, both engines on
the shipped assets in float32 at det_max_side=512. The rendering half
draws ocrjax's pages bit for bit, with the degradation and geometry tiers
too, and the edit distance is ocrjax's.
"""

import dataclasses

import numpy as np
import pytest

from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.train import e2e_eval as jeval
from ocrjax.train import synth as jsynth
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.train import e2e_eval
from test_torch_fixture import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def engines():
    cfg = asset_config(det_max_side=512, compute_dtype="float32")
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**dataclasses.asdict(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


@pytest.mark.parametrize("beam", [False, True])
def test_e2e_numbers_equal_ocrjax(engines, beam):
    jax_engine, port = engines
    want = jeval.evaluate_e2e(jax_engine, n_pages=2, size=512, beam=beam)
    got = e2e_eval.evaluate_e2e(port, n_pages=2, size=512, beam=beam)
    assert got == want
    assert want["det_recall"] > 0.5


@pytest.mark.parametrize("kw", [
    {},
    dict(max_rotation=5.0, degrade_level=0.5),
    dict(projective=0.5, curl=0.5, supersample=2),
])
def test_render_e2e_draws_ocrjax_pages(engines, kw):
    _, port = engines
    pages, gts = e2e_eval.render_e2e(port.charset, n_pages=2, size=320,
                                     seed=7, **kw)
    rng = np.random.RandomState(7)
    for page, texts in zip(pages, gts):
        want, quads, wtexts = jsynth.render_page(
            rng, port.charset, size=(320, 320),
            max_rotation=kw.get("max_rotation", 0.0),
            supersample=kw.get("supersample", 1))
        if kw.get("projective", 0) > 0 or kw.get("curl", 0) > 0:
            want, quads = jsynth.warp_page_projective(
                want, quads, rng, severity=kw["projective"], curl=kw["curl"])
        if kw.get("degrade_level", 0) > 0:
            want = jsynth.degrade_image(want, rng, level=kw["degrade_level"])
        np.testing.assert_array_equal(page, want)
        assert texts == wtexts


@pytest.mark.parametrize("a,b", [("", "abc"), ("kitten", "sitting"),
                                 ("flaw", "lawn"), ("same", "same"),
                                 ("ab", "ba")])
def test_levenshtein_is_ocrjax(a, b):
    assert e2e_eval._levenshtein(a, b) == jeval._levenshtein(a, b)
