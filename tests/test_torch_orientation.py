"""The orientation stage in the port (rec_try_flip): the classifier, the
180-degree flip, the page prior and the margins against ocrjax's, then the
flip and landscape (rot90) goldens through every lane, both engines in
float32 with the goldens' flip config (scripts/freeze_goldens.py:58-63).

Bar: logits rtol 1e-4, the flip bit for bit, strings, order and flip
decisions identical, box corners within 0.011 px, scores within 2e-3.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrjax import api_det as jax_api_det
from ocrjax import weights as jax_weights
from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.charset import Charset
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.models import cls as jax_cls
from ocrjax.train import synth
from ocrjax_torch import api_det
from ocrjax_torch import weights as W
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.models import cls
from test_torch_fixture import few_torch_threads, jax_fields  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS = os.path.join(ROOT, "assets", "cls.safetensors")


@pytest.mark.parametrize("W_", [64, 77, 320])
def test_classifier_logits_match_flax(W_):
    """Stride-2 SAME padding on odd widths, and the width-masked mean and
    max (ceil(w / 8) columns; an empty strip pools to 0)."""
    rng = np.random.RandomState(W_)
    x = rng.randn(6, 32, W_, 1).astype(np.float32)
    widths = np.asarray([W_, 1, 0, W_ // 2, 9, W_ - 1], np.int32)
    flax_cls = jax_cls.OrientationClassifier(compute_dtype="float32")
    want = np.asarray(flax_cls.apply(jax_weights.load_variables(CLS),
                                     jnp.asarray(x), jnp.asarray(widths)))
    model = cls.OrientationClassifier()
    W.load_into(model, W.cls_state_dict(W.read_safetensors(CLS)[0])[0])
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(widths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_flip_strips_by_width_is_bit_exact():
    rng = np.random.RandomState(0)
    strips = rng.randn(7, 32, 96).astype(np.float32)
    widths = np.asarray([96, 1, 0, 40, 95, 7, 64], np.int32)
    flip = np.asarray([1, 1, 1, 0, 1, 1, 0], bool)
    want = np.asarray(jax_cls.flip_strips_by_width(
        jnp.asarray(strips), jnp.asarray(widths), jnp.asarray(flip), -1.0))
    got = cls.flip_strips_by_width(torch.from_numpy(strips),
                                   torch.from_numpy(widths),
                                   torch.from_numpy(flip), -1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_apply_page_prior_matches_ocrjax(seed):
    rng = np.random.RandomState(seed)
    n = 40
    margin = (rng.randn(n) * 9).astype(np.float32)    # beyond the +-8 clip
    widths = rng.randint(0, 320, n).astype(np.int32)
    seg = rng.randint(0, 6, n).astype(np.int32)
    want = np.asarray(jax_api_det.apply_page_prior(
        jnp.asarray(margin), jnp.asarray(widths), jnp.asarray(seg), 2.0))
    got = api_det.apply_page_prior(torch.from_numpy(margin),
                                   torch.from_numpy(widths),
                                   torch.from_numpy(seg), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert ((got > 0) == (want > 0)).all()


@pytest.fixture(scope="module")
def engines():
    cfg = asset_config(det_max_side=512, compute_dtype="float32",
                       rec_try_flip=True)
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**jax_fields(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


@pytest.mark.parametrize("antisym", [False, True])
def test_cls_margins_in_both_modes(engines, antisym):
    """The symmetric two-pass ensemble, and the single pass (2 logit(s))
    taken when the asset carries the antisymmetry certificate."""
    jax_engine, port = engines
    assert port.cls_antisym is False              # the shipped asset
    rng = np.random.RandomState(1)
    strips = rng.randn(5, 32, 128).astype(np.float32)
    widths = np.asarray([128, 60, 3, 100, 127], np.int32)
    jax_engine.cls_antisym = port.cls_antisym = antisym
    try:
        w_rot, w_m = jax_api_det._cls_margins(
            jax_engine, jax_engine.cls_variables, jnp.asarray(strips),
            jnp.asarray(widths))
        with torch.no_grad():
            g_rot, g_m = api_det._cls_margins(port, torch.from_numpy(strips),
                                              torch.from_numpy(widths))
    finally:
        jax_engine.cls_antisym = port.cls_antisym = False
    np.testing.assert_array_equal(g_rot.numpy(), np.asarray(w_rot))
    np.testing.assert_allclose(g_m.numpy(), np.asarray(w_m), rtol=1e-4,
                               atol=1e-4)


def test_recognize_strips_flips_with_page_groups(engines):
    """Upside-down strips among upright ones, decided alone, as one page
    and in per-page prior groups."""
    jax_engine, port = engines
    strips = []
    for k, s in enumerate((301, 302, 303, 304, 305)):
        text = synth.random_text(np.random.RandomState(s), port.charset, 4,
                                 14)
        strip = synth.render_line(text, (32, 40, 24, 32, 48)[k])
        strips.append(np.ascontiguousarray(strip[::-1, ::-1])
                      if k % 2 else strip)
    for kw in ({}, {"same_page": True}, {"prior_ids": [7, 3, 7, 7, 3]}):
        got = port.recognize_strips(strips, **kw)
        want = jax_engine.recognize_strips(strips, **kw)
        assert [r.text for r in got] == [r.text for r in want]
        assert [r.flipped for r in got] == [r.flipped for r in want]
        assert any(r.flipped for r in got)
        np.testing.assert_allclose([r.confidence for r in got],
                                   [r.confidence for r in want], atol=2e-3)


@pytest.fixture(scope="module")
def routed():
    sys.path.insert(0, ROOT)
    from scripts.freeze_goldens import render_routed_cases
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))
    imgs = render_routed_cases(charset)
    rng = np.random.RandomState(1210)
    big = synth.render_page(rng, charset, size=(700, 640), n_lines=(3, 5),
                            text_height=(30, 44))[0]
    imgs["big180"] = np.ascontiguousarray(np.rot90(big, 2))
    imgs["big90"] = np.ascontiguousarray(np.rot90(big))
    return imgs


def _assert_same(got, want, min_lines=3):
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


@pytest.mark.parametrize("page,lane", [("flip", "ocr"), ("flip", "staged"),
                                       ("rot90", "staged")])
def test_flip_goldens_on_ocr(engines, routed, page, lane):
    """ocr() takes the fused lane; "staged" forces the staged lane, whose
    rot90 redo runs the rotated page through ocr() again. (ocr() of the
    landscape page, the fused program rerouting it to the bucketed lane's
    rot90 redo, is the path of test_flip_goldens_on_ocr_batch[True].)"""
    jax_engine, port = engines
    if lane == "ocr":
        got, want = port.ocr(routed[page]), jax_engine.ocr(routed[page])
    else:
        got = api_det.ocr(port, routed[page], force_staged=True)
        want = jax_api_det.ocr(jax_engine, routed[page], force_staged=True)
    _assert_same(got, want)


@pytest.mark.parametrize("fused", [True, False])
def test_flip_goldens_on_ocr_batch(engines, routed, fused):
    jax_engine, port = engines
    batch = [routed["flip"], routed["rot90"]]
    for g, w in zip(port.ocr_batch(batch, fused=fused),
                    jax_engine.ocr_batch(batch, fused=fused)):
        _assert_same(g, w)


def test_fullres_batch_with_rotated_oversize_pages(engines, routed):
    """An oversize upside-down page pools on the full-resolution lane with
    its own prior group; an oversize landscape page is redone rotated."""
    jax_engine, port = engines
    batch = [routed["big180"], routed["big90"]]
    got = api_det.ocr_fullres_batch(port, batch)
    want = jax_api_det.ocr_fullres_batch(jax_engine, batch)
    for g, w in zip(got, want):
        _assert_same(g, w)
