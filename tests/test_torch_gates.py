"""The reference's hardware gates (tests/test_tpu.py), as chip_smoke.py
phase 19 measures them, on the CPU in float32 at the cuts of
test_torch_fixture.GATE_CUTS, against ocrjax's measurement of the same
gates on the same pages (expected_jax_gates_fp32.json, written by
`tests/test_torch_fixture.py --write-gates`); and the two repairs ahead of
them: the detectors follow the config as ocrjax's do, and det crops expand
their boxes on the host as ocrjax does.

Cuts (the card runs the reference's sizes): every page gate one page or
one seed, the tiled batch two 2048-pixel pages, the dense page 1536x1024
with 80 lines.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import chip_smoke as CS
from test_torch_fixture import (EXPECTED, GATE_CUTS, GATE_TIMINGS,
                                GATES_EXPECTED, PAGES, _charset,
                                asset_config as jax_asset_config,
                                few_torch_threads, gate_digests,
                                jax_e2e_pages)  # noqa: F401

from ocrjax_torch.api import OcrEngine, asset_config

# the goldens' bar (tests/test_goldens.py:48-75)
BOX_TOL, SCORE_TOL = 0.011, 2e-3
# the conv gate's error: both sides round x to bf16 and sum in float32 in
# their own order; the largest error is a bf16 rounding of the plain
# version's output, the same in both packages to 1%
CONV_ERR_RTOL = 1e-2


@pytest.fixture(scope="module")
def want():
    with open(GATES_EXPECTED) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(CS.GATE_LINES))
def test_gate_reads_as_ocrjax(want, name):
    got = CS.GATE_FNS[name]("cpu", "float32", **GATE_CUTS.get(name, {}))
    assert got["test"] == f"tests/test_tpu.py:{CS.GATE_LINES[name]}"
    assert got["bar"] and isinstance(got["ok"], bool)
    w = want["numbers"][name]
    numbers = {k: v for k, v in got["numbers"].items()
               if k not in GATE_TIMINGS.get(name, ())}
    if name == "conv":
        assert numbers["max_abs_err"] == pytest.approx(w["max_abs_err"],
                                                       rel=CONV_ERR_RTOL)
        assert numbers["worst_over_tolerance"] <= 0.0
        assert w["worst_over_tolerance"] <= 0.0
    else:
        assert json.loads(json.dumps(numbers)) == w
    for key in GATE_TIMINGS.get(name, ()):
        assert np.isfinite(got["numbers"][key])
    if name not in CS.GATE_UNITS:
        assert got["pages"]["pages"]


def test_gate_pages_are_current(want):
    """Both renderers still draw the pages the committed numbers were
    measured on."""
    from ocrjax.train import synth as jsynth
    from ocrjax_torch.charset import default_charset
    from ocrjax_torch.train import e2e_eval, synth
    assert want["cuts"] == json.loads(json.dumps(GATE_CUTS))
    assert gate_digests(jsynth, _charset(), jax_e2e_pages) == want["digests"]
    charset = default_charset()

    def port_e2e(n_pages, seed, **kw):
        return e2e_eval.render_e2e(charset, n_pages=n_pages, seed=seed, **kw)
    assert gate_digests(synth, charset, port_e2e) == want["digests"]


# ---------------------------------------------------------------------------
# the detector built from the config in force at its first use
# ---------------------------------------------------------------------------

def _assert_same(got, want):
    assert [line.text for line in got.lines] == \
        [line.text for line in want.lines]
    if want.lines:
        g = np.stack([line.box.quad for line in got.lines])
        w = np.stack([line.box.quad for line in want.lines])
        assert np.abs(g - w).max() <= BOX_TOL
        assert np.abs(np.asarray([line.box.score for line in got.lines])
                      - np.asarray([line.box.score for line in want.lines])
                      ).max() <= SCORE_TOL


def _assert_boxes(got, want):
    assert len(got) == len(want)
    if want:
        assert np.abs(np.stack([b.quad for b in got])
                      - np.stack([b.quad for b in want])).max() <= BOX_TOL
        assert np.abs(np.asarray([b.score for b in got])
                      - np.asarray([b.score for b in want])).max() \
            <= SCORE_TOL


def _pages():
    return [np.repeat(p[..., None], 3, 2) for p in np.load(PAGES)["pages"]]


@pytest.mark.parametrize("order", ["before_first_call", "after_first_call"])
def test_detectors_follow_a_config_set_after_construction(order):
    """compute_dtype set to float32 on from_pretrained engines of both
    packages, before any call or after a first tiled call: detect, the
    fused lane and ocr_tiled read as ocrjax's at the goldens' bar. ocrjax
    builds the flagship DB at its first use and the tile DB again with
    every config; before the repair the port built both at construction
    and served bf16 boxes 4.4457 px from ocrjax's here."""
    from ocrjax.api import OcrEngine as JaxEngine
    pages = _pages()[:1]
    port = OcrEngine.from_pretrained(device="cpu")
    ref = JaxEngine.from_pretrained()
    if order == "after_first_call":
        for eng in (port, ref):
            eng.ocr_tiled(pages[0])
    for eng in (port, ref):
        eng.config = eng.config.replace(compute_dtype="float32")
    assert port.det_model.head.dtype == torch.float32
    for g, w in zip(port.ocr_batch(pages, fused=True),
                    ref.ocr_batch(pages, fused=True)):
        _assert_same(g, w)
    _assert_boxes(port.detect(pages[0]), ref.detect(pages[0]))
    _assert_same(port.ocr_tiled(pages[0]), ref.ocr_tiled(pages[0]))
    if order == "before_first_call":
        # the fused lane at ocrjax's committed float32 outputs
        with open(EXPECTED) as f:
            expected = json.load(f)["pages"]
        for res, w in zip(port.ocr_batch(pages, fused=True), expected):
            assert [line.text for line in res.lines] == w["strings"]
            assert np.abs(np.stack([line.box.quad for line in res.lines])
                          - np.asarray(w["boxes"])).max() <= BOX_TOL


def test_det_model_is_the_served_detector_and_keeps_loaded_weights():
    """Weights loaded into engine.det_model (eval_multiseed --det-weights)
    are the ones the lanes serve with, and a rebuild of the detector
    (engine._det = None after a config change, as the CLI and
    calibrate_unclip do) keeps them, as ocrjax's det_variables stay."""
    from ocrjax_torch import api_det, weights as W
    eng = OcrEngine(config=asset_config(compute_dtype="float32"),
                    device="cpu", seed=5)
    flat = W.model_variables(OcrEngine.from_pretrained(
        device="cpu").det_model)
    W.load_model_variables(eng.det_model, flat)
    assert api_det.det_state(eng).model is eng.det_model
    eng.config = eng.config.replace(det_unclip_ratio=2.0)
    eng._det = None
    rebuilt = eng.det_model
    assert rebuilt is api_det.det_state(eng).model
    got = W.model_variables(rebuilt)
    assert set(got) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
    # the tile detector follows the config; none without a tile asset
    assert eng.tile_det_model is None
    pre = OcrEngine.from_pretrained(device="cpu")
    tile = pre.tile_det_model
    assert tile is pre.tile_det_model
    pre.config = pre.config.replace(compute_dtype="float32")
    assert pre.tile_det_model is not tile
    assert pre.tile_det_model.head.dtype == torch.float32


# ---------------------------------------------------------------------------
# det crops: the margins on the host
# ---------------------------------------------------------------------------

def test_det_crop_margins_are_ocrjaxs_bit_for_bit(monkeypatch):
    """generate_det_crops expands the detected boxes as ocrjax does (the
    margins in float32, the sum and the clip in float64, float32 at the
    upload): the quads its warp receives equal ocrjax's expansion of the
    same boxes bit for bit."""
    from ocrjax.ops.warp import expand_quads
    from ocrjax_torch.ops import warp
    from ocrjax_torch.train.det_crops import generate_det_crops
    seen = []
    host, multi = warp.expand_quads_host, warp.warp_quads_multi_refined

    def spy_host(quads, *a, **k):
        seen.append({"boxes": np.array(quads)})
        return host(quads, *a, **k)

    def spy_warp(pages, page_ids, quads, bounds, **k):
        seen[-1]["warped"] = quads.cpu().numpy()
        return multi(pages, page_ids, quads, bounds, **k)
    monkeypatch.setattr(warp, "expand_quads_host", spy_host)
    monkeypatch.setattr(warp, "warp_quads_multi_refined", spy_warp)
    eng = OcrEngine.from_pretrained(
        device="cpu", config=asset_config(compute_dtype="float32"))
    S, m = 320, eng.config.rec_crop_margin
    generate_det_crops(eng, n_pages=2, page_size=S, chunk=2)
    assert seen and all(len(s["boxes"]) for s in seen)
    for s in seen:
        assert s["boxes"].dtype == np.float32
        want = np.asarray(expand_quads(
            s["boxes"], m, m, bounds=np.asarray([S - 1.0, S - 1.0],
                                                np.float32)), np.float32)
        np.testing.assert_array_equal(s["warped"], want)
