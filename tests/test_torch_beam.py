"""Beam CTC in the port: ctc_beam_decode against ocrjax's on seeded logits,
and beam=True through recognize and every page lane against the JAX engine
(both in float32 on the shipped assets, det_max_side=512).

Bar: token ids and lengths identical, confidences within rtol 1e-5; on the
lanes the goldens bar (identical strings and order, box corners within
0.011 px, scores and confidences within 2e-3).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrjax import api_det as jax_api_det
from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.charset import Charset
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.ops import ctc as jax_ctc
from ocrjax.train import synth
from ocrjax_torch import api_det
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.ops import ctc
from test_torch_fixture import few_torch_threads, jax_fields  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V_SHIPPED = 96     # the shipped charset's classes, blank included


def _decode_both(logits, lengths, max_tokens, beam_width):
    want = jax_ctc.ctc_beam_decode(jnp.asarray(logits), jnp.asarray(lengths),
                                   max_tokens=max_tokens,
                                   beam_width=beam_width)
    got = ctc.ctc_beam_decode(torch.from_numpy(logits),
                              torch.from_numpy(lengths),
                              max_tokens=max_tokens, beam_width=beam_width)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_same_decode(logits, lengths, max_tokens, beam_width):
    (wt, wn, wc), (gt, gn, gc) = _decode_both(logits, lengths, max_tokens,
                                              beam_width)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gc, wc, rtol=1e-5)
    assert gt.dtype == np.int32 and gn.dtype == np.int32
    return gt, gn


# (B, T, V, K, L, scale): small vocabularies, the shipped charset's V at the
# CRNN's 80 frames, and L small enough that the token buffer overflows
CASES = [(5, 37, 12, 8, 37, 3.0), (3, 12, 6, 8, 12, 2.0),
         (4, 80, V_SHIPPED, 8, 128, 4.0), (2, 80, V_SHIPPED, 4, 128, 1.0),
         (3, 30, 6, 4, 3, 3.0), (2, 40, V_SHIPPED, 8, 5, 0.5)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_beam_decode_matches_ocrjax(case):
    B, T, V, K, L, scale = case
    rng = np.random.RandomState(B * 1000 + T + V)
    logits = (rng.randn(B, T, V) * scale).astype(np.float32)
    lengths = rng.randint(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    _, n = _assert_same_decode(logits, lengths, L, K)
    if L < T // 2:
        assert n.max() == L                   # the buffer overflowed


def test_beam_decode_zero_length_inputs():
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 10, 7).astype(np.float32)
    toks, n = _assert_same_decode(logits, np.asarray([0, 10, 0], np.int32),
                                  8, 8)
    assert n[0] == 0 and n[2] == 0 and not toks[0].any()


@pytest.mark.parametrize("V,K", [(5, 8), (V_SHIPPED, 8), (9, 3)])
def test_beam_decode_uniform_logits_ties_everywhere(V, K):
    """Every candidate ties: the top-K order alone decides, and disabled
    beams at exactly -1e30 take part in the next frame's merge. (XLA's
    float32 log rounds log(V) one ulp away from torch's at V = 7, 47 and 49
    of 2..129; there the two frameworks' ties are between other numbers,
    so those V are not used.)"""
    logits = np.zeros((2, 16, V), np.float32)
    _assert_same_decode(logits, np.asarray([16, 9], np.int32), 16, K)


def test_beam_decode_merge_heavy_ambiguity():
    """tests/test_ctc.py's merge-stress case: mass on {blank, a, b} over 40
    frames, where stay x extend prefix joins are most frequent."""
    rng = np.random.RandomState(7)
    logits = np.full((1, 40, 97), -9.0, np.float32)
    logits[:, :, :3] = rng.randn(1, 40, 3).astype(np.float32) * 0.7
    _assert_same_decode(logits, np.asarray([40], np.int32), 64, 8)


def test_beam_decode_where_greedy_and_beam_diverge():
    """p(blank) = .6, p(a) = .4 on two frames: greedy reads "" and beam
    "a" (P("a") = .64 > P("") = .36)."""
    logits = np.log(np.tile(np.asarray([[[0.6, 0.4, 1e-9]]], np.float32),
                            (1, 2, 1)))
    lengths = np.asarray([2], np.int32)
    toks, n = _assert_same_decode(logits, lengths, 4, 4)
    assert list(toks[0][: n[0]]) == [1]
    _, gn, _ = ctc.ctc_greedy_decode(torch.from_numpy(logits),
                                     torch.from_numpy(lengths))
    assert int(gn[0]) == 0


def test_beam_step_keeps_the_state_of_finished_sequences():
    """A sequence past its length keeps its beams untouched."""
    rng = np.random.RandomState(5)
    B, K, V, L = 2, 4, 6, 5
    state = (torch.from_numpy(rng.randn(B, K).astype(np.float32)),
             torch.from_numpy(rng.randn(B, K).astype(np.float32)),
             torch.from_numpy(rng.randint(-1, V, (B, K)).astype(np.int32)),
             torch.from_numpy(rng.randint(0, V, (B, K, L)).astype(np.int32)),
             torch.from_numpy(rng.randint(0, L, (B, K)).astype(np.int32)))
    logp = torch.log_softmax(torch.from_numpy(
        rng.randn(B, V).astype(np.float32)), -1)
    out = ctc._beam_step(state, logp, torch.tensor([False, True]),
                         beam_width=K, blank=0)
    for a, b in zip(out, state):
        assert torch.equal(a[0], b[0])


@pytest.fixture(scope="module")
def engines():
    cfg = asset_config(det_max_side=512, compute_dtype="float32")
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**jax_fields(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


def test_golden_beam_strips(engines):
    """goldens["beam_strips"] through recognize(beam=True)."""
    jax_engine, port = engines
    with open(os.path.join(ROOT, "assets", "goldens", "goldens.json")) as f:
        golden = json.load(f)["beam_strips"]
    for g in golden:
        rng = np.random.RandomState(g["seed"])
        text = synth.random_text(rng, port.charset, 4, 14)
        assert text == g["gt"]
        strip = synth.render_line(text, port.config.rec_height)
        got = port.recognize(strip, beam=True)
        want = jax_engine.recognize(strip, beam=True)
        assert got.text == want.text == g["beam"]
        assert abs(got.confidence - want.confidence) <= 1e-5


@pytest.fixture(scope="module")
def pages():
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))

    def page(seed, size=(512, 512), **kw):
        return synth.render_page(np.random.RandomState(seed), charset,
                                 size=size, **kw)[0]

    return {"straight": page(102, n_lines=(3, 6), text_height=(20, 40)),
            "tilted": page(202, n_lines=(2, 4), text_height=(22, 36),
                           max_rotation=8.0),
            "big": page(1203, size=(760, 600), n_lines=(4, 7),
                        text_height=(26, 44))}


def _assert_same(got, want, min_lines=2):
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


def _lane(engine, mod, lane, pages):
    """One lane's beam=True results on the given engine."""
    if lane == "fused":      # the tilted page reroutes to the bucketed lane
        return engine.ocr_batch([pages["straight"], pages["tilted"]],
                                fused=True, beam=True)
    if lane == "bucketed":   # the oversize page takes full-resolution crops
        return engine.ocr_batch([pages["straight"], pages["big"]],
                                fused=False, beam=True)
    if lane == "staged":
        return [mod.ocr(engine, pages["tilted"], beam=True,
                        force_staged=True)]
    return [engine.ocr(pages["big"], beam=True)]   # full resolution


@pytest.mark.parametrize("lane", ["fused", "bucketed", "staged", "fullres"])
def test_beam_on_every_lane_matches_jax(engines, pages, lane):
    jax_engine, port = engines
    got = _lane(port, api_det, lane, pages)
    want = _lane(jax_engine, jax_api_det, lane, pages)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w)
