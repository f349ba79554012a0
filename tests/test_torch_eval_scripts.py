"""The reference's evaluation and bench scripts in the port
(ocrjax_torch/scripts/: eval_quality_breakdown, eval_xheight, eval_beam,
bench_int8_det, bench_try_flip, eval_tiled_quality, probe_dense,
calibrate_unclip): their helpers against the reference's, and each
main() with --cpu in float32 at a tiny cut against ocrjax's script at the
same cut (expected_jax_scripts_fp32.json, written by
`tests/test_torch_fixture.py --write-scripts`).

Cuts (test_torch_fixture.SCRIPT_CUTS, the same for both packages): one
page a font, a length tier, a seed or a ratio; eval_beam's evaluate_e2e
one page a call; bench_int8_det on a 128-pixel canvas; bench_try_flip 2
pages, one window each; probe_dense one 1024x1024 page of 40 lines. The
port alone also times eval_beam's throughput on 32 strips and
bench_int8_det's forwards once each: times are held to being there and
finite, not to a value.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import chip_smoke as CS
from test_torch_fixture import (SCRIPT_CUTS, SCRIPTS_EXPECTED, e2e_pages_cut,
                                few_torch_threads, fp32_engines,
                                reference_script)  # noqa: F401

from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.scripts import (bench_int8_det, eval_beam,
                                  eval_quality_breakdown, eval_xheight,
                                  probe_dense)

ALPHABET = "xXoOsScCvVwWzZuUkKyYpPmMnN01lI|.aAbB7 -∅"
# bench_int8_det's float maps: float32 in both packages, summed in another
# order; a pixel at the threshold may fall either way
INT8_ATOL = {"agreement": 2e-5, "mean_abs_diff": 2e-6, "max_abs_diff": 2e-3}


@pytest.fixture(scope="module")
def want():
    with open(SCRIPTS_EXPECTED) as f:
        return json.load(f)


@settings(max_examples=300, deadline=None)
@given(st.characters(), st.characters())
def test_case_flip_is_the_reference(a, b):
    ref = reference_script("eval_xheight")
    assert eval_xheight.case_flip(a, b) == ref.case_flip(a, b)
    assert eval_xheight.CASE_PAIRS == ref.CASE_PAIRS


@settings(max_examples=300, deadline=None)
@given(st.text(ALPHABET, max_size=12), st.text(ALPHABET, max_size=12))
def test_align_subs_is_the_reference(gt, pred):
    ref = reference_script("eval_quality_breakdown")
    assert eval_quality_breakdown._align_subs(gt, pred) == \
        ref._align_subs(gt, pred)
    for a, b in eval_quality_breakdown._align_subs(gt, pred):
        assert eval_xheight.case_flip(a, b) == \
            reference_script("eval_xheight").case_flip(a, b)


class _Line:
    def __init__(self, quad, text):
        self.box = type("Box", (), {"quad": quad})()
        self.text = text


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 31 - 1),
       st.lists(st.text(ALPHABET, min_size=1, max_size=4), min_size=0,
                max_size=8))
def test_probe_dense_match_is_the_reference(seed, texts):
    rng = np.random.RandomState(seed)
    quads = [np.asarray([[x, y], [x + w, y], [x + w, y + h], [x, y + h]],
                        np.float32)
             for x, y, w, h in rng.uniform(0, 60, (len(texts), 4))]
    lines = [_Line(q + rng.normal(0, rng.choice([0.5, 8.0]), q.shape),
                   t if rng.rand() < 0.7 else t + "x")
             for q, t in zip(quads, texts) if rng.rand() < 0.8]
    rng.shuffle(lines)
    assert probe_dense.match(quads, texts, lines) == \
        reference_script("probe_dense").match(quads, texts, lines)


@contextlib.contextmanager
def _port_cut(name):
    from ocrjax_torch.train import e2e_eval
    cut = SCRIPT_CUTS[name]
    with fp32_engines(OcrEngine, asset_config, **cut.get("config", {})), \
            e2e_pages_cut(e2e_eval, cut.get("e2e_pages")), \
            CS.patched(eval_beam, "N_STRIPS", 32), \
            CS.patched(bench_int8_det, "REPEATS", 1):
        yield


def _run(name) -> tuple:
    with _port_cut(name):
        return CS.run_port_script(name, [*SCRIPT_CUTS[name]["argv"],
                                         "--cpu"])


@pytest.mark.parametrize("name", CS.SCRIPTS)
def test_script_reads_as_the_reference(want, name):
    """The port's printout parses to the reference's keys, every number
    finite, and equal numbers but the times."""
    assert want[name]["cut"] == json.loads(json.dumps(SCRIPT_CUTS[name]))
    text, got = _run(name)
    assert CS.key_shape(got) == CS.key_shape(want[name]["parsed"])
    assert CS.all_finite(got)
    g, w = (CS.drop_timings(name, p) for p in (got, want[name]["parsed"]))
    if name == "bench_int8_det":
        for key, atol in INT8_ATOL.items():
            assert g.pop(key) == pytest.approx(w.pop(key), abs=atol), key
    assert g == w
    # the same lines of text but the times
    assert len(text.splitlines()) == len(want[name]["text"].splitlines())


def test_scripts_refuse_to_run_off_the_card_without_cpu():
    """Without CUDA (this host has none) and without --cpu a script
    raises; it never takes the CPU quietly."""
    for name in CS.SCRIPTS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with contextlib.redirect_stdout(io.StringIO()):
                CS.run_port_script(name, SCRIPT_CUTS[name]["argv"])


def test_bench_int8_det_times_the_detector_that_serves(monkeypatch):
    """The model bench_int8_det times is the engine's serving detector:
    the one the fused lane runs after it."""
    from ocrjax_torch import api_det
    from ocrjax_torch.models import db_int8
    models, engines = [], []
    apply_prob = db_int8.apply_prob

    def spy(model, x, int8):
        models.append(model)
        return apply_prob(model, x, int8)
    monkeypatch.setattr(db_int8, "apply_prob", spy)
    with _port_cut("bench_int8_det"):
        cut = OcrEngine.from_pretrained.__func__

        def from_pretrained(cls, *a, **k):
            engines.append(cut(cls, *a, **k))
            return engines[-1]
        with CS.patched(OcrEngine, "from_pretrained",
                        classmethod(from_pretrained)):
            CS.run_port_script("bench_int8_det", ["--cpu"])
    eng, = engines
    timed = set(map(id, models))
    models.clear()
    page = np.full((128, 128, 3), 255, np.uint8)
    page[40:60, 20:100] = 0
    eng.ocr_batch([page], fused=True)
    assert set(map(id, models)) == timed == {id(eng.det_model)}
    assert api_det.det_state(eng).model is eng.det_model
