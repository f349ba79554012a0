"""The reference's diagnostic scripts in the port (ocrjax_torch/scripts/:
diag_dense, diag_dense_stages, diag_tile_det, diag_rec_fetch,
diag_reroute): each main() with --cpu in float32 at a tiny cut against
ocrjax's script at the same cut (expected_jax_diag_fp32.json, written by
`tests/test_torch_fixture.py --write-diag`).

Cuts (test_torch_fixture.DIAG_CUTS, the same for both packages):
diag_dense one 1024x1024 page of 40 lines; diag_dense_stages one 1024x1024
page of 40 lines, one timed run; diag_tile_det one 256x256 tile;
diag_rec_fetch 2 pages, one timed run; diag_reroute 4 pages. Both
printouts are read by chip_smoke.parse_script_output. Times are held to
being there and finite, not to a value; diag_tile_det's models are random
(flax's init and a torch generator), so only its shape is compared.
"""

from __future__ import annotations

import contextlib
import io
import json
import tempfile

import numpy as np
import pytest

import chip_smoke as CS
from test_torch_fixture import (BENCH_TRAFFIC, DIAG_CUTS, DIAG_EXPECTED,
                                few_torch_threads, float32_configs,
                                fp32_engines)  # noqa: F401

from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.ops import cc_label
from ocrjax_torch.postprocess import db_boxes
from ocrjax_torch.scripts import diag_dense_stages, diag_tile_det

TILT_TOL = 1e-3     # degrees


@pytest.fixture(scope="module")
def want():
    with open(DIAG_EXPECTED) as f:
        return json.load(f)


@contextlib.contextmanager
def _port_cut(name):
    cut = DIAG_CUTS[name]
    with contextlib.ExitStack() as st:
        st.enter_context(fp32_engines(OcrEngine, asset_config))
        if "page_size" in cut:
            st.enter_context(CS.patched(diag_dense_stages, "PAGE_SIZE",
                                        tuple(cut["page_size"])))
        if "tile" in cut:
            st.enter_context(CS.patched(diag_tile_det, "T", cut["tile"]))
            st.enter_context(float32_configs(diag_tile_det))
        yield


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """name -> (printout, parse, what else the run left: diag_reroute's
    saved quads and the pages it ran), each script run once."""
    runs = {}

    def run(name):
        if name not in runs:
            extra = {}
            tmp = tmp_path_factory.mktemp(name)
            batch = OcrEngine.ocr_batch

            def ocr_batch(self, images, *a, **k):
                extra.setdefault("pages", list(images))
                return batch(self, images, *a, **k)
            with _port_cut(name), \
                    CS.patched(tempfile, "tempdir", str(tmp)), \
                    CS.patched(OcrEngine, "ocr_batch", ocr_batch):
                text, got = CS.run_port_script(
                    name, [*DIAG_CUTS[name]["argv"], "--cpu"])
            for path in tmp.glob("diag_reroute_quads_*.npz"):
                extra["saved"] = dict(np.load(path))
            runs[name] = (text, got, extra)
        return runs[name]
    return run


def tilt_stats(vq: np.ndarray, min_aspect: float) -> dict:
    """The reference script's statistics of one page's quads, unrounded."""
    e = vq[:, 1] - vq[:, 0]
    a = np.abs(np.degrees(np.arctan2(e[:, 1], e[:, 0]))) % 90.0
    tilt = np.minimum(a, 90.0 - a)
    w_len = np.linalg.norm(vq[:, 1] - vq[:, 0], axis=1)
    h_len = np.linalg.norm(vq[:, 3] - vq[:, 0], axis=1)
    aspect = (np.maximum(w_len, h_len)
              / np.maximum(np.minimum(w_len, h_len), 1.0))
    gated = np.where(aspect >= min_aspect, tilt, 0.0)
    return {"max_gated_tilt": float(gated.max()),
            "offender_aspect": float(aspect[np.argmax(gated)])}


def _check_dense(got, want, _extra, _saved):
    # no field of diag_dense is a time: all of it is equal
    assert got == want
    assert got["found"] > 0 and got["n"] == 40


def _check_dense_stages(got, want, _extra, _saved):
    assert got["gt_lines"] == want["gt_lines"]
    assert got["tile_cap"] == want["tile_cap"]
    assert [r["lines"] for r in got["runs"]] == \
        [r["lines"] for r in want["runs"]]
    assert got["resident"]["tiles"] == want["resident"]["tiles"]
    run, = got["runs"]
    # ocrjax's host stages, with the port's device stages nested in them;
    # on the CPU no device time
    names = {s[0] for s in run["stages"]}
    ref, = want["runs"]
    assert {s[0] for s in ref["stages"]} <= names
    assert [s[2] for s in run["stages"] if s[0] in {
        r[0] for r in ref["stages"]}] == [
        dict((r[0], r[2]) for r in ref["stages"])[s[0]]
        for s in run["stages"] if s[0] in {r[0] for r in ref["stages"]}]
    assert {"tile_det", "ccl", "extract_boxes", "warp_refine", "crnn",
            "ctc"} <= names
    assert run["device_ms"] == "not measured"
    assert run["sum_ms"] == pytest.approx(sum(s[1] for s in run["stages"]),
                                          abs=0.05 * len(run["stages"]))


def _check_tile_det(got, want, _extra, _saved):
    assert sorted(got) == sorted(want) == ["1", "2", "4"]
    assert all(v["tiles"] == 1 for v in got.values())


def _check_rec_fetch(got, want, _extra, _saved):
    assert (got["pages"], got["pooled_lines"]) == \
        (want["pages"], want["pooled_lines"])
    assert [r["n_chunks"] for r in got["runs"]] == \
        [r["n_chunks"] for r in want["runs"]]
    # the packed rows' bytes, as the reference's payload
    assert [r["payload_kb"] for r in got["runs"]] == \
        [r["payload_kb"] for r in want["runs"]]
    assert got["pooled_lines"] > 0


def _check_reroute(got, want, extra, saved):
    keep = ("page", "reroute", "boxes", "thresh")
    assert [{k: d[k] for k in keep} for d in got["decisions"]] == \
        [{k: d[k] for k in keep} for d in want["decisions"]]
    assert {k: got[k] for k in ("det", "pages", "reroutes")} == \
        {k: want[k] for k in ("det", "pages", "reroutes")}
    mine = extra["saved"]
    assert sorted(mine) == sorted(saved)
    aspect = asset_config().fused_reroute_min_aspect
    for k in saved:
        ref = np.asarray(saved[k], np.float32)
        np.testing.assert_allclose(mine[k], ref, atol=CS.BOX_TOL, rtol=0)
        a, b = tilt_stats(mine[k], aspect), tilt_stats(ref, aspect)
        for s in a:
            assert a[s] == pytest.approx(b[s], abs=TILT_TOL), (k, s)
    # the printed statistics are the saved quads' (to the printed 0.01)
    for d in got["decisions"]:
        s = tilt_stats(mine[f"p{d['page']}"], aspect)
        assert d["max_gated_tilt"] == pytest.approx(s["max_gated_tilt"],
                                                    abs=0.0051)
        assert d["offender_aspect"] == pytest.approx(s["offender_aspect"],
                                                     abs=0.051)


CHECKS = {"diag_dense": _check_dense,
          "diag_dense_stages": _check_dense_stages,
          "diag_tile_det": _check_tile_det,
          "diag_rec_fetch": _check_rec_fetch,
          "diag_reroute": _check_reroute}


@pytest.mark.parametrize("name", CS.DIAG_SCRIPTS)
def test_diag_script_reads_as_the_reference(want, port, name):
    """The port's printout parses to the reference's keys, every number
    finite, and the fields that are not times as ocrjax's."""
    assert want[name]["cut"] == json.loads(json.dumps(DIAG_CUTS[name]))
    text, got, extra = port(name)
    assert CS.key_shape(got) == CS.key_shape(want[name]["parsed"])
    assert CS.all_finite(got)
    CHECKS[name](got, want[name]["parsed"], extra,
                 want[name].get("saved", {}))


def test_diag_reroute_replays_the_bench_traffic(port):
    """diag_reroute's pages are the port's bench traffic's first pages:
    both draw line_bucket_for_count(256) strip texts (render_traffic's
    line_bucket, the fixture's too) before the pages, from RandomState(0)."""
    _, got, extra = port("diag_reroute")
    pages = np.load(BENCH_TRAFFIC)["pages"]
    assert len(extra["pages"]) == got["pages"] == 4
    for img, want_page in zip(extra["pages"], pages):
        np.testing.assert_array_equal(img[..., 0], want_page)


@pytest.mark.parametrize("name", CS.DIAG_SCRIPTS)
def test_diag_script_refuses_to_run_off_the_card_without_cpu(name):
    """Without CUDA (this host has none) and without --cpu a script
    raises; it never takes the CPU quietly."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with contextlib.redirect_stdout(io.StringIO()):
            CS.run_port_script(name, DIAG_CUTS[name]["argv"])


@pytest.mark.parametrize("hs", [1, 2, 4])
def test_diag_tile_det_labels_a_512_grid_on_the_cluster_path(hs):
    """At T = 2048 extract_boxes' cc_downsample is det_cc_downsample // hs,
    so K1 labels a 512x512 grid at every head stride: the cluster path."""
    cfg = diag_tile_det.OcrConfig(det_head_stride=hs)
    kw = db_boxes.static_kwargs_from_config(cfg.replace(
        det_max_candidates=cfg.tile_max_candidates))
    side = diag_tile_det.T // hs // kw["cc_downsample"]
    assert side == 512 and kw["coord_stride"] == hs
    assert cc_label.ccl_path(side, side) == "cluster"


def test_diag_reroute_loads_det_weights_across_the_config_change(
        port, tmp_path):
    """--det loads flax-layout weights into the detector before the script
    changes the config; the shipped det file reads the same decisions and
    quads, saved under the file's name."""
    import os
    _, base, extra = port("diag_reroute")
    det = os.path.join(CS.ROOT, "assets", "det.safetensors")
    with _port_cut("diag_reroute"), \
            CS.patched(tempfile, "tempdir", str(tmp_path)):
        _, got = CS.run_port_script("diag_reroute",
                                    ["--det", det, "--pages", "2", "--cpu"])
    assert got["det"] == det and got["pages"] == 2
    assert got["decisions"] == base["decisions"][:len(got["decisions"])]
    saved = dict(np.load(tmp_path / "diag_reroute_quads_det.npz"))
    for k, q in saved.items():
        np.testing.assert_array_equal(q, extra["saved"][k])
