"""The port's bench (ocrjax_torch/bench_lib.py) at a tiny size on the CPU,
its roofline counter against hand-counted FLOPs, and `cli bench`.

run_bench: 2 pages at 512, 8 strips, one 768x512 dense page of 40 lines,
repeats=1, no extension windows (extension_budget_s=0: on a loaded host
the CPU's windows may fall below 0.4x its ceiling, and the extension would
sample windows 20 s apart for minutes). Its report carries every key of
ocrjax's run_bench report, the link probe and each window's probe and
fetch fields among them, every number finite and positive, the host
stages of each lane with their MB, and every device stage time "not
measured" (no card). The traffic is the reference bench's, rendered by the
same seeds and order as ocrjax's run_bench: held here against
ocrjax.train.synth directly.
"""

import contextlib
import io
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from ocrjax.charset import Charset as JaxCharset
from ocrjax.train import synth as jsynth
from ocrjax_torch import bench_lib
from ocrjax_torch import cli as tcli
from ocrjax_torch.charset import Charset
from ocrjax_torch.utils import roofline as RL
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


CHARSET = os.path.join(ROOT, "assets", "rec.charset.txt")
TINY = dict(pages=2, lines=8, det_max_side=512, dense_pages=1,
            dense_size=(768, 512), dense_lines=40)


def reference_keys() -> set:
    """The keys ocrjax's run_bench puts in its report."""
    with open(os.path.join(ROOT, "ocrjax", "bench_lib.py")) as f:
        src = f.read()
    keys = set(re.findall(r'report\["(\w+)"\]', src))
    body = src[src.index("report: Dict[str, float] = {"):]
    keys |= set(re.findall(r'"(\w+)":', body[:body.index("}")]))
    return keys


@pytest.fixture(scope="module")
def traffic():
    return bench_lib.render_traffic(Charset.from_file(CHARSET), **TINY)


@pytest.fixture(scope="module")
def report(traffic):
    return bench_lib.run_bench(pages=2, lines=8, repeats=1, cpu=True,
                               traffic=traffic, extension_budget_s=0)


def test_traffic_is_the_reference_bench_traffic(traffic):
    """Strips then pages from RandomState(0), dense page s from
    RandomState(1000 + s), as ocrjax's run_bench draws them."""
    cs = JaxCharset.from_file(CHARSET)
    rng = np.random.RandomState(0)
    texts = [jsynth.random_text(rng, cs, 4, 12) for _ in range(8)]
    assert bench_lib.traffic_texts(traffic, "strip") == texts
    s = jsynth.render_line(texts[3], 32)
    w = min(s.shape[1], 320)
    np.testing.assert_array_equal(traffic["strips"][3, :, :w], s[:, :w])
    assert traffic["strip_widths"][3] == w
    pages = [jsynth.render_page(rng, cs, size=(512, 512)) for _ in range(2)]
    np.testing.assert_array_equal(traffic["pages"],
                                  np.stack([p[0] for p in pages]))
    assert bench_lib.traffic_texts(traffic, "page") == [p[2] for p in pages]
    np.testing.assert_array_equal(
        traffic["page_quads"], np.concatenate([np.stack(p[1])
                                               for p in pages]))
    dense = jsynth.render_page_dense(np.random.RandomState(1000), cs,
                                     size=(768, 512), n_lines=40)
    np.testing.assert_array_equal(traffic["dense"][0], dense[0])
    assert bench_lib.traffic_texts(traffic, "dense") == [dense[2]]


def test_report_has_the_reference_keys_but_the_link_fields(report):
    """Every key of ocrjax's report, the link fields included: link_probe
    and each window's probe and fetch fields, under ocrjax's keys."""
    want = reference_keys()
    assert {"crops_per_sec", "pages_per_sec_device", "dense_pages_per_sec",
            "roofline", "windows_detail", "link_probe"} <= want
    assert want <= set(report)
    assert set(report) - want == {"cc_label_launches_by_section"}
    lp = report["link_probe"]
    assert set(lp) == {"rtt_ms", "upload_mb_s"} and lp["rtt_ms"] >= 0
    assert lp["upload_mb_s"] is None or lp["upload_mb_s"] > 0
    for w in report["windows_detail"]:
        assert set(w) == {"path", "pages_per_sec", "probe_rtt_ms",
                          "probe_up_mb_s", "fetch_ms", "fetch_mb"}
        # MiB to 0.01: two pages' payloads round to 0.0
        assert w["fetch_ms"] >= 0 and w["fetch_mb"] >= 0


def test_report_numbers_are_finite(report):
    for k, v in report.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v > 0, k
    assert report["device"] == "cpu" and report["pages"] == 2
    assert len(report["pages_per_sec_fused_windows"]) == 3
    assert len(report["pages_per_sec_bucketed_windows"]) == 3
    assert report["pages_per_sec"] == max(
        report["pages_per_sec_fused_windows"]
        + report["pages_per_sec_bucketed_windows"])
    assert report["dense_gt_lines_per_page"] == 40.0
    stages = report["stages_last_window"]
    assert set(stages) == {"fused", "bucketed", "dense"}
    for lane, host in (("fused", ("host_decode", "fused_dispatch",
                                  "fused_fetch")),
                       ("bucketed", ("host_decode", "det_dispatch",
                                     "det_fetch", "warp_norm",
                                     "rec_dispatch", "rec_fetch_decode")),
                       ("dense", ("tile_prep", "tile_det_dispatch",
                                  "tile_det_fetch", "tile_seam_merge",
                                  "tile_assign", "tile_assembly"))):
        rep = stages[lane]
        assert set(rep["device_ms"]) == set(rep["host_ms"])
        assert set(rep["device_ms"].values()) == {"not measured"}
        assert set(host) <= set(rep["host_ms"])
        fetch = {"fused": "fused_fetch", "bucketed": "det_fetch",
                 "dense": "tile_det_fetch"}[lane]
        assert rep["host_ms"][fetch]["mb"] >= 0
    roof = report["roofline"]
    assert roof["peak_bf16_tflops"] == 989.0
    assert [s["stage"] for s in roof["stages"]] == [
        "rec_fwd+ctc", "rec_bilstm_share", "fused_e2e_chunk2",
        "dense_tile_det_page"]
    assert 0 < roof["stages"][1]["pct_of_rec_flops"] < 100
    # the kernel counts only count the card's launches
    assert all(v == {"shared": 0, "cluster": 0, "global": 0}
               for v in report["cc_label_launches_by_section"].values())


def test_bench_refuses_traffic_smaller_than_asked(traffic):
    with pytest.raises(ValueError, match="strips"):
        bench_lib.run_bench(pages=3, lines=8, cpu=True, traffic=traffic)


def test_roofline_counts_a_conv_and_a_matmul_by_hand():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    x = torch.randn(2, 3, 10, 12)
    # 2 FLOPs a MAC: every output pixel and channel takes 3 * 3 * 3 MACs
    assert RL.torch_flops(conv, x) == 2 * (2 * 8 * 10 * 12) * (3 * 3 * 3)
    a, b = torch.randn(5, 7), torch.randn(7, 11)
    assert RL.torch_flops(torch.matmul, a, b) == 2 * 5 * 7 * 11
    lstm = torch.nn.LSTM(6, 4, batch_first=True)
    assert RL.torch_flops(lstm, torch.randn(3, 9, 6)) == \
        3 * 9 * 2 * 4 * 4 * (6 + 4)
    row = RL.stage_entry("x", 989e12 * 0.5, 1.0)
    assert row["achieved_tflops"] == 494.5 and row["pct_of_bf16_peak"] == 50.0


def test_cli_bench_prints_one_json(traffic, tmp_path):
    path = str(tmp_path / "traffic.npz")
    np.savez_compressed(path, **traffic)
    out = io.StringIO()
    real, seen = bench_lib.run_bench, []

    def run_bench(**kw):          # the CLI passes ocrjax's arguments
        seen.append(kw)
        return real(**kw, extension_budget_s=0)
    with contextlib.redirect_stdout(out), \
            _patched(bench_lib, "run_bench", run_bench):
        rc = tcli.main(["bench", "--cpu", "--pages", "2", "--lines", "8",
                        "--repeats", "1", "--traffic", path])
    assert "extension_budget_s" not in seen[0]
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["pages"] == 2 and rep["crops_per_sec"] > 0
