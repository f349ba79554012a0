"""ocrjax_torch.utils.profiling on the CPU: the StageTimer times nested
stages with the host clock (its device report says "not measured"),
counts calls as ocrjax's StageTimer does for the same stages, names each
stage in a torch.profiler trace written by device_trace, and the
module-level stage() opens no span while no timer is active."""

from __future__ import annotations

import glob
import json
import time

from ocrjax_torch.utils import profiling as P

# a sequence of (stage, nested stages) as a pipeline runs them
SEQUENCE = [("tile_prep", []), ("tile_det", []),
            ("extract_boxes", ["ccl"]), ("tile_det", []),
            ("extract_boxes", ["ccl", "ccl"]), ("warp_refine", []),
            ("crnn", ["ctc"])]


def _run(stage, sleep_s: float = 0.0) -> None:
    for outer, inner in SEQUENCE:
        with stage(outer):
            for name in inner:
                with stage(name):
                    time.sleep(sleep_s)


def _trace_names(out_dir) -> set:
    path, = glob.glob(str(out_dir / "*.json"))
    return {e.get("name") for e in json.load(open(path))["traceEvents"]}


def test_stage_timer_times_nested_stages_on_the_cpu():
    timer = P.StageTimer("cpu")
    with timer.active():
        _run(P.stage, sleep_s=0.002)
    host = timer.host_report()
    assert set(host) == {"tile_prep", "tile_det", "extract_boxes", "ccl",
                         "warp_refine", "crnn", "ctc"}
    # an outer stage holds the time of the stages nested in it
    assert host["ccl"] >= 3 * 2.0
    assert host["extract_boxes"] >= host["ccl"]
    assert host["crnn"] >= host["ctc"] >= 2.0
    assert timer.report() == {k: "not measured" for k in host}
    assert not timer.on_card and not timer.events


def test_stage_timer_counts_calls_as_ocrjax():
    from ocrjax.utils.profiling import StageTimer as JaxTimer
    ref = JaxTimer()
    _run(ref.stage)
    timer = P.StageTimer("cpu")
    with timer.active():
        _run(P.stage)
    got = timer.host_report(calls=True)
    want = ref.report()
    assert list(got) == list(want)
    assert {k: v["calls"] for k, v in got.items()} == \
        {k: v["calls"] for k, v in want.items()}
    assert all(set(v) == set(want[k]) for k, v in got.items())
    assert {k: v["calls"] for k, v in got.items()} == {
        "ccl": 3, "crnn": 1, "ctc": 1, "extract_boxes": 2, "tile_det": 2,
        "tile_prep": 1, "warp_refine": 1}


def test_device_trace_names_the_stages(tmp_path):
    timer = P.StageTimer("cpu")
    with P.device_trace(str(tmp_path), "cpu"), timer.active():
        _run(P.stage)
    names = _trace_names(tmp_path)
    assert {"tile_prep", "tile_det", "extract_boxes", "ccl", "warp_refine",
            "crnn", "ctc"} <= names


def test_stage_without_a_timer_opens_no_span(tmp_path):
    assert P._active is None
    with P.device_trace(str(tmp_path), "cpu"):
        with P.stage("no_timer_stage"):
            pass
        timer = P.StageTimer("cpu")
        with timer.active(), P.stage("timed_stage"):
            pass
    names = _trace_names(tmp_path)
    assert "timed_stage" in names and "no_timer_stage" not in names
    assert dict(timer.calls) == {"timed_stage": 1}


def test_timer_defaults_to_the_card_only_where_there_is_one():
    import torch
    assert P.StageTimer().on_card == torch.cuda.is_available()
    assert not P.StageTimer("cpu").on_card

