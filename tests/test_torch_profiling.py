"""ocrjax_torch.utils.profiling on the CPU: the StageTimer times nested
stages with the host clock (its device report says "not measured"),
counts calls as ocrjax's StageTimer does for the same stages, names each
stage in a torch.profiler trace written by device_trace, and the
module-level stage() opens no span while no timer is active. Host stages
(the worker threads') are counted exactly from many threads and open no
profiler span."""

from __future__ import annotations

import glob
import json
import time

import pytest

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


def test_stage_without_a_timer_opens_no_span():
    """Under torch.profiler with no timer active the module-level stage()
    opens no span (device_trace activates a timer of its own, so it is not
    the profiler here)."""
    from torch.profiler import profile
    assert P._active is None
    with profile() as prof:
        with P.stage("no_timer_stage"):
            pass
        timer = P.StageTimer("cpu")
        with timer.active(), P.stage("timed_stage"):
            pass
    names = {e.name for e in prof.events()}
    assert "timed_stage" in names and "no_timer_stage" not in names
    assert dict(timer.calls) == {"timed_stage": 1}


def test_device_trace_without_a_timer_names_the_stages(tmp_path):
    """device_trace makes a timer active where there is none, so the
    operator's trace names the stages; it leaves none active after."""
    assert P._active is None
    with P.device_trace(str(tmp_path), "cpu"):
        assert P.current() is not None
        _run(P.stage)
    assert P.current() is None
    assert {"tile_prep", "tile_det", "extract_boxes", "ccl", "warp_refine",
            "crnn", "ctc"} <= _trace_names(tmp_path)


def test_host_stages_from_many_threads_count_exactly():
    """More threads than cores, each opening 500 host stages (an outer
    and a nested one) while the interpreter switches threads often: every
    call is counted, each total is the sum of its spans' lengths in the
    log, and each nested span's parent is its own thread's outer span."""
    import os
    import sys
    import threading
    n_threads = max(8, 2 * (os.cpu_count() or 1))
    reps = 500
    timer = P.StageTimer("cpu")
    errors = []

    def work():
        try:
            for _ in range(reps):
                with P.host_stage("outer"), P.host_stage("inner"):
                    pass
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.active():
            threads = [threading.Thread(target=P.carry(work))
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not errors and not any(t.is_alive() for t in threads)
    spans = timer.spans
    assert len(spans) == 2 * n_threads * reps
    assert dict(timer.calls) == {"outer": n_threads * reps,
                                 "inner": n_threads * reps}
    for name in ("outer", "inner"):
        got = sum(s.end_ns - s.start_ns for s in spans if s.name == name)
        assert timer.host[name] == pytest.approx(got * 1e-6, abs=1e-6)
    for s in spans:
        assert s.host_only and s.call is None
        if s.name == "inner":
            p = spans[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        else:
            assert s.parent is None
    assert len({s.thread for s in spans}) == n_threads


def test_host_stages_open_no_profiler_span_and_no_cuda_event():
    """host_stage records the host clock only: no profiler span on any
    thread, and no CUDA event even on a card timer (there is no card
    here, so one would raise); a host step (device=False) opens its
    profiler span and records no event either. A stage() on a thread
    other than the timer's opens nothing."""
    import threading
    from torch.profiler import profile
    timer = P.StageTimer("cuda")
    assert timer.on_card

    def worker():
        with P.host_stage("worker_host"), P.stage("worker_stage"):
            pass

    with profile() as prof, timer.active():
        with P.host_stage("main_host"):
            pass
        with P.stage("host_step", device=False):    # a span, no event
            pass
        t = threading.Thread(target=P.carry(worker))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    names = {e.name for e in prof.events()}
    assert not {"main_host", "worker_host", "worker_stage"} & names
    assert "host_step" in names
    assert dict(timer.calls) == {"main_host": 1, "worker_host": 1,
                                 "host_step": 1}
    assert not timer.events


def test_timer_defaults_to_the_card_only_where_there_is_one():
    import torch
    assert P.StageTimer().on_card == torch.cuda.is_available()
    assert not P.StageTimer("cpu").on_card



def test_add_bytes_reports_mb_as_ocrjax():
    """Bytes given to a stage show as its "mb" (MiB, to 0.01) in the
    report with calls, as in ocrjax's report; a stage without bytes has
    no "mb"; the module-level add_bytes feeds the active timer and does
    nothing without one."""
    from ocrjax.utils.profiling import StageTimer as JaxTimer
    ref = JaxTimer()
    timer = P.StageTimer("cpu")
    P.add_bytes("fused_fetch", 123)                    # no timer: dropped
    for stage, add in ((ref.stage, ref.add_bytes), (P.stage, P.add_bytes)):
        with timer.active():
            for n in (3 * 2**20, 5 * 2**19 + 7):
                with stage("fused_fetch"):
                    add("fused_fetch", n)
            with stage("host_decode"):
                pass
    got = timer.host_report(calls=True)
    want = ref.report()
    assert {k: set(v) for k, v in got.items()} == \
        {k: set(v) for k, v in want.items()}
    assert got["fused_fetch"]["mb"] == want["fused_fetch"]["mb"] == 5.5
    assert "mb" not in got["host_decode"]
    assert timer.bytes["fused_fetch"] == 3 * 2**20 + 5 * 2**19 + 7
    assert P.current() is None
