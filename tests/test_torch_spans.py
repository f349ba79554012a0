"""The port's spans on the CPU: a span a call at the engine's entries,
the host steps' spans, the worker threads' host stages and the span log
(ocrjax_torch.utils.profiling), the lanes' lookahead (preprocess.lookahead)
and its spans, the Chrome trace that device_trace writes with no timer of
the caller's, the stage marks inside the fused and pooled programs (which
split a capture, so they must not change), and the benchmark's readers of
the new spans."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from ocrjax_torch import api_det, graphs, preprocess
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.charset import Charset
from ocrjax_torch.train import synth
from ocrjax_torch.utils import profiling as P
from test_torch_fixture import few_torch_threads  # noqa: F401
from test_torch_graphs import StandInBackend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256


@pytest.fixture(scope="module")
def pages():
    cs = Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    out = []
    for seed in (11, 12, 13):
        g = synth.render_page(np.random.RandomState(seed), cs,
                              size=(SIZE, SIZE), n_lines=(2, 4),
                              text_height=(18, 26))[0]
        out.append(np.repeat(g[..., None], 3, 2))
    return out


@pytest.fixture(scope="module")
def big_page():
    """A page larger than the canvas: the pooled lane recognizes it from
    full-resolution crops through recognize_strips."""
    cs = Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    g = synth.render_page(np.random.RandomState(21), cs,
                          size=(SIZE + 64, SIZE + 64), n_lines=(2, 3),
                          text_height=(20, 26))[0]
    return np.repeat(g[..., None], 3, 2)


def _engine():
    cfg = asset_config(det_max_side=SIZE, compute_dtype="float32",
                       fused_chunk_pages=2)
    return OcrEngine.from_pretrained(config=cfg, device="cpu")


@pytest.fixture(scope="module")
def eng():
    return _engine()


def _encloses(outer, inner) -> bool:
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


# ------------------------------------------------- (a) calls and parents --

def test_each_call_spans_its_work_with_its_id(eng, pages, big_page):
    """Two calls: the fused lane (decode on the worker threads) and the
    pooled lane on a downscaled page (its crops go through
    recognize_strips inside the call, which opens no call span). Every
    span carries its call's id and nests in its parent: the innermost
    span of its thread that encloses it, else its call's span."""
    timer = P.StageTimer("cpu")
    with timer.active():
        eng.ocr_batch(pages, fused=True)
        eng.ocr_batch([big_page])
    spans = timer.spans
    assert timer.n_calls == 2
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [(spans[i].name, spans[i].call) for i in roots] == \
        [("ocr_batch", 0), ("ocr_batch", 1)]
    names = {s.name for s in spans}
    assert "recognize_strips" not in names
    assert {"decode", "decode_submit", "lookup", "pack", "upload",
            "assemble", "rec_plan", "host_decode", "fused_dispatch",
            "det_dispatch", "crnn"} <= names
    assert all(s.end_ns is not None for s in spans)
    main = spans[roots[0]].thread
    workers = {s.thread for s in spans if s.name == "decode"}
    assert workers and main not in workers
    assert all(s.host_only == (s.name == "decode") for s in spans)
    for i, s in enumerate(spans):
        if i in roots:
            continue
        call = roots[s.call]
        assert s.call in (0, 1) and _encloses(spans[call], s)
        inner = [j for j in range(i) if spans[j].thread == s.thread
                 and spans[j].call == s.call and j not in roots
                 and _encloses(spans[j], s)]
        assert s.parent == (inner[-1] if inner else call), (i, s)
    # the downscaled page's crops are recognized inside call 1
    assert {(s.call, spans[s.parent].name) for s in spans
            if s.name == "crnn"} == {(0, "fused_dispatch"), (1, "ocr_batch")}
    assert {s.call for s in spans if s.name == "assemble"} == {0, 1}


def test_entries_number_their_calls_and_load_inside_them(eng, pages):
    assert P.current() is None
    eng.ocr(pages[0])
    timer = P.StageTimer("cpu")
    with timer.active():
        eng.ocr(pages[0])
        eng.detect(pages[1])
        eng.recognize(pages[2][:40, :120])
    spans = timer.spans
    assert [(s.name, s.call) for s in spans if s.parent is None] \
        == [("ocr", 0), ("detect", 1), ("recognize", 2)]
    # each entry loads its page inside its own span
    assert [(s.call, spans[s.parent].name) for s in spans
            if s.name == "load_image"] == \
        [(0, "ocr"), (1, "detect"), (2, "recognize")]


@pytest.mark.parametrize("form", ["luma", "rgb"])
def test_luma_lanes_load_once_inside_their_call(eng, pages, form):
    """ocr()'s fused path and detect_tiled load a 2-D page, kept 2-D, as
    they load its RGB stack: one load_image span a call, inside it. The
    tiled batch loads on its prep thread, inside tile_prep_work."""
    page = pages[0][..., 0] if form == "luma" else pages[0]
    timer = P.StageTimer("cpu")
    with timer.active():
        eng.ocr(page)
        eng.detect_tiled(page)
        eng.ocr_tiled_batch([page])
    spans = timer.spans
    assert [(s.call, spans[s.parent].name) for s in spans
            if s.name == "load_image"] == [(0, "ocr"), (1, "detect_tiled")]
    assert [(s.call, s.host_only) for s in spans
            if s.name == "tile_prep_work"] == [(2, True)]


# ---------------------------------------------- (c) the lanes' lookahead --

def test_lookahead_runs_the_next_item_while_the_caller_holds_this_one():
    """preprocess.lookahead: item k + 1's work runs, on one thread apart
    from the caller's and the decode pool's, while the caller holds item
    k; the caller's wait is a stage an item, and so is each submit."""
    started = [threading.Event() for _ in range(4)]
    threads = set()

    def work(k):
        threads.add(threading.current_thread())
        started[k].set()
        return k * k

    for submit in ("decode_submit", None):
        timer = P.StageTimer("cpu")
        got = []
        with timer.active():
            for k, out in enumerate(preprocess.lookahead(
                    work, range(4), "host_decode", submit)):
                got.append(out)
                if k + 1 < 4:
                    assert started[k + 1].wait(10), k
        assert got == [0, 1, 4, 9]
        want = ["host_decode"] if submit is None else [submit,
                                                       "host_decode"]
        assert [s.name for s in timer.spans] == want * 4
        for e in started:
            e.clear()
    t, = threads
    assert t is not threading.current_thread()
    assert not t.name.startswith("ocrjax_torch-decode")


@pytest.mark.parametrize("lane", ["bucketed", "fused", "tiled"])
def test_the_lanes_lookahead_spans(eng, pages, lane):
    """Each lane's wait for its lookahead, a stage a chunk (a page in the
    tiled lane), follows its submit where the lane has one, on the
    caller's thread; the work runs on other threads."""
    run = {"bucketed": lambda: eng.ocr_batch(pages),
           "fused": lambda: eng.ocr_batch(pages, fused=True),
           "tiled": lambda: eng.ocr_tiled_batch(pages)}[lane]
    timer = P.StageTimer("cpu")
    with timer.active():
        run()
    spans = timer.spans
    main = spans[0].thread
    pipe = [s.name for s in spans if s.thread == main and s.name in
            ("decode_submit", "host_decode", "tile_prep")]
    work = [s for s in spans if s.name in ("decode", "tile_prep_work")]
    if lane == "tiled":
        assert pipe == ["tile_prep"] * len(pages)
        assert {s.name for s in work} == {"tile_prep_work"}
        assert len({s.thread for s in work}) == 1
    else:                       # chunks of 2 pages
        assert pipe == ["decode_submit", "host_decode"] * 2
        assert {s.name for s in work} == {"decode"}
    assert len(work) == len(pages) and main not in {s.thread for s in work}


# ------------------------------------------------- (d) the operator trace --

def test_device_trace_without_a_timer_names_calls_and_workers(
        tmp_path, eng, pages):
    """device_trace with no timer of the caller's: the stages are in the
    trace with their call ids, and each decode span sits on its worker's
    row inside its call's span on the trace's clock."""
    assert P.current() is None
    with P.device_trace(str(tmp_path), "cpu"):
        eng.ocr_batch(pages, fused=True)
        eng.ocr_batch(pages[:2], fused=True)
    assert P.current() is None
    path, = glob.glob(str(tmp_path / "*.json"))
    events = json.load(open(path))["traceEvents"]
    stages = [e for e in events if e.get("cat") == "user_annotation"]
    calls = sorted((e for e in stages if e["name"] == "ocr_batch"),
                   key=lambda e: e["ts"])
    assert [e["args"]["call"] for e in calls] == [0, 1]
    for name in ("fused_dispatch", "det_forward", "pack", "upload",
                 "assemble", "host_decode"):
        got = [e for e in stages if e["name"] == name]
        assert got and {e["args"]["call"] for e in got} == {0, 1}, name
    for e in stages:
        c = calls[e["args"]["call"]]
        assert c["ts"] <= e["ts"] + 1 and \
            e["ts"] + e["dur"] <= c["ts"] + c["dur"] + 1, e["name"]
    main = calls[0]["tid"]
    decodes = [e for e in events if e.get("cat") == "host_stage"]
    assert len(decodes) == 5 and {e["name"] for e in decodes} == {"decode"}
    rows = {e["tid"] for e in decodes}
    assert main not in rows
    named = {e["tid"] for e in events if e.get("ph") == "M"
             and e.get("name") == "thread_name"}
    assert rows <= named
    for e in decodes:
        c = calls[e["args"]["call"]]
        assert c["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= c["ts"] + c["dur"], e


# ---------------------------------------- (e) the programs' stage marks --

# the stage marks that split each program's capture and its graphs a
# replay, as they were before the call spans and the host steps' spans
# (the fused lane's one program, 13 graphs, is two since its recognition
# runs on the occupied slots alone: 9 and 5 graphs at one pass)
PROGRAM_MARKS = {
    "fused": [(("det_forward", "extract_boxes", "ccl", "warp_refine"), 9)],
    "fused_rec": [(("crnn", "ctc"), 5)],
    "det": [(("det_forward", "extract_boxes", "ccl"), 7)],
    "truncate_tokens": [((), 1)],
    "truncate_det": [((), 1)],
    "gray_norm": [((), 1)],
    "rec_chunk": [(("warp_refine", "crnn", "ctc"), 7)],
}


def _marks(programs) -> dict:
    out = {}
    for p in programs:
        for e in p.entries.values():
            enters = tuple(it[1] for it in e.tape.items if it[0] == "enter")
            out.setdefault(p.name, []).append((enters, e.tape.n_graphs))
    return {k: sorted(set(v)) for k, v in out.items()}


def test_the_programs_stage_marks_are_unchanged(monkeypatch, pages):
    monkeypatch.setitem(graphs.BACKENDS, "cpu", StandInBackend())
    e = _engine()
    shared = api_det.truncate_det_program       # held by the module
    before = len(shared.entries)
    timer = P.StageTimer("cpu")
    with timer.active():
        e.ocr_batch(pages, fused=True)     # captures under the timer
        e.ocr_batch(pages)
        e.ocr_batch(pages, fused=True)     # replays
    got = _marks(list(graphs.all_programs(e)) + [shared])
    assert got == PROGRAM_MARKS
    # a capture is a stage of its own, outside the program it captures
    assert timer.calls["graph_capture"] == sum(
        len(p.entries) for p in graphs.all_programs(e)) + len(
            shared.entries) - before
    caps = [s for s in timer.spans if s.name == "graph_capture"]
    assert all(timer.spans[s.parent].name != "graph_capture" for s in caps)


# ------------------------------------------------ (f) the metric readers --

def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "span_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


RECORD = {"pages": 64, "calls": 8, "host_ms": {
    "decode": 96.0, "tile_prep_work": 320.0, "fetch_wait": 16.0,
    "load_image": 10.0, "assemble": 6.0, "host_decode": 5.0}}


@pytest.mark.parametrize("name, want, stages", [
    ("decode_busy_ms_per_page", 1.5, ["decode"]),
    ("tile_prep_busy_ms_per_page", 5.0, ["tile_prep_work"]),
    ("fetch_wait_ms_per_page", 0.25, ["fetch_wait"]),
    ("api_host_ms.single", 2.0, ["load_image", "assemble"]),
])
def test_span_metric_readers(name, want, stages):
    read = _reader(name)
    assert read(RECORD) == pytest.approx(want)
    without = dict(RECORD, host_ms={k: v for k, v in RECORD["host_ms"].items()
                                    if k not in stages})
    assert read(without) is None
    assert read(dict(RECORD, host_ms=None)) is None
    if len(stages) > 1:      # one of the two stages alone still reads
        one = dict(RECORD, host_ms={stages[0]: 8.0})
        assert read(one) == pytest.approx(1.0)


def test_stage_is_a_global_check_without_a_timer():
    """What an untraced run pays a span: nothing is recorded
    and no profiler span opens."""
    assert P.current() is None
    with torch.profiler.profile() as prof:
        with P.stage("x"), P.host_stage("y"):
            pass
    assert not {"x", "y"} & {e.name for e in prof.events()}
