"""Per-stage timing and tracing (port of ocrjax/utils/profiling.py).

Pipeline code wraps its stages in `stage(name)`, which does nothing unless
a StageTimer is active (`with timer.active():`). Then each stage opens a
`torch.profiler.record_function(name)` span (so it is named in a
torch.profiler trace, as ocrjax's stages are in a jax trace), counts one
call and reads the host clock around it; on the card it also records a
pair of CUDA events on the current stream. `report()` synchronizes once
and sums the elapsed device time per stage name, `host_report()` the host
time (for host stages such as the tile plan or the seam merge, where
device time means nothing) and, with calls=True, ocrjax's report: total,
calls and mean per stage, and "mb" where add_bytes gave the stage bytes
(the fetch stages count what they copied to the host). Stages may nest
(the CCL inside box extraction). While a program is captured as CUDA
graphs (graphs.Program), a stage splits the capture instead, and its
events are recorded between the replays of the pieces. A host step (the
page's load, the pack, an upload, the wait on a fetch, the results'
assembly, the plan of recognition, a capture, a call) is a stage with
device=False: its profiler span and host clock, no CUDA events.

Calls. Each public entry of the engine is an `entry`: while a timer is
active, its call opens a stage named after the method and numbered 0, 1,
2, ... within the timer (a call made inside another, such as the tiled
lane's host fallback through recognize_strips, opens none). Every span
opened during the call carries the call's number.

Threads. The timer's stages belong to the thread that activated it; a
`stage()` on any other thread does nothing. Work that the pipeline hands
to its worker threads (the decode pool's pages, the tile-prep thread's
pages) is timed by `host_stage(name)`: host clock only, no CUDA event and
no profiler span (a span of a worker would name the main thread's idle
gaps in a trace), counted under a lock. Such a task is submitted as
`carry(fn)`, which binds it to the call that submits it.

The span log. While active, the timer keeps every span it timed in
`spans`: name, call, parent (the log index of the span it nests in on
its thread; a worker's outermost span nests in its call's span), native
thread id, start and end on time.time_ns()'s clock, which is
torch.profiler's, and whether it was a host_stage. A span reads the clock
once at each end: time.perf_counter_ns() plus its offset to
time.time_ns() when the timer was made, so a span's length is the host
time that the totals sum and a nested span lies inside its parent.
device_trace writes the worker spans into its Chrome trace from this log,
and each stage's call. The log grows by one entry a span while the timer
is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch

NOT_MEASURED = "not measured"

_active: Optional["StageTimer"] = None
# the capture (graphs._Tape) that a thread is making, if any
_capture_hook = None
# on a worker thread, while it runs a carry()'d task: .task, the
# (timer, call) the task was submitted from
_worker = threading.local()


def set_capture_hook(tape) -> None:
    global _capture_hook
    _capture_hook = tape


def _on_card(device: Optional[str]) -> bool:
    """Whether `device` is the card; None: the card where there is one."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@dataclasses.dataclass(slots=True)
class Span:
    """One timed span of the log (see the module's docstring)."""
    name: str
    call: Optional[int]
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: Optional[int] = None      # None while the span is open
    host_only: bool = False


class StageTimer:
    """device: "cuda" times each stage with CUDA events besides the host
    clock, "cpu" with the host clock only (default: the card where there
    is one). One timer per timed window.

    Thread safety: `stage` and `call` belong to the thread that activated
    the timer (the module-level stage() and entry route only that
    thread's to them); `host_stage` and `add_bytes` are safe from any
    thread. Read the reports and `spans` after the window."""

    def __init__(self, device: Optional[str] = None):
        self.on_card = _on_card(device)
        self.events: Dict[str, List[Tuple[torch.cuda.Event,
                                          torch.cuda.Event]]] = \
            defaultdict(list)
        self.host: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)
        self.spans: List[Span] = []
        # perf_counter_ns() + offset: time.time_ns()'s clock
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.n_calls = 0                  # calls numbered so far
        self._lock = threading.Lock()
        # .open: the thread's open spans, .tid: its native id
        self._threads = threading.local()
        self._owner: Optional[int] = None  # the thread that activated it
        self._call: Optional[int] = None   # the owner's open call
        self._call_span: Dict[int, int] = {}   # call -> its span's index

    def add_bytes(self, name: str, nbytes: int) -> None:
        """Attribute bytes moved between host and card to a stage: a slow
        window that fetched few MB waited on something else than its
        payload."""
        with self._lock:
            self.bytes[name] += int(nbytes)

    def _thread(self) -> threading.local:
        th = self._threads
        if not hasattr(th, "open"):
            th.open, th.tid = [], threading.get_native_id()
        return th

    def _open(self, name: str, call: Optional[int], host_only: bool) -> int:
        th = self._thread()
        t0 = time.perf_counter_ns() + self.offset_ns
        with self._lock:
            parent = th.open[-1] if th.open else self._call_span.get(call)
            idx = len(self.spans)
            self.spans.append(Span(name, call, parent, th.tid, t0,
                                   host_only=host_only))
        th.open.append(idx)
        return idx

    def _close(self, idx: int) -> None:
        t1 = time.perf_counter_ns() + self.offset_ns
        self._threads.open.pop()
        with self._lock:
            span = self.spans[idx]
            span.end_ns = t1
            self.host[span.name] += (t1 - span.start_ns) * 1e-6
            self.calls[span.name] += 1

    @contextlib.contextmanager
    def stage(self, name: str, device: bool = True) -> Iterator[None]:
        """device=False: a host step (no CUDA events; each pair costs
        ~40 us of host on the card)."""
        # the log's bookkeeping stays outside the pair of events: on an
        # idle card the events time the host between them too
        on_card = self.on_card and device
        with torch.profiler.record_function(name):
            idx = self._open(name, self._call, False)
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            try:
                yield
            finally:
                if on_card:
                    end.record()
                    self.events[name].append((start, end))
                self._close(idx)

    @contextlib.contextmanager
    def host_stage(self, name: str, call: Optional[int] = None
                   ) -> Iterator[None]:
        """A stage on the host clock alone, safe from any thread: no CUDA
        event, no profiler span. `call`: the call the work was submitted
        from."""
        idx = self._open(name, call, True)
        try:
            yield
        finally:
            self._close(idx)

    @contextlib.contextmanager
    def call(self, name: str) -> Iterator[None]:
        """The stage of one call of the engine, numbered; inside an open
        call it opens nothing."""
        if self._call is not None:
            yield
            return
        self._call = self.n_calls
        self.n_calls += 1
        try:
            with self.stage(name, device=False):
                self._call_span[self._call] = self._threads.open[-1]
                yield
        finally:
            self._call = None

    @contextlib.contextmanager
    def active(self) -> Iterator["StageTimer"]:
        global _active
        prev, _active = _active, self
        prev_owner, self._owner = self._owner, threading.get_ident()
        try:
            yield self
        finally:
            _active = prev
            self._owner = prev_owner

    def report(self) -> Dict[str, Union[float, str]]:
        """Total device milliseconds per stage. A timer off the card reads
        the host clock only: each of its stages says "not measured"."""
        if not self.on_card:
            return {name: NOT_MEASURED for name in self.host}
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}

    def host_report(self, calls: bool = False) -> Dict:
        """Total host milliseconds per stage (a host_stage's summed over
        its threads); with calls, ocrjax's report instead: per stage, in
        name order, {"total_ms", "calls", "mean_ms"} rounded to 0.01 ms,
        and "mb" (MiB, to 0.01) for a stage with bytes."""
        if not calls:
            return dict(self.host)
        out = {}
        for name in sorted(self.host):
            entry = {"total_ms": round(self.host[name], 2),
                     "calls": self.calls[name],
                     "mean_ms": round(self.host[name]
                                      / max(self.calls[name], 1), 2)}
            if name in self.bytes:
                entry["mb"] = round(self.bytes[name] / 2**20, 2)
            out[name] = entry
        return out


def _owned() -> Optional[StageTimer]:
    """The active timer where this thread activated it, else None."""
    t = _active
    if t is None or t._owner != threading.get_ident():
        return None
    return t


@contextlib.contextmanager
def stage(name: str, device: bool = True) -> Iterator[None]:
    """The active timer's stage on its own thread (device=False: a host
    step, no CUDA events); a split of the capture this thread makes;
    nothing otherwise."""
    hook = _capture_hook
    if hook is not None and hook.thread == threading.get_ident():
        with hook.stage(name):
            yield
        return
    t = _owned()
    if t is None:
        yield
    else:
        with t.stage(name, device):
            yield


def entry(fn: Callable) -> Callable:
    """A public entry of the engine: while a timer is active, its call
    opens the call's stage, named after the method, unless a call is
    already open."""
    name = fn.__name__

    @functools.wraps(fn)
    def run(*args, **kw):
        t = _owned()
        if t is None or t._call is not None:
            return fn(*args, **kw)
        with t.call(name):
            return fn(*args, **kw)
    return run


def _task() -> Optional[Tuple[StageTimer, Optional[int]]]:
    """(timer, call) of the work this thread runs now, None without a
    timer."""
    task = getattr(_worker, "task", None)
    if task is not None:
        return task
    t = _active
    if t is None:
        return None
    return t, (t._call if t._owner == threading.get_ident() else None)


def carry(fn: Callable) -> Callable:
    """fn bound to the call running on this thread, for another thread to
    run: its host_stage spans carry that call. fn itself without a
    timer."""
    task = _task()
    if task is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kw):
        prev = getattr(_worker, "task", None)
        _worker.task = task
        try:
            return fn(*args, **kw)
        finally:
            _worker.task = prev
    return run


@contextlib.contextmanager
def host_stage(name: str) -> Iterator[None]:
    """The active timer's host_stage, on any thread, for the call the
    running task came from; nothing without a timer."""
    task = _task()
    if task is None:
        yield
    else:
        with task[0].host_stage(name, task[1]):
            yield


def current() -> Optional[StageTimer]:
    """The active timer, None when there is none."""
    return _active


def add_bytes(name: str, nbytes: int) -> None:
    """The active timer's add_bytes; nothing without an active timer."""
    if _active is not None:
        _active.add_bytes(name, nbytes)


def _add_spans_to_trace(path: str, timer: StageTimer) -> None:
    """Completes a Chrome trace that torch.profiler wrote while `timer`
    was active: each stage event gets args.call from the span log (the
    events of a name pair in order with the last of its logged stages),
    and each host_stage span becomes an event on its own thread's row, at
    (start_ns - baseTimeNanoseconds) / 1000 microseconds, the trace's
    clock."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace["traceEvents"]
    pid = os.getpid()
    spans = [s for s in timer.spans if s.end_ns is not None]
    logged = defaultdict(list)
    for s in spans:
        if not s.host_only:
            logged[s.name].append(s)
    traced = defaultdict(list)
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e.get("name") in logged):
            traced[e["name"]].append(e)
    for name, evs in traced.items():
        evs.sort(key=lambda e: e["ts"])
        # a timer active before the profiler started logged more
        for e, s in zip(evs, logged[name][-len(evs):]):
            if s.call is not None:
                e.setdefault("args", {})["call"] = s.call
    names = {t.native_id: t.name for t in threading.enumerate()}
    rows = set()
    for s in spans:
        if s.host_only:
            events.append({"ph": "X", "cat": "host_stage", "name": s.name,
                           "pid": pid, "tid": s.thread,
                           "ts": (s.start_ns - base) / 1e3,
                           "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": {"call": s.call}})
            rows.add(s.thread)
    named = {e.get("tid") for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for tid in sorted(rows - named):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": names.get(
                           tid, f"thread {tid}")}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(out_dir: str, device: Optional[str] = None
                 ) -> Iterator[None]:
    """torch.profiler over the block, its Chrome trace written to
    out_dir/ocrjax_torch.<pid>.trace.json (the CLI's --profile). CUDA
    activity is traced where `device` is the card (default: where there is
    one), host activity always. Without an active timer a host-clock
    StageTimer is active over the block (the profiler times the device),
    so the trace names every stage and call; after export the trace gains
    the timer's worker spans and each stage's call (_add_spans_to_trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if _on_card(device) else [])
    timer = _active or StageTimer("cpu")
    own = contextlib.nullcontext() if _active is not None else timer.active()
    with profile(activities=acts) as prof, own:
        yield
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"ocrjax_torch.{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    _add_spans_to_trace(path, timer)
