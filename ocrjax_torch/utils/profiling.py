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
calls and mean per stage. Stages may nest (the CCL inside box extraction).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch

NOT_MEASURED = "not measured"

_active: Optional["StageTimer"] = None


def _on_card(device: Optional[str]) -> bool:
    """Whether `device` is the card; None: the card where there is one."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


class StageTimer:
    """device: "cuda" times each stage with CUDA events besides the host
    clock, "cpu" with the host clock only (default: the card where there
    is one). One timer per timed window; not thread-safe."""

    def __init__(self, device: Optional[str] = None):
        self.on_card = _on_card(device)
        self.events: Dict[str, List[Tuple[torch.cuda.Event,
                                          torch.cuda.Event]]] = \
            defaultdict(list)
        self.host: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        with torch.profiler.record_function(name):
            if self.on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.on_card:
                    end.record()
                    self.events[name].append((start, end))
                self.host[name] += (time.perf_counter() - t0) * 1e3
                self.calls[name] += 1

    @contextlib.contextmanager
    def active(self) -> Iterator["StageTimer"]:
        global _active
        prev, _active = _active, self
        try:
            yield self
        finally:
            _active = prev

    def report(self) -> Dict[str, Union[float, str]]:
        """Total device milliseconds per stage. A timer off the card reads
        the host clock only: each of its stages says "not measured"."""
        if not self.on_card:
            return {name: NOT_MEASURED for name in self.host}
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}

    def host_report(self, calls: bool = False) -> Dict:
        """Total host milliseconds per stage; with calls, ocrjax's report
        instead: per stage, in name order, {"total_ms", "calls",
        "mean_ms"} rounded to 0.01 ms."""
        if not calls:
            return dict(self.host)
        return {name: {"total_ms": round(self.host[name], 2),
                       "calls": self.calls[name],
                       "mean_ms": round(self.host[name]
                                        / max(self.calls[name], 1), 2)}
                for name in sorted(self.host)}


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    if _active is None:
        yield
    else:
        with _active.stage(name):
            yield


@contextlib.contextmanager
def device_trace(out_dir: str, device: Optional[str] = None
                 ) -> Iterator[None]:
    """torch.profiler over the block, its Chrome trace written to
    out_dir/ocrjax_torch.<pid>.trace.json (the CLI's --profile). CUDA
    activity is traced where `device` is the card (default: where there is
    one), host activity always."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if _on_card(device) else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out_dir, f"ocrjax_torch.{os.getpid()}.trace.json"))
