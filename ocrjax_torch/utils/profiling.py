"""Per-stage device timing with CUDA events.

Pipeline code wraps its stages in `stage(name)`, which does nothing unless
a StageTimer is active (`with timer.active():`). Then each stage records a
pair of CUDA events on the current stream and the host clock around it;
`report()` synchronizes once and sums the elapsed device time per stage
name, `host_report()` the host time (for host stages such as the tile plan
or the seam merge, where device time means nothing). Stages may nest (the
CCL inside box extraction).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

_active: Optional["StageTimer"] = None


class StageTimer:
    def __init__(self):
        self.events: Dict[str, List[Tuple[torch.cuda.Event,
                                          torch.cuda.Event]]] = \
            defaultdict(list)
        self.host: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            end.record()
            self.host[name] += (time.perf_counter() - t0) * 1e3
            self.events[name].append((start, end))

    @contextlib.contextmanager
    def active(self) -> Iterator["StageTimer"]:
        global _active
        prev, _active = _active, self
        try:
            yield self
        finally:
            _active = prev

    def report(self) -> Dict[str, float]:
        """Total device milliseconds per stage."""
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}

    def host_report(self) -> Dict[str, float]:
        """Total host milliseconds per stage."""
        return dict(self.host)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    if _active is None:
        yield
    else:
        with _active.stage(name):
            yield
