"""Reading a torch.profiler trace of the card: the seconds in which an
operation ran on the device, the operations that took most time, and the
idle gaps, each named by the innermost host span (a `record_function`
span: the program's StageTimer opens one a stage) open across its
middle."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple


def _events(prof):
    return prof.profiler.kineto_results.events()


def device_intervals(prof) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of every kernel, copy and set on the card
    (the device-side copies of host annotations excluded)."""
    out = []
    for e in _events(prof):
        if e.device_type().name != "CUDA" or e.is_user_annotation():
            continue
        s = e.start_ns()
        out.append((s, s + max(e.duration_ns(), 0), e.name()))
    out.sort()
    return out


def host_spans(prof) -> List[Tuple[int, int, str]]:
    out = []
    for e in _events(prof):
        if e.device_type().name == "CPU" and e.is_user_annotation():
            s = e.start_ns()
            out.append((s, s + e.duration_ns(), e.name()))
    return out


def summarize(prof, t0_ns: int, t1_ns: int, top: int = 10) -> Dict:
    """busy_s (the union of device intervals inside [t0, t1]), the device
    operations by total time, the idle gaps by host stage."""
    ivs = [(max(s, t0_ns), min(e, t1_ns), n)
           for s, e, n in device_intervals(prof) if e > t0_ns and s < t1_ns]
    by_op = defaultdict(float)
    merged: List[List[int]] = []
    for s, e, n in ivs:
        by_op[n] += (e - s) * 1e-9
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = []
    prev = t0_ns
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    spans = sorted(host_spans(prof))
    starts = [s for s, _, _ in spans]
    longest = max((e - s for s, e, _ in spans), default=0)
    by_gap = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        name, best = "no stage", None
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, e, n = spans[k]
            if s <= mid < e and (best is None or e - s < best):
                name, best = n, e - s
            if mid - s > longest:
                break
        by_gap[name] += (g1 - g0) * 1e-9
    rank = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy, "device_ops": rank(by_op),
            "idle_gaps": rank(by_gap), "n_device_ops": len(ivs)}
