"""The bench entry point (port of the root bench.py): one JSON line with the
headline metric.

    python -m ocrjax_torch.bench_main

Runs bench_lib.run_bench(pages=96, lines=256, repeats=3) on the card over
the committed traffic, writes the full report to BENCH_DETAIL_TORCH.json
at the repository root and prints one line: the median e2e window's
pages/s (metric pages_per_sec_per_chip_e2e_median), every window, the
device-resident pages/s, p50 page latency, crops/s and the dense C5
numbers, and the host link's probe (link_probe), as the reference's
record does. A watchdog thread bounds the run (OCRJAX_BENCH_DEADLINE_S,
default 1800 s): past it, the best completed window with an `error` (exit
0), or a zero record (exit 3) when no window completed. No record carries
a comparison with a TPU target; a degraded record carries the last
completed run of this port (BENCH_DETAIL_TORCH.json) as context, never as
its value.
"""

from __future__ import annotations

import json
import os
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETAIL = os.path.join(ROOT, "BENCH_DETAIL_TORCH.json")

# live progress shared with the watchdog: run_bench appends each measured
# e2e window and the section metrics as they complete
_progress = {"windows": [], "partial": {}, "done": False}


def _prior_hardware_run():
    """A summary of the last completed run (BENCH_DETAIL_TORCH.json), or
    None."""
    try:
        with open(DETAIL) as f:
            d = json.load(f)
        return {
            "file": os.path.relpath(DETAIL, ROOT),
            "mtime": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                   time.gmtime(os.path.getmtime(DETAIL))),
            "device": d.get("device"),
            "pages_per_sec": round(d.get("pages_per_sec", 0.0), 1),
            "pages_per_sec_median": round(
                d.get("pages_per_sec_median", 0.0), 1),
            "pages_per_sec_device": round(
                d.get("pages_per_sec_device", 0.0), 1),
            "crops_per_sec": round(d.get("crops_per_sec", 0.0), 0),
        }
    except (OSError, ValueError, AttributeError):
        return None


def _watchdog(deadline_s: float):
    """Past the deadline: print the best completed window with an error
    and exit 0, or an error record and exit 3; return quietly once the run
    is done."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        time.sleep(min(5.0, deadline_s))
        if _progress["done"]:
            return
    if _progress["windows"]:
        rec = {
            "metric": "pages_per_sec_per_chip_e2e_peak_sustained",
            "value": round(max(_progress["windows"]), 2),
            "unit": "pages/s",
            "windows": [round(v, 1) for v in _progress["windows"]],
            "error": "bench deadline hit mid-run; value = best completed "
                     "window",
        }
        rec.update(_progress["partial"])
        code = 0
    else:
        rec = {
            "metric": "pages_per_sec_per_chip_e2e_peak_sustained",
            "value": 0.0, "unit": "pages/s",
            "error": "device unreachable: start-up or the first window did "
                     "not complete within the deadline",
        }
        code = 3
    prior = _prior_hardware_run()
    if prior:
        rec["prior_hardware_run"] = prior
    print(json.dumps(rec), flush=True)
    os._exit(code)


def main() -> None:
    threading.Thread(
        target=_watchdog,
        args=(float(os.environ.get("OCRJAX_BENCH_DEADLINE_S", 1800.0)),),
        daemon=True).start()
    from ocrjax_torch.bench_lib import run_bench

    # 96 pages: six 16-page fused chunks, the host decode of chunk k+1
    # overlapping the device work of chunk k
    report = run_bench(pages=96, lines=256, repeats=3, progress=_progress)
    _progress["done"] = True
    with open(DETAIL, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({
        "metric": "pages_per_sec_per_chip_e2e_median",
        "value": round(report["pages_per_sec_median"], 2),
        "unit": "pages/s",
        "device": report["device"],
        "peak_pages_per_sec": round(report["pages_per_sec"], 1),
        "device_pages_per_sec": round(report["pages_per_sec_device"], 1),
        "fused_windows": report["pages_per_sec_fused_windows"],
        "bucketed_windows": report["pages_per_sec_bucketed_windows"],
        "p50_page_latency_ms": round(report["p50_page_latency_ms"], 1),
        "crops_per_sec": round(report["crops_per_sec"], 0),
        "dense_pages_per_sec": round(report["dense_pages_per_sec"], 2),
        "dense_lines_per_sec": round(report["dense_lines_per_sec"], 0),
        "dense_pages_per_sec_device": round(
            report["dense_pages_per_sec_device"], 2),
        # the link's state at the run's start: read the e2e numbers
        # against it
        "link_probe": report["link_probe"],
    }), flush=True)


if __name__ == "__main__":
    main()
