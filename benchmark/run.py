"""The benchmark of ocrjax_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name from BENCHMARK.json: its
configuration (configs/<config>.json: the OcrConfig as run and the assets,
each a file or drawn from a seed (lib/seeded.py), pinned by sha256), the
configuration's recognizer (reference/rec_<arch>.py by its
`ocr_config["rec_arch"]`, "crnn" where it names none; the interface is in
reference/recognizers.py), its traffic (traffic/<mix>.json, read by
lib/traffic.py or by the module the mix names), the limits of its check
(limits/<workload>.json) and its metrics (metrics/<metric>.py, each a
`read(record)`; the record carries the recognizer's parts' FLOPs and
bytes under "work"). The run builds the engine on the card, runs every
distinct call of the seed's call sequence (set-up: loading, kernel
builds, graph captures), then calls the entry in a closed loop with one
client for --seconds seconds. With --trace 1 the window is shorter
(TRACE_SECONDS at most) and runs under the program's StageTimer and
torch.profiler, and the per-layer metrics are reported. After the window
it reads the peak memory, frees the program, runs the plain reference
over the pages of one drawn occurrence of every distinct call and
compares (lib/check.py). The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error.

It needs a CUDA device and exits with 3 and no result without one, and
with 4 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# one intra-op thread during set-up: idle OpenMP workers spinning beside
# the captures slowed it (19-29 s against 13-16 s on an 8-core host of an
# H100); the window runs at the process's own count, as users run it
THREADS = torch.get_num_threads()
torch.set_num_threads(1)

from benchmark.lib import check, trace, traffic  # noqa: E402

TRACE_SECONDS = 6.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ocrjax")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def read_metric(name: str, record: Dict) -> Optional[float]:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    v = mod.read(record)
    return None if v is None else float(v)


def cell_metrics(bench: Dict, workload: str, section: str) -> List[Dict]:
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def asset_paths(conf: Dict, root: str = ROOT) -> Dict[str, str]:
    """The configuration's asset files, each checked against its pinned
    sha256; a changed file is refused. A seeded asset (lib/seeded.py) is
    written once into .bench_cache/assets/ and read from there."""
    from benchmark.lib import seeded
    from benchmark.reference.models import sha256
    out = {}
    for name, a in conf["assets"].items():
        if "path" in a:
            path = os.path.join(root, a["path"])
            seeded.check_pin(a["path"], sha256(path), a["sha256"])
            out[name] = path
    for name, a in conf["assets"].items():
        if "seed" in a:
            out[name] = seeded.asset(
                name, a, conf["ocr_config"], out["charset"],
                os.path.join(root, ".bench_cache", "assets"))
    return out


def ocr_config(conf: Dict, overrides: Optional[Dict] = None) -> Dict:
    """The program's OcrConfig values: the configuration's, with any
    overrides."""
    return dict(conf["ocr_config"], **(overrides or {}))


def build_engine(cfg: Dict, assets: Dict[str, str], device: str):
    """The engine from the pinned assets, as OcrEngine.from_pretrained
    builds it."""
    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.charset import Charset
    from ocrjax_torch.config import OcrConfig
    config = OcrConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items()})
    loaded = {n: W.read_safetensors(assets[n]) if n in assets else (None, {})
              for n in ("rec", "det", "cls", "det_tile")}
    arch = loaded["det_tile"][1].get("arch")
    eng = OcrEngine(config=config,
                    charset=Charset.from_file(assets["charset"]),
                    rec_weights=loaded["rec"][0],
                    det_weights=loaded["det"][0],
                    cls_weights=loaded["cls"][0], device=device,
                    tile_det_weights=loaded["det_tile"][0],
                    tile_det_arch=json.loads(arch) if arch else None)
    eng.cls_antisym = loaded["cls"][1].get("antisym") == "1"
    return eng


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", bench: Optional[Dict] = None,
             root: str = ROOT,
             program_hook=None, log=None) -> Dict:
    """One run of a cell -> the result object. program_hook(engine) may
    replace the engine's methods (the harness's fault tests)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = bench or load_json(root, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    conf = load_json(root, cfg_entry["file"])
    mix = traffic.load_mix(cell["traffic"])
    assets = asset_paths(conf, root)
    pages = traffic.load_pages(mix)
    seq = traffic.call_sequence(mix, len(pages), seed)
    distinct = list(dict.fromkeys(seq))
    cfg = ocr_config(conf)
    ref_cfg = SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in conf["ocr_config"].items()})
    from benchmark.lib.work import Work
    t_in = time.perf_counter()
    work = Work(ref_cfg, assets, mix, pages)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    t_work = time.perf_counter()
    engine = build_engine(cfg, assets, device)
    t_engine = time.perf_counter()
    if program_hook is not None:
        program_hook(engine)
    run = traffic.make_call(engine, mix, pages)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # set-up: every distinct call once (kernel builds, graph captures),
    # then the first few again (first replays)
    for call in distinct + distinct[:3]:
        run(call)
    sync()
    setup_s = time.perf_counter() - PROCESS_T0
    log(f"setup imports+data {t_in - PROCESS_T0:.2f} s, work count "
        f"{t_work - t_in:.2f} s, engine {t_engine - t_work:.2f} s, "
        f"{len(distinct)} distinct calls warmed "
        f"{setup_s - (t_engine - PROCESS_T0):.2f} s")

    window = min(seconds, TRACE_SECONDS) if traced else seconds
    # the check judges one occurrence of every distinct call, drawn from
    # the seed by reservoir sampling, so the window keeps one result a call
    rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    kept: Dict[int, list] = {}
    seen: Dict[int, int] = {}
    lines = 0
    calls = []
    timer = prof = None
    torch.set_num_threads(THREADS)
    if traced:
        from ocrjax_torch.utils.profiling import StageTimer
        from torch.profiler import ProfilerActivity, profile
        timer = StageTimer(device=device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        ctx = timer.active()
        ctx.__enter__()
    t0 = time.perf_counter()
    t0_ns = time.time_ns()
    deadline = t0 + window
    i = 0
    while True:
        k = i % len(seq)
        ts = time.perf_counter()
        out = run(seq[k])
        te = time.perf_counter()
        calls.append((k, ts, te))
        lines += sum(len(r.lines) for r in out)
        seen[k] = seen.get(k, 0) + 1
        if rng.integers(seen[k]) == 0:
            kept[k] = out
        i += 1
        if te >= deadline:
            break
    sync()
    t1_ns = time.time_ns()
    t_end = calls[-1][2]
    record: Dict = {"setup_s": setup_s, "window_s": t_end - t0,
                    "calls": len(calls),
                    "pages": sum(len(seq[k]) for k, _, _ in calls),
                    "lines": lines,
                    "latencies_ms": [(te - ts) * 1e3 for _, ts, te in calls],
                    "flops": sum(work.call_flops(seq[k]) for k, _, _ in calls),
                    "ccl_bytes": sum(work.call_ccl_bytes(seq[k])
                                     for k, _, _ in calls),
                    "work": work.window_parts([seq[k] for k, _, _ in calls])}
    breakdown = None
    if traced:
        ctx.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        record["device_ms"] = timer.report()
        record["host_ms"] = dict(timer.host)
        record["stage_bytes"] = dict(timer.bytes)
        summary = trace.summarize(prof, t0_ns, t1_ns)
        record["busy_s"] = summary["busy_s"]
        record["traced_s"] = (t1_ns - t0_ns) * 1e-9
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        del prof
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        raise SystemExit(4)

    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, section):
        v = read_metric(m["name"], record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if on_card else 0}
    if traced:
        dev["busy_s"] = record["busy_s"]
        dev["window_s"] = record["traced_s"]

    # the check: the program is freed first, then the reference runs
    prog_pages, page_idx = [], []
    for k in sorted(kept):
        if len(kept[k]) != len(seq[k]):
            raise RuntimeError(f"call {k} returned {len(kept[k])} results "
                               f"for {len(seq[k])} pages")
        prog_pages += [check.page_dict(r) for r in kept[k]]
        page_idx += list(seq[k])
    del engine, run, kept, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from benchmark.reference.pipeline import Reference
    t_ref = time.perf_counter()
    ref = Reference(conf["ocr_config"], assets, device)
    ref_by_page = traffic.reference_pages(ref, mix, pages,
                                          sorted(set(page_idx)), {})
    numbers = check.compare(prog_pages, [ref_by_page[i] for i in page_idx])
    ref_s = time.perf_counter() - t_ref
    limits = check.load_limits(workload)
    correct = check.judge(numbers, limits)
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    for k in ("ref_lines", "prog_lines", "pages"):
        log(f"check {k} {numbers[k]:g}")
    log(f"check reference_s {ref_s:.3f}")
    for k, v in limits.items():
        log(f"check {k} {numbers[k]!r} limit {v!r}")
    out = {"correct": bool(correct), "attempted": len(calls), "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["unlimited"] = {k: v for k, v in numbers.items() if k not in limits}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), bench=bench)
    print(json.dumps(out), flush=True)
    for k, c in out["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
