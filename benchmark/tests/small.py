"""A small copy of the benchmark for the CPU tests: the benchmark folder
copied into a temporary root beside the asset files, with cells of the
same lanes on crops of the committed pages at a 480-pixel canvas (tiles of
512 for the tiled lane), float32, and runs of it in a child process that
imports the copy."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")
SMALL = dict(det_max_side=480, compute_dtype="float32", tile_size=512,
             tile_overlap=64)
CELLS = {"small-batch": ("batch", "pooled", "ocr_batch", {}),
         "small-fused": ("batch", "fused", "ocr_batch", {"fused": True}),
         "small-single": ("single", "fused", "ocr", {}),
         "small-tiled": ("tiled", "tiled", "ocr_tiled_batch", {})}


# 480 x 480 crops of committed pages that hold 4 whole lines each
CROPS = ((93, 480, 480), (90, 0, 0), (87, 0, 480), (67, 0, 0))


def _crop_lines(quads, counts, page, y0, x0, n=480):
    cut = np.concatenate([[0], np.cumsum(counts)])
    q = quads[cut[page]:cut[page + 1]] - np.array([x0, y0], np.float32)
    keep = (q.min(axis=(1, 2)) >= 0) & (q.max(axis=(1, 2)) < n)
    return q[keep].tolist()


def make_root(tmp: str) -> str:
    """-> the temporary root, holding BENCHMARK.json, benchmark/ and
    assets/ (links to the repo's files)."""
    root = os.path.join(tmp, "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "assets"), os.path.join(root, "assets"))
    data = os.path.join(root, "benchmark", "data")
    with np.load(os.path.join(data, "bench_traffic.npz")) as z:
        pages = np.stack([z["pages"][p, y:y + 480, x:x + 480]
                          for p, y, x in CROPS])
        lines = [_crop_lines(z["page_quads"], z["page_line_counts"], *c)
                 for c in CROPS]
    with np.load(os.path.join(data, "c5_pages.npz")) as z:
        a4 = np.ascontiguousarray(z["dense"][:400, :1100])
    c5 = json.load(open(os.path.join(data, "c5_lines.json")))["dense"]
    a4_lines = [q for q in c5 if np.max(q) < 400 and
                max(p[0] for p in q) < 1100]
    np.savez(os.path.join(data, "small_pages.npz"), pages=pages, a4=a4)
    json.dump({"pages": lines, "a4": [a4_lines]},
              open(os.path.join(data, "small_lines.json"), "w"))
    draws = {"batch": (["pages"], dict(draw="permutation",
                                       pages_per_call=2)),
             "single": (["pages"], dict(draw="permutation",
                                        pages_per_call=1)),
             "tiled": (["a4"], dict(draw="shuffle", call_pages=[0, 0],
                                    calls=2))}
    for cell, (kind, lane, entry, kw) in CELLS.items():
        keys, draw = draws[kind]
        mix = dict(entry=entry, kwargs=kw, lane=lane,
                   arg="page" if entry == "ocr" else "pages",
                   source=dict(file="small_pages.npz", keys=keys,
                               lines=dict(file="small_lines.json")),
                   **draw)
        json.dump(mix, open(os.path.join(
            root, "benchmark", "traffic", f"{cell}.json"), "w"))
        json.dump({"limits": {"lines_off": 0.0}}, open(os.path.join(
            root, "benchmark", "limits", f"{cell}.json"), "w"))
    for name in ("page960", "a4_300dpi"):
        path = os.path.join(root, "benchmark", "configs", f"{name}.json")
        conf = json.load(open(path))
        conf["ocr_config"].update(SMALL)
        json.dump(conf, open(os.path.join(
            root, "benchmark", "configs", f"small_{name}.json"), "w"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    bench["configs"] = [dict(c, name="small_" + c["name"], file=(
        "benchmark/configs/small_" + c["name"] + ".json"))
        for c in bench["configs"]]
    bench["workloads"] = [dict(name=cell, config="small_" + (
        "a4_300dpi" if k == "tiled" else "page960"), traffic=cell, chips=1,
        why="CPU test") for cell, (k, *_) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"),
              indent=1)
    return root


def run(root: str, workload: str, seed: int = 7, seconds: float = 0.5,
        trace: int = 0, fault: str = None, extra: str = "") -> Dict:
    """run_cell of the copy in a child process on the CPU -> the result."""
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {root!r})\n"
        f"sys.path.insert(1, {REPO!r})\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import run as R\n"
        f"{extra}\n"
        "hook = None\n"
        f"if {fault!r}:\n"
        f"    sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
        f"    import faults; hook = getattr(faults, {fault!r})\n"
        f"out = R.run_cell({workload!r}, {seed}, {seconds}, {bool(trace)},"
        f" device='cpu', program_hook=hook)\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"run failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])
