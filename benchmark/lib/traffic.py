"""The traffic of a cell: a mix file (traffic/<mix>.json) of parameters ->
the pages, the fixed call sequence of a run, the call the window makes and
the reference's pass over the same pages.

A mix names the engine entry a call drives (`entry`, `kwargs`; `arg`
"page" passes a call's one page, else its list of pages), the lane the
reference follows (`lane`) and how many pages one reference call takes
(`reference_chunk`, 16 unless given), the pages (`source`: an .npz under
data/, the keys to read, each a page or a stack of pages, and `lines`,
where each page's line boxes are, for the work count) and how calls draw
them (`draw`):
  * "permutation": a seeded permutation of every page, cut into calls of
    `pages_per_call` (which divides the page count) and cycled, so every
    seed sends the same pages in another order;
  * "shuffle": `calls` calls, each a seeded order of the pages listed in
    `call_pages` (indices into the source), cycled.
A mix whose traffic these parameters cannot state names a module of its
own (`generator`: traffic/<generator>.py). Each function that module
defines takes the place of the one here of the same name: load_pages,
page_lines, call_sequence, make_call, reference_pages. The sequence is
fixed before set-up and its distinct calls are what set-up warms.

Like everything a cell needs, the mix is found by name: so are the
configuration, its recognizer (reference/rec_<arch>.py), its seeded
assets (lib/seeded.py), the limits and the metrics (run.py).
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_mix(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _hook(mix: Dict, name: str):
    """The mix's generator module's function `name`, or None."""
    gen = mix.get("generator")
    if not gen:
        return None
    path = os.path.join(HERE, "traffic", f"{gen}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_traffic_" + gen.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name, None)


def load_pages(mix: Dict) -> List[np.ndarray]:
    hook = _hook(mix, "load_pages")
    if hook is not None:
        return hook(mix)
    src = mix["source"]
    with np.load(os.path.join(HERE, "data", src["file"])) as z:
        pages = []
        for key in src["keys"]:
            a = z[key]
            pages += [a] if a.ndim == 2 else list(a)
    return [np.ascontiguousarray(p) for p in pages]


def page_lines(mix: Dict) -> List[np.ndarray]:
    """Each page's line boxes, in the source's page order: from an .npz's
    stacked quads and per-page counts, or from a JSON that holds under each
    source key a list of its pages' boxes."""
    hook = _hook(mix, "page_lines")
    if hook is not None:
        return hook(mix)
    spec = mix["source"]["lines"]
    path = os.path.join(HERE, "data", spec["file"])
    if path.endswith(".npz"):
        with np.load(path) as z:
            quads, counts = z[spec["quads"]], z[spec["counts"]]
        cut = np.concatenate([[0], np.cumsum(counts)])
        return [quads[a:b] for a, b in zip(cut[:-1], cut[1:])]
    with open(path) as f:
        boxes = json.load(f)
    return [np.asarray(page, np.float32).reshape(-1, 4, 2)
            for k in mix["source"]["keys"] for page in boxes[k]]


def call_sequence(mix: Dict, n_pages: int, seed: int
                  ) -> List[Tuple[int, ...]]:
    """One period of the call sequence: tuples of page indices."""
    hook = _hook(mix, "call_sequence")
    if hook is not None:
        return hook(mix, n_pages, seed)
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    if mix["draw"] == "permutation":
        k = int(mix["pages_per_call"])
        if n_pages % k:
            raise ValueError(f"{k} pages a call do not divide {n_pages}")
        perm = rng.permutation(n_pages)
        return [tuple(int(i) for i in perm[lo:lo + k])
                for lo in range(0, n_pages, k)]
    if mix["draw"] == "shuffle":
        base = np.asarray(mix["call_pages"])
        return [tuple(int(i) for i in base[rng.permutation(len(base))])
                for _ in range(int(mix["calls"]))]
    raise ValueError(f"unknown draw {mix['draw']!r}")


def make_call(engine, mix: Dict, pages) -> Callable:
    """call (page indices) -> the entry's results, one a page. A mix whose
    `arg` is "page" calls the entry once with its one page."""
    hook = _hook(mix, "make_call")
    if hook is not None:
        return hook(engine, mix, pages)
    fn = getattr(engine, mix["entry"])
    kw = dict(mix.get("kwargs", {}))
    if mix.get("arg", "pages") == "page":
        return lambda call: [fn(pages[call[0]], **kw)]
    return lambda call: fn([pages[i] for i in call], **kw)


def reference_pages(ref, mix: Dict, pages, todo: Sequence[int],
                    out: Dict) -> Dict:
    """The reference's result of each page index in todo, into out."""
    hook = _hook(mix, "reference_pages")
    if hook is not None:
        return hook(ref, mix, pages, todo, out)
    step = int(mix.get("reference_chunk", 16))
    todo = list(todo)
    for lo in range(0, len(todo), step):
        chunk = todo[lo:lo + step]
        for i, r in zip(chunk, ref.run(mix["lane"],
                                       [pages[i] for i in chunk])):
            out[i] = r
    return out
