"""The comparison that decides `correct`: the program's page results
against the reference's, page by page.

Lines are paired within a page by their boxes: every pair whose centres
lie closer than half the smaller box height is a candidate, and pairs are
taken in order of their widest corner gap. Per run it reads:
  * lines_off: the reference's lines that the program did not return at a
    paired box with the same string, plus the program's lines that pair
    with none, over the reference's lines;
  * corner_px_mean / corner_px_max: the mean and the widest corner gap of
    the pairs, in page pixels;
  * score_gap_max / score_gap_p50: the widest and the median gap of a
    pair's detection scores (each the mean probability over its box);
  * conf_gap_p50: the median gap of the recognizer's confidence (the mean
    best-class probability over the kept frames) over the pairs that read
    the same string;
  * cer: the characters' edit distance of the paired strings, plus the
    characters of unpaired lines, over the reference's characters;
  * order_pages: pages whose paired lines come in another order.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def page_dict(result) -> Dict:
    """An OcrResult -> the reference's page form."""
    lines = result.lines
    return {"quads": np.asarray([np.asarray(l.box.quad, np.float32)
                                 for l in lines], np.float32
                                ).reshape(-1, 4, 2),
            "scores": np.asarray([l.box.score for l in lines], np.float32),
            "texts": [l.text for l in lines],
            "confs": np.asarray([l.confidence for l in lines], np.float32)}


def _pairs(pq: np.ndarray, rq: np.ndarray):
    if not len(pq) or not len(rq):
        return []
    pc, rc = pq.mean(axis=1), rq.mean(axis=1)
    ph = np.linalg.norm(pq[:, 3] - pq[:, 0], axis=-1)
    rh = np.linalg.norm(rq[:, 3] - rq[:, 0], axis=-1)
    dc = np.linalg.norm(pc[:, None] - rc[None], axis=-1)
    ok = dc < 0.5 * np.minimum(ph[:, None], rh[None])
    gap = np.linalg.norm(pq[:, None] - rq[None], axis=-1).max(axis=-1)
    cand = sorted((float(gap[i, j]), i, j) for i, j in zip(*np.nonzero(ok)))
    used_p, used_r, out = set(), set(), []
    for g, i, j in cand:
        if i in used_p or j in used_r:
            continue
        used_p.add(i)
        used_r.add(j)
        out.append((i, j, g))
    return out


def edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def compare(prog: Sequence[Dict], ref: Sequence[Dict]) -> Dict[str, float]:
    n_ref = n_prog = n_pair = off = order_pages = 0
    edits = ref_chars = 0
    gaps: List[float] = []
    score_gaps: List[float] = []
    conf_gaps: List[float] = []
    for p, r in zip(prog, ref):
        pairs = _pairs(p["quads"], r["quads"])
        n_ref += len(r["texts"])
        n_prog += len(p["texts"])
        n_pair += len(pairs)
        ref_chars += sum(len(t) for t in r["texts"])
        for i, j, g in pairs:
            gaps.append(g)
            score_gaps.append(abs(float(p["scores"][i])
                                  - float(r["scores"][j])))
            same = p["texts"][i] == r["texts"][j]
            off += not same
            if same:
                conf_gaps.append(abs(float(p["confs"][i])
                                     - float(r["confs"][j])))
            else:
                edits += edit_distance(p["texts"][i], r["texts"][j])
        paired_p = {i for i, _, _ in pairs}
        paired_r = {j for _, j, _ in pairs}
        edits += sum(len(t) for k, t in enumerate(p["texts"])
                     if k not in paired_p)
        edits += sum(len(t) for k, t in enumerate(r["texts"])
                     if k not in paired_r)
        by_prog = [j for _, j, _ in sorted(pairs)]
        order_pages += by_prog != sorted(by_prog)
    off += (n_ref - n_pair) + (n_prog - n_pair)
    med = lambda xs: float(np.median(xs)) if xs else 0.0  # noqa: E731
    return {"lines_off": off / max(n_ref, 1),
            "cer": edits / max(ref_chars, 1),
            "corner_px_mean": float(np.mean(gaps)) if gaps else 0.0,
            "corner_px_max": max(gaps, default=0.0),
            "score_gap_max": max(score_gaps, default=0.0),
            "score_gap_p50": med(score_gaps),
            "conf_gap_p50": med(conf_gaps),
            "order_pages": float(order_pages),
            "ref_lines": float(n_ref), "prog_lines": float(n_prog),
            "pages": float(len(ref))}


def load_limits(workload: str) -> Dict[str, float]:
    """limits/<workload>.json: {number: limit}; a run is correct when no
    number passes its limit."""
    path = os.path.join(HERE, "limits", f"{workload}.json")
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= v for k, v in limits.items())
