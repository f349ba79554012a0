"""Per-font and per-confusion breakdown of end-to-end misses on synthetic
pages (port of scripts/eval_quality_breakdown.py: the same flags and
printout).

Renders single-font pages, so that every miss belongs to one font, pairs
each ground-truth line with its best Levenshtein match and prints the
line-exact rate per font, a ranked histogram of character substitutions
and sample misses.

    python -m ocrjax_torch.scripts.eval_quality_breakdown \\
        [--pages-per-font 6] [--size 640] [--seed 123] [--beam] \\
        [--weights REC] [--cpu]

The pages are rendered on the host; the engine runs on the card unless
given --cpu.
"""

from __future__ import annotations

import argparse
import collections
import os

import numpy as np


def _align_subs(gt: str, pred: str):
    """Character substitutions from one Levenshtein backtrace."""
    n, m = len(gt), len(pred)
    d = np.zeros((n + 1, m + 1), np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (gt[i - 1] != pred[j - 1]))
    subs, i, j = [], n, m
    while i > 0 and j > 0:
        if d[i, j] == d[i - 1, j - 1] + (gt[i - 1] != pred[j - 1]):
            if gt[i - 1] != pred[j - 1]:
                subs.append((gt[i - 1], pred[j - 1]))
            i, j = i - 1, j - 1
        elif d[i, j] == d[i - 1, j] + 1:
            subs.append((gt[i - 1], "∅"))  # deletion
            i -= 1
        else:
            subs.append(("∅", pred[j - 1]))  # insertion
            j -= 1
    subs += [(c, "∅") for c in gt[:i]] + [("∅", c) for c in pred[:j]]
    return subs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.eval_quality_breakdown")
    ap.add_argument("--pages-per-font", type=int, default=6)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--beam", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    ap.add_argument("--weights", default=None,
                    help="candidate rec safetensors (default: shipped)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.train import synth
    from ocrjax_torch.train.e2e_eval import _levenshtein

    eng = OcrEngine.from_pretrained(device=device)
    if args.weights:
        W.load_model_variables(eng.rec_model,
                               W.read_safetensors(args.weights)[0])
        print("candidate rec weights:", args.weights, flush=True)
    per_font = {}
    subs_hist = collections.Counter()
    miss_examples = []

    for font in synth.FONTS:
        fname = os.path.basename(font).replace(".ttf", "")
        rng = np.random.RandomState(args.seed)
        total = exact = 0
        for _ in range(args.pages_per_font):
            page, quads, texts = synth.render_page(
                rng, eng.charset, size=(args.size, args.size),
                fonts=[font])
            img = np.repeat(page[..., None], 3, axis=2)
            res = eng.ocr(img, beam=args.beam)
            preds = [ln.text for ln in res.lines]
            total += len(texts)
            for t in texts:
                if t in preds:
                    preds.remove(t)
                    exact += 1
                    continue
                if preds:
                    dists = [_levenshtein(t, p) for p in preds]
                    k = int(np.argmin(dists))
                    p = preds.pop(k)
                    for s in _align_subs(t, p):
                        subs_hist[s] += 1
                    if len(miss_examples) < 24:
                        miss_examples.append((fname, t, p))
                else:
                    if len(miss_examples) < 24:
                        miss_examples.append((fname, t, "<no box>"))
        per_font[fname] = (exact, total)

    print("\n== per-font line-exact ==")
    for f, (e, t) in sorted(per_font.items()):
        print(f"  {f:28s} {e}/{t} = {e / max(t, 1):.3f}")
    g_e = sum(e for e, _ in per_font.values())
    g_t = sum(t for _, t in per_font.values())
    print(f"  {'ALL':28s} {g_e}/{g_t} = {g_e / max(g_t, 1):.3f}")

    print("\n== top substitutions (gt→pred, ∅=ins/del) ==")
    for (a, b), n in subs_hist.most_common(20):
        print(f"  {a!r:6s} → {b!r:6s}  ×{n}")

    print("\n== sample misses ==")
    for f, t, p in miss_examples:
        print(f"  [{f}] {t!r} → {p!r}")


if __name__ == "__main__":
    main()
