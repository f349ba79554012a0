"""Line-exact per glyph count and the case-confusion breakdown of the
x-height tail (port of scripts/eval_xheight.py: the same flags and
printout).

Renders pages whose lines have controlled glyph counts, runs the
production end-to-end path and reports:
  * line-exact per glyph count (1, 2, 3, 5, 8);
  * the case-flip substitutions on the x-height-confusable cluster
    (x/X, o/O, s/S, c/C, v/V, w/W, z/Z + 0/O, 1/l/I), the error class
    that the ink refine's full-height rescale creates by erasing the size
    cue.

    python -m ocrjax_torch.scripts.eval_xheight [--pages 12] [--size 640] \\
        [--seed 42] [--flat-frac 0.46] [--weights REC] [--cpu]

The pages are rendered on the host; the engine runs on the card unless
given --cpu.
"""

from __future__ import annotations

import argparse
import collections

import numpy as np

CASE_PAIRS = {frozenset(p) for p in
              ["xX", "oO", "sS", "cC", "vV", "wW", "zZ", "uU",
               "kK", "yY", "pP", "mM", "nN",
               # shape twins whose only cue is size/stroke statistics
               "0O", "1l", "1I", "lI", "l|", "I|", "1|", ".o", ".O"]}


def case_flip(a, b):
    return frozenset((a, b)) in CASE_PAIRS or \
        (a.lower() == b.lower() and a != b)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.eval_xheight")
    ap.add_argument("--pages", type=int, default=12,
                    help="pages per length tier")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    ap.add_argument("--flat-frac", type=float, default=None,
                    help="override cfg.rec_flat_band_frac (0 disables)")
    ap.add_argument("--weights", default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.scripts.eval_quality_breakdown import _align_subs
    from ocrjax_torch.train import synth
    from ocrjax_torch.train.e2e_eval import _levenshtein

    eng = OcrEngine.from_pretrained(device=device)
    if args.weights:
        W.load_model_variables(eng.rec_model,
                               W.read_safetensors(args.weights)[0])
    if args.flat_frac is not None:
        eng.config = eng.config.replace(rec_flat_band_frac=args.flat_frac)
    print("rec_flat_band_frac:",
          getattr(eng.config, "rec_flat_band_frac", "n/a"), flush=True)

    per_len = {}
    subs_hist = collections.Counter()
    for L in (1, 2, 3, 5, 8):
        rng = np.random.RandomState(args.seed + L)
        total = exact = case_miss = 0
        for _ in range(args.pages):
            page, quads, texts = synth.render_page(
                rng, eng.charset, size=(args.size, args.size),
                n_lines=(5, 8), max_len=L, min_len=L)
            img = np.repeat(page[..., None], 3, axis=2)
            res = eng.ocr(img)
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
                    flips = [s for s in _align_subs(t, p)
                             if "∅" not in s and case_flip(*s)]
                    if flips:
                        case_miss += 1
                        for s in flips:
                            subs_hist[s] += 1
        per_len[L] = (exact, total, case_miss)

    print("\n== line-exact per glyph count ==")
    for L, (e, t, cm) in sorted(per_len.items()):
        print(f"  len {L}: {e}/{t} = {e / max(t, 1):.3f}   "
              f"case-flip misses: {cm} ({cm / max(t, 1):.3f})")
    ge = sum(e for e, _, _ in per_len.values())
    gt = sum(t for _, t, _ in per_len.values())
    gc = sum(c for _, _, c in per_len.values())
    print(f"  ALL: {ge}/{gt} = {ge / max(gt, 1):.3f}   case-flip {gc}")

    print("\n== case-flip substitutions ==")
    for (a, b), n in subs_hist.most_common(16):
        print(f"  {a!r} → {b!r}  ×{n}")


if __name__ == "__main__":
    main()
