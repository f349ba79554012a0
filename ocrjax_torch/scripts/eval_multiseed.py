"""Multi-seed end-to-end validation, the gate a candidate's weights pass
before they ship (port of scripts/eval_multiseed.py: the same tiers, seeds,
flags and JSON).

Tiers:
  straight          8 seeds x 8 clean pages
  rotated           6 seeds x 4 pages, per-line rotation +-10 deg
  heldout_renderer  the straight pages through the 3x supersampled glyph
                    rasterizer
  degraded          (--degrade) 4 seeds x 4 pages through
                    synth.degrade_image at levels 0.25, 0.5, 0.75, 1.0
  projective        (--projective) 4 seeds x 4 pages under keystone and
                    page curl at severities 0.3, 0.6, 1.0

    python -m ocrjax_torch.scripts.eval_multiseed [--weights REC] \\
        [--det-weights DET] [--degrade] [--projective] [--cpu] [--json OUT]

The pages are rendered on the host; the engine runs on the card unless
given --cpu.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ocrjax_torch.scripts import describe


def _mean(dicts, key):
    return float(np.mean([d[key] for d in dicts]))


def _tier(engine, seeds, n_pages, **kw):
    from ocrjax_torch.train.e2e_eval import evaluate_e2e
    runs = [evaluate_e2e(engine, n_pages=n_pages, seed=s, **kw)
            for s in seeds]
    return {
        "line_exact_match": _mean(runs, "line_exact_match"),
        "det_recall": _mean(runs, "det_recall"),
        "char_error_rate": _mean(runs, "char_error_rate"),
        "per_seed_exact": [round(r["line_exact_match"], 4) for r in runs],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.eval_multiseed")
    ap.add_argument("--weights", default=None,
                    help="candidate rec safetensors (default: shipped assets)")
    ap.add_argument("--det-weights", default=None,
                    help="candidate det safetensors (default: shipped assets)")
    ap.add_argument("--straight-seeds", type=int, default=8)
    ap.add_argument("--rotated-seeds", type=int, default=6)
    ap.add_argument("--degrade", action="store_true",
                    help="also sweep page degradation levels")
    ap.add_argument("--degrade-seeds", type=int, default=4)
    ap.add_argument("--projective", action="store_true",
                    help="also sweep projective/keystone + page-curl "
                         "severities (synth.warp_page_projective)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    ap.add_argument("--json", default=None, help="write results as JSON")
    ap.add_argument("--flat-frac", type=float, default=None,
                    help="override cfg.rec_flat_band_frac")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print("devices:", describe(device), flush=True)

    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine

    eng = OcrEngine.from_pretrained(device=device)
    if args.weights:
        W.load_model_variables(eng.rec_model,
                               W.read_safetensors(args.weights)[0])
        print("candidate rec weights:", args.weights, flush=True)
    if args.det_weights:
        W.load_model_variables(eng.det_model,
                               W.read_safetensors(args.det_weights)[0])
        print("candidate det weights:", args.det_weights, flush=True)
    if args.flat_frac is not None:
        eng.config = eng.config.replace(rec_flat_band_frac=args.flat_frac)
        print("rec_flat_band_frac:", args.flat_frac, flush=True)

    out = {}
    out["straight"] = _tier(
        eng, range(123, 123 + args.straight_seeds), n_pages=8)
    print("straight:", json.dumps(out["straight"]), flush=True)
    out["rotated"] = _tier(
        eng, range(9, 9 + args.rotated_seeds), n_pages=4, max_rotation=10.0)
    print("rotated:", json.dumps(out["rotated"]), flush=True)
    # held-out rasterizer: the same pages, glyphs rendered 3x and
    # Lanczos-downsampled, a rendering no model trained on
    out["heldout_renderer"] = _tier(
        eng, range(123, 123 + args.straight_seeds), n_pages=8, supersample=3)
    print("heldout_renderer:", json.dumps(out["heldout_renderer"]),
          flush=True)
    if args.degrade:
        for lv in (0.25, 0.5, 0.75, 1.0):
            out[f"degraded_{lv}"] = _tier(
                eng, range(321, 321 + args.degrade_seeds), n_pages=4,
                degrade_level=lv)
            print(f"degraded {lv}:", json.dumps(out[f"degraded_{lv}"]),
                  flush=True)
    if args.projective:
        for lv in (0.3, 0.6, 1.0):
            out[f"projective_{lv}"] = _tier(
                eng, range(555, 555 + args.degrade_seeds), n_pages=4,
                projective=lv, curl=lv)
            print(f"projective {lv}:", json.dumps(out[f"projective_{lv}"]),
                  flush=True)

    print("\n== summary (line-exact) ==")
    for k, v in out.items():
        print(f"  {k:14s} {v['line_exact_match']:.4f} "
              f"(recall {v['det_recall']:.3f}, cer {v['char_error_rate']:.4f})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.json)


if __name__ == "__main__":
    main()
