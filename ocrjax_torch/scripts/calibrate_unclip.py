"""Calibrates det_unclip_ratio end to end on synthetic pages (port of
scripts/calibrate_unclip.py: the same flags and printout).

The unclip ratio couples detection geometry to recognition quality: too
small and strips lose ascenders and descenders (the DB rect-unclip of thin
boxes under-recovers the shrink), too large and strips swallow neighbours.
This sweeps the ratio against line exact-match and CER with the shipped
weights and prints the best value.

    python -m ocrjax_torch.scripts.calibrate_unclip \\
        [--ratios 1.5,2.0,2.5,3.0] [--pages 6] [--cpu]

The pages are rendered on the host; the engine runs on the card unless
given --cpu.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.calibrate_unclip")
    ap.add_argument("--ratios", default="1.5,2.0,2.5,3.0")
    ap.add_argument("--pages", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.train.e2e_eval import evaluate_e2e

    results = {}
    for ratio in [float(r) for r in args.ratios.split(",")]:
        engine = OcrEngine.from_pretrained(device=device)
        engine.config = engine.config.replace(det_unclip_ratio=ratio)
        engine._det = None
        m = evaluate_e2e(engine, n_pages=args.pages)
        results[ratio] = m
        print(f"ratio={ratio}: {json.dumps({k: round(v, 4) for k, v in m.items()})}",
              flush=True)
    best = max(results, key=lambda r: (results[r]["line_exact_match"],
                                       -results[r]["char_error_rate"]))
    print(f"best ratio: {best}")


if __name__ == "__main__":
    main()
