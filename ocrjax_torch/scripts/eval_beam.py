"""Beam against greedy decoding: what beam costs and what it buys (port of
scripts/eval_beam.py: the same flags and printout).

Reports (a) crops/s at production shapes (count bucket 256, width 320,
K = cfg.ctc_beam_width, 80 frames) for greedy and beam, and (b) line-exact
and CER per quality tier (straight and the degraded sweep) for both
decoders through the production end-to-end path.

    python -m ocrjax_torch.scripts.eval_beam [--seeds 4] [--repeats 3] [--cpu]

The strips and pages are rendered on the host; the engine runs on the card
unless given --cpu. A timing is the host clock around one recognition
call, the card synchronized before each reading; each decoder runs once
before it is timed.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ocrjax_torch.scripts import clock

# the throughput batch: strips, and the width bucket they are padded to
N_STRIPS, STRIP_WIDTH = 256, 320


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m ocrjax_torch.scripts.eval_beam")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.api_det import upload
    from ocrjax_torch.train import synth
    from ocrjax_torch.train.e2e_eval import evaluate_e2e

    eng = OcrEngine.from_pretrained(device=device)
    cfg = eng.config
    rng = np.random.RandomState(0)

    # ---- throughput at production shapes ---------------------------------
    n, W = N_STRIPS, STRIP_WIDTH
    strips = np.zeros((n, cfg.rec_height, W), np.uint8)
    widths = np.full((n,), W, np.int32)
    for i in range(n):
        t = synth.random_text(rng, eng.charset, 4, 12)
        s = synth.render_line(t, cfg.rec_height)
        w = min(s.shape[1], W)
        strips[i, :, :w] = s[:, :w]
        widths[i] = w
    sd, wd = upload(eng, strips), upload(eng, widths)
    rates = {}
    for beam in (False, True):
        eng._rec_step(sd, wd, beam=beam)[0].cpu()
        ts = []
        for _ in range(args.repeats):
            t0 = clock(device)
            eng._rec_step(sd, wd, beam=beam)[0].cpu()
            ts.append(clock(device) - t0)
        rates["beam" if beam else "greedy"] = n / min(ts)
    print(json.dumps({
        "crops_per_sec_greedy": round(rates["greedy"], 0),
        "crops_per_sec_beam": round(rates["beam"], 0),
        "beam_cost_x": round(rates["greedy"] / rates["beam"], 2),
        "beam_width": cfg.ctc_beam_width,
    }), flush=True)

    # ---- accuracy per tier ------------------------------------------------
    out = {}
    tiers = [("straight", dict()), ("degraded_0.5", dict(degrade_level=0.5)),
             ("degraded_0.75", dict(degrade_level=0.75)),
             ("degraded_1.0", dict(degrade_level=1.0))]
    for name, kw in tiers:
        for beam in (False, True):
            runs = [evaluate_e2e(eng, n_pages=4, seed=321 + s, beam=beam,
                                 **kw)
                    for s in range(args.seeds)]
            key = f"{name}/{'beam' if beam else 'greedy'}"
            out[key] = {
                "line_exact": round(float(np.mean(
                    [r["line_exact_match"] for r in runs])), 4),
                "cer": round(float(np.mean(
                    [r["char_error_rate"] for r in runs])), 4),
            }
            print(key, json.dumps(out[key]), flush=True)

    print("\n== beam vs greedy (line-exact / cer) ==")
    for name, _ in tiers:
        g, b = out[f"{name}/greedy"], out[f"{name}/beam"]
        print(f"  {name:14s} greedy {g['line_exact']:.4f}/{g['cer']:.4f}"
              f"   beam {b['line_exact']:.4f}/{b['cer']:.4f}"
              f"   Δexact {b['line_exact'] - g['line_exact']:+.4f}")


if __name__ == "__main__":
    main()
