"""rec_try_flip's cost and what upright pages pay for it (port of
scripts/bench_try_flip.py: the same flags and JSON lines).

Measures the fused lane's pages/s and straight-page line-exact with the
orientation stage off and on, in alternating windows; the overhead is the
median of the per-pair ratios. The reference's ship rule: on by default if
the overhead is under 5% and straight quality is unchanged.

    python -m ocrjax_torch.scripts.bench_try_flip [--pages 48] \\
        [--repeats 3] [--cpu]

The pages are rendered on the host; the engine runs on the card unless
given --cpu. A window is the host clock around one ocr_batch(fused=True)
call, the card synchronized before each reading; each setting runs once
before any window.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ocrjax_torch.scripts import clock


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.bench_try_flip")
    ap.add_argument("--pages", type=int, default=48)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.train import synth

    eng = OcrEngine.from_pretrained(device=device)
    eng.config = eng.config.replace(fused_lines_per_page=16)
    rng = np.random.RandomState(77)
    imgs, gts = [], []
    for _ in range(args.pages):
        page, _, texts = synth.render_page(rng, eng.charset)
        imgs.append(np.repeat(page[..., None], 3, axis=2))
        gts.append(texts)

    # alternating off/on windows: the overhead is the median of per-pair
    # ratios, which cancels a slow drift of the machine
    res_q = {}
    windows = {False: [], True: []}
    for flip in (False, True):
        eng.config = eng.config.replace(rec_try_flip=flip)
        eng.ocr_batch(imgs[:8], fused=True)       # warm this config
    pair_ratios = []
    for _ in range(args.repeats):
        pps = {}
        for flip in (False, True):
            eng.config = eng.config.replace(rec_try_flip=flip)
            t0 = clock(device)
            res = eng.ocr_batch(imgs, fused=True)
            dt = clock(device) - t0
            pps[flip] = len(imgs) / dt
            windows[flip].append(pps[flip])
            res_q[flip] = res
        pair_ratios.append(pps[True] / pps[False])
    out = {}
    for flip in (False, True):
        tot = hit = 0
        for r, gt in zip(res_q[flip], gts):
            got = [l.text for l in r.lines]
            tot += len(gt)
            hit += sum(1 for t in gt if t in got)
        out["flip_on" if flip else "flip_off"] = {
            "pages_per_sec": round(max(windows[flip]), 1),
            "windows": [round(v, 1) for v in windows[flip]],
            "line_exact": round(hit / tot, 4),
        }
        print(json.dumps(out["flip_on" if flip else "flip_off"]),
              flush=True)

    ovh = 1.0 - float(np.median(pair_ratios))
    dq = out["flip_on"]["line_exact"] - out["flip_off"]["line_exact"]
    print(json.dumps({"overhead_frac": round(ovh, 4),
                      "pair_ratios": [round(r, 3) for r in pair_ratios],
                      "quality_delta": round(dq, 4),
                      "default_on_ok": bool(ovh < 0.05 and dq >= -0.005)}))


if __name__ == "__main__":
    main()
