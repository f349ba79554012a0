"""Multi-seed quality of the C5 tiled path (port of
scripts/eval_tiled_quality.py: the same flags and printout).

Runs the 2048-pixel, 12-16-line scenario of the reference's tiled gate
(tests/test_tpu.py::test_c5_tiled_e2e_on_tpu) over several seeds and
reports line-exact per seed, their mean and minimum, and the first misses.

    python -m ocrjax_torch.scripts.eval_tiled_quality [--seeds 8] \\
        [--size 2048] [--weights REC] [--cpu]

The pages are rendered on the host; the engine runs on the card unless
given --cpu.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.eval_tiled_quality")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--weights", default=None, help="rec weights override")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.train import synth

    eng = OcrEngine.from_pretrained(device=device)
    if args.weights:
        W.load_model_variables(eng.rec_model,
                               W.read_safetensors(args.weights)[0])
        print("candidate rec weights:", args.weights, flush=True)
    per_seed = []
    misses = []
    for seed in range(42, 42 + args.seeds):
        rng = np.random.RandomState(seed)
        page, _, texts = synth.render_page(
            rng, eng.charset, size=(args.size, args.size),
            n_lines=(12, 16), max_len=12)
        img = np.repeat(page[..., None], 3, axis=2)
        res = eng.ocr_tiled(img)
        rem = list(texts)
        exact = 0
        for l in res.lines:
            if l.text in rem:
                rem.remove(l.text)
                exact += 1
        per_seed.append(exact / len(texts))
        misses.extend((seed, m) for m in rem)
    print(json.dumps({
        "per_seed_exact": [round(v, 4) for v in per_seed],
        "mean": round(float(np.mean(per_seed)), 4),
        "min": round(float(np.min(per_seed)), 4),
    }))
    for seed, m in misses[:20]:
        print("  miss seed=%d gt=%r" % (seed, m))


if __name__ == "__main__":
    main()
