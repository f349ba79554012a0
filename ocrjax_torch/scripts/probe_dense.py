"""C5 dense-page quality and throughput at the specification's density,
hundreds of lines a page (port of scripts/probe_dense.py: the same flags
and printout). Reports detection recall, line-exact, truncation, and
pages/s and lines/s of the tiled batch path.

    python -m ocrjax_torch.scripts.probe_dense [--pages 4] [--lines 200] \\
        [--height 3072] [--width 2048] [--seed 5] [--det-weights DET] [--cpu]

The pages are rendered on the host; the engine runs on the card unless
given --cpu. The batch is the host clock around one ocr_tiled_batch call,
the card synchronized before each reading, after one warm call of the
same batch.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ocrjax_torch.scripts import clock


def match(quads, texts, lines):
    found = exact = 0
    for q, t in zip(quads, texts):
        c = q.mean(axis=0)
        h = q[:, 1].max() - q[:, 1].min() + 1
        best, bd = None, 1e9
        for l in lines:
            dd = np.hypot(*(np.asarray(l.box.quad).mean(axis=0) - c))
            if dd < bd:
                bd, best = dd, l
        if best is not None and bd < max(h, 10):
            found += 1
            exact += best.text == t
    return found, exact


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.probe_dense")
    ap.add_argument("--pages", type=int, default=4)
    ap.add_argument("--lines", type=int, default=200)
    ap.add_argument("--height", type=int, default=3072)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    ap.add_argument("--det-weights", default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.train import synth

    eng = OcrEngine.from_pretrained(device=device)
    if args.det_weights:
        W.load_model_variables(eng.det_model,
                               W.read_safetensors(args.det_weights)[0])
        print("candidate det weights:", args.det_weights, flush=True)
    rng = np.random.RandomState(args.seed)
    pages = []
    for _ in range(args.pages):
        page, quads, texts = synth.render_page_dense(
            rng, eng.charset, size=(args.height, args.width),
            n_lines=args.lines)
        pages.append((np.repeat(page[..., None], 3, axis=2), quads, texts))
        print(f"rendered {len(texts)} lines", flush=True)

    # warm the batch path itself: its pooled windows are other shapes than
    # a single page's
    t0 = clock(device)
    res0 = eng.ocr_tiled_batch([p[0] for p in pages])[0]
    print(f"warm batch: {clock(device) - t0:.1f}s, {len(res0.lines)} lines, "
          f"truncated={res0.truncated}", flush=True)

    t0 = clock(device)
    results = eng.ocr_tiled_batch([p[0] for p in pages])
    dt = clock(device) - t0

    tot = tfound = texact = tlines = 0
    for (img, quads, texts), res in zip(pages, results):
        found, exact = match(quads, texts, res.lines)
        tot += len(texts)
        tfound += found
        texact += exact
        tlines += len(res.lines)
        print(f"page: gt={len(texts)} det={len(res.lines)} found={found} "
              f"exact={exact} truncated={res.truncated}", flush=True)
    print(json.dumps({
        "pages": args.pages, "gt_lines": tot,
        "det_recall": round(tfound / max(tot, 1), 4),
        "line_exact": round(texact / max(tot, 1), 4),
        "pages_per_sec": round(args.pages / dt, 3),
        "lines_per_sec": round(tot / dt, 1),
        "batch_s": round(dt, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
