"""The fused lane's rotation reroutes on the bench's page mix (port of
scripts/diag_reroute.py: the same flags and printout).

Replays the bench's page mix (rng seed 0, after the line_bucket_for_count
(256) strip texts the bench draws first) through one
ocr_batch(fused=True) call with fused_lines_per_page=16, and prints per
page the reroute decision (fused.should_reroute_rotation, wrapped for the
call) with the tilt statistics behind it, so that a change of det weights
that flips a decision can be traced to its pages and boxes. Each page's
valid quads are saved to <tmp>/diag_reroute_quads_<tag>.npz (tempfile's
directory; <tag> the --det file's name, else "assets").

    python -m ocrjax_torch.scripts.diag_reroute [--det DET] [--pages 16] \\
        [--cpu]

The reference forces JAX onto the CPU. This port runs the engine on the
card unless given --cpu: the decisions depend on the detector's quads,
and the card's are the ones the served fused lane reroutes on.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.diag_reroute")
    ap.add_argument("--det", default=None,
                    help="det checkpoint to load in place of assets/det")
    ap.add_argument("--pages", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch import fused, geometry
    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.train import synth

    engine = OcrEngine.from_pretrained(device=device)
    if args.det:
        W.load_model_variables(engine.det_model,
                               W.read_safetensors(args.det)[0])
    engine.config = engine.config.replace(fused_lines_per_page=16)
    cfg = engine.config
    charset = engine.charset

    rng = np.random.RandomState(0)
    # the bench draws line_bucket_for_count(256) strip texts before it
    # renders its pages, so the page mix depends on them
    for _ in range(cfg.line_bucket_for_count(256)):
        synth.random_text(rng, charset, 4, 12)
    imgs = []
    for _ in range(args.pages):
        page, _, _ = synth.render_page(
            rng, charset, size=(cfg.det_max_side, cfg.det_max_side))
        imgs.append(np.repeat(page[..., None], 3, axis=2))

    decisions = []
    saved_quads = []
    orig = fused.should_reroute_rotation

    def spy(vq, cfg_):
        e = vq[:, 1] - vq[:, 0]
        a = np.abs(np.degrees(np.arctan2(e[:, 1], e[:, 0]))) % 90.0
        tilt = np.minimum(a, 90.0 - a)
        w_len = np.linalg.norm(vq[:, 1] - vq[:, 0], axis=1)
        h_len = np.linalg.norm(vq[:, 3] - vq[:, 0], axis=1)
        aspect = (np.maximum(w_len, h_len)
                  / np.maximum(np.minimum(w_len, h_len), 1.0))
        gated = np.where(aspect >= cfg_.fused_reroute_min_aspect, tilt, 0.0)
        med90 = float(np.median(geometry.quad_tilt_deg(vq)))
        out = orig(vq, cfg_)
        saved_quads.append(np.asarray(vq))
        decisions.append(dict(
            n_boxes=len(vq), reroute=bool(out),
            max_gated_tilt=float(gated.max()) if len(vq) else 0.0,
            offender_aspect=(float(aspect[np.argmax(gated)]) if len(vq)
                             else 0.0),
            median_tilt90=med90,
            thresh=cfg_.fused_rotation_reroute_deg,
        ))
        return out

    fused.should_reroute_rotation = spy
    try:
        engine.ocr_batch(imgs, fused=True)
    finally:
        fused.should_reroute_rotation = orig

    tag = os.path.basename(args.det or "assets").split(".")[0]
    np.savez(os.path.join(tempfile.gettempdir(),
                          f"diag_reroute_quads_{tag}.npz"),
             **{f"p{i}": q for i, q in enumerate(saved_quads)})
    n_re = sum(d["reroute"] for d in decisions)
    print(f"det={args.det or 'assets'}  pages={args.pages}  "
          f"reroutes={n_re}")
    for i, d in enumerate(decisions):
        flag = "REROUTE" if d["reroute"] else "       "
        print(f"  page {i:2d} {flag} boxes={d['n_boxes']:2d} "
              f"max_gated_tilt={d['max_gated_tilt']:6.2f} "
              f"(thresh {d['thresh']}) offender_aspect="
              f"{d['offender_aspect']:5.1f} "
              f"med_tilt90={d['median_tilt90']:6.2f}")


if __name__ == "__main__":
    main()
