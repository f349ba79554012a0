"""Dense-page detection recall, miss by miss (port of scripts/diag_dense.py:
the same flags and printout). Runs one ocr_tiled page and sorts each
ground-truth line no predicted box centre lies near (a miss) by its
distance to the nearest tile seam band, its height, width and position,
then lists the lines found with the wrong text (detection against
recognition).

    python -m ocrjax_torch.scripts.diag_dense [--seed 5] \\
        [--size 3072x2048] [--n-lines 200] [--det-weights DET] [--cpu]

--det-weights loads a flax-layout det safetensors into the engine's
flagship detector (weights.load_model_variables), which keeps them across
a rebuild for a later config. The page is rendered on the host; the
engine runs on the card unless given --cpu.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.diag_dense")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--size", default="3072x2048")
    ap.add_argument("--n-lines", type=int, default=200)
    ap.add_argument("--det-weights", default=None,
                    help="candidate det safetensors (default: shipped)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch import weights as Wt
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.train import synth

    eng = OcrEngine.from_pretrained(device=device)
    if args.det_weights:
        Wt.load_model_variables(eng.det_model,
                                Wt.read_safetensors(args.det_weights)[0])
        print("candidate det weights:", args.det_weights, flush=True)
    rng = np.random.RandomState(args.seed)
    H, W = (int(v) for v in args.size.split("x"))
    page, quads, texts = synth.render_page_dense(
        rng, eng.charset, size=(H, W), n_lines=args.n_lines)
    print(f"gt lines: {len(texts)}")
    img = np.repeat(page[..., None], 3, axis=2)
    res = eng.ocr_tiled(img)
    print(f"pred lines: {len(res.lines)} truncated={res.truncated}")

    pred_centers = np.array([np.asarray(l.box.quad).mean(axis=0)
                             for l in res.lines]) \
        if res.lines else np.zeros((0, 2))

    tile = eng.config.tile_size
    ov = eng.config.tile_overlap
    stride = tile - ov

    misses, wrong = [], []
    found = exact = 0
    for q, t in zip(quads, texts):
        c = q.mean(axis=0)
        h = q[:, 1].max() - q[:, 1].min() + 1
        w = q[:, 0].max() - q[:, 0].min() + 1
        if len(pred_centers):
            dd = np.hypot(*(pred_centers - c).T)
            j = int(np.argmin(dd))
            bd = dd[j]
        else:
            bd = 1e9
        rec = {"c": c, "h": h, "w": w, "t": t,
               "y_mod": float(c[1]) % stride}
        if bd < max(h, 10):
            found += 1
            if res.lines[j].text == t:
                exact += 1
            else:
                rec["pred"] = res.lines[j].text
                wrong.append(rec)
        else:
            misses.append(rec)
    n = len(texts)
    print(f"found {found}/{n} = {found/n:.3f}   exact {exact}/{n} = "
          f"{exact/n:.3f}")

    def seam_dist(y):
        # distance from the nearest tile boundary band [k*stride, k*stride+ov]
        m = y % stride
        return min(m, abs(m - ov), stride - m)

    print("\n-- MISSES (no box near gt center):", len(misses))
    for r in sorted(misses, key=lambda r: r["c"][1])[:40]:
        print(f"  y={r['c'][1]:7.1f} x={r['c'][0]:7.1f} h={r['h']:4.0f} "
              f"w={r['w']:5.0f} seam_d={seam_dist(r['c'][1]):6.1f} "
              f"t={r['t']!r}")
    if misses:
        sd = [seam_dist(r["c"][1]) for r in misses]
        print(f"  seam_dist: median {np.median(sd):.0f}, "
              f"<{ov}px: {sum(1 for v in sd if v < ov)}/{len(sd)}")
        hs = [r["h"] for r in misses]
        ws = [r["w"] for r in misses]
        print(f"  miss h: median {np.median(hs):.0f} (all-gt median "
              f"{np.median([q[:,1].max()-q[:,1].min() for q in quads]):.0f})")
        print(f"  miss w: median {np.median(ws):.0f}")
        xs = [r["c"][0] for r in misses]
        print(f"  miss x: median {np.median(xs):.0f}  (page W={W})")
        ys = sorted(r["c"][1] for r in misses)
        print(f"  miss y range: {ys[0]:.0f}..{ys[-1]:.0f} (page H={H})")

    print("\n-- WRONG TEXT (box found):", len(wrong))
    for r in wrong[:20]:
        print(f"  y={r['c'][1]:7.1f} h={r['h']:4.0f} gt={r['t']!r} "
              f"pred={r['pred']!r}")


if __name__ == "__main__":
    main()
