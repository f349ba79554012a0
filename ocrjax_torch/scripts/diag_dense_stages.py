"""Per-stage time of the dense C5 tiled path (port of
scripts/diag_dense_stages.py: the same flags and printout). Runs the
bench's dense workload (3 pages of PAGE_SIZE, 200 lines, seeds 1000+s)
through ocr_tiled_batch inside an active utils.profiling.StageTimer and
prints the stage table, then the resident-tile det forward (the det term
of the dense ceiling).

    python -m ocrjax_torch.scripts.diag_dense_stages [--pages 3] \\
        [--n-lines 200] [--repeats 2] [--cpu]

The table's totals and calls are the host clock's, the quantity ocrjax's
timer sums; under it each stage's device milliseconds from CUDA events
("not measured" with --cpu), and "unattributed" is the wall time less the
sum of the host totals. The stage names are the port's own (tile_prep,
tile_det, ccl, extract_boxes, tile_det_fetch, tile_seam_merge,
warp_refine, crnn, ctc), not ocrjax's dispatch and fetch names; ccl
nests inside extract_boxes, so the sum counts it twice. The resident det
forward is tiling's TileForward (prob and boxes) on the first page's
tiles already on the device, warm, the least of 3 calls (CUDA events on
the card). The engine runs on the card unless given --cpu.
"""

from __future__ import annotations

import argparse

import numpy as np

from ocrjax_torch.scripts import clock, device_ms

PAGE_SIZE = (3072, 2048)     # the bench's dense pages


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.diag_dense_stages")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    ap.add_argument("--pages", type=int, default=3)
    ap.add_argument("--n-lines", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ocrjax_torch import preprocess, tiling
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.api_det import upload
    from ocrjax_torch.train import synth
    from ocrjax_torch.utils.profiling import StageTimer

    eng = OcrEngine.from_pretrained(device=device)
    cfg = eng.config
    imgs = []
    for s in range(args.pages):
        rng = np.random.RandomState(1000 + s)
        page, _, texts = synth.render_page_dense(
            rng, eng.charset, size=PAGE_SIZE, n_lines=args.n_lines)
        imgs.append(np.repeat(page[..., None], 3, axis=2))
        print(f"page {s}: {len(texts)} gt lines", flush=True)

    print("window tile cap:", tiling.max_pool_tiles(cfg), flush=True)
    t0 = clock(device)
    eng.ocr_tiled_batch(imgs)
    print(f"warm (compile) run: {clock(device) - t0:.1f}s", flush=True)

    for r in range(args.repeats):
        timer = StageTimer(device)
        t0 = clock(device)
        with timer.active():
            res = eng.ocr_tiled_batch(imgs)
        dt = clock(device) - t0
        rep = timer.host_report(calls=True)
        dev = timer.report()
        nl = sum(len(x.lines) for x in res)
        print(f"\nrun {r}: {dt*1e3:.0f} ms total = "
              f"{args.pages/dt:.2f} pages/s, {nl/dt:.0f} lines/s "
              f"({nl} lines)")
        acc = sum(v["total_ms"] for v in rep.values())
        order = sorted(rep.items(), key=lambda kv: -kv[1]["total_ms"])
        for k, v in order:
            print(f"  {k:22s} {v['total_ms']:8.1f} ms  x{v['calls']}")
        print(f"  {'(sum of stages)':22s} {acc:8.1f} ms  "
              f"(unattributed {dt*1e3-acc:.1f} ms)")
        if not timer.on_card:
            print("  device ms (CUDA events): not measured")
            continue
        print("  device ms (CUDA events):")
        for k, _ in order:
            print(f"  {k:22s} {dev[k]:8.1f} ms")

    # resident-tile det forward (the device det term of the dense ceiling)
    img0 = preprocess.load_image(imgs[0], auto_invert=cfg.auto_invert)
    _, groups = tiling._prep_page(eng, img0)
    fwd = tiling._tile_forward(eng)
    devs = [upload(eng, preprocess.pack_for_upload(g, cfg)) for g in groups]

    def det_once():
        for g in devs:
            fwd(g)

    det_once()
    ms = min(device_ms(det_once, device) for _ in range(3))
    shapes = [tuple(g.shape) for g in groups]
    print(f"\nresident det fwd ({shapes} tiles/page): {ms:.1f} ms/page")


if __name__ == "__main__":
    main()
