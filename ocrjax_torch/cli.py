"""Command-line interface of the port (port of ocrjax/cli.py): the same
subcommands, flags and JSON output as `python -m ocrjax.cli`.

Usage:
  python -m ocrjax_torch.cli recognize strip.png
  python -m ocrjax_torch.cli detect page.png --json
  python -m ocrjax_torch.cli ocr page1.png page2.png --beam
  python -m ocrjax_torch.cli ocr huge.png --tiled
  python -m ocrjax_torch.cli bench [--pages 16 --lines 256 --repeats 3]

It runs on the card; --cpu runs it on the CPU instead, and without CUDA and
without --cpu it fails with the engine's error. --profile DIR writes a
torch.profiler trace there (and prints to stderr how many pages the
luma lanes kept 2-D and, after a run of the fused lane, the share of its
line slots recognized). --viz draws with PIL
and exits 2 where PIL is absent. `bench` runs bench_lib.run_bench on the
committed traffic (or --traffic FILE) and prints its report as one JSON
line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import List

from ocrjax_torch.imageio import ImageDecodeError

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ocrjax_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("images", nargs="*", help="image path(s)")
        sp.add_argument("--weights", default=None,
                        help="assets dir (default: repo assets/)")
        sp.add_argument("--json", action="store_true", dest="as_json")
        sp.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace to DIR")
        # config flags, 1:1 with OcrConfig fields
        sp.add_argument("--det-thresh", type=float, default=None)
        sp.add_argument("--det-box-thresh", type=float, default=None)
        sp.add_argument("--det-unclip-ratio", type=float, default=None)
        sp.add_argument("--det-max-side", type=int, default=None)
        sp.add_argument("--det-int8", action="store_true",
                        help="int8 backbone and FPN for the DB detector "
                             "(models/db_int8.py)")
        sp.add_argument("--charset", default=None,
                        help="charset dict file (one char per line)")
        sp.add_argument("--try-flip", action="store_true",
                        help="180-degree handling: the orientation "
                             "classifier (assets/cls.safetensors) rotates "
                             "upside-down strips before the CRNN; mostly-"
                             "flipped pages read in reversed order")
        sp.add_argument("--no-auto-invert", action="store_true",
                        help="no polarity canonicalization (by default "
                             "light-ink-on-dark pages are inverted at "
                             "decode: config.auto_invert)")
        sp.add_argument("--flat-band-frac", type=float, default=None,
                        help="flat-band ink rescale fraction "
                             "(config.rec_flat_band_frac; 0 disables)")
        sp.add_argument("--tile-pipeline-tiles", type=int, default=None,
                        help="target tiles per C5 window "
                             "(config.tile_pipeline_tiles)")
        sp.add_argument("--no-tile-det", action="store_true",
                        help="tile detection uses the flagship DB instead "
                             "of the tile detector "
                             "(assets/det_tile.safetensors)")
        sp.add_argument("--no-blank-skip", action="store_true",
                        help="no blank-tile prescreen")
        sp.add_argument("--dewarp-curl", action="store_true",
                        help="curved-baseline rectification of recognition "
                             "strips (config.rec_dewarp_curl)")
        sp.add_argument("--tile-window-hbm-mb", type=int, default=None,
                        help="device memory budget per pooled C5 window "
                             "(config.tile_window_hbm_mb)")
        sp.add_argument("--viz", default=None, metavar="PATH",
                        help="write a debug visualization (detected quads "
                             "and text drawn on the page; needs PIL); for "
                             "several inputs PATH gets an index suffix")

    sp = sub.add_parser("recognize", help="C1: text-line image -> string")
    common(sp)
    sp.add_argument("--beam", action="store_true")

    sp = sub.add_parser("detect", help="C2: page -> boxes")
    common(sp)
    sp.add_argument("--tiled", action="store_true",
                    help="C5: tiled high-resolution detection")

    sp = sub.add_parser("ocr", help="C3/C4: page(s) -> ordered text")
    common(sp)
    sp.add_argument("--beam", action="store_true")
    sp.add_argument("--tiled", action="store_true")
    sp.add_argument("--fused", action="store_true",
                    help="C4 through the fused lane (fixed per-page line "
                         "capacity)")

    sp = sub.add_parser("bench", help="throughput/latency benchmarks")
    common(sp)
    sp.add_argument("--pages", type=int, default=16)
    sp.add_argument("--lines", type=int, default=256)
    sp.add_argument("--repeats", type=int, default=3)
    sp.add_argument("--traffic", default=None, metavar="FILE",
                    help="traffic .npz (bench_lib.render_traffic; default: "
                         "the committed testdata/bench_traffic.npz)")
    return p


def _make_engine(args):
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.charset import Charset

    engine = OcrEngine.from_pretrained(path=args.weights,
                                       device="cpu" if args.cpu else "cuda")
    if args.charset:
        charset = Charset.from_file(args.charset)
        if charset.num_classes != engine.charset.num_classes:
            print(f"error: charset size {charset.num_classes} does not match "
                  f"the loaded recognizer head ({engine.charset.num_classes})",
                  file=sys.stderr)
            raise SystemExit(2)
        engine.charset = charset
    overrides = {}
    for field, flag in [("det_thresh", "det_thresh"),
                        ("det_box_thresh", "det_box_thresh"),
                        ("det_unclip_ratio", "det_unclip_ratio"),
                        ("det_max_side", "det_max_side"),
                        ("rec_flat_band_frac", "flat_band_frac"),
                        ("tile_pipeline_tiles", "tile_pipeline_tiles"),
                        ("tile_window_hbm_mb", "tile_window_hbm_mb")]:
        v = getattr(args, flag)
        if v is not None:
            overrides[field] = v
    for field, flag, value in [("rec_try_flip", "try_flip", True),
                               ("det_int8", "det_int8", True),
                               ("auto_invert", "no_auto_invert", False),
                               ("tile_det_enable", "no_tile_det", False),
                               ("tile_blank_skip", "no_blank_skip", False),
                               ("rec_dewarp_curl", "dewarp_curl", True)]:
        if getattr(args, flag, False):
            overrides[field] = value
    if overrides:
        # the engine's lanes read engine.config on every call, and its
        # program registry follows it; the detector is built again from it
        engine.config = engine.config.replace(**overrides)
        engine._det = None
    return engine


@contextlib.contextmanager
def _profiled(args):
    """utils.profiling.device_trace over the run when --profile DIR: its
    Chrome trace is written to DIR; the forms load_page kept the pages in,
    where the fused lane ran the share of its line slots that it
    recognized, and where the tiled lane ran the share of candidate pairs
    its seam merge tested go to stderr."""
    if not args.profile:
        yield
        return
    from ocrjax_torch.fused import slot_counts
    from ocrjax_torch.preprocess import page_forms
    from ocrjax_torch.tiling import seam_counts
    from ocrjax_torch.utils.profiling import device_trace
    before, forms = dict(slot_counts), dict(page_forms)
    seams = dict(seam_counts)
    with device_trace(args.profile, "cpu" if args.cpu else "cuda"):
        yield
    f = {k: page_forms[k] - forms.get(k, 0) for k in ("luma", "rgb")}
    if any(f.values()):
        print(f"page forms: {f['luma']} luma, {f['rgb']} rgb",
              file=sys.stderr)
    n = {k: slot_counts[k] - before.get(k, 0)
         for k in ("chunks", "slots", "occupied", "recognized")}
    if n["slots"]:
        print(f"fused slots: {n['recognized']} of {n['slots']} recognized "
              f"({100 * n['recognized'] / n['slots']:.1f}%), "
              f"{n['occupied']} occupied, {n['chunks']} chunks",
              file=sys.stderr)
    m = {k: seam_counts[k] - seams.get(k, 0)
         for k in ("pages", "candidates", "pairs", "pairs_tested",
                   "pairs_merged", "groups")}
    if m["pages"]:
        share = 100 * m["pairs_tested"] / max(m["pairs"], 1)
        print(f"seam merge: {m['pairs_tested']} of {m['pairs']} pairs "
              f"tested ({share:.1f}%), {m['pairs_merged']} merged, "
              f"{m['candidates']} candidates -> {m['groups']} boxes, "
              f"{m['pages']} pages", file=sys.stderr)


def _quad_list(quad) -> List[List[float]]:
    return [[round(float(x), 2), round(float(y), 2)] for x, y in quad]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _main(args)
    except (FileNotFoundError, ImageDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(args) -> int:
    if args.cmd == "bench":
        from ocrjax_torch import bench_lib
        report = bench_lib.run_bench(
            pages=args.pages, lines=args.lines, repeats=args.repeats,
            weights=args.weights, cpu=args.cpu,
            traffic=args.traffic or bench_lib.TRAFFIC)
        print(json.dumps(report))
        return 0

    if not args.images:
        print("error: no input images", file=sys.stderr)
        return 2
    if args.viz and args.cmd in ("detect", "ocr"):
        try:
            import PIL  # noqa: F401
        except ImportError:
            print("error: --viz draws with PIL, which is not installed",
                  file=sys.stderr)
            return 2

    engine = _make_engine(args)
    out = []
    with _profiled(args):
        if args.cmd == "ocr" and len(args.images) > 1 and not args.tiled:
            # C4: one batched detection and pooled recognition (--fused:
            # the fused lane)
            t0 = time.perf_counter()
            results = engine.ocr_batch(args.images, beam=args.beam,
                                       fused=args.fused)
            ms = round((time.perf_counter() - t0) * 1e3 / len(results), 1)
            for path, res in zip(args.images, results):
                out.append({"image": path, "text": res.text, "lines": [
                    {"text": line.text,
                     "confidence": round(line.confidence, 4),
                     "quad": _quad_list(line.box.quad),
                     "score": round(line.box.score, 4)}
                    for line in res.lines], "ms": ms})
        else:
            for path in args.images:
                t0 = time.perf_counter()
                if args.cmd == "recognize":
                    r = engine.recognize(path, beam=args.beam)
                    out.append({"image": path, "text": r.text,
                                "confidence": round(r.confidence, 4)})
                elif args.cmd == "detect":
                    boxes = (engine.detect_tiled(path) if args.tiled
                             else engine.detect(path))
                    out.append({"image": path, "boxes": [
                        {"quad": _quad_list(b.quad),
                         "score": round(b.score, 4)} for b in boxes]})
                else:
                    res = (engine.ocr_tiled(path, beam=args.beam)
                           if args.tiled else engine.ocr(path, beam=args.beam))
                    out.append({"image": path, "text": res.text, "lines": [
                        {"text": line.text,
                         "confidence": round(line.confidence, 4),
                         "quad": _quad_list(line.box.quad),
                         "score": round(line.box.score, 4)}
                        for line in res.lines]})
                out[-1]["ms"] = round((time.perf_counter() - t0) * 1e3, 1)

    if args.viz and args.cmd in ("detect", "ocr"):
        for i, item in enumerate(out):
            dest = args.viz if len(out) == 1 else _viz_indexed(args.viz, i)
            _write_viz(item["image"], item, dest)
    _emit(args, out)
    return 0


def _viz_indexed(path: str, i: int) -> str:
    root, ext = os.path.splitext(path)
    return f"{root}.{i}{ext or '.png'}"


def _write_viz(image_path, item, dest) -> None:
    """Detected quads (green) and decoded text (red) over the page."""
    from PIL import Image, ImageDraw

    from ocrjax_torch import preprocess

    img = Image.fromarray(preprocess.load_image(image_path)).convert("RGB")
    draw = ImageDraw.Draw(img)
    for e in item.get("boxes") or item.get("lines") or []:
        q = [tuple(pt) for pt in e["quad"]]
        draw.polygon(q, outline=(0, 200, 0), width=2)
        if "text" in e:
            x = min(p[0] for p in q)
            y = min(p[1] for p in q)
            draw.text((x, max(0, y - 12)), e["text"], fill=(220, 0, 0))
    img.save(dest)


def _emit(args, out) -> None:
    if args.as_json:
        print(json.dumps(out, indent=2))
        return
    for item in out:
        print(f"== {item['image']} ({item['ms']} ms)")
        if "boxes" in item:
            for b in item["boxes"]:
                print(f"  {b['quad']} score={b['score']}")
        else:
            print(item["text"])


if __name__ == "__main__":
    raise SystemExit(main())
