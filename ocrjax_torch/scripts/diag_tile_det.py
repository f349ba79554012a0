"""The dense C5 tile detection program split in two, per head stride
(port of scripts/diag_tile_det.py: the same flags and printout): the
prob forward against the prob forward plus box extraction.

    python -m ocrjax_torch.scripts.diag_tile_det [--tiles 2] [--cpu]

For head strides 1, 2 and 4 it builds the flagship DB (models.db.
create_db, random weights from a seeded torch generator) in the default
config's compute dtype and runs it on --tiles random T x T luma tiles,
then extract_boxes with the tile candidate cap (tile_max_candidates).
Each time is the least of 5 warm calls, with CUDA events on the card
(scripts.device_ms) where the reference fetched a scalar reduction.
extract_boxes labels components on a coarse grid of cc_downsample =
det_cc_downsample // head stride (static_kwargs_from_config), so K1 labels
a (T/4)^2 grid at every head stride: 512^2 at T = 2048, K1's cluster path.
The models run on the card unless given --cpu.
"""

from __future__ import annotations

import argparse

import numpy as np

from ocrjax_torch.config import OcrConfig
from ocrjax_torch.scripts import device_ms

T = 2048        # the tile side


def bench(fn, device: str) -> float:
    """The least of 5 timed calls of fn after one warm call, in ms."""
    fn()
    return min(device_ms(fn, device) for _ in range(5))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.diag_tile_det")
    ap.add_argument("--tiles", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run the models on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import torch
    from ocrjax_torch import preprocess
    from ocrjax_torch import weights as W
    from ocrjax_torch.models.db import create_db
    from ocrjax_torch.postprocess import db_boxes

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --cpu to run the "
                           "models on the CPU")
    n = args.tiles
    rng = np.random.RandomState(0)
    gray = (rng.rand(n, T, T) * 255).astype(np.uint8)
    g_dev = torch.from_numpy(gray).to(device)

    for hs in (1, 2, 4):
        cfg = OcrConfig(det_head_stride=hs)
        model = create_db(cfg)
        W.init_random_(model, 1)
        model = model.to(device).eval()
        tcfg = cfg.replace(det_max_candidates=cfg.tile_max_candidates)

        @torch.inference_mode()
        def prob_fn():
            x = preprocess.det_normalize_gray(g_dev, cfg.det_mean,
                                              cfg.det_std)
            return model(x)["prob"]

        @torch.inference_mode()
        def full_fn():
            return db_boxes.extract_boxes(
                prob_fn(), thresh=float(tcfg.det_thresh),
                box_thresh=float(tcfg.det_box_thresh),
                unclip_ratio=float(tcfg.det_unclip_ratio),
                min_box_size=float(tcfg.det_min_box_size),
                **db_boxes.static_kwargs_from_config(tcfg))

        t_prob = bench(prob_fn, device)
        t_full = bench(full_fn, device)
        print(f"head_stride={hs}: prob {t_prob:7.1f} ms  "
              f"prob+boxes {t_full:7.1f} ms  "
              f"(boxes {t_full - t_prob:6.1f} ms)  [{n} tiles]",
              flush=True)


if __name__ == "__main__":
    main()
