"""The work a page needs, counted once at set-up on the reference's
models: the detector's FLOPs over the page's pixels, the configuration's
recognizer's (reference/recognizers.py) over each line's strip at its own
width (no bucket or padding counts) with the FLOPs and bytes of each of
its parts, and the labelling grids of K1 from the config's shapes."""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.lib import stats, traffic
from benchmark.reference import models as M
from benchmark.reference import pipeline as P
from benchmark.reference import recognizers


class Work:
    """A cell's FLOPs, recognizer parts and K1 bytes a call, from its
    pages' work."""

    def __init__(self, cfg, assets: Dict[str, str], mix: Dict,
                 pages: Sequence[np.ndarray]):
        # the detector is fully convolutional and every stride divides 64,
        # so FLOPs a pixel counted on a small input on the host hold at
        # every size that 32 divides; the 'meta' device would load torch's
        # Python meta kernels, seconds of set-up
        cpu = torch.device("cpu")
        tiled = mix["lane"] == "tiled"
        if tiled:
            flat, m = M.read_safetensors(assets["det_tile"])
            arch, S = json.loads(m["arch"]), cfg.tile_size
        else:
            flat = M.read_safetensors(assets["det"])[0]
            arch = dict(P.FLAGSHIP_ARCH, head_stride=cfg.det_head_stride)
            S = cfg.det_max_side
        with torch.inference_mode():
            det_px = stats.counted_flops(
                M.db_prob, M.Params(flat, cpu), arch,
                torch.zeros(1, 3, 64, 64)) / 64.0 ** 2
        det_s = det_px * S * S
        ds = max(1, cfg.det_cc_downsample // int(arch.get("head_stride",
                                                           1)))
        widths = [stats.strip_widths(q, cfg.rec_height)
                  for q in traffic.page_lines(mix)]
        cut = np.cumsum([0] + [len(w) for w in widths])
        every = np.concatenate(widths) if widths else np.zeros(0, np.int64)
        rec = recognizers.resolve(cfg)
        rec_f = rec.flops(M.Params(M.read_safetensors(assets["rec"])[0],
                                   cpu), cfg, every)
        parts = rec.parts(cfg, every) if hasattr(rec, "parts") else {}
        self.page_flops, self.page_grids, self.page_parts = [], [], []
        for k, page in enumerate(pages):
            lo, hi = cut[k], cut[k + 1]
            if tiled:
                det_f = det_px * page.shape[0] * page.shape[1]
                corners, _ = P.prep_tiles(P.to_gray(page), cfg)
                grids = [(th // ds, tw // ds) for (_, _, th, tw) in corners]
            else:
                det_f, grids = det_s, [(S // ds, S // ds)]
            self.page_flops.append(det_f + float(rec_f[lo:hi].sum()))
            self.page_grids.append(grids)
            self.page_parts.append({
                f"{name}_{kind}": float(np.sum(v[lo:hi]))
                for name, fb in parts.items()
                for kind, v in zip(("flops", "bytes"), fb)})

    def call_flops(self, call) -> float:
        return float(sum(self.page_flops[i] for i in call))

    def call_ccl_bytes(self, call) -> float:
        return stats.ccl_bytes([g for i in call for g in self.page_grids[i]])

    def window_parts(self, calls) -> Dict[str, float]:
        """Each recognizer part's FLOPs and bytes ("<part>_flops",
        "<part>_bytes") over every page of these calls."""
        out: Dict[str, float] = {}
        for call in calls:
            for i in call:
                for key, v in self.page_parts[i].items():
                    out[key] = out.get(key, 0.0) + v
        return out
