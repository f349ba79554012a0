"""The work a page needs, counted once at set-up on the reference's
models: the detector's FLOPs over the page's pixels, the recognizer's over
each line's strip at its own width (no bucket or padding counts), and the
labelling grids of K1 from the config's shapes."""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.lib import stats, traffic
from benchmark.reference import models as M
from benchmark.reference import pipeline as P


class Work:
    """A cell's FLOPs and K1 bytes a call, from its pages' work."""

    def __init__(self, cfg, assets: Dict[str, str], mix: Dict,
                 pages: Sequence[np.ndarray]):
        # the models are fully convolutional and every stride divides 64,
        # so FLOPs a pixel (a strip column for the CRNN) counted on a
        # small input on the host hold at every size that 32 divides; the
        # 'meta' device would load torch's Python meta kernels, seconds of
        # set-up
        cpu = torch.device("cpu")
        rec = M.Params(M.read_safetensors(assets["rec"])[0], cpu)
        H = cfg.rec_height
        with torch.inference_mode():
            self.rec_per_px = stats.counted_flops(
                M.crnn_logits, rec, torch.zeros(1, H, 128),
                torch.full((1,), 128)) / 128.0
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
        lines = traffic.page_lines(mix)
        self.page_flops, self.page_grids = [], []
        for page, q in zip(pages, lines):
            w = stats.strip_widths(q, H)
            if tiled:
                det_f = det_px * page.shape[0] * page.shape[1]
                corners, _ = P.prep_tiles(P.to_gray(page), cfg)
                grids = [(th // ds, tw // ds) for (_, _, th, tw) in corners]
            else:
                det_f, grids = det_s, [(S // ds, S // ds)]
            self.page_flops.append(det_f + self.rec_per_px * float(w.sum()))
            self.page_grids.append(grids)

    def call_flops(self, call) -> float:
        return float(sum(self.page_flops[i] for i in call))

    def call_ccl_bytes(self, call) -> float:
        return stats.ccl_bytes([g for i in call for g in self.page_grids[i]])
