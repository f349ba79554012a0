"""The fused page lane: detect (float or int8) -> extract_boxes -> top-K
lines -> separable warp (or the exact homography warp), ink refine, re-warp
-> [dewarp] -> [orientation stage] -> CRNN -> greedy or beam CTC, on the
device, for a chunk of pages at a time (port of ocrjax/fused.py).

The reference compiles this as one XLA program and packs its outputs into
one byte row for a slow host link; here `FusedOcr` is a plain function over
device tensors that returns them as tensors. ocr_pages_fused redoes, as the
reference does, the pages this lane cannot answer: a colour page on the
staged lane over min-channel luma, tilted pages and pages that saturate the
line capacity on the bucketed lane, and downscaled ones of those on the
full-resolution lane. With rec_try_flip a page whose lines mostly flipped
reads in reversed order, and a landscape scan reroutes to the staged lane,
whose 90-degree redo rotates it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ocrjax_torch import geometry, preprocess
from ocrjax_torch.models import db_int8
from ocrjax_torch.ops import warp as warp_lib
from ocrjax_torch.postprocess import db_boxes
from ocrjax_torch.utils.logging import get_logger, log_fields
from ocrjax_torch.utils.profiling import stage

def top_k(score: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim; ties go to
    the lower index, as jax.lax.top_k breaks them."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class FusedOcr:
    """Device program of the fused lane for one (K, bucket width, greedy or
    beam, warp kind) and the engine's config at construction.
    separable_warp=False takes the exact homography warp grouped per page
    and the homography ink refine in place of the separable AABB crop and
    its AABB refine (the reference's make_fused_ocr_fn switch)."""

    def __init__(self, engine, lines_per_page: int = 32,
                 bucket_width: int = 320, beam: bool = False,
                 separable_warp: bool = True):
        self.engine = engine
        self.cfg = engine.config
        self.K = lines_per_page
        self.W = bucket_width
        self.beam = beam
        self.separable_warp = separable_warp

    @torch.inference_mode()
    def __call__(self, gray_up: torch.Tensor, thr, valid_wh: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """gray_up: (B, S, S/2) packed nibbles (upload_bits 4) or (B, S, S)
        uint8 luma; thr: (det_thresh, box_thresh, unclip_ratio,
        min_box_size); valid_wh: (B, 2) float32 valid page (w, h) on the
        canvas. Returns tokens (B, K, T), n_tokens (B, K), conf (B, K),
        quads (B, K, 4, 2) canvas px, scores (B, K), valid (B, K), flipped
        (B, K)."""
        from ocrjax_torch.api_det import _cls_flip_strips, crnn_decode
        cfg, eng, K = self.cfg, self.engine, self.K
        H = cfg.rec_height
        B = gray_up.shape[0]
        with stage("det_forward"):
            gray_u8 = preprocess.unpack_on_device(gray_up, cfg)
            x = preprocess.det_normalize_gray(gray_u8, cfg.det_mean,
                                              cfg.det_std)
            prob = db_int8.apply_prob(eng.det_model, x,
                                      cfg.det_int8)           # (B, S', S')
        with stage("extract_boxes"):
            # zero the prob map outside each page's valid area before the
            # top-K, so replicate-padding streaks cannot take line slots
            Sd = prob.shape[-1]
            ar = torch.arange(Sd, dtype=torch.float32, device=prob.device)
            in_valid = ((ar[None, None, :] < valid_wh[:, 0, None, None])
                        & (ar[None, :, None] < valid_wh[:, 1, None, None]))
            prob = torch.where(in_valid, prob, 0.0)
            cand = db_boxes.extract_boxes(
                prob, thresh=thr[0], box_thresh=thr[1], unclip_ratio=thr[2],
                min_box_size=thr[3],
                **db_boxes.static_kwargs_from_config(cfg))
            score = torch.where(cand["valid"], cand["scores"], -1.0)
            top_s, top_i = top_k(score, K)
            quads = torch.gather(
                cand["boxes"], 1, top_i[..., None, None].expand(-1, -1, 4, 2))
            line_valid = top_s > 0.0
        with stage("warp_refine"):
            gray = preprocess.gray_normalize(gray_u8, cfg.rec_mean,
                                             cfg.rec_std)
            pad_v = (0.0 - cfg.rec_mean) / cfg.rec_std
            bounds = (valid_wh - 1.0)[:, None, None, :]       # (B, 1, 1, 2)
            warp_src = quads
            if cfg.rec_snap_to_ink and cfg.rec_crop_margin > 0:
                warp_src = warp_lib.expand_quads(
                    quads, cfg.rec_crop_margin, cfg.rec_crop_margin,
                    bounds=bounds)
            if self.separable_warp:
                warp = warp_lib.warp_quads_separable
                refine = warp_lib.refine_aabb_to_ink
            else:
                warp = warp_lib.warp_quads_grouped
                refine = warp_lib.refine_quads_to_ink
            strips, widths = warp(gray, warp_src, rec_height=H,
                                  bucket_width=self.W, pad_value=pad_v)
            if cfg.rec_snap_to_ink:
                refined = refine(
                    strips.reshape(B * K, H, self.W), widths.reshape(B * K),
                    warp_src.reshape(B * K, 4, 2), rec_height=H,
                    bounds=bounds.expand(B, K, 1, 2).reshape(B * K, 1, 2),
                    ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
                    margin_fracs=(cfg.rec_crop_margin, cfg.rec_crop_margin),
                    x_margin_keep=cfg.rec_ink_x_margin_keep,
                    orig_quads=quads.reshape(B * K, 4, 2),
                    flat_frac=cfg.rec_flat_band_frac,
                    case_gate=cfg.rec_flat_case_gate)
                strips, widths = warp(gray, refined.reshape(B, K, 4, 2),
                                      rec_height=H, bucket_width=self.W,
                                      pad_value=pad_v)
            strips = strips.reshape(B * K, H, self.W)
            widths = widths.reshape(B * K)
            strips = warp_lib.maybe_dewarp_curl(strips, widths, cfg)
        if cfg.rec_try_flip:
            # each page is one prior group; empty slots weigh nothing
            seg = torch.arange(B, device=strips.device).repeat_interleave(K)
            strips, flip = _cls_flip_strips(
                eng, strips, widths, seg_ids=seg,
                prior_weights=widths * line_valid.reshape(B * K))
        else:
            flip = torch.zeros(B * K, dtype=torch.bool, device=strips.device)
        tokens, n_tokens, conf = crnn_decode(eng, strips, widths, self.beam)
        return {"tokens": tokens.reshape(B, K, -1),
                "n_tokens": n_tokens.reshape(B, K),
                "conf": conf.reshape(B, K), "quads": quads,
                "scores": top_s, "valid": line_valid,
                "flipped": flip.reshape(B, K)}


def should_reroute_rotation(vq: np.ndarray, cfg) -> bool:
    """Whether a page's valid quads (N, 4, 2) send it to the staged
    exact-homography lane: any elongated box tilted past max(reroute_deg,
    atan(noise_px / long side)), or an elongated-box median tilt past
    reroute_deg (see ocrjax/fused.py for the measurements)."""
    e = vq[:, 1] - vq[:, 0]
    a = np.abs(np.degrees(np.arctan2(e[:, 1], e[:, 0]))) % 90.0
    tilt = np.minimum(a, 90.0 - a)
    w_len = np.linalg.norm(vq[:, 1] - vq[:, 0], axis=1)
    h_len = np.linalg.norm(vq[:, 3] - vq[:, 0], axis=1)
    aspect = (np.maximum(w_len, h_len)
              / np.maximum(np.minimum(w_len, h_len), 1.0))
    elong = aspect >= cfg.fused_reroute_min_aspect
    long_side = np.maximum(np.maximum(w_len, h_len), 1.0)
    noise_floor = np.degrees(np.arctan2(cfg.fused_reroute_noise_px,
                                        long_side))
    single_thresh = np.maximum(cfg.fused_rotation_reroute_deg, noise_floor)
    single = bool(np.any(elong & (tilt > single_thresh)))
    coherent = bool(elong.any()) and (
        float(np.median(tilt[elong])) > cfg.fused_rotation_reroute_deg)
    rot90 = (cfg.rec_try_flip and cfg.rot90_tilt_deg > 0
             and float(np.median(geometry.quad_tilt_deg(vq)))
             > cfg.rot90_tilt_deg)
    return rot90 or single or coherent


def _fused_for(engine, K: int, W: int, beam: bool,
               separable_warp: bool = True) -> FusedOcr:
    """FusedOcr cached per (K, W, beam, warp kind, config without the
    thresholds)."""
    cfg = engine.config
    key = (K, W, beam, separable_warp,
           cfg.replace(det_thresh=0.0, det_box_thresh=0.0,
                       det_unclip_ratio=0.0, det_min_box_size=0))
    if key not in engine._fused_cache:
        engine._fused_cache[key] = FusedOcr(engine, K, W, beam,
                                            separable_warp)
    return engine._fused_cache[key]


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


def ocr_pages_fused(engine, images, lines_per_page: int = None,
                    bucket_width: int = None, beam: bool = False,
                    separable_warp: bool = True) -> List["OcrResult"]:
    """Batched page OCR through the fused lane: per-page OcrResult in
    reading order, original image coords. separable_warp=False runs the
    fused program with the exact homography warp (FusedOcr)."""
    from ocrjax_torch import api_det, bucketing
    from ocrjax_torch.api import DetBox, OcrLine, OcrResult

    cfg = engine.config
    K = lines_per_page or cfg.fused_lines_per_page
    W = bucket_width or cfg.rec_bucket_for_width(10 * cfg.rec_height)
    B = len(images)
    if B == 0:
        return []
    fused = _fused_for(engine, K, W, beam, separable_warp)
    if cfg.rec_try_flip:
        engine.warn_untrained_cls()
    thr = (float(cfg.det_thresh), float(cfg.det_box_thresh),
           float(cfg.det_unclip_ratio), float(cfg.det_min_box_size))

    def run(packed: np.ndarray, wh: np.ndarray, depth: int = 0):
        """Dispatch one chunk; on device OOM halve it (up to 3 times)."""
        try:
            return fused(api_det.upload(engine, packed), thr,
                         api_det.upload(engine, wh))
        except torch.cuda.OutOfMemoryError:
            if depth >= 3 or len(packed) <= 1:
                raise
            log_fields(get_logger("ocrjax_torch.fused"), "warning",
                       "device OOM: halving fused chunk",
                       chunk_pages=len(packed), depth=depth)
            mid = len(packed) // 2
            halves = [_to_host(run(packed[:mid], wh[:mid], depth + 1)),
                      _to_host(run(packed[mid:], wh[mid:], depth + 1))]
            return {k: torch.from_numpy(np.concatenate([h[k] for h in halves]))
                    for k in halves[0]}

    C = max(1, min(cfg.fused_chunk_pages, B))
    scales = np.ones((B,), np.float64)
    valid_hw = np.zeros((B, 2), np.int64)
    ok = np.ones((B,), bool)
    colorful = set()
    pending = []
    # every chunk is dispatched before any result is read: the host decode
    # of chunk k+1 overlaps the device work of chunk k
    for lo in range(0, B, C):
        hi = min(lo + C, B)
        grays, scales[lo:hi], valid_hw[lo:hi], ok[lo:hi], col = \
            preprocess.decode_chunk_to_gray(
                images, range(lo, hi), cfg,
                color_frac=cfg.fused_color_reroute_frac)
        colorful.update(lo + j for j, c in enumerate(col) if c)
        wh = valid_hw[lo:hi, ::-1].astype(np.float32).copy()
        pending.append(run(preprocess.pack_for_upload(grays, cfg), wh))
    chunks = [_to_host(o) for o in pending]
    out = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}

    results: List[OcrResult] = []
    reroute: List[int] = []
    for i in range(B):
        if not ok[i]:
            results.append(OcrResult(lines=[]))
            continue
        if i in colorful:
            # colour reroute: 601 luma can wash saturated ink out, so the
            # page runs the staged lane over min-channel luma
            results.append(api_det.ocr(engine, images[i], beam=beam,
                                       color=True))
            continue
        nh, nw = valid_hw[i]
        valid = out["valid"][i]
        quads = out["quads"][i]
        vq = quads[valid]
        if len(vq):
            ctr = vq.mean(axis=1)
            vq = vq[(ctr[:, 0] < nw) & (ctr[:, 1] < nh)]
        if (cfg.fused_rotation_reroute_deg > 0 and len(vq)
                and should_reroute_rotation(vq, cfg)):
            reroute.append(i)
            results.append(None)   # filled by the redo below
            continue
        qs, metas = [], []
        for k in np.where(valid)[0]:
            q = quads[k]
            if not (q[:, 0].mean() < nw and q[:, 1].mean() < nh):
                continue  # canvas-padding artifact
            qs.append(geometry.scale_quads(q, scales[i]))
            metas.append(k)
        lines = []
        for j in api_det.reading_order(
                qs, [out["flipped"][i, k] for k in metas]):
            k = metas[j]
            text = engine.charset.decode(
                out["tokens"][i, k][: out["n_tokens"][i, k]])
            lines.append(OcrLine(
                box=DetBox(qs[j], float(out["scores"][i, k])),
                text=text, confidence=float(out["conf"][i, k])))
        # all K slots valid (before the artifact filter): the page may hold
        # more lines than the fused capacity
        results.append(OcrResult(lines=lines,
                                 truncated=bool(valid.sum() >= K)))

    # tilted and saturated pages are redone as ONE pooled batch on the
    # bucketed lane (exact homography crops, unbounded line count);
    # downscaled ones pool on the full-resolution lane instead, which
    # recognizes from crops of the original image
    redo = [i for i in range(B)
            if results[i] is not None and results[i].truncated and ok[i]]
    if reroute or redo:
        log_fields(get_logger("ocrjax_torch.fused"), "info",
                   "fused-path redo through the staged pipeline",
                   rotated=len(reroute), saturated=len(redo),
                   colorful=len(colorful))
        pooled = [i for i in reroute + redo if scales[i] >= 0.999]
        for i, res in zip(pooled, bucketing.ocr_pages(
                engine, [images[i] for i in pooled], beam=beam)):
            results[i] = res
        down = [i for i in reroute + redo if scales[i] < 0.999]
        if down:
            for i, res in zip(down, api_det.ocr_fullres_batch(
                    engine, [images[i] for i in down], beam=beam)):
                results[i] = res
    return results
