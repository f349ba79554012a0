"""The staged detection and end-to-end lanes (port of ocrjax/api_det.py):
detect, the staged single-page ocr with exact homography crops, and the
full-resolution lanes for pages that were downscaled onto the canvas.

Call structure of the staged ocr():
  canvas = host decode onto the fixed S x S luma canvas
  prob, candidates = DetState.forward        (DB forward, extract_boxes)
  (host: valid boxes, count and width buckets)
  strips = warp_quads_refined                (probe, ink refine, re-warp)
  tokens = rec_strips                        (CRNN, greedy CTC)
  (host: charset lookup, reading order)

The reference packs the candidates into one array and fetches a truncated
prefix first (pack_det, _truncate_det_jit, fetch_det) to save round trips on
a slow host link; neither changes a result. The port returns tensors and
copies them to the host once.

The 90-degree (landscape) redo and the orientation stage belong to the
orientation slice: the engine refuses rec_try_flip, so those branches of the
reference are not reached here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ocrjax_torch import geometry, preprocess
from ocrjax_torch.ops import ctc
from ocrjax_torch.ops import warp as warp_lib
from ocrjax_torch.postprocess import db_boxes
from ocrjax_torch.utils import flatband
from ocrjax_torch.utils.profiling import stage


def upload(engine, a: np.ndarray) -> torch.Tensor:
    """Host array -> tensor on the engine's device (pinned and
    non-blocking on a card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if engine.device.type == "cuda":
        return t.pin_memory().to(engine.device, non_blocking=True)
    return t


class DetState:
    """The staged detector of an engine: DB forward and box extraction over
    a batch of uploaded canvases, on the engine's device."""

    def __init__(self, engine):
        self.engine = engine

    @torch.inference_mode()
    def forward(self, gray_up: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """gray_up: (B, S, S/2) packed nibbles (upload_bits 4) or (B, S, S)
        uint8 luma, as preprocess.pack_for_upload makes them. Returns
        (prob (B, S', S'), candidates {'boxes' (B, C, 4, 2) canvas px,
        'scores' (B, C), 'valid' (B, C)}) as device tensors."""
        eng, cfg = self.engine, self.engine.config
        with stage("det_forward"):
            gray_u8 = preprocess.unpack_on_device(gray_up, cfg)
            x = preprocess.det_normalize_gray(gray_u8, cfg.det_mean,
                                              cfg.det_std)
            prob = eng.det_model(x)["prob"]
        with stage("extract_boxes"):
            cand = db_boxes.extract_boxes(
                prob, thresh=float(cfg.det_thresh),
                box_thresh=float(cfg.det_box_thresh),
                unclip_ratio=float(cfg.det_unclip_ratio),
                min_box_size=float(cfg.det_min_box_size),
                **db_boxes.static_kwargs_from_config(cfg))
        return prob, cand


def det_state(engine) -> DetState:
    if engine._det is None:
        engine._det = DetState(engine)
    return engine._det


def fetch_det(cands: Sequence[Dict[str, torch.Tensor]]):
    """Candidate dicts of several chunks -> host (boxes (B, C, 4, 2),
    scores (B, C), valid (B, C)), one copy per tensor."""
    def cat(key):
        ts = [c[key] for c in cands]
        return (torch.cat(ts) if len(ts) > 1 else ts[0]).cpu().numpy()
    return cat("boxes"), cat("scores"), cat("valid")


def _detect_canvas(engine, image, gray_fn=None):
    """Runs detection on one page; returns (img, canvas u8, the uploaded
    canvas tensor, scale, boxes, scores, valid) with the candidates on the
    host. The warps reuse the uploaded canvas. gray_fn: the RGB -> luma
    projection (default 601 luma through the luma-first decode; the colour
    reroute passes preprocess.to_gray_minchannel)."""
    cfg = engine.config
    img = preprocess.load_image(image, auto_invert=cfg.auto_invert)
    if gray_fn is None:
        canvas, scale, (nh, nw), _ = preprocess.decode_canvas_luma_first(
            img, cfg)
    else:
        canvas, scale, (nh, nw) = preprocess.det_resize_to_canvas(img, cfg)
        canvas = gray_fn(canvas)
    canvas_dev = upload(engine, preprocess.pack_for_upload(canvas[None], cfg))
    _, cand = det_state(engine).forward(canvas_dev)
    boxes, scores, valid = (a[0] for a in fetch_det([cand]))
    # drop candidates whose centre lies in canvas padding
    cx = boxes[:, :, 0].mean(axis=1)
    cy = boxes[:, :, 1].mean(axis=1)
    valid = valid & (cx < nw) & (cy < nh)
    return img, canvas, canvas_dev, scale, boxes, scores, valid


def detect(engine, image) -> List["DetBox"]:
    """Full page -> quads and scores in original image coords, in reading
    order."""
    from ocrjax_torch.api import DetBox

    _, _, _, scale, boxes, scores, valid = _detect_canvas(engine, image)
    quads = [geometry.scale_quads(boxes[i], scale)
             for i in np.where(valid)[0]]
    ss = scores[valid]
    order = geometry.sort_reading_order(quads)
    return [DetBox(quads[i], float(ss[i])) for i in order]


def gray_norm(engine, canvas_dev: torch.Tensor) -> torch.Tensor:
    """Uploaded (packed) luma canvases -> (B, S, S) float32 pages normalized
    for the warps."""
    cfg = engine.config
    return preprocess.gray_normalize(
        preprocess.unpack_on_device(canvas_dev, cfg), cfg.rec_mean,
        cfg.rec_std)


@torch.inference_mode()
def rec_strips(engine, strips: torch.Tensor, widths: torch.Tensor):
    """Recognition of normalized device strips (N, H, W) with their widths:
    -> (tokens (N, T), n_tokens (N,), conf (N,)) device tensors, greedy
    CTC. The crops should already be ink-refined (ops.warp two-pass
    warps)."""
    cfg = engine.config
    strips = warp_lib.maybe_dewarp_curl(strips, widths, cfg)
    with stage("crnn"):
        logits, frame_lengths = engine.rec_model(strips[:, None], widths)
    with stage("ctc"):
        return ctc.ctc_greedy_decode(logits, frame_lengths,
                                     blank=cfg.ctc_blank,
                                     max_tokens=cfg.rec_max_tokens)


def ocr(engine, image, force_staged: bool = False, color: bool = False
        ) -> "OcrResult":
    """One page: detect, warp on the device, recognize, order.
    force_staged skips the fused fast path (the fused lane's reroutes use
    it). color=True runs the staged pipeline over min-channel luma so
    saturated coloured ink keeps its contrast."""
    from ocrjax_torch.api import DetBox, OcrLine, OcrResult

    cfg = engine.config
    # an explicit projection, so the canvas is resized in RGB first, as the
    # reference's ocr() does (detect() takes the luma-first decode)
    gray_fn = preprocess.to_gray_minchannel if color else preprocess.to_gray
    if color:
        force_staged = True
    if cfg.ocr_single_fused and not force_staged:
        img = preprocess.load_image(image, auto_invert=cfg.auto_invert)
        if max(img.shape[:2]) <= cfg.det_max_side:
            # latency path: one device program for a page that fits the
            # canvas; saturated and tilted pages are redone inside
            from ocrjax_torch import fused as F
            return F.ocr_pages_fused(engine, [img])[0]
        image = img

    img, canvas, canvas_dev, scale, boxes, scores, valid = \
        _detect_canvas(engine, image, gray_fn=gray_fn)
    idx = np.where(valid)[0]
    if len(idx) == 0:
        return OcrResult(lines=[])
    if scale < 0.999:
        # a downscaled page is recognized from crops of the ORIGINAL image
        # at full resolution, not from the blurred canvas
        return _ocr_from_original(engine, img, scale, boxes, scores, idx,
                                  gray_fn=gray_fn)

    # host decision: count bucket and strip width bucket, from the TIGHT
    # detector quads plus headroom for the ink refinement
    quads_orig_canvas = boxes[idx]                            # (n, 4, 2)
    quads_canvas = quads_orig_canvas
    est_w = _estimate_strip_widths(quads_canvas, cfg.rec_height)
    if cfg.rec_snap_to_ink:
        est_w = est_w * 1.25
    bucket_w = cfg.rec_bucket_for_width(int(est_w.max(initial=1)))
    h_img, w_img = img.shape[:2]
    page_bounds = np.asarray([w_img - 1.0, h_img - 1.0], np.float32)
    if cfg.rec_snap_to_ink and cfg.rec_crop_margin > 0:
        quads_canvas = warp_lib.expand_quads_host(
            quads_canvas, cfg.rec_crop_margin, cfg.rec_crop_margin,
            bounds=page_bounds)
    n = len(idx)
    pad = cfg.line_bucket_for_count(n) - n
    if pad > 0:
        # pad rows repeat the last quad; they never reach the result
        quads_canvas = np.concatenate(
            [quads_canvas, np.tile(quads_canvas[-1:], (pad, 1, 1))])
        quads_orig_canvas = np.concatenate(
            [quads_orig_canvas, np.tile(quads_orig_canvas[-1:], (pad, 1, 1))])

    with torch.inference_mode():
        pad_v = (0.0 - cfg.rec_mean) / cfg.rec_std
        with stage("warp_refine"):
            gray = gray_norm(engine, canvas_dev)[0]
            q_dev = upload(engine, quads_canvas.astype(np.float32))
            if cfg.rec_snap_to_ink:
                strips, widths = warp_lib.warp_quads_refined(
                    gray, q_dev, upload(engine, page_bounds),
                    rec_height=cfg.rec_height, bucket_width=bucket_w,
                    ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
                    margin_fracs=(cfg.rec_crop_margin, cfg.rec_crop_margin),
                    x_margin_keep=cfg.rec_ink_x_margin_keep,
                    pad_value=pad_v,
                    orig_quads=upload(
                        engine, quads_orig_canvas.astype(np.float32)),
                    flat_frac=cfg.rec_flat_band_frac,
                    case_gate=cfg.rec_flat_case_gate)
            else:
                strips, widths = warp_lib.warp_quads(
                    gray, q_dev, rec_height=cfg.rec_height,
                    bucket_width=bucket_w, pad_value=pad_v)
        tokens, n_tokens, conf = (t.cpu().numpy() for t in rec_strips(
            engine, strips, widths))

    quads_orig = [geometry.scale_quads(boxes[i], scale) for i in idx]
    lines = []
    for k in geometry.sort_reading_order(quads_orig):
        lines.append(OcrLine(
            box=DetBox(quads_orig[k], float(scores[idx[k]])),
            text=engine.charset.decode(tokens[k][: n_tokens[k]]),
            confidence=float(conf[k])))
    return OcrResult(lines=lines)


def _ink_crop_host(gray: np.ndarray, x0: int, y0: int, x1: int, y1: int,
                   ink_thresh: int = 128, min_count: int = 2,
                   margin_left_px: float = 0.0, margin_right_px: float = 0.0,
                   x_margin_keep: float = 1.0, flat_frac: float = 0.0,
                   box_h_px: float = 0.0) -> np.ndarray:
    """Host mirror of ops.warp.ink_boxes for full-resolution crops of the
    original image: tighten an (expanded) crop window to the ink band
    through its vertical centre, with pads matching the device refinement
    at the strip scale. Columns deeper than keep * margin into the
    expansion margin cannot count as ink; margins are per side, as applied
    after clamping to the page. The rounding is the reference's: numpy's
    and Python's round, both half to even."""
    crop = gray[y0:y1, x0:x1]
    ink = crop < ink_thresh
    slack_l = int(round(margin_left_px * (1.0 - x_margin_keep)))
    slack_r = int(round(margin_right_px * (1.0 - x_margin_keep)))
    if (slack_l > 0 or slack_r > 0) and crop.shape[1] > slack_l + slack_r:
        ink = ink.copy()
        if slack_l > 0:
            ink[:, :slack_l] = False
        if slack_r > 0:
            ink[:, crop.shape[1] - slack_r:] = False
    rows = ink.sum(axis=1) >= min_count
    if not rows.any():
        return crop
    # close blank row runs bounded by ink on both sides and no longer than
    # max(2, 10% of the crop): underscores and diacritics stay in the band
    ys_ink = np.where(rows)[0]
    if len(ys_ink) > 1:
        G = max(2, int(round(0.10 * crop.shape[0])))
        gaps = np.diff(ys_ink)
        for k in np.where((gaps > 1) & (gaps <= G + 1))[0]:
            rows[ys_ink[k]:ys_ink[k + 1] + 1] = True
    c = crop.shape[0] // 2
    if rows[c]:
        a = b = c
        while a > 0 and rows[a - 1]:
            a -= 1
        while b < len(rows) - 1 and rows[b + 1]:
            b += 1
    else:
        ys = np.where(rows)[0]
        a, b = int(ys.min()), int(ys.max())
    cols = ink[a:b + 1].sum(axis=0) >= 1
    if not cols.any():
        return crop
    xs = np.where(cols)[0]
    band_h = b - a + 1
    pad_y = max(1, round(band_h * 2 / 28))
    pad_x = max(1, round(band_h * 3 / 28))
    if flat_frac > 0.0 and flatband.flat_band_gate(ink[a:b + 1],
                                                   line_h=box_h_px):
        # flat-band rescale: render the band at flat_frac of the strip,
        # padded with true background (255) so the glyphs stay centred
        half = int(round(band_h / (2.0 * flat_frac)))
        yc = (a + b) // 2
        ca, cb = yc - half, yc + half
        nx0 = int(xs.min()) - pad_x
        nx1 = int(xs.max()) + 1 + pad_x
        out = np.full((cb - ca + 1, nx1 - nx0), 255, crop.dtype)
        sa, sb = max(0, ca), min(crop.shape[0] - 1, cb)
        sx0, sx1 = max(0, nx0), min(crop.shape[1], nx1)
        out[sa - ca:sa - ca + (sb - sa + 1),
            sx0 - nx0:sx0 - nx0 + (sx1 - sx0)] = crop[sa:sb + 1, sx0:sx1]
        return out
    return crop[max(0, a - pad_y):b + 1 + pad_y,
                max(0, int(xs.min()) - pad_x):int(xs.max()) + 1 + pad_x]


def _fullres_strips(engine, img, scale, boxes, scores, idx, gray_fn=None):
    """Host crops for full-resolution recognition of a downscaled page ->
    (quads_orig, strips, scores)."""
    cfg = engine.config
    h, w = img.shape[:2]
    gray = (gray_fn or preprocess.to_gray)(img)
    quads_orig, strips, ss = [], [], []
    for i in idx:
        q = geometry.scale_quads(boxes[i], scale)
        margin = 0.0
        if cfg.rec_snap_to_ink:
            margin = cfg.rec_crop_margin * (q[:, 1].max() - q[:, 1].min() + 1)
        x0 = int(max(0, np.floor(q[:, 0].min() - margin)))
        x1 = int(min(w, np.ceil(q[:, 0].max() + margin) + 1))
        y0 = int(max(0, np.floor(q[:, 1].min() - margin)))
        y1 = int(min(h, np.ceil(q[:, 1].max() + margin) + 1))
        if x1 - x0 < 2 or y1 - y0 < 2:
            continue
        quads_orig.append(q)
        strips.append(_ink_crop_host(
            gray, x0, y0, x1, y1,
            margin_left_px=max(0.0, q[:, 0].min() - x0),
            margin_right_px=max(0.0, (x1 - 1) - q[:, 0].max()),
            x_margin_keep=cfg.rec_ink_x_margin_keep,
            flat_frac=cfg.rec_flat_band_frac,
            box_h_px=(float(np.linalg.norm(q[3] - q[0]))
                      if cfg.rec_flat_case_gate else 0.0))
            if cfg.rec_snap_to_ink else gray[y0:y1, x0:x1])
        ss.append(float(scores[i]))
    return quads_orig, strips, ss


def _assemble_fullres_page(quads_orig, ss, rs) -> "OcrResult":
    """(quads, scores, RecResults) -> OcrResult in reading order."""
    from ocrjax_torch.api import DetBox, OcrLine, OcrResult

    return OcrResult(lines=[
        OcrLine(box=DetBox(quads_orig[k], ss[k]), text=rs[k].text,
                confidence=rs[k].confidence)
        for k in geometry.sort_reading_order(quads_orig)])


def _ocr_from_original(engine, img, scale, boxes, scores, idx, gray_fn=None):
    """Full-resolution recognition of one downscaled page: axis-aligned
    hull crops of the original image through recognize_strips."""
    from ocrjax_torch.api import OcrResult

    quads_orig, strips, ss = _fullres_strips(
        engine, img, scale, boxes, scores, idx, gray_fn=gray_fn)
    if not strips:
        return OcrResult(lines=[])
    return _assemble_fullres_page(quads_orig, ss,
                                  engine.recognize_strips(strips))


def ocr_fullres_batch(engine, images) -> List["OcrResult"]:
    """Pooled staged lane for DOWNSCALED pages: chunked batched detection
    (every chunk dispatched before any candidate is read), then all pages'
    full-resolution host crops in one recognize_strips round. A page that
    fails to decode yields an empty result."""
    from ocrjax_torch.api import OcrResult

    cfg = engine.config
    B = len(images)
    results = [None] * B
    st = det_state(engine)
    imgs, canvases, scales = [None] * B, [None] * B, np.ones(B)
    valid_hw = np.zeros((B, 2), np.int64)
    for i in range(B):
        try:
            img = preprocess.load_image(images[i],
                                        auto_invert=cfg.auto_invert)
            # this lane resizes the RGB page and then takes the luma, as
            # the reference does here (not the luma-first decode)
            canvas, scale, nhw = preprocess.det_resize_to_canvas(img, cfg)
        except (FileNotFoundError, ValueError, OSError):
            results[i] = OcrResult(lines=[])
            continue
        imgs[i], canvases[i], scales[i] = img, canvas, scale
        valid_hw[i] = nhw
    live = [i for i in range(B) if imgs[i] is not None]
    if not live:
        return results

    C = max(1, min(cfg.fused_chunk_pages, len(live)))
    cands = []
    for lo in range(0, len(live), C):
        grays = np.stack([preprocess.to_gray(canvases[i])
                          for i in live[lo:lo + C]])
        cands.append(st.forward(
            upload(engine, preprocess.pack_for_upload(grays, cfg)))[1])
    boxes, scores, valid = fetch_det(cands)

    items = []
    for row, i in enumerate(live):
        nh, nw = valid_hw[i]
        cx = boxes[row, :, :, 0].mean(axis=1)
        cy = boxes[row, :, :, 1].mean(axis=1)
        idx = np.where(valid[row] & (cx < nw) & (cy < nh))[0]
        if len(idx) == 0:
            results[i] = OcrResult(lines=[])
            continue
        items.append((i, imgs[i], scales[i], boxes[row], scores[row], idx))
    for i, res in pooled_fullres_from_boxes(engine, items):
        results[i] = res
    return results


def pooled_fullres_from_boxes(engine, items):
    """One pooled recognize_strips round over several downscaled pages'
    full-resolution host crops, from boxes already detected. items:
    [(key, img, scale, boxes (C, 4, 2) canvas coords, scores (C,), idx)]
    -> (key, OcrResult) pairs. Shared by ocr_fullres_batch (which detects
    first) and bucketing.ocr_pages (which has the batch's candidates)."""
    from ocrjax_torch.api import OcrResult

    all_strips, refs, out = [], [], []
    for key, img, scale, boxes_i, scores_i, idx in items:
        quads_orig, strips, ss = _fullres_strips(
            engine, img, scale, boxes_i, scores_i, idx)
        if not strips:
            out.append((key, OcrResult(lines=[])))
            continue
        refs.append((key, quads_orig, ss, len(all_strips)))
        all_strips.extend(strips)
    if all_strips:
        rs = engine.recognize_strips(all_strips)
        for key, quads_orig, ss, lo in refs:
            out.append((key, _assemble_fullres_page(
                quads_orig, ss, rs[lo:lo + len(quads_orig)])))
    return out


def _estimate_strip_widths(quads: np.ndarray, rec_height: int) -> np.ndarray:
    e_top = np.linalg.norm(quads[:, 1] - quads[:, 0], axis=-1)
    e_left = np.linalg.norm(quads[:, 3] - quads[:, 0], axis=-1)
    return np.round(np.maximum(e_top, 1.0) * rec_height
                    / np.maximum(e_left, 1.0))


def ocr_batch(engine, images: Sequence) -> List["OcrResult"]:
    """Batched end-to-end OCR over many pages, pooled and bucketed
    (bucketing.ocr_pages); a corrupt image yields an empty OcrResult."""
    from ocrjax_torch import bucketing
    return bucketing.ocr_pages(engine, images)
