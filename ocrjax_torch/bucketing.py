"""Width/count bucketing and the pooled batched end-to-end lane (port of
ocrjax/bucketing.py).

A batch of pages gives hundreds of line crops of very different widths.
They are pooled ACROSS pages and routed into (line-count, strip-width)
buckets, so padding stays small and every dispatch has one of a few
shapes; strip widths become CTC frame lengths, which keeps padded columns
out of the decoded strings.

Pipeline (ocr_pages):
  1. chunked batched DB forward and box extraction over all canvases;
  2. host: the valid quads of all pages, estimated strip widths, width
     buckets;
  3. per (width bucket, warp kind, count chunk): pooled warp with ink
     refinement, CRNN, greedy or beam CTC;
  4. the decoded lines back to their pages, in reading order.

With rec_try_flip the orientation is decided in two phases over whole
pages (recognize_pooled), and landscape scans are redone rotated.

Host stages, as the reference names them: host_decode (the wait for the
lookahead decode of the next chunk), det_dispatch, det_fetch (the
truncated candidate fetch, api_det.fetch_det), warp_norm, cls_margins,
rec_dispatch (every recognition chunk packed, concatenated, its copy to
the host started) and rec_fetch_decode (the first fetch_max_tokens token
columns read, the rare refetch, the strings).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ocrjax_torch import geometry, graphs, preprocess
from ocrjax_torch.api_det import count_rec
from ocrjax_torch.ops import bytepack
from ocrjax_torch.ops import warp as warp_lib
from ocrjax_torch.utils.profiling import add_bytes, current, stage


def assign_width_buckets(est_widths: np.ndarray, buckets: Sequence[int]
                         ) -> Dict[int, np.ndarray]:
    """Group indices by the smallest bucket >= estimated width."""
    out: Dict[int, List[int]] = {}
    arr = np.asarray(buckets)
    for i, w in enumerate(est_widths):
        b = int(arr[np.searchsorted(arr, min(w, arr[-1]))])
        out.setdefault(b, []).append(i)
    return {k: np.asarray(v, np.int64) for k, v in out.items()}


def pad_count(n: int, cfg) -> int:
    return cfg.line_bucket_for_count(n)


def sep_warp_mask(quads: np.ndarray, warp_src: np.ndarray, cfg,
                  page_h: int | None = None) -> np.ndarray:
    """Which pooled quads may take the separable warp (cfg.pooled_sep_warp):
    tilt within max(fused_rotation_reroute_deg, atan(noise_px / long side))
    (below that the measured tilt is prob-map noise and an AABB crop equals
    the homography crop after ink refinement) and an expanded AABB that
    fits the warp's row tile. Tilted, near-vertical and tall quads keep the
    exact homography warp."""
    q = np.asarray(quads, np.float32)
    tilt = geometry.quad_tilt_deg(q)
    w_len = np.linalg.norm(q[:, 1] - q[:, 0], axis=1)
    h_len = np.linalg.norm(q[:, 3] - q[:, 0], axis=1)
    long_side = np.maximum(np.maximum(w_len, h_len), 1.0)
    thresh = np.maximum(
        cfg.fused_rotation_reroute_deg,
        np.degrees(np.arctan2(cfg.fused_reroute_noise_px, long_side)))
    ws = np.asarray(warp_src, np.float32)
    aabb_h = ws[..., 1].max(axis=-1) - ws[..., 1].min(axis=-1)
    tile_h = cfg.pooled_sep_tile_h
    if page_h is not None:  # the warp clamps its row tile to the page
        tile_h = min(tile_h, int(page_h))
    return (tilt <= thresh) & (aabb_h <= tile_h - 4)


@torch.inference_mode()
def recognize_pooled(engine, gray_dev: torch.Tensor, page_ids: np.ndarray,
                     quads: np.ndarray, b_all: np.ndarray,
                     beam: bool = False, prior_ids: np.ndarray = None):
    """Pooled width-bucketed recognition over normalized device pages.

    gray_dev: (P, S, S) float32 normalized pages (or tiles) on the device;
    page_ids (N,) row of gray_dev per quad; quads (N, 4, 2) float32 tight
    detector boxes in page coords; b_all (N, 1, 2) per-quad valid (max_x,
    max_y). Returns (texts, confs, flipped) aligned with quads. One
    dispatch per (width bucket, warp kind, count chunk): near-axis-aligned
    quads take the separable warp, tilted or tall ones the homography warp,
    and a bucket holding more quads than the largest count bucket is split.
    Every dispatch is issued before any result is copied to the host: the
    chunks' packed rows (api_det.pack_rec / pack_rec_flip) are concatenated
    on the device and copied once, their first fetch_max_tokens token
    columns first, the whole rows again only if a line has more. (The
    reference pads the page axis to a power of two to bound its compiled
    programs; eager PyTorch needs no such padding.)

    With rec_try_flip, phase A computes the orientation margin of every
    quad (plain homography warp), the host adds the page prior over whole
    prior_ids groups (default page_ids; tiles of one document share a
    group), so page-mates in different buckets share one consensus; phase
    B rotates the chosen strips and recognizes."""
    from ocrjax_torch.api_det import (_estimate_strip_widths,
                                      apply_page_prior, cls_margins_multi,
                                      unpack_rec, unpack_rec_flip, upload)

    cfg = engine.config
    # the host's plan: width buckets, quad expansion, warp kind, chunks
    with stage("rec_plan", device=False):
        warp_src = quads
        # width estimate from the TIGHT quads, with headroom: the ink
        # refinement rescales the band to full strip height
        est_w = _estimate_strip_widths(quads, cfg.rec_height)
        if cfg.rec_snap_to_ink:
            est_w = est_w * 1.25
        if cfg.rec_snap_to_ink and cfg.rec_crop_margin > 0:
            warp_src = warp_lib.expand_quads_host(
                quads, cfg.rec_crop_margin, cfg.rec_crop_margin, bounds=b_all)

        cap = cfg.line_batch_buckets[-1]
        sep_ok = (sep_warp_mask(quads, warp_src, cfg,
                                page_h=int(gray_dev.shape[1]))
                  if cfg.pooled_sep_warp else np.zeros(len(quads), bool))
        chunks = []
        for bucket_w, idx_all in assign_width_buckets(
                est_w, cfg.rec_width_buckets).items():
            for sep in (True, False):
                gidx = idx_all[sep_ok[idx_all] == sep]
                for lo in range(0, len(gidx), cap):
                    chunks.append((bucket_w, gidx[lo:lo + cap], sep))

    def padded(idx):  # pad rows repeat the last quad; never read back
        return np.concatenate([idx, np.repeat(idx[-1:],
                                              pad_count(len(idx), cfg)
                                              - len(idx))])

    try_flip = cfg.rec_try_flip
    flips_all = np.zeros(len(quads), bool)
    if try_flip:
        engine.warn_untrained_cls()
        with stage("cls_margins"):
            pend = []
            for bucket_w, idx, _ in chunks:
                sel = padded(idx)
                # a copy: the next chunk of this shape replays over the
                # program's output before the margins are read
                pend.append((idx, cls_margins_multi(
                    engine, gray_dev, upload(engine, page_ids[sel].astype(
                        np.int64)), upload(engine, warp_src[sel].astype(
                            np.float32)), bucket_w).clone()))
            # one copy to the host for every chunk's margins
            host = torch.from_numpy(bytepack.fetch(
                torch.cat([m for _, m in pend])))
            margins = torch.zeros(len(quads))
            off = 0
            for idx, m in pend:
                margins[torch.from_numpy(idx)] = host[off:off + len(idx)]
                off += m.shape[0]
            if cfg.cls_page_prior > 0:
                seg = np.unique(prior_ids if prior_ids is not None
                                else page_ids,
                                return_inverse=True)[1].reshape(-1)
                margins = apply_page_prior(
                    margins, torch.from_numpy(est_w.astype(np.int32)),
                    torch.from_numpy(seg), cfg.cls_page_prior)
            flips_all = (margins > 0).numpy()

    tokT = cfg.rec_max_tokens
    t_eff = (cfg.fetch_max_tokens
             if 0 < cfg.fetch_max_tokens < tokT else tokT)
    program = graphs.program(engine, "rec_chunk", _rec_chunk)
    pending = []
    with stage("rec_dispatch"):
        for bucket_w, idx, sep in chunks:
            sel = padded(idx)
            count_rec(len(sel), bucket_w)
            flips = upload(engine, flips_all[sel]) if try_flip else None
            # a copy: a later chunk of this shape replays over the
            # program's output before the rows are concatenated
            out = program(engine, gray_dev,
                          upload(engine, page_ids[sel].astype(np.int64)),
                          upload(engine, warp_src[sel].astype(np.float32)),
                          upload(engine, b_all[sel]),
                          upload(engine, quads[sel].astype(np.float32)),
                          flips, bucket_w, sep, beam).clone()
            pending.append((idx, out))
        # every chunk's rows in one device concat and one copy, the first
        # t_eff token columns a line first (the full concat stays on the
        # device for the rare longer line)
        pcat = (torch.cat([o for _, o in pending]) if len(pending) > 1
                else pending[0][1])
        copy = bytepack.HostCopy(pcat if t_eff == tokT else
                                 bytepack.truncate_tokens(pcat, 1, tokT,
                                                          t_eff))

    texts = [None] * len(quads)
    confs = [0.0] * len(quads)
    with stage("rec_fetch_decode"):
        phost = copy.result()
        add_bytes("rec_fetch_decode", phost.nbytes)
        if t_eff < tokT and phost[:, t_eff].max(initial=0) > t_eff:
            phost, t_eff = bytepack.fetch(pcat), tokT  # a line passed t_eff
            add_bytes("rec_fetch_decode", phost.nbytes)
            bytepack.refetches["rec_fetch_decode"] += 1
        unpack = unpack_rec_flip if try_flip else unpack_rec
        off = 0
        for idx, out in pending:
            tokens, n_tokens, conf = unpack(phost[off:off + out.shape[0]],
                                            t_eff)[:3]
            off += out.shape[0]
            for k, qi in enumerate(idx):
                texts[qi] = engine.charset.decode(tokens[k][: n_tokens[k]])
                confs[qi] = float(conf[k])
    return texts, confs, [bool(f) for f in flips_all]


@torch.inference_mode()
def _rec_chunk(engine, gray_dev: torch.Tensor, ids: torch.Tensor,
               ws: torch.Tensor, bounds: torch.Tensor,
               orig_quads: torch.Tensor, flips, bucket_w: int, sep: bool,
               beam: bool) -> torch.Tensor:
    """One pooled recognition chunk on the device: the multi-page warp of
    the expanded quads ws (separable or homography, with the ink refine
    and re-warp under rec_snap_to_ink), [the forced flips,] recognition
    and the packed rows (pack_rec, or pack_rec_flip with flips)."""
    from ocrjax_torch.api_det import (pack_rec, pack_rec_flip, rec_strips,
                                      rec_strips_forced_flip)
    cfg = engine.config
    kw = dict(rec_height=cfg.rec_height, bucket_width=bucket_w,
              pad_value=(0.0 - cfg.rec_mean) / cfg.rec_std)
    if sep:
        kw["tile_h"] = cfg.pooled_sep_tile_h
    with stage("warp_refine"):
        if cfg.rec_snap_to_ink:
            refined_warp = (warp_lib.warp_quads_multi_sep_refined if sep
                            else warp_lib.warp_quads_multi_refined)
            strips, widths = refined_warp(
                gray_dev, ids, ws, bounds,
                ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
                margin_fracs=(cfg.rec_crop_margin, cfg.rec_crop_margin),
                x_margin_keep=cfg.rec_ink_x_margin_keep,
                orig_quads=orig_quads, flat_frac=cfg.rec_flat_band_frac,
                case_gate=cfg.rec_flat_case_gate, **kw)
        elif sep:
            strips, widths = warp_lib.warp_quads_multi_separable(
                gray_dev, ids, ws, **kw)
        else:
            strips, widths = warp_lib.warp_quads_multi(gray_dev, ids, ws,
                                                       **kw)
    if flips is not None:
        return pack_rec_flip(engine, *rec_strips_forced_flip(
            engine, strips, widths, flips, beam))
    return pack_rec(engine, *rec_strips(engine, strips, widths, beam))


def stack_pages(engine, devs: Sequence[torch.Tensor], size: int = None
                ) -> torch.Tensor:
    """The normalized pages of several uploaded chunks (api_det.gray_norm)
    as one (P, S, S) tensor, each zero-padded at its bottom and right to
    `size` where given (the tiled lane's remainder tiles). On the card it
    is the device's shared page buffer (graphs.shared_buffer, P rounded up
    to a power of two), which every recognition program of the call reads
    without a copy."""
    from ocrjax_torch.api_det import gray_norm
    nib = engine.config.upload_bits == 4      # two pixels a byte
    shapes = [(d.shape[0], d.shape[1], d.shape[2] * (2 if nib else 1))
              for d in devs]
    S_h = size or shapes[0][1]
    S_w = size or shapes[0][2]
    n = sum(sh[0] for sh in shapes)
    out = graphs.shared_buffer("pages", (n, S_h, S_w), torch.float32,
                               devs[0].device)
    lo = 0
    for d, (b, h, w) in zip(devs, shapes):
        dst = out[lo:lo + b]
        if (h, w) != (S_h, S_w):
            dst.zero_()
            dst = dst[:, :h, :w]
        # copied at once: the next chunk of this shape replays over
        # gray_norm's output
        dst.copy_(gray_norm(engine, d))
        lo += b
    return out


def ocr_pages(engine, images: Sequence, beam: bool = False,
              _allow_rot90: bool = True) -> List["OcrResult"]:
    """Pooled batched OCR: one OcrResult per input image.

    Detection is chunked and every chunk is dispatched before any candidate
    is read; the uploaded canvases stay on the device and the pooled warp
    reuses them. Pages that were downscaled onto the canvas keep the batch's
    detections but are recognized from full-resolution crops of the original
    (api_det.pooled_fullres_from_boxes), so a batch never reads a page worse
    than the single-page lane does. With rec_try_flip, landscape scans are
    left out of the pool and redone rotated, as one batch, at the end
    (_allow_rot90 keeps that redo from recursing)."""
    from ocrjax_torch.api import DetBox, OcrLine, OcrResult
    from ocrjax_torch.api_det import (_is_landscape, det_state, fetch_det,
                                      pack_det,
                                      pooled_fullres_from_boxes,
                                      reading_order, upload)

    cfg = engine.config
    B = len(images)
    if B == 0:
        return []
    st = det_state(engine)
    C = max(1, min(cfg.fused_chunk_pages, B))
    scales = np.ones((B,), np.float64)
    valid_hw = np.zeros((B, 2), np.int64)
    ok = np.ones((B,), bool)
    originals: Dict[int, np.ndarray] = {}

    def decode(bound):
        return preprocess.decode_chunk_to_gray(images, range(*bound), cfg,
                                               originals_out=originals)

    # chunk k + 1 decodes on the lookahead thread while chunk k is
    # uploaded and dispatched
    bounds = [(lo, min(lo + C, B)) for lo in range(0, B, C)]
    decoded = preprocess.lookahead(decode, bounds, "host_decode",
                                   "decode_submit")
    chunk_devs, cands = [], []
    for (lo, hi), got in zip(bounds, decoded):
        grays, scales[lo:hi], valid_hw[lo:hi], ok[lo:hi], _ = got
        with stage("det_dispatch"):
            dev = upload(engine, preprocess.pack_for_upload(grays, cfg))
            chunk_devs.append(dev)
            cands.append(pack_det(st.forward(dev)[1]))
    with stage("det_fetch"):
        boxes, scores, valid = fetch_det(cands, cfg, timer=current())
    # the host's plan of the lines: candidates in each page's valid
    # region, landscape and downscaled pages routed off, the pooled list
    with stage("rec_plan", device=False):
        for i in range(B):
            nh, nw = valid_hw[i]
            cx = boxes[i, :, :, 0].mean(axis=1)
            cy = boxes[i, :, :, 1].mean(axis=1)
            valid[i] &= ok[i] & (cx < nw) & (cy < nh)

        rot90_pages = []
        if _allow_rot90:
            for i in range(B):
                j = np.where(valid[i])[0]
                if len(j) and _is_landscape(cfg, boxes[i, j]):
                    rot90_pages.append(i)
                    valid[i] = False

        # full-resolution lane for downscaled pages
        down_items = []
        for i in range(B):
            if ok[i] and scales[i] < 0.999 and valid[i].any():
                down_items.append((i, originals[i], scales[i], boxes[i],
                                   scores[i], np.where(valid[i])[0]))
                valid[i] = False

        page_ids, quads, qscores, slots = [], [], [], []
        for i in range(B):
            for j in np.where(valid[i])[0]:
                slots.append((i, len(quads)))
                page_ids.append(i)
                quads.append(boxes[i, j])
                qscores.append(scores[i, j])
        if quads:
            page_ids = np.asarray(page_ids, np.int32)
            quads = np.asarray(quads, np.float32)
            # per-quad bounds: the page's valid region, not its padding
            b_all = (valid_hw[page_ids][:, ::-1].astype(np.float32)
                     - 1.0)[:, None, :]
    results: List[List[OcrLine]] = [[] for _ in range(B)]

    if len(quads):
        with torch.inference_mode(), stage("warp_norm"), \
                stage("warp_refine"):
            gray_dev = stack_pages(engine, chunk_devs)
        texts, confs, flips = recognize_pooled(
            engine, gray_dev, page_ids, quads, b_all, beam=beam)
        with stage("assemble", device=False):
            for i in range(B):
                mine = [s for (p, s) in slots if p == i]
                if not mine:
                    continue
                page_quads = [geometry.scale_quads(quads[s], scales[i])
                              for s in mine]
                results[i] = [
                    OcrLine(box=DetBox(page_quads[k],
                                       float(qscores[mine[k]])),
                            text=texts[mine[k]], confidence=confs[mine[k]])
                    for k in reading_order(page_quads,
                                           [flips[s] for s in mine])]
    for i, res in pooled_fullres_from_boxes(engine, down_items, beam=beam):
        results[i] = res.lines
    if rot90_pages:
        # one batch for every landscape page, rotated 90 degrees ccw
        imgs = [preprocess.load_image(images[i], auto_invert=cfg.auto_invert)
                for i in rot90_pages]
        redo = ocr_pages(engine, [np.ascontiguousarray(np.rot90(img))
                                  for img in imgs],
                         beam=beam, _allow_rot90=False)
        for i, img, rr in zip(rot90_pages, imgs, redo):
            results[i] = [
                OcrLine(box=DetBox(geometry.rot90_ccw_to_orig(
                    line.box.quad, img.shape[1]), line.box.score),
                    text=line.text, confidence=line.confidence)
                for line in rr.lines]
    return [OcrResult(lines=r) for r in results]
