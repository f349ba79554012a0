"""The staged detection and end-to-end lanes (port of ocrjax/api_det.py):
detect, the staged single-page ocr with exact homography crops, the
full-resolution lanes for pages that were downscaled onto the canvas, and
the orientation stage (rec_try_flip) with the 90-degree redo of landscape
scans.

Call structure of the staged ocr():
  canvas = host decode onto the fixed S x S luma canvas
  prob, candidates = DetState.forward        (DB forward, extract_boxes)
  (host: valid boxes; a page whose boxes read ~90 degrees is redone rotated)
  (host: count and width buckets)
  strips = warp_quads_refined                (probe, ink refine, re-warp)
  tokens = rec_strips / rec_strips_flip      ([cls, flip,] [dewarp,] CRNN,
                                             CTC)
  (host: charset lookup, reading order; reversed for an upside-down page)

Transport, as the reference's: the candidates travel as one float32 row
a page (pack_det), and fetch_det copies the first det_fetch_candidates
slots of it first, refetching the whole row only where a page used a
later slot; the recognition outputs travel as one packed row a line
(pack_rec, pack_rec_flip: uint8 under cfg.fetch_bytes, see ops.bytepack).
None of it changes a result.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ocrjax_torch import geometry, graphs, preprocess
from ocrjax_torch.models import cls as cls_lib
from ocrjax_torch.models import db_int8
from ocrjax_torch.ops import bytepack, ctc
from ocrjax_torch.ops import warp as warp_lib
from ocrjax_torch.postprocess import db_boxes
from ocrjax_torch.utils import flatband
from ocrjax_torch.utils.profiling import StageTimer, stage


def upload(engine, a: np.ndarray) -> torch.Tensor:
    """Host array -> tensor on the engine's device (pinned and
    non-blocking on a card)."""
    with stage("upload", device=False):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if engine.device.type == "cuda":
            with graphs.checked():
                return t.pin_memory().to(engine.device, non_blocking=True)
        return t


def upload_thresholds(engine) -> torch.Tensor:
    """The config's four detection thresholds (det_thresh, det_box_thresh,
    det_unclip_ratio, det_min_box_size) as one (4,) float32 tensor on the
    engine's device, a pinned upload: the programs take them as an input,
    as the reference traces them, so that a threshold sweep replays the
    same graphs."""
    cfg = engine.config
    return upload(engine, np.asarray(
        [cfg.det_thresh, cfg.det_box_thresh, cfg.det_unclip_ratio,
         float(cfg.det_min_box_size)], np.float32))


class DetState:
    """The staged detector of an engine: the flagship DB, built here from
    the config of the detector's first use and kept (ocrjax's _DetState;
    `engine._det` holds it, and resetting that to None builds it again
    from the config then in force), and its forward, DB forward and box
    extraction over a batch of uploaded canvases. The forward is a
    program of the engine's registry, made over this detector
    (graphs.held): keyed by the canvas batch's shape, with the thresholds
    as a tensor, its graphs split at the stages, so the DB forward and
    the box extraction (before, at and after the CCL) replay as the
    reference's prob_fn and boxes_fn do."""

    def __init__(self, engine):
        self.engine = engine
        self.model = engine.build_detector("det")

    @property
    def program(self) -> graphs.Program:
        return graphs.held(self.engine, "det",
                           lambda: graphs.Program(self._run, "det"),
                           over=self.model)

    def forward(self, gray_up: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """gray_up: (B, S, S/2) packed nibbles (upload_bits 4) or (B, S, S)
        uint8 luma, as preprocess.pack_for_upload makes them. Returns
        (prob (B, S', S'), candidates {'boxes' (B, C, 4, 2) canvas px,
        'scores' (B, C), 'valid' (B, C)}) as device tensors; on the card
        the program's static outputs, which the next call of the same shape
        overwrites."""
        return self.program(gray_up, upload_thresholds(self.engine))

    @torch.inference_mode()
    def _run(self, gray_up: torch.Tensor, thr: torch.Tensor):
        cfg = self.engine.config
        with stage("det_forward"):
            gray_u8 = preprocess.unpack_on_device(gray_up, cfg)
            x = preprocess.det_normalize_gray(gray_u8, cfg.det_mean,
                                              cfg.det_std)
            prob = db_int8.apply_prob(self.model, x, cfg.det_int8)
        with stage("extract_boxes"):
            cand = db_boxes.extract_boxes(
                prob, thresholds=thr,
                **db_boxes.static_kwargs_from_config(cfg))
        return prob, cand


def det_state(engine) -> DetState:
    if engine._det is None:
        engine._det = DetState(engine)
    return engine._det


def pack_det(cand: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A candidate dict -> one (B, C * 10) float32 row a page: boxes (C * 8
    canvas px), scores (C), valid (C, as 0/1), so a chunk's candidates are
    one copy."""
    B, C = cand["scores"].shape
    return torch.cat([cand["boxes"].reshape(B, C * 8).float(),
                      cand["scores"].float(), cand["valid"].float()], dim=1)


def unpack_det(packed: np.ndarray, C: int):
    """Host side inverse of pack_det -> (boxes (B, C, 4, 2), scores (B, C),
    valid (B, C))."""
    B = packed.shape[0]
    return (packed[:, :C * 8].reshape(B, C, 4, 2), packed[:, C * 8:C * 9],
            packed[:, C * 9:] > 0.5)


def truncate_det(packed: torch.Tensor, C: int, Kf: int) -> torch.Tensor:
    """The first Kf slots of a pack_det row and the page's highest used
    slot plus one (n_need) -> (B, Kf * 10 + 1). Exact by construction:
    extract_boxes fills its slots in ascending raster root order (the
    sort over root values with a BIG sentinel, postprocess/db_boxes.py),
    so a page's components are a prefix of its C slots, every valid slot
    below n_need, and the host refetches the full row only where n_need
    passes Kf (fetch_det)."""
    B = packed.shape[0]
    boxes = packed[:, :C * 8].reshape(B, C, 8)[:, :Kf].reshape(B, Kf * 8)
    valid = packed[:, C * 9:C * 10]
    slot = torch.arange(1, C + 1, dtype=torch.float32, device=packed.device)
    n_need = torch.where(valid > 0.5, slot, 0.0).amax(dim=1, keepdim=True)
    return torch.cat([boxes, packed[:, C * 8:C * 8 + Kf], valid[:, :Kf],
                      n_need], dim=1)


# truncate_det's graphs (the reference's _truncate_det_jit), held by the
# module, outside every engine's registry: no engine is at hand where the
# candidates are fetched
truncate_det_program = graphs.Program(truncate_det, "truncate_det")


def fetch_det(packed_chunks: Sequence[torch.Tensor], cfg, C: int = None,
              adapt: dict = None, timer: StageTimer = None,
              stage: str = "det_fetch"):
    """pack_det rows of several chunks -> host (boxes (B, C, 4, 2), scores
    (B, C), valid (B, C)) by ocrjax's truncated first fetch
    (cfg.det_fetch_candidates = Kf): every chunk's first Kf slots a page
    are copied (all copies started before any is read), and a chunk is
    refetched whole only where a page used a later slot. Exact always:
    the prefix is padded back to C slots with invalid ones. timer: the
    StageTimer that counts the copied bytes under `stage`.

    adapt: a dict carrying a saturation latch across the calls of one
    stream (the tiled lanes pass one scoped to the engine). Dense C5 tiles
    overflow the prefix every time, so after one overflow the latch
    fetches whole rows first; it resets once a fetch's highest used slot
    is back at or under Kf / 2."""
    C = cfg.det_max_candidates if C is None else C
    Kf = cfg.det_fetch_candidates

    def count(arr):
        if timer is not None:
            timer.add_bytes(stage, arr.nbytes)
        return arr

    if not (0 < Kf < C) or (adapt or {}).get("full"):
        arr = count(bytepack.fetch(torch.cat(list(packed_chunks))
                                   if len(packed_chunks) > 1
                                   else packed_chunks[0]))
        out = unpack_det(arr, C)
        if adapt is not None and adapt.get("full") and 0 < Kf < C:
            cols = np.nonzero(out[2])[1]
            if cols.max(initial=-1) + 1 <= Kf // 2:
                adapt["full"] = False      # the stream went sparse again
        return out
    copies = [bytepack.HostCopy(truncate_det_program(p, C, Kf))
              for p in packed_chunks]
    bs, ss, vs = [], [], []
    for cp, p in zip(copies, packed_chunks):
        arr = count(cp.result())
        if arr[:, Kf * 10].max(initial=0) > Kf:  # a page used a later slot
            bytepack.refetches[stage] += 1
            b, sc, v = unpack_det(count(bytepack.fetch(p)), C)
            if adapt is not None:
                adapt["full"] = True
        else:
            n = arr.shape[0]
            b = np.zeros((n, C, 4, 2), np.float32)
            sc = np.zeros((n, C), np.float32)
            v = np.zeros((n, C), bool)
            b[:, :Kf] = arr[:, :Kf * 8].reshape(n, Kf, 4, 2)
            sc[:, :Kf] = arr[:, Kf * 8:Kf * 9]
            v[:, :Kf] = arr[:, Kf * 9:Kf * 10] > 0.5
        bs.append(b)
        ss.append(sc)
        vs.append(v)
    if len(bs) == 1:
        return bs[0], ss[0], vs[0]
    return np.concatenate(bs), np.concatenate(ss), np.concatenate(vs)


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
    boxes, scores, valid = (a[0] for a in fetch_det([pack_det(cand)], cfg))
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


def _gray_norm(engine, canvas_dev: torch.Tensor) -> torch.Tensor:
    cfg = engine.config
    return preprocess.gray_normalize(
        preprocess.unpack_on_device(canvas_dev, cfg), cfg.rec_mean,
        cfg.rec_std)


def gray_norm(engine, canvas_dev: torch.Tensor) -> torch.Tensor:
    """Uploaded (packed) luma canvases -> (B, S, S) float32 pages normalized
    for the warps; a program (the reference's _gray_norm_jit), whose static
    output the next call of the same shape overwrites."""
    return graphs.program(engine, "gray_norm", _gray_norm)(engine,
                                                          canvas_dev)


def decode(engine, logits: torch.Tensor, frame_lengths: torch.Tensor,
           beam: bool = False):
    """CTC decode of the CRNN's logits: greedy, or the prefix beam search
    at cfg.ctc_beam_width."""
    cfg = engine.config
    with stage("ctc"):
        if beam:
            return ctc.ctc_beam_decode(logits, frame_lengths,
                                       blank=cfg.ctc_blank,
                                       max_tokens=cfg.rec_max_tokens,
                                       beam_width=cfg.ctc_beam_width)
        return ctc.ctc_greedy_decode(logits, frame_lengths,
                                     blank=cfg.ctc_blank,
                                     max_tokens=cfg.rec_max_tokens)


def rec_decode(engine, strips: torch.Tensor, widths: torch.Tensor,
               beam: bool = False):
    """The recognizer and CTC over normalized device strips (N, H, W) ->
    (tokens (N, T), n_tokens (N,), conf (N,)) device tensors; every lane
    reaches the recognizer here. The forward is the stage named after the
    architecture, cfg.rec_arch: "crnn" or "svtr". An engine whose
    recognizer is not the one the config names is refused."""
    arch = engine.config.rec_arch
    if engine.rec_model.arch != arch:
        raise ValueError(
            f"rec_arch is {arch!r} but the engine's recognizer is a "
            f"{engine.rec_model.arch!r}: build the engine with the config "
            f"that names its recognizer")
    with stage(arch):
        logits, frame_lengths = engine.rec_model(strips[:, None], widths)
    return decode(engine, logits, frame_lengths, beam)


# strips the recognizer ran and the grid columns (W / 4 a strip, the CTC
# frames) it computed: count-bucket rows x bucket width / 4 a call, summed
# on the host from the shapes each lane passes to its recognition program
# (no device read); the CLI's --profile prints them
rec_counts: collections.Counter = collections.Counter()


def count_rec(rows: int, width: int) -> None:
    rec_counts.update(strips=rows, columns=rows * (width // 4))


@torch.inference_mode()
def _rec_strips(engine, strips: torch.Tensor, widths: torch.Tensor,
                beam: bool = False):
    strips = warp_lib.maybe_dewarp_curl(strips, widths, engine.config)
    return rec_decode(engine, strips, widths, beam)


def rec_strips(engine, strips: torch.Tensor, widths: torch.Tensor,
               beam: bool = False):
    """Recognition of normalized device strips (N, H, W) with their widths,
    the staged and pooled lanes' order: dewarp (rec_dewarp_curl), CRNN,
    CTC -> (tokens (N, T), n_tokens (N,), conf (N,)) device tensors. The
    crops should already be ink-refined (ops.warp two-pass warps). A
    program keyed per (N, bucket width) (the reference's _rec_strips_jit);
    inside another program it runs as part of that one."""
    return graphs.program(engine, "rec_strips", _rec_strips)(
        engine, strips, widths, beam)


def pack_rec(engine, tokens: torch.Tensor, n_tokens: torch.Tensor,
             conf: torch.Tensor) -> torch.Tensor:
    """Recognition outputs -> one row a line, one copy for a chunk:
    (n, T + 5) uint8 under cfg.fetch_bytes (tokens, n_tokens, conf's four
    bytes; ops.bytepack), else (n, T + 2) float32 (tokens, n_tokens,
    conf)."""
    if bytepack.use_byte_fetch(engine):
        return torch.cat([tokens.to(torch.uint8),
                          n_tokens[:, None].to(torch.uint8),
                          bytepack.f32_to_bytes(conf[:, None])], dim=1)
    return torch.cat([tokens.float(), n_tokens[:, None].float(),
                      conf[:, None].float()], dim=1)


def unpack_rec(packed: np.ndarray, max_tokens: int):
    """Host side inverse of pack_rec (either dtype) -> (tokens (n, T) int32,
    n_tokens (n,) int32, conf (n,) float32)."""
    T = max_tokens
    if packed.dtype == np.uint8:
        return (packed[:, :T].astype(np.int32),
                packed[:, T].astype(np.int32),
                bytepack.bytes_to_f32(packed[:, T + 1:T + 5])[:, 0])
    return (packed[:, :T].astype(np.int32), packed[:, T].astype(np.int32),
            packed[:, T + 1])


def pack_rec_flip(engine, tokens: torch.Tensor, n_tokens: torch.Tensor,
                  conf: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """pack_rec with the orientation stage's flips: (n, T + 6) uint8
    (tokens, n_tokens, flip, conf's four bytes) under cfg.fetch_bytes,
    else (n, T + 3) float32 with conf before flip (the reference's legacy
    column order)."""
    if bytepack.use_byte_fetch(engine):
        return torch.cat([tokens.to(torch.uint8),
                          n_tokens[:, None].to(torch.uint8),
                          flip[:, None].to(torch.uint8),
                          bytepack.f32_to_bytes(conf[:, None])], dim=1)
    return torch.cat([tokens.float(), n_tokens[:, None].float(),
                      conf[:, None].float(), flip[:, None].float()], dim=1)


def unpack_rec_flip(packed: np.ndarray, max_tokens: int):
    """Host side inverse of pack_rec_flip (either dtype) -> (tokens,
    n_tokens, conf, flipped)."""
    T = max_tokens
    if packed.dtype == np.uint8:
        return (packed[:, :T].astype(np.int32),
                packed[:, T].astype(np.int32),
                bytepack.bytes_to_f32(packed[:, T + 2:T + 6])[:, 0],
                packed[:, T + 1] > 0)
    return (packed[:, :T].astype(np.int32), packed[:, T].astype(np.int32),
            packed[:, T + 1], packed[:, T + 2] > 0.5)


def _cls_margins(engine, strips: torch.Tensor, widths: torch.Tensor):
    """Orientation margins -> (the strips rotated 180 degrees, margin);
    positive means flipped. The symmetric ensemble logit(s) -
    logit(rot180 s) by default; one classifier pass with margin 2 logit(s)
    when cfg.cls_single_pass is on and the cls asset carries the
    antisymmetry certificate (engine.cls_antisym)."""
    cfg = engine.config
    pad = (0.0 - cfg.rec_mean) / cfg.rec_std
    with stage("cls"):
        rot = cls_lib.flip_strips_by_width(
            strips, widths, torch.ones(strips.shape[:1], dtype=torch.bool,
                                       device=strips.device), pad)
        if cfg.cls_single_pass and engine.cls_antisym:
            return rot, 2.0 * engine.cls_model(strips[:, None], widths)
        n = strips.shape[0]
        logit = engine.cls_model(torch.cat([strips, rot])[:, None],
                                 torch.cat([widths, widths]))
        return rot, logit[:n] - logit[n:]


def apply_page_prior(margin: torch.Tensor, widths: torch.Tensor,
                     seg_ids: torch.Tensor, alpha: float, clip: float = 8.0
                     ) -> torch.Tensor:
    """margin_i + alpha * (width-weighted mean of its group's margins, each
    clipped to +-clip): lines of one page borrow its orientation consensus,
    while a line with strong evidence of its own still overrides. Group ids
    must be dense in [0, len(margin))."""
    n = margin.shape[0]
    w = widths.float()
    seg = seg_ids.long()
    num = torch.zeros(n, device=margin.device).index_add_(
        0, seg, torch.clamp(margin, -clip, clip) * w)
    den = torch.zeros(n, device=margin.device).index_add_(0, seg, w)
    return margin + alpha * (num[seg] / torch.clamp(den[seg], min=1.0))


def _cls_flip_strips(engine, strips: torch.Tensor, widths: torch.Tensor,
                     seg_ids: torch.Tensor = None,
                     prior_weights: torch.Tensor = None):
    """The orientation stage in front of recognition: classify every strip
    and its rotation, add the page prior over seg_ids groups (None: every
    line decides alone), rotate the losers. prior_weights replaces the
    widths as the prior's weights (the fused lane zeroes its empty slots).
    Returns (strips, flipped)."""
    rot, margin = _cls_margins(engine, strips, widths)
    cfg = engine.config
    if seg_ids is not None and cfg.cls_page_prior > 0:
        margin = apply_page_prior(
            margin, widths if prior_weights is None else prior_weights,
            seg_ids, cfg.cls_page_prior)
    flipped = margin > 0
    return torch.where(flipped[:, None, None], rot, strips), flipped


@torch.inference_mode()
def rec_strips_flip(engine, strips: torch.Tensor, widths: torch.Tensor,
                    seg_ids: torch.Tensor, beam: bool = False):
    """rec_try_flip's recognition on the staged lane: orientation stage
    (seg_ids groups the lines of one page), then rec_strips (dewarp, CRNN,
    CTC) -> (tokens, n_tokens, conf, flipped) device tensors."""
    strips, flipped = _cls_flip_strips(engine, strips, widths,
                                       seg_ids.to(strips.device))
    return (*rec_strips(engine, strips, widths, beam), flipped)


def _rec_strips_flip_packed(engine, strips, widths, seg_ids, beam):
    return pack_rec_flip(engine, *rec_strips_flip(engine, strips, widths,
                                                  seg_ids, beam))


def rec_strips_flip_packed(engine, strips: torch.Tensor,
                           widths: torch.Tensor, seg_ids: torch.Tensor,
                           beam: bool = False) -> torch.Tensor:
    """pack_rec_flip of rec_strips_flip as one program (the reference's
    _rec_strips_flip_packed_jit): the staged lane's try-flip recognition
    in one fetched row a line."""
    return graphs.program(engine, "rec_strips_flip_packed",
                          _rec_strips_flip_packed)(
        engine, strips, widths, seg_ids, beam)


@torch.inference_mode()
def rec_strips_forced_flip(engine, strips: torch.Tensor,
                           widths: torch.Tensor, flip: torch.Tensor,
                           beam: bool = False):
    """rec_strips_flip with the flip decisions already made (the pooled
    lane's second phase): rotate the chosen strips, recognize."""
    cfg = engine.config
    with stage("cls"):
        strips = cls_lib.flip_strips_by_width(
            strips, widths, flip, (0.0 - cfg.rec_mean) / cfg.rec_std)
    return (*rec_strips(engine, strips, widths, beam), flip)


@torch.inference_mode()
def _cls_margins_multi(engine, gray_dev: torch.Tensor,
                       page_ids: torch.Tensor, quads: torch.Tensor,
                       bucket_width: int) -> torch.Tensor:
    cfg = engine.config
    with stage("warp_refine"):
        strips, widths = warp_lib.warp_quads_multi(
            gray_dev, page_ids, quads, rec_height=cfg.rec_height,
            bucket_width=bucket_width,
            pad_value=(0.0 - cfg.rec_mean) / cfg.rec_std)
    return _cls_margins(engine, strips, widths)[1]


def cls_margins_multi(engine, gray_dev: torch.Tensor,
                      page_ids: torch.Tensor, quads: torch.Tensor,
                      bucket_width: int) -> torch.Tensor:
    """Orientation margins of quads warped off several pages with the plain
    (un-refined) homography warp: the pooled lane's first phase, whose
    margins go to the host for the page prior over whole pages. A program
    (the reference's _cls_margins_multi_jit), whose static output the next
    call of the same shape overwrites."""
    return graphs.program(engine, "cls_margins_multi", _cls_margins_multi)(
        engine, gray_dev, page_ids, quads, bucket_width)


def reading_order(quads: Sequence[np.ndarray], flipped) -> List[int]:
    """Reading order of a page's quads; a page whose lines mostly flipped
    is upside down and reads from the bottom right."""
    if sum(bool(f) for f in flipped) * 2 > len(quads):
        return geometry.sort_reading_order([-q for q in quads])
    return geometry.sort_reading_order(quads)


def rot90_redo(engine, img: np.ndarray, beam: bool = False,
               color: bool = False) -> "OcrResult":
    """Redo a landscape scan rotated 90 degrees counter-clockwise and map
    the boxes back. A wrong direction leaves the lines upside down, which
    the orientation stage corrects, so the redo needs rec_try_flip."""
    from ocrjax_torch.api import DetBox, OcrLine, OcrResult

    res = ocr(engine, np.ascontiguousarray(np.rot90(img)), beam=beam,
              color=color, _allow_rot90=False)
    w = img.shape[1]
    return OcrResult(lines=[
        OcrLine(box=DetBox(geometry.rot90_ccw_to_orig(line.box.quad, w),
                           line.box.score),
                text=line.text, confidence=line.confidence)
        for line in res.lines], truncated=res.truncated)


def _is_landscape(cfg, quads: np.ndarray) -> bool:
    """The rot90 reroute's test: rec_try_flip on and a median box tilt past
    cfg.rot90_tilt_deg."""
    return bool(cfg.rec_try_flip and cfg.rot90_tilt_deg > 0 and float(
        np.median(geometry.quad_tilt_deg(quads))) > cfg.rot90_tilt_deg)


def ocr(engine, image, beam: bool = False, force_staged: bool = False,
        color: bool = False, _allow_rot90: bool = True) -> "OcrResult":
    """One page: detect, warp on the device, recognize, order.
    force_staged skips the fused fast path (the fused lane's reroutes use
    it). color=True runs the staged pipeline over min-channel luma so
    saturated coloured ink keeps its contrast. _allow_rot90 keeps the
    landscape redo from recursing."""
    from ocrjax_torch.api import DetBox, OcrLine, OcrResult

    cfg = engine.config
    # an explicit projection, so the canvas is resized in RGB first, as the
    # reference's ocr() does (detect() takes the luma-first decode)
    gray_fn = preprocess.to_gray_minchannel if color else preprocess.to_gray
    if color:
        force_staged = True
    if cfg.ocr_single_fused and not force_staged:
        # a grey page stays 2-D: the fused decode reads its one channel,
        # and the routes that need RGB reload it through load_image
        img = preprocess.load_page(image, auto_invert=cfg.auto_invert)
        if max(img.shape[:2]) <= cfg.det_max_side:
            # latency path: one device program for a page that fits the
            # canvas; saturated and tilted pages are redone inside
            from ocrjax_torch import fused as F
            return F.ocr_pages_fused(engine, [img], beam=beam)[0]
        image = img

    img, canvas, canvas_dev, scale, boxes, scores, valid = \
        _detect_canvas(engine, image, gray_fn=gray_fn)
    idx = np.where(valid)[0]
    if len(idx) == 0:
        return OcrResult(lines=[])
    # a median box tilt near 90 degrees: a landscape scan, redone rotated
    # (tilt does not depend on scale, so the canvas boxes decide)
    if _allow_rot90 and _is_landscape(cfg, boxes[idx]):
        return rot90_redo(engine, img, beam=beam, color=color)
    if scale < 0.999:
        # a downscaled page is recognized from crops of the ORIGINAL image
        # at full resolution, not from the blurred canvas
        return _ocr_from_original(engine, img, scale, boxes, scores, idx,
                                  beam=beam, gray_fn=gray_fn)

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
    nb = cfg.line_bucket_for_count(n)
    pad = nb - n
    if pad > 0:
        # pad rows repeat the last quad; they never reach the result
        quads_canvas = np.concatenate(
            [quads_canvas, np.tile(quads_canvas[-1:], (pad, 1, 1))])
        quads_orig_canvas = np.concatenate(
            [quads_orig_canvas, np.tile(quads_orig_canvas[-1:], (pad, 1, 1))])

    strips, widths = staged_warp(
        engine, canvas_dev, upload(engine, quads_canvas.astype(np.float32)),
        upload(engine, page_bounds),
        upload(engine, quads_orig_canvas.astype(np.float32)), bucket_w)
    count_rec(nb, bucket_w)
    if cfg.rec_try_flip:
        # the page's lines share one prior group; each pad row (a copy of
        # the last quad) votes alone
        engine.warn_untrained_cls()
        seg = np.concatenate([np.zeros(n, np.int64),
                              np.arange(1, nb - n + 1)])
        tokens, n_tokens, conf, flips = unpack_rec_flip(
            bytepack.fetch(rec_strips_flip_packed(
                engine, strips, widths, upload(engine, seg), beam)),
            cfg.rec_max_tokens)
        flips = flips[:n]
    else:
        out = rec_strips(engine, strips, widths, beam)
        tokens, n_tokens, conf = (t.cpu().numpy() for t in out)
        flips = []

    with stage("assemble", device=False):
        quads_orig = [geometry.scale_quads(boxes[i], scale) for i in idx]
        lines = []
        for k in reading_order(quads_orig, flips):
            lines.append(OcrLine(
                box=DetBox(quads_orig[k], float(scores[idx[k]])),
                text=engine.charset.decode(tokens[k][: n_tokens[k]]),
                confidence=float(conf[k])))
        return OcrResult(lines=lines)


@torch.inference_mode()
def _staged_warp(engine, canvas_dev: torch.Tensor, q_dev: torch.Tensor,
                 bounds: torch.Tensor, orig_quads: torch.Tensor,
                 bucket_w: int):
    cfg = engine.config
    pad_v = (0.0 - cfg.rec_mean) / cfg.rec_std
    with stage("warp_refine"):
        gray = _gray_norm(engine, canvas_dev)[0]
        if cfg.rec_snap_to_ink:
            return warp_lib.warp_quads_refined(
                gray, q_dev, bounds, rec_height=cfg.rec_height,
                bucket_width=bucket_w,
                ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
                margin_fracs=(cfg.rec_crop_margin, cfg.rec_crop_margin),
                x_margin_keep=cfg.rec_ink_x_margin_keep, pad_value=pad_v,
                orig_quads=orig_quads, flat_frac=cfg.rec_flat_band_frac,
                case_gate=cfg.rec_flat_case_gate)
        return warp_lib.warp_quads(gray, q_dev, rec_height=cfg.rec_height,
                                   bucket_width=bucket_w, pad_value=pad_v)


def staged_warp(engine, canvas_dev: torch.Tensor, q_dev: torch.Tensor,
                bounds: torch.Tensor, orig_quads: torch.Tensor,
                bucket_w: int):
    """The staged lane's crops of one uploaded canvas: normalize, then the
    exact homography warp with its ink refine and re-warp (or the plain
    warp without rec_snap_to_ink) of the (n, 4, 2) expanded quads q_dev
    (orig_quads: the tight ones; bounds: the page's (max x, max y)) ->
    (strips (n, H, bucket_w), widths (n,)). A program keyed per (n,
    bucket width), the reference's jitted warps."""
    return graphs.program(engine, "staged_warp", _staged_warp)(
        engine, canvas_dev, q_dev, bounds, orig_quads, bucket_w)


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

    with stage("assemble", device=False):
        return OcrResult(lines=[
            OcrLine(box=DetBox(quads_orig[k], ss[k]), text=rs[k].text,
                    confidence=rs[k].confidence)
            for k in reading_order(quads_orig, [r.flipped for r in rs])])


def _ocr_from_original(engine, img, scale, boxes, scores, idx,
                       beam: bool = False, gray_fn=None):
    """Full-resolution recognition of one downscaled page: axis-aligned
    hull crops of the original image through recognize_strips."""
    from ocrjax_torch.api import OcrResult

    quads_orig, strips, ss = _fullres_strips(
        engine, img, scale, boxes, scores, idx, gray_fn=gray_fn)
    if not strips:
        return OcrResult(lines=[])
    return _assemble_fullres_page(quads_orig, ss, engine.recognize_strips(
        strips, beam=beam, same_page=True))


def ocr_fullres_batch(engine, images, beam: bool = False
                      ) -> List["OcrResult"]:
    """Pooled staged lane for DOWNSCALED pages: chunked batched detection
    (every chunk dispatched before any candidate is read), then all pages'
    full-resolution host crops in one recognize_strips round with a prior
    group per page. A page that fails to decode yields an empty result; a
    landscape scan is redone rotated."""
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
        cands.append(pack_det(st.forward(
            upload(engine, preprocess.pack_for_upload(grays, cfg)))[1]))
    boxes, scores, valid = fetch_det(cands, cfg)

    items = []
    for row, i in enumerate(live):
        nh, nw = valid_hw[i]
        cx = boxes[row, :, :, 0].mean(axis=1)
        cy = boxes[row, :, :, 1].mean(axis=1)
        idx = np.where(valid[row] & (cx < nw) & (cy < nh))[0]
        if len(idx) == 0:
            results[i] = OcrResult(lines=[])
            continue
        if _is_landscape(cfg, boxes[row, idx]):
            results[i] = rot90_redo(engine, imgs[i], beam=beam)
            continue
        items.append((i, imgs[i], scales[i], boxes[row], scores[row], idx))
    for i, res in pooled_fullres_from_boxes(engine, items, beam=beam):
        results[i] = res
    return results


def pooled_fullres_from_boxes(engine, items, beam: bool = False):
    """One pooled recognize_strips round over several downscaled pages'
    full-resolution host crops, from boxes already detected. items:
    [(key, img, scale, boxes (C, 4, 2) canvas coords, scores (C,), idx)]
    -> (key, OcrResult) pairs. Shared by ocr_fullres_batch (which detects
    first) and bucketing.ocr_pages (which has the batch's candidates)."""
    from ocrjax_torch.api import OcrResult

    all_strips, prior, refs, out = [], [], [], []
    for gi, (key, img, scale, boxes_i, scores_i, idx) in enumerate(items):
        quads_orig, strips, ss = _fullres_strips(
            engine, img, scale, boxes_i, scores_i, idx)
        if not strips:
            out.append((key, OcrResult(lines=[])))
            continue
        refs.append((key, quads_orig, ss, len(all_strips)))
        all_strips.extend(strips)
        prior.extend([gi] * len(strips))
    if all_strips:
        rs = engine.recognize_strips(all_strips, beam=beam, prior_ids=prior)
        for key, quads_orig, ss, lo in refs:
            out.append((key, _assemble_fullres_page(
                quads_orig, ss, rs[lo:lo + len(quads_orig)])))
    return out


def _estimate_strip_widths(quads: np.ndarray, rec_height: int) -> np.ndarray:
    e_top = np.linalg.norm(quads[:, 1] - quads[:, 0], axis=-1)
    e_left = np.linalg.norm(quads[:, 3] - quads[:, 0], axis=-1)
    return np.round(np.maximum(e_top, 1.0) * rec_height
                    / np.maximum(e_left, 1.0))


def ocr_batch(engine, images: Sequence, beam: bool = False
              ) -> List["OcrResult"]:
    """Batched end-to-end OCR over many pages, pooled and bucketed
    (bucketing.ocr_pages); a corrupt image yields an empty OcrResult."""
    from ocrjax_torch import bucketing
    return bucketing.ocr_pages(engine, images, beam=beam)


def detect_tiled(engine, image) -> List["DetBox"]:
    """Tiled detection of a high-resolution page (tiling.detect_tiled)."""
    from ocrjax_torch import tiling
    return tiling.detect_tiled(engine, image)
