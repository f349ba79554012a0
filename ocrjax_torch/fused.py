"""The fused page lane: detect (float or int8) -> extract_boxes -> top-K
lines -> separable warp (or the exact homography warp), ink refine, re-warp
-> [dewarp] -> [orientation stage] -> CRNN -> greedy or beam CTC, on the
device, for a chunk of pages at a time (port of ocrjax/fused.py).

The reference compiles this as one XLA program; here `FusedOcr` is two
graphs.Programs, each captured on the card once per key as CUDA graphs,
one a stage, and replayed from then on, with the four detection
thresholds a (4,) device tensor so that a sweep replays the same graphs.
The first detects and warps every line slot (pages a chunk times K) and
counts the occupied ones; the host reads the count, and the second runs
the CRNN and CTC on the occupied slots alone, gathered on the card, at
their count bucket (the reference recognizes every slot and the host
drops the empty ones). Both end the same way: every output of a page
packed into one row (uint8 under cfg.fetch_bytes, ops.bytepack;
unpack_fused reads it), so the host makes one copy a chunk. The host side
is the reference's pipeline: chunk k + 1 decodes on a lookahead thread
while chunk k is dispatched, each chunk's copy to the host (its first
fetch_max_tokens token columns a line) starts right after its dispatch,
and a chunk with a longer line is refetched whole. Chunk k's count is read
after chunk k + 1 is packed, so that the card has run chunk k's detection
by then.

ocr_pages_fused redoes, as the reference does, the pages this lane cannot
answer: a colour page on the staged lane over min-channel luma, tilted
pages and pages that saturate the line capacity on the bucketed lane, and
downscaled ones of those on the full-resolution lane. With rec_try_flip a
page whose lines mostly flipped reads in reversed order, and a landscape
scan reroutes to the staged lane, whose 90-degree redo rotates it.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np
import torch

from ocrjax_torch import geometry, graphs, preprocess
from ocrjax_torch.models import db_int8
from ocrjax_torch.ops import bytepack
from ocrjax_torch.ops import warp as warp_lib
from ocrjax_torch.postprocess import db_boxes
from ocrjax_torch.utils.logging import get_logger, log_fields
from ocrjax_torch.utils.profiling import add_bytes, stage


def top_k(score: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim; ties go to
    the lower index, as jax.lax.top_k breaks them."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rec_row_chunks(cfg, n: int, slots: int) -> Tuple[int, ...]:
    """Rows of each CRNN pass over a chunk's n occupied slots (of `slots`):
    passes of the largest line-count bucket while more remain, the rest at
    its bucket, never past the chunk's slots."""
    sizes, off = [], 0
    while off < n:
        sizes.append(min(cfg.line_bucket_for_count(n - off), slots - off))
        off += sizes[-1]
    return tuple(sizes)


# the fused lane's slots, summed over the chunks it recognized: "chunks",
# "slots" (B * K a chunk), "occupied" (valid line slots) and "recognized"
# (the rows the CRNN ran on); recognized / slots is the share of the
# slots recognized
slot_counts: collections.Counter = collections.Counter()


class FusedOcr:
    """Device programs of the fused lane for one (K, bucket width, greedy
    or beam, warp kind), the engine's config and its detector at
    construction (the detector is built then, outside the programs).
    separable_warp=False takes the exact homography warp grouped per page
    and the homography ink refine in place of the separable AABB crop and
    its AABB refine (the reference's make_fused_ocr_fn switch).

    Two programs a chunk. `program` detects, warps the top-K line slots of
    every page (and classifies them under rec_try_flip) and counts the
    occupied slots; `rec_program` gathers the occupied slots, runs the
    CRNN and CTC on them at their count bucket (rec_row_chunks) and puts
    the results back in their slots of the packed rows, every empty slot
    0. The host reads the count in between: detect, count, recognize
    (ocr_pages_fused reads it once the next chunk is packed)."""

    def __init__(self, engine, lines_per_page: int = 32,
                 bucket_width: int = 320, beam: bool = False,
                 separable_warp: bool = True):
        self.engine = engine
        self.cfg = engine.config
        self.det_model = engine.det_model
        self.K = lines_per_page
        self.W = bucket_width
        self.beam = beam
        self.separable_warp = separable_warp
        self.program = graphs.Program(self._detect, "fused")
        self.rec_program = graphs.Program(self._recognize, "fused_rec")

    def programs(self):
        return (self.program, self.rec_program)

    def __call__(self, gray_up: torch.Tensor, thr, valid_wh: torch.Tensor
                 ) -> torch.Tensor:
        """gray_up: (B, S, S/2) packed nibbles (upload_bits 4) or (B, S, S)
        uint8 luma; thr: (det_thresh, box_thresh, unclip_ratio,
        min_box_size), a (4,) float32 tensor on the device
        (api_det.upload_thresholds) or four floats, uploaded here;
        valid_wh: (B, 2) float32 valid page (w, h) on the
        canvas. On the card the result is the program's static output,
        which the next call of the same shape overwrites. Returns one
        packed row a page (unpack_fused): tokens (B,
        K, T), n_tokens (B, K), valid (B, K), [flipped (B, K),] conf (B,
        K), quads (B, K, 4, 2) canvas px, scores (B, K) as
        (B, K * (T + 42)) uint8, one more K columns under rec_try_flip,
        with cfg.fetch_bytes; else tokens, n_tokens, conf, quads,
        scores, valid, [flipped] as (B, K * (T + 12)) float32, one more
        K with rec_try_flip. An empty slot's tokens, n_tokens and conf
        read 0."""
        det = self.detect(gray_up, thr, valid_wh)
        return self.recognize(det, self.count(det))

    def detect(self, gray_up: torch.Tensor, thr, valid_wh: torch.Tensor):
        """The first program (arguments as __call__'s), and the copy of its
        occupied-slot count to the host started behind it: the handle
        that count() and recognize() take."""
        from ocrjax_torch.api_det import upload
        if not isinstance(thr, torch.Tensor):
            thr = upload(self.engine, np.asarray(thr, np.float32))
        out = self.program(gray_up, thr, valid_wh)
        return out, bytepack.HostCopy(out[-1])

    @staticmethod
    def count(det) -> int:
        """The chunk's occupied slots, read on the host (fused_count: the
        wait for the first program where it has not finished)."""
        return int(det[1].result("fused_count")[0])

    def recognize(self, det, n_valid: int) -> torch.Tensor:
        """The second program over detect()'s outputs, at n_valid's row
        chunks -> the packed rows (__call__). No call of the first
        program of the same shape may come between detect() and this."""
        out = det[0][:-1]
        slots = out[0].shape[0]
        sizes = rec_row_chunks(self.cfg, n_valid, slots)
        slot_counts.update(chunks=1, slots=slots, occupied=n_valid,
                           recognized=sum(sizes))
        return self.rec_program(*out, sizes)

    @torch.inference_mode()
    def _detect(self, gray_up: torch.Tensor, thr: torch.Tensor,
                valid_wh: torch.Tensor):
        """-> strips (B*K, H, W), widths (B*K,), order (B*K,): the slots,
        occupied first, line_valid (B, K), flip (B*K,), quads (B, K, 4,
        2), scores (B, K), n_valid (1,) int32."""
        from ocrjax_torch.api_det import _cls_flip_strips
        cfg, eng, K = self.cfg, self.engine, self.K
        H = cfg.rec_height
        B = gray_up.shape[0]
        with stage("det_forward"):
            gray_u8 = preprocess.unpack_on_device(gray_up, cfg)
            x = preprocess.det_normalize_gray(gray_u8, cfg.det_mean,
                                              cfg.det_std)
            prob = db_int8.apply_prob(self.det_model, x,
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
                prob, thresholds=thr,
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
            seg = torch.arange(B, device=strips.device)[:, None].expand(
                B, K).reshape(-1)
            strips, flip = _cls_flip_strips(
                eng, strips, widths, seg_ids=seg,
                prior_weights=widths * line_valid.reshape(B * K))
        else:
            flip = torch.zeros(B * K, dtype=torch.bool, device=strips.device)
        # the occupied slots first, in slot order
        order = torch.argsort(~line_valid.reshape(B * K), stable=True)
        n_valid = line_valid.sum().reshape(1).to(torch.int32)
        return (strips, widths, order, line_valid, flip, quads, top_s,
                n_valid)

    @torch.inference_mode()
    def _recognize(self, strips: torch.Tensor, widths: torch.Tensor,
                   order: torch.Tensor, line_valid: torch.Tensor,
                   flip: torch.Tensor, quads: torch.Tensor,
                   top_s: torch.Tensor, sizes: Tuple[int, ...]
                   ) -> torch.Tensor:
        from ocrjax_torch.api_det import crnn_decode
        cfg, eng, K = self.cfg, self.engine, self.K
        B, T = line_valid.shape[0], cfg.rec_max_tokens
        dev = strips.device
        passes, off = [], 0
        for n in sizes:
            idx = order[off:off + n]
            passes.append(crnn_decode(eng, strips[idx], widths[idx],
                                      self.beam))
            off += n
        if passes:
            rows = [torch.cat(r) for r in zip(*passes)]
        else:                                   # no occupied slot
            rows = [torch.zeros((0, T), dtype=torch.int32, device=dev),
                    torch.zeros(0, dtype=torch.int32, device=dev),
                    torch.zeros(0, dtype=torch.float32, device=dev)]
        # back to the slots: a slot's row sits at its rank in `order`;
        # the slots past the recognized rows, and every empty slot, read 0
        rank = torch.argsort(order)
        keep = line_valid.reshape(B * K)

        def to_slots(r):
            r = torch.cat([r, r.new_zeros((B * K - off,) + r.shape[1:])])
            return torch.where(keep.reshape((-1,) + (1,) * (r.dim() - 1)),
                               r[rank], 0)
        tokens, n_tokens, conf = (to_slots(r) for r in rows)
        tokens = tokens.reshape(B, K * T)
        n_tokens, conf, flip = (t.reshape(B, K) for t in (n_tokens, conf,
                                                          flip))
        quads = quads.reshape(B, K * 8)
        if bytepack.use_byte_fetch(eng):
            u8 = torch.uint8
            parts = [tokens.to(u8), n_tokens.to(u8), line_valid.to(u8)]
            if cfg.rec_try_flip:
                parts.append(flip.to(u8))
            parts += [bytepack.f32_to_bytes(conf),
                      bytepack.f32_to_bytes(quads),
                      bytepack.f32_to_bytes(top_s)]
            return torch.cat(parts, dim=1)
        parts = [tokens, n_tokens, conf, quads, top_s, line_valid]
        if cfg.rec_try_flip:
            parts.append(flip)
        return torch.cat([t.float() for t in parts], dim=1)


def unpack_fused(payload: np.ndarray, K: int, max_tokens: int,
                 try_flip: bool = False) -> Dict[str, np.ndarray]:
    """Host side inverse of FusedOcr's packed rows (the byte layout for a
    uint8 payload, the float32 one otherwise) -> tokens (B, K, T) int32,
    n_tokens (B, K) int32, conf (B, K), quads (B, K, 4, 2), scores (B, K),
    valid (B, K), flipped (B, K). try_flip must be the rec_try_flip the
    rows were made with (it adds the flip column); max_tokens is the token
    width of the rows (fetch_max_tokens after truncate_tokens)."""
    B = payload.shape[0]
    T = max_tokens
    o = 0

    def take(n):
        nonlocal o
        o += n
        return payload[:, o - n:o]

    if payload.dtype == np.uint8:
        out = {"tokens": take(K * T).reshape(B, K, T).astype(np.int32),
               "n_tokens": take(K).astype(np.int32),
               "valid": take(K) > 0,
               "flipped": (take(K) > 0 if try_flip
                           else np.zeros((B, K), bool))}
        out["conf"] = bytepack.bytes_to_f32(take(K * 4))
        out["quads"] = bytepack.bytes_to_f32(take(K * 32)).reshape(B, K, 4, 2)
        out["scores"] = bytepack.bytes_to_f32(take(K * 4))
        return out
    return {"tokens": take(K * T).reshape(B, K, T).astype(np.int32),
            "n_tokens": take(K).astype(np.int32),
            "conf": take(K),
            "quads": take(K * 8).reshape(B, K, 4, 2),
            "scores": take(K),
            "valid": take(K) > 0.5,
            "flipped": (take(K) > 0.5 if try_flip
                        else np.zeros((B, K), bool))}


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
    """The engine's FusedOcr for (K, W, beam, warp kind), an entry of its
    program registry made over the detector it reads (graphs.held)."""
    return graphs.held(
        engine, ("fused", K, W, beam, separable_warp),
        lambda: FusedOcr(engine, K, W, beam, separable_warp),
        over=engine.det_model)


def ocr_pages_fused(engine, images, lines_per_page: int = None,
                    bucket_width: int = None, beam: bool = False,
                    separable_warp: bool = True) -> List["OcrResult"]:
    """Batched page OCR through the fused lane: per-page OcrResult in
    reading order, original image coords. separable_warp=False runs the
    fused program with the exact homography warp (FusedOcr).

    Host pipeline: chunk k + 1 decodes on the lookahead thread while chunk
    k is packed, uploaded and detected (host_decode times only the wait
    for it, decode each page's work on the decode threads). Chunk k's
    occupied-slot count is read (fused_count) once chunk k + 1 is decoded,
    packed and uploaded; then chunk k's recognition is dispatched, its
    rows' first fetch_max_tokens token columns start their copy to the
    host, and chunk k + 1's detection follows (fused_dispatch);
    fused_fetch reads the rows and refetches the full rows of a chunk
    where a line has more tokens. A chunk that ran out of device memory
    at dispatch is redone in halves, up to 3 times, and fetched whole."""
    from ocrjax_torch import api_det, bucketing
    from ocrjax_torch.api import DetBox, OcrLine, OcrResult

    cfg = engine.config
    K = lines_per_page or cfg.fused_lines_per_page
    W = bucket_width or cfg.rec_bucket_for_width(10 * cfg.rec_height)
    B = len(images)
    if B == 0:
        return []
    with stage("lookup", device=False):      # the programs' caches
        fused = _fused_for(engine, K, W, beam, separable_warp)
        truncate = graphs.program(engine, "truncate_tokens",
                                  bytepack.truncate_tokens)
    if cfg.rec_try_flip:
        engine.warn_untrained_cls()
    thr = api_det.upload_thresholds(engine)
    T = cfg.rec_max_tokens
    T_f = cfg.fetch_max_tokens if 0 < cfg.fetch_max_tokens < T else 0

    def dispatch(packed: np.ndarray, wh: np.ndarray) -> torch.Tensor:
        # a copy of the program's static output: the next chunk's replay
        # overwrites that, and a refetch reads this chunk's rows after it
        return fused(api_det.upload(engine, packed), thr,
                     api_det.upload(engine, wh)).clone()

    def fetch_halving(packed: np.ndarray, wh: np.ndarray,
                      depth: int = 0) -> np.ndarray:
        """Dispatch and fetch one chunk whole; on device OOM halve it."""
        try:
            return bytepack.fetch(dispatch(packed, wh))
        except torch.cuda.OutOfMemoryError:
            if depth >= 3 or len(packed) <= 1:
                raise
            log_fields(get_logger("ocrjax_torch.fused"), "warning",
                       "device OOM: halving fused chunk",
                       chunk_pages=len(packed), depth=depth)
            mid = len(packed) // 2
            return np.concatenate([
                fetch_halving(packed[:mid], wh[:mid], depth + 1),
                fetch_halving(packed[mid:], wh[mid:], depth + 1)])

    def decode(bound):
        # the colour reroute's test rides on the decode: 601 luma can wash
        # saturated ink out, so such pages run the staged lane over
        # min-channel luma
        return preprocess.decode_chunk_to_gray(
            images, range(*bound), cfg,
            color_frac=cfg.fused_color_reroute_frac)

    C = max(1, min(cfg.fused_chunk_pages, B))
    scales = np.ones((B,), np.float64)
    valid_hw = np.zeros((B, 2), np.int64)
    ok = np.ones((B,), bool)
    colorful = set()
    bounds = [(lo, min(lo + C, B)) for lo in range(0, B, C)]
    decoded = preprocess.lookahead(decode, bounds, "host_decode",
                                   "decode_submit")

    def take(ci: int):
        """Chunk ci's decode (waited for; the next chunk's submitted), its
        pack and its upload -> the uploaded (pages, valid (w, h))."""
        lo, hi = bounds[ci]
        grays, scales[lo:hi], valid_hw[lo:hi], ok[lo:hi], col = \
            next(decoded)
        colorful.update(lo + j for j, c in enumerate(col) if c)
        wh = valid_hw[lo:hi, ::-1].astype(np.float32).copy()
        with stage("fused_dispatch"):
            packed = preprocess.pack_for_upload(grays, cfg)
            inputs.append((packed, wh))
            # the copy to the card queues behind the previous chunk's
            # detection, and runs while the host wakes from its count
            return api_det.upload(engine, packed), api_det.upload(engine, wh)

    def detect(up):
        with stage("fused_dispatch"):
            try:
                return fused.detect(up[0], thr, up[1])
            except torch.cuda.OutOfMemoryError:
                return None            # redone in halves at fetch time

    def recognize(det):
        """(rows, their copy) of a detected chunk; (None, None) where it
        ran out of device memory (redone in halves at fetch time)."""
        if det is None:
            return None, None
        n_valid = fused.count(det)
        with stage("fused_dispatch"):
            try:
                # a copy of the program's static output: the next chunk's
                # replay overwrites that, and a refetch reads this chunk's
                # rows after it
                o = fused.recognize(det, n_valid).clone()
            except torch.cuda.OutOfMemoryError:
                return None, None
            # this chunk's copy starts now and rides under the next
            # chunk's detection
            return o, bytepack.HostCopy(truncate(o, K, T, T_f) if T_f
                                        else o)

    # chunk k's count is read once chunk k + 1 is decoded, packed and
    # uploaded, when the card has run chunk k's detection; stream order
    # keeps chunk k's strips until its recognition has read them, before
    # chunk k + 1's detection replays over them
    outs, copies, inputs = [], [], []
    det = detect(take(0))
    for ci in range(len(bounds)):
        up = take(ci + 1) if ci + 1 < len(bounds) else None
        o, cp = recognize(det)
        outs.append(o)
        copies.append(cp)
        if up is not None:
            det = detect(up)
    chunks = []
    with stage("fused_fetch"):
        for o, cp, (packed, wh) in zip(outs, copies, inputs):
            if o is None:
                arr, t_eff = fetch_halving(packed, wh), T
            else:
                arr, t_eff = cp.result(), T_f or T
            add_bytes("fused_fetch", arr.nbytes)
            c = unpack_fused(arr, K, t_eff, cfg.rec_try_flip)
            if t_eff < T and c["n_tokens"].max(initial=0) > t_eff:
                full = bytepack.fetch(o)          # a line passed T_f tokens
                add_bytes("fused_fetch", full.nbytes)
                bytepack.refetches["fused_fetch"] += 1
                c = unpack_fused(full, K, T, cfg.rec_try_flip)
            chunks.append(c)
    results: List[OcrResult] = []
    reroute: List[int] = []
    with stage("assemble", device=False):
        if len(chunks) == 1:
            out = chunks[0]
        else:   # token widths differ where a chunk was refetched at T
            tw = max(c["tokens"].shape[2] for c in chunks)
            out = {k: np.concatenate([
                np.pad(c[k], ((0, 0), (0, 0), (0, tw - c[k].shape[2])))
                if k == "tokens" else c[k] for c in chunks])
                for k in chunks[0]}
        for i in range(B):
            if not ok[i]:
                results.append(OcrResult(lines=[]))
                continue
            if i in colorful:
                # colour reroute: 601 luma can wash saturated ink out, so
                # the page runs the staged lane over min-channel luma
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
            # all K slots valid (before the artifact filter): the page may
            # hold more lines than the fused capacity
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
