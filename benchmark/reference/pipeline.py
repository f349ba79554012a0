"""The plain reference of the three served lanes, page by page, in float32.

It follows the published semantics of each lane as the shipped
configuration states them, from the raw page pixels and the asset files:
  * the detection canvas (601 luma, float32 bilinear downscale with
    replicate padding) and the 4-bit Bayer dither of the upload, worked
    out again here, then the DB detector in float32 and the box extraction
    (`boxes.extract_boxes`, the fixed-sweep labeling included);
  * "pooled" (`OcrEngine.ocr_batch`): every page's lines pooled by strip
    width bucket, near-axis-aligned ones through the separable crop and
    the others through the homography warp, each with the ink refine and
    re-warp (`warp.py`), then the recognizer and greedy CTC;
  * "fused" (`ocr_batch(fused=True)` and `ocr` of a page that fits the
    canvas): the page's K best boxes, the separable crop at the fixed
    bucket width with its AABB ink refine, the recognizer and CTC; a page
    with a tilted line or with all K slots used is redone on the pooled
    lane;
  * the recognizer: the configuration's, `recognizers.resolve` (the CRNN,
    `rec_crnn.py`, where it names none);
  * "tiled" (`ocr_tiled_batch`): the tile plan with the blank-tile
    prescreen, the tile detector on each tile, the seam merge, each line
    recognized from the tile that holds its crop, and the lines no tile
    holds from a host crop of the page.
Lines come back in reading order. Nothing here is batched across pages
where the lanes pool for speed: every line's crop and recognition depend
on its own page only. Pages downscaled onto the canvas, the orientation
stage and beam search are outside what the cells run, and raise.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from . import boxes as B
from . import flatband, geometry, models as M, recognizers
from . import warp as W

FLAGSHIP_ARCH = dict(channels=(64, 128, 256, 512), blocks_per_stage=2,
                     inner=96)
_BAYER4 = (np.array([[0, 8, 2, 10], [12, 4, 14, 6],
                     [3, 11, 1, 9], [15, 7, 13, 5]], np.uint16) * 34 + 17)


# ---------------------------------------------------------------------------
# Host preprocessing
# ---------------------------------------------------------------------------

def to_rgb(page: np.ndarray) -> np.ndarray:
    page = np.asarray(page)
    return np.stack([page] * 3, axis=-1) if page.ndim == 2 else page


def to_gray(img: np.ndarray) -> np.ndarray:
    """601 luma in 15-bit fixed point, (9798 R + 19235 G + 3735 B + 16384)
    >> 15; a grey pixel keeps its value."""
    if img.ndim == 2:
        return img
    c = img.astype(np.uint32)
    y = (9798 * c[..., 0] + 19235 * c[..., 1] + 3735 * c[..., 2]
         + 16384) >> 15
    return y.astype(np.uint8)


def inverted(img: np.ndarray, stride: int = 4) -> bool:
    """Light ink on dark: the lower median of the subsampled channel sums
    below 384."""
    sub = img[::stride, ::stride]
    sums = (sub.astype(np.int32).sum(axis=2) if sub.ndim == 3
            else 3 * sub.astype(np.int32)).ravel()
    k = (sums.size + 1) // 2 - 1
    return int(np.partition(sums, k)[k]) < 384


def canvas(page: np.ndarray, cfg):
    """-> (S x S uint8 luma canvas, scale, (valid h, valid w))."""
    img = np.asarray(page)
    if cfg.auto_invert and inverted(img):
        img = np.asarray(255 - img, np.uint8)
    luma = to_gray(img)
    S = cfg.det_max_side
    h, w = luma.shape
    scale = min(S / max(h, w), 1.0)
    nh = max(1, int(np.floor(h * scale + 0.5)))
    nw = max(1, int(np.floor(w * scale + 0.5)))
    if (nh, nw) != (h, w):
        raise NotImplementedError("a page larger than the canvas takes the "
                                  "full-resolution lane, not covered here")
    out = np.empty((S, S), np.uint8)
    out[:nh, :nw] = luma
    out[nh:, :nw] = out[nh - 1:nh, :nw]
    out[:, nw:] = out[:, nw - 1:nw]
    return out, nh / h, (nh, nw)


def dither(gray: np.ndarray) -> np.ndarray:
    """The 4-bit upload as the device sees it: q = floor(g / 17 + (2b + 1)
    / 32) with b the Bayer 4 x 4 threshold of the pixel's absolute row and
    column, as levels 17 q."""
    H, W_ = gray.shape[-2:]
    bay = np.tile(_BAYER4, (H // 4 + 1, W_ // 4 + 1))[:H, :W_]
    q = ((gray.astype(np.uint16) << 5) + bay) // 544
    return (q * 17).astype(np.uint8)


def scale_shift(u8: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(u8 / 255 - mean) / std with the product rounded once."""
    c = float(np.float32(1.0 / 255.0))
    m = float(np.float32(mean))
    return (u8.double() * c - m).float() * (1.0 / std)


def det_input(levels: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, S) uint8 -> (B, 3, S, S) float32, per-channel normalized."""
    mean = torch.tensor(cfg.det_mean, dtype=torch.float32,
                        device=levels.device).view(1, 3, 1, 1)
    inv = 1.0 / torch.tensor(cfg.det_std, dtype=torch.float32,
                             device=levels.device).view(1, 3, 1, 1)
    return (levels.float()[:, None] * (1.0 / 255.0) - mean) * inv


def resize_linear_u8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """uint8 (H, W) bilinear resize with 11-bit fixed-point weights and an
    int32 row pass (the 2 x 2 box average at an exact 2:1 downscale)."""
    h, w = img.shape
    if (nh, nw) == (h, w):
        return img.copy()
    if h == 2 * nh and w == 2 * nw:
        a = img.astype(np.int32)
        return ((a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
                 + a[1::2, 1::2] + 2) >> 2).astype(np.uint8)

    def axis(n_in, n_out):
        f = ((np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / (
            n_out / n_in)) - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        return s, f - s.astype(np.float32)

    def fixed(frac):
        one, k = np.float32(1.0), np.float32(2048.0)
        return (np.rint((one - frac) * k).astype(np.int32),
                np.rint(frac * k).astype(np.int32))

    sx, fx = axis(w, nw)
    lo, hi = sx < 0, sx >= w - 1
    fx = np.where(lo | hi, np.float32(0.0), fx)
    sx = np.where(lo, 0, np.where(hi, w - 1, sx))
    a0, a1 = (a.reshape(1, -1) for a in fixed(fx))
    sy, fy = axis(h, nh)
    b0, b1 = (b.reshape(-1, 1) for b in fixed(fy))
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    src = img.astype(np.int32)
    rows = src[:, sx] * a0 + src[:, np.minimum(sx + 1, w - 1)] * a1
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
           + 2) >> 2
    return out.astype(np.uint8)


def ink_crop_host(gray, x0, y0, x1, y1, margin_left_px, margin_right_px,
                  x_margin_keep, flat_frac, box_h_px=0.0, ink_thresh=128,
                  min_count=2) -> np.ndarray:
    """A crop window of the page tightened to the ink band through its
    vertical centre, padded as the strip refine pads (half-to-even
    rounding); a flat band is rendered at flat_frac of the strip height."""
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


# ---------------------------------------------------------------------------
# Tiles
# ---------------------------------------------------------------------------

def axis_plan(total: int, tile: int, overlap: int, quantum: int):
    if total <= tile:
        return [(0, min(tile, -(-total // quantum) * quantum))]
    stride = max(tile - overlap, 1)
    starts = list(range(0, total - tile, stride))
    rem = total - (starts[-1] + tile) + overlap
    size = min(tile, -(-rem // quantum) * quantum)
    return [(s, tile) for s in starts] + [(total - size, size)]


def tile_plan(h: int, w: int, cfg):
    """(y, x, th, tw) tiles covering the page, sorted by shape."""
    q = max(cfg.tile_size // 8, 32)
    ys = axis_plan(h, cfg.tile_size, cfg.tile_overlap, q)
    xs = axis_plan(w, cfg.tile_size, cfg.tile_overlap, q)
    corners = [(y, x, th, tw) for (y, th) in ys for (x, tw) in xs]
    corners.sort(key=lambda c: (c[2], c[3], c[0], c[1]))
    return corners


def prep_tiles(gray: np.ndarray, cfg):
    """-> (corners, padded page): a tile whose 4x-subsampled luma spans
    fewer than 24 levels holds no ink and is dropped (one always stays)."""
    h, w = gray.shape
    corners = tile_plan(h, w, cfg)
    ph = max(h, max(y + th for (y, _, th, _) in corners))
    pw = max(w, max(x + tw for (_, x, _, tw) in corners))
    padded = np.pad(gray, ((0, ph - h), (0, pw - w)), mode="edge")
    if cfg.tile_blank_skip and len(corners) > 1:
        def has_ink(y, x, th, tw):
            sub = padded[y:y + th, x:x + tw][::4, ::4]
            return int(sub.max()) - int(sub.min()) >= 24
        corners = [c for c in corners if has_ink(*c)] or corners[:1]
    return corners, padded


def _seam_x_bands(corners):
    ivals = sorted(set((x, x + tw) for (_, x, _, tw) in corners))
    return [(b0, min(a1, b1)) for (a0, a1), (b0, b1)
            in zip(ivals, ivals[1:]) if b0 < a1]


def merge_seams(quads, scores, iou_thresh, x_bands, tile_ids):
    """Union of seam duplicates (hull IoU above iou_thresh) and of the
    fragments of one line that a seam cut (same row, from different
    tiles, meeting or a gap of at most 1.5 line heights in an overlap)."""
    n = len(quads)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    if n > 1:
        q = np.stack(quads)
        x0, y0 = q[:, :, 0].min(axis=1), q[:, :, 1].min(axis=1)
        x1, y1 = q[:, :, 0].max(axis=1), q[:, :, 1].max(axis=1)
        iw = np.minimum(x1[:, None], x1) - np.maximum(x0[:, None], x0)
        ih = np.minimum(y1[:, None], y1) - np.maximum(y0[:, None], y0)
        inter = np.maximum(iw, 0) * np.maximum(ih, 0)
        area = (x1 - x0) * (y1 - y0)
        iou = inter / np.maximum(area[:, None] + area - inter, 1e-9)
        dup = iou > iou_thresh
        min_h = np.maximum(np.minimum(
            (y1 - y0)[:, None], (y1 - y0)[None, :]), 1.0)
        same_row = ih >= 0.7 * min_h
        meet = iw >= 2.0
        gap0 = np.minimum(x1[:, None], x1)
        gap1 = np.maximum(x0[:, None], x0)
        small_gap = (gap1 - gap0) <= 1.5 * min_h
        in_band = np.zeros((n, n), bool)
        for (b0, b1) in x_bands:
            in_band |= (gap0 >= b0 - 4.0) & (gap1 <= b1 + 4.0)
        t = np.asarray(tile_ids)
        frag = same_row & (meet | (small_gap & in_band)) \
            & (t[:, None] != t[None, :])
        ii, jj = np.nonzero(np.triu(dup | frag, k=1))
        for i, j in zip(ii.tolist(), jj.tolist()):
            parent[find(i)] = find(j)
    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    out_q, out_s = [], []
    for members in groups.values():
        q, s = quads[members[0]], scores[members[0]]
        for m in members[1:]:
            q = geometry.merge_quads(q, quads[m])
            s = max(s, scores[m])
        out_q.append(q)
        out_s.append(s)
    return out_q, out_s


def assign_to_tiles(cfg, corners, quads, h, w):
    """Each quad to the tile holding its expanded crop, the one whose
    centre is nearest (first on a tie); quads no tile holds go to the
    host crop."""
    tile_ids, tile_quads, tile_bounds, pooled, host = [], [], [], [], []
    for qi, q in enumerate(quads):
        qh = q[:, 1].max() - q[:, 1].min() + 1.0
        m = cfg.rec_crop_margin * qh + 2.0 if cfg.rec_snap_to_ink else 2.0
        x0, x1 = q[:, 0].min() - m, q[:, 0].max() + m
        y0, y1 = q[:, 1].min() - m, q[:, 1].max() + m
        cx0, cy0 = max(x0, 0.0), max(y0, 0.0)
        cx1, cy1 = min(x1, w - 1.0), min(y1, h - 1.0)
        best = None
        for t, (ty, tx, th, tw) in enumerate(corners):
            if cx0 >= tx and cy0 >= ty and cx1 < tx + tw and cy1 < ty + th:
                c = abs(tx + tw / 2 - (x0 + x1) / 2) \
                    + abs(ty + th / 2 - (y0 + y1) / 2)
                if best is None or c < best[1]:
                    best = (t, c)
        if best is None:
            host.append(qi)
            continue
        t = best[0]
        ty, tx, th, tw = corners[t]
        pooled.append(qi)
        tile_ids.append(t)
        tile_quads.append(q - np.array([tx, ty], np.float32))
        tile_bounds.append([min(tw, w - tx) - 1.0, min(th, h - ty) - 1.0])
    return tile_ids, tile_quads, tile_bounds, pooled, host


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def page_result(quads, scores, texts, confs) -> Dict:
    """A page's lines in reading order."""
    order = geometry.sort_reading_order(quads) if len(quads) else []
    return {"quads": np.asarray([quads[k] for k in order],
                                np.float32).reshape(-1, 4, 2),
            "scores": np.asarray([scores[k] for k in order], np.float32),
            "texts": [texts[k] for k in order],
            "confs": np.asarray([confs[k] for k in order], np.float32)}


class Reference:
    """cfg: the configuration's OcrConfig values; assets: name -> path of
    the safetensors files ("det", "rec", "det_tile") and "charset"; lowp:
    None (float32), or "fp8", the check's control (models.Params)."""

    def __init__(self, cfg: Mapping, assets: Mapping[str, str], device,
                 lowp: str = None):
        self.cfg = SimpleNamespace(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg.items()})
        self.device = torch.device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.det = M.Params(M.read_safetensors(assets["det"])[0], device,
                           lowp)
        self.det_arch = dict(FLAGSHIP_ARCH,
                             head_stride=self.cfg.det_head_stride)
        self.rec = M.Params(M.read_safetensors(assets["rec"])[0], device,
                           lowp)
        self.recognizer = recognizers.resolve(self.cfg)
        self.chars = M.load_charset(assets["charset"])
        self.tile = self.tile_arch = None
        if "det_tile" in assets:
            flat, meta = M.read_safetensors(assets["det_tile"])
            self.tile = M.Params(flat, device, lowp)
            self.tile_arch = json.loads(meta["arch"])

    # -- pieces ------------------------------------------------------------
    def _extract(self, prob: torch.Tensor, max_candidates: int,
                 head_stride: int):
        c = self.cfg
        cand = B.extract_boxes(
            prob, thresh=float(c.det_thresh),
            box_thresh=float(c.det_box_thresh),
            unclip_ratio=float(c.det_unclip_ratio),
            min_box_size=float(c.det_min_box_size),
            max_candidates=max_candidates, cc_iters=c.det_cc_iters,
            cc_downsample=max(1, c.det_cc_downsample // head_stride),
            coord_stride=head_stride)
        return cand

    def _prob(self, params, arch, levels: np.ndarray) -> torch.Tensor:
        x = det_input(torch.from_numpy(levels).to(self.device), self.cfg)
        return torch.cat([M.db_prob(params, arch, x[i:i + 4])
                          for i in range(0, x.shape[0], 4)])

    def _rec_norm(self, levels: np.ndarray) -> torch.Tensor:
        return scale_shift(torch.from_numpy(levels).to(self.device),
                           self.cfg.rec_mean, self.cfg.rec_std)

    def recognize(self, strips: torch.Tensor, widths: torch.Tensor):
        """Normalized strips (N, H, Wb), widths (N,) -> (texts, confs)."""
        texts, confs = [], []
        for lo in range(0, strips.shape[0], 128):
            logits, lens = self.recognizer.logits(
                self.rec, self.cfg, strips[lo:lo + 128], widths[lo:lo + 128])
            ids, cs = M.ctc_greedy(logits, lens, self.cfg.rec_max_tokens,
                                   self.cfg.ctc_blank)
            texts += ["".join(self.chars[i - 1] for i in seq) for seq in ids]
            confs += cs
        return texts, confs

    def _warp_kw(self, bucket_w: int):
        c = self.cfg
        return dict(rec_height=c.rec_height, bucket_width=bucket_w,
                    pad_value=(0.0 - c.rec_mean) / c.rec_std)

    def _refine_kw(self):
        c = self.cfg
        return dict(ink_thresh=(0.5 - c.rec_mean) / c.rec_std,
                    margin_fracs=(c.rec_crop_margin, c.rec_crop_margin),
                    x_margin_keep=c.rec_ink_x_margin_keep,
                    flat_frac=c.rec_flat_band_frac,
                    case_gate=c.rec_flat_case_gate)

    def pooled_rec(self, pages: torch.Tensor, page_ids: np.ndarray,
                   quads: np.ndarray, b_all: np.ndarray):
        """Recognition of quads (N, 4, 2) on normalized pages (P, S, S):
        width bucket from the tight quad (x 1.25 for the ink refine), the
        separable crop where the tilt is noise and the crop fits the row
        tile, else the homography warp; both refine to the ink and warp
        again."""
        c = self.cfg
        if not c.rec_snap_to_ink:
            raise NotImplementedError("the cells run rec_snap_to_ink")
        e_top = np.linalg.norm(quads[:, 1] - quads[:, 0], axis=-1)
        e_left = np.linalg.norm(quads[:, 3] - quads[:, 0], axis=-1)
        est_w = np.round(np.maximum(e_top, 1.0) * c.rec_height
                         / np.maximum(e_left, 1.0)) * 1.25
        ws = quads
        if c.rec_crop_margin > 0:
            ws = W.expand_quads_host(quads, c.rec_crop_margin,
                                     c.rec_crop_margin, bounds=b_all)
        tilt = geometry.quad_tilt_deg(quads)
        w_len = np.linalg.norm(quads[:, 1] - quads[:, 0], axis=1)
        h_len = np.linalg.norm(quads[:, 3] - quads[:, 0], axis=1)
        long_side = np.maximum(np.maximum(w_len, h_len), 1.0)
        thresh = np.maximum(c.fused_rotation_reroute_deg, np.degrees(
            np.arctan2(c.fused_reroute_noise_px, long_side)))
        aabb_h = ws[..., 1].max(axis=-1) - ws[..., 1].min(axis=-1)
        tile_h = min(c.pooled_sep_tile_h, int(pages.shape[1]))
        sep_ok = ((tilt <= thresh) & (aabb_h <= tile_h - 4)
                  if c.pooled_sep_warp else np.zeros(len(quads), bool))
        buckets = np.asarray(c.rec_width_buckets)
        bucket = buckets[np.searchsorted(buckets, np.minimum(est_w,
                                                             buckets[-1]))]
        texts = [None] * len(quads)
        confs = [0.0] * len(quads)
        dev = self.device
        for bw in sorted(set(bucket.tolist())):
            for sep in (True, False):
                idx = np.where((bucket == bw) & (sep_ok == sep))[0]
                if not len(idx):
                    continue
                kw = self._warp_kw(int(bw))
                if sep:
                    kw["tile_h"] = c.pooled_sep_tile_h
                fn = (W.warp_quads_multi_sep_refined if sep
                      else W.warp_quads_multi_refined)
                t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa
                    np.ascontiguousarray(a)).to(dev, dt)
                strips, widths = fn(
                    pages, t(page_ids[idx], torch.int64), t(ws[idx]),
                    t(b_all[idx]), orig_quads=t(quads[idx]),
                    **self._refine_kw(), **kw)
                tx, cs = self.recognize(strips, widths)
                for k, qi in enumerate(idx):
                    texts[qi], confs[qi] = tx[k], cs[k]
        return texts, confs

    def recognize_host_strips(self, strips: Sequence[np.ndarray]):
        """uint8 page crops -> (texts, confs): resized to the strip height
        (aspect kept), zero-padded to the width bucket of the widest
        (widths cut to it), normalized, recognized."""
        c = self.cfg
        res = [resize_linear_u8(s, c.rec_height, max(1, int(round(
            s.shape[1] * c.rec_height / s.shape[0])))) for s in strips]
        widths = np.array([r.shape[1] for r in res], np.int32)
        bw = next((b for b in c.rec_width_buckets if widths.max() <= b),
                  c.rec_width_buckets[-1])
        batch = np.zeros((len(res), c.rec_height, bw), np.uint8)
        for i, r in enumerate(res):
            batch[i, :, :min(r.shape[1], bw)] = r[:, :bw]
        x = scale_shift(torch.from_numpy(batch).to(self.device),
                        c.rec_mean, c.rec_std)
        return self.recognize(x, torch.from_numpy(
            np.minimum(widths, bw)).to(self.device))

    # -- lanes -------------------------------------------------------------
    def _canvases(self, pages):
        got = [canvas(p, self.cfg) for p in pages]
        return (np.stack([g[0] for g in got]),
                np.array([g[1] for g in got]),
                np.array([g[2] for g in got], np.int64))

    def pooled(self, pages: Sequence[np.ndarray]) -> List[Dict]:
        c = self.cfg
        grays, scales, vhw = self._canvases(pages)
        levels = dither(grays)
        cand = self._extract(self._prob(self.det, self.det_arch, levels),
                             c.det_max_candidates, c.det_head_stride)
        boxes = cand["boxes"].cpu().numpy()
        scores = cand["scores"].cpu().numpy()
        valid = cand["valid"].cpu().numpy()
        page_ids, quads, qs = [], [], []
        for i in range(len(pages)):
            nh, nw = vhw[i]
            ctr = boxes[i].mean(axis=1)
            for j in np.where(valid[i] & (ctr[:, 0] < nw)
                              & (ctr[:, 1] < nh))[0]:
                page_ids.append(i)
                quads.append(boxes[i, j])
                qs.append(float(scores[i, j]))
        out = [page_result([], [], [], []) for _ in pages]
        if not quads:
            return out
        page_ids = np.asarray(page_ids, np.int64)
        quads = np.asarray(quads, np.float32)
        b_all = (vhw[page_ids][:, ::-1].astype(np.float32) - 1.0)[:, None]
        texts, confs = self.pooled_rec(self._rec_norm(levels), page_ids, quads,
                                   b_all)
        for i in range(len(pages)):
            mine = np.where(page_ids == i)[0]
            out[i] = page_result(
                [geometry.scale_quads(quads[k], scales[i]) for k in mine],
                [qs[k] for k in mine], [texts[k] for k in mine],
                [confs[k] for k in mine])
        return out

    def fused(self, pages: Sequence[np.ndarray]) -> List[Dict]:
        c = self.cfg
        K = c.fused_lines_per_page
        Wb = next((b for b in c.rec_width_buckets
                   if 10 * c.rec_height <= b), c.rec_width_buckets[-1])
        H = c.rec_height
        grays, scales, vhw = self._canvases(pages)
        levels = dither(grays)
        prob = self._prob(self.det, self.det_arch, levels)
        n = len(pages)
        wh = torch.from_numpy(vhw[:, ::-1].astype(np.float32).copy()).to(
            self.device)
        Sd = prob.shape[-1]
        ar = torch.arange(Sd, dtype=torch.float32, device=prob.device)
        in_valid = ((ar[None, None, :] < wh[:, 0, None, None])
                    & (ar[None, :, None] < wh[:, 1, None, None]))
        prob = torch.where(in_valid, prob, 0.0)
        cand = self._extract(prob, c.det_max_candidates, c.det_head_stride)
        score = torch.where(cand["valid"], cand["scores"], -1.0)
        top_s, top_i = torch.sort(score, dim=-1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :K], top_i[:, :K]
        quads = torch.gather(cand["boxes"], 1,
                             top_i[..., None, None].expand(-1, -1, 4, 2))
        gray = self._rec_norm(levels)
        bounds = (wh - 1.0)[:, None, None, :]
        ws = W.expand_quads(quads, c.rec_crop_margin, c.rec_crop_margin,
                            bounds=bounds) if c.rec_crop_margin > 0 \
            else quads
        kw = self._warp_kw(Wb)
        strips, widths = W.warp_quads_separable(gray, ws, **kw)
        refined = W.refine_aabb_to_ink(
            strips.reshape(n * K, H, Wb), widths.reshape(n * K),
            ws.reshape(n * K, 4, 2), rec_height=H,
            bounds=bounds.expand(n, K, 1, 2).reshape(n * K, 1, 2),
            orig_quads=quads.reshape(n * K, 4, 2), **self._refine_kw())
        strips, widths = W.warp_quads_separable(
            gray, refined.reshape(n, K, 4, 2), **kw)
        line_valid = (top_s > 0.0).cpu().numpy()
        sel = np.where(line_valid.reshape(-1))[0]
        texts = [""] * (n * K)
        confs = [0.0] * (n * K)
        if len(sel):
            got, cs = self.recognize(
                strips.reshape(n * K, H, Wb)[sel],
                widths.reshape(n * K)[sel])
            for k, t, cf in zip(sel, got, cs):
                texts[k], confs[k] = t, cf
        quads = quads.cpu().numpy()
        top_s = top_s.cpu().numpy()
        out, redo = [], []
        for i in range(n):
            nh, nw = vhw[i]
            keep = [k for k in np.where(line_valid[i])[0]
                    if quads[i, k, :, 0].mean() < nw
                    and quads[i, k, :, 1].mean() < nh]
            vq = quads[i, keep]
            if (c.fused_rotation_reroute_deg > 0 and len(vq)
                    and self._reroute(vq)) or line_valid[i].sum() >= K:
                redo.append(i)
                out.append(None)
                continue
            out.append(page_result(
                [geometry.scale_quads(quads[i, k], scales[i]) for k in keep],
                [float(top_s[i, k]) for k in keep],
                [texts[i * K + k] for k in keep],
                [confs[i * K + k] for k in keep]))
        if redo:
            for i, r in zip(redo, self.pooled([pages[i] for i in redo])):
                out[i] = r
        return out

    def _reroute(self, vq: np.ndarray) -> bool:
        """A tilted elongated line, or a tilted page: the staged lane."""
        c = self.cfg
        e = vq[:, 1] - vq[:, 0]
        a = np.abs(np.degrees(np.arctan2(e[:, 1], e[:, 0]))) % 90.0
        tilt = np.minimum(a, 90.0 - a)
        w_len = np.linalg.norm(vq[:, 1] - vq[:, 0], axis=1)
        h_len = np.linalg.norm(vq[:, 3] - vq[:, 0], axis=1)
        aspect = (np.maximum(w_len, h_len)
                  / np.maximum(np.minimum(w_len, h_len), 1.0))
        elong = aspect >= c.fused_reroute_min_aspect
        long_side = np.maximum(np.maximum(w_len, h_len), 1.0)
        single_thresh = np.maximum(c.fused_rotation_reroute_deg, np.degrees(
            np.arctan2(c.fused_reroute_noise_px, long_side)))
        single = bool(np.any(elong & (tilt > single_thresh)))
        coherent = bool(elong.any()) and (
            float(np.median(tilt[elong])) > c.fused_rotation_reroute_deg)
        return single or coherent

    def tiled(self, pages: Sequence[np.ndarray]) -> List[Dict]:
        return [self._tiled_page(p) for p in pages]

    def _tiled_page(self, page: np.ndarray) -> Dict:
        c = self.cfg
        if self.tile is None or not c.tile_det_enable:
            raise NotImplementedError("the cells run the tile detector")
        img = to_rgb(page)
        if c.auto_invert:
            sub = img[::4, ::4].mean(axis=2)
            if float(np.median(sub)) < 128:
                img = np.asarray(255 - img, np.uint8)
        gray = to_gray(img)
        h, w = gray.shape
        corners, padded = prep_tiles(gray, c)
        hs = int(self.tile_arch.get("head_stride", 1))
        cap = max(c.det_max_candidates, c.tile_max_candidates)
        T = c.tile_size
        pages_dev = torch.zeros((len(corners), T, T), dtype=torch.float32,
                                device=self.device)
        quads, ss, tids = [], [], []
        for t, (y, x, th, tw) in enumerate(corners):
            levels = dither(padded[y:y + th, x:x + tw])[None]
            pages_dev[t, :th, :tw] = self._rec_norm(levels)[0]
            cand = self._extract(self._prob(self.tile, self.tile_arch,
                                            levels), cap, hs)
            bx = cand["boxes"][0].cpu().numpy()
            sc = cand["scores"][0].cpu().numpy()
            for i in np.where(cand["valid"][0].cpu().numpy())[0]:
                q = bx[i] + np.array([x, y], np.float32)
                q[:, 0] = np.clip(q[:, 0], 0, w - 1)
                q[:, 1] = np.clip(q[:, 1], 0, h - 1)
                quads.append(q)
                ss.append(float(sc[i]))
                tids.append(t)
        quads, ss = merge_seams(quads, ss, c.tile_merge_iou,
                                _seam_x_bands(corners), tids)
        if not quads:
            return page_result([], [], [], [])
        t_ids, t_quads, t_bounds, pooled, host = assign_to_tiles(
            c, corners, quads, h, w)
        texts = [None] * len(quads)
        confs = [0.0] * len(quads)
        if pooled:
            got, cs = self.pooled_rec(
                pages_dev, np.asarray(t_ids, np.int64),
                np.asarray(t_quads, np.float32),
                np.asarray(t_bounds, np.float32)[:, None, :])
            for k, qi in enumerate(pooled):
                texts[qi], confs[qi] = got[k], cs[k]
        if host:
            crops = []
            for qi in host:
                q = quads[qi]
                margin = c.rec_crop_margin * (q[:, 1].max()
                                              - q[:, 1].min() + 1)
                x0 = int(max(0, np.floor(q[:, 0].min() - margin)))
                x1 = int(min(w, np.ceil(q[:, 0].max() + margin) + 1))
                y0 = int(max(0, np.floor(q[:, 1].min() - margin)))
                y1 = int(min(h, np.ceil(q[:, 1].max() + margin) + 1))
                crops.append(ink_crop_host(
                    gray, x0, y0, x1, y1,
                    margin_left_px=max(0.0, q[:, 0].min() - x0),
                    margin_right_px=max(0.0, (x1 - 1) - q[:, 0].max()),
                    x_margin_keep=c.rec_ink_x_margin_keep,
                    flat_frac=c.rec_flat_band_frac,
                    box_h_px=(float(np.linalg.norm(q[3] - q[0]))
                              if c.rec_flat_case_gate else 0.0)))
            got, cs = self.recognize_host_strips(crops)
            for qi, t, cf in zip(host, got, cs):
                texts[qi], confs[qi] = t, cf
        return page_result(quads, ss, texts, confs)

    def run(self, lane: str, pages: Sequence[np.ndarray]) -> List[Dict]:
        with torch.inference_mode():
            return getattr(self, lane)(pages)
