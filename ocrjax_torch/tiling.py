"""Tiled OCR of high-resolution pages (port of ocrjax/tiling.py).

A page larger than cfg.tile_size is cut into overlapping tiles: full tiles
march at tile_size - tile_overlap, and the remainder of each axis is one
smaller tile whose size is rounded up to a quantum, so a page costs no
redundant full tile. Tiles of one shape run through the tile detector as
one batch; their boxes come back to page coordinates, and boxes that meet
across a seam merge on the host. Recognition reuses the uploaded tiles:
each merged box is recognized from a tile that contains its whole crop,
pooled across the tiles of a window of pages (bucketing.recognize_pooled);
a line longer than any tile is cropped from the page on the host.

ocr_tiled_batch streams pages in windows of tiles. The host prepares page
i+1 on the lookahead thread (preprocess.lookahead) while page i is
uploaded, and the next window's upload and detection are issued before the
current window's candidates are read, so the card detects while the host
merges and recognizes. Under a tile mesh (parallel.mesh.shard_tiled_serving)
the ranks split each tile batch's detection (_dispatch_group).

A tile batch's candidates travel as api_det.pack_det rows and come back
through api_det.fetch_det's truncated first fetch. Dense tiles overflow
its prefix every time, so an engine-scoped latch (_det_fetch_adapt)
switches the stream to whole-row fetches after an overflow and back once
a fetch is sparse again. Host stages, as the reference names them:
tile_prep (the wait for the prep thread), tile_det_dispatch,
tile_det_fetch, tile_seam_merge, tile_assign, tile_host_fallback,
tile_assembly; the prep thread's work on each page is the host stage
tile_prep_work.
"""

from __future__ import annotations

import collections
import threading
from typing import List, Tuple

import numpy as np
import torch

from ocrjax_torch import geometry, graphs, preprocess
from ocrjax_torch.models import db_int8
from ocrjax_torch.postprocess import db_boxes
from ocrjax_torch.utils.logging import get_logger, log_fields
from ocrjax_torch.utils.profiling import current, host_stage, stage


def axis_plan(total: int, tile: int, overlap: int, quantum: int
              ) -> List[Tuple[int, int]]:
    """(start, size) intervals covering [0, total) with >= `overlap`
    overlap: full tiles at stride tile - overlap, then one remainder tile
    anchored at the end whose size is total - covered + overlap rounded up
    to a multiple of `quantum` (at most `tile`)."""
    if total <= tile:
        return [(0, min(tile, -(-total // quantum) * quantum))]
    stride = max(tile - overlap, 1)
    starts = list(range(0, total - tile, stride))
    rem = total - (starts[-1] + tile) + overlap
    size = min(tile, -(-rem // quantum) * quantum)
    return [(s, tile) for s in starts] + [(total - size, size)]


def tile_plan(h: int, w: int, cfg) -> List[Tuple[int, int, int, int]]:
    """(y, x, th, tw) tiles covering (h, w), sorted by shape so that each
    shape's tiles are contiguous."""
    q = max(cfg.tile_size // 8, 32)
    ys = axis_plan(h, cfg.tile_size, cfg.tile_overlap, q)
    xs = axis_plan(w, cfg.tile_size, cfg.tile_overlap, q)
    corners = [(y, x, th, tw) for (y, th) in ys for (x, tw) in xs]
    corners.sort(key=lambda c: (c[2], c[3], c[0], c[1]))
    return corners


def tile_grid(h: int, w: int, tile: int, overlap: int
              ) -> List[Tuple[int, int]]:
    """Top-left corners of a square overlapping grid of full tiles
    covering (h, w) (the uniform plan; the lanes use tile_plan)."""
    stride = max(tile - overlap, 1)

    def starts(total):
        if total <= tile:
            return [0]
        return list(range(0, total - tile, stride)) + [total - tile]

    return [(y, x) for y in starts(h) for x in starts(w)]


def _seam_bands(corners: List[Tuple[int, int, int, int]]):
    """X- and Y-intervals covered by tile overlaps (the seam regions)."""

    def bands(ivals):
        ivals = sorted(set(ivals))
        return [(b0, min(a1, b1)) for (a0, a1), (b0, b1)
                in zip(ivals, ivals[1:]) if b0 < a1]

    return (bands([(x, x + tw) for (_, x, _, tw) in corners]),
            bands([(y, y + th) for (y, _, th, _) in corners]))


# the seam merge's work, summed over the pages merged (one
# _merge_seam_boxes call a page): "pages", "candidates", "pairs" (the
# pairs of a page's candidates, n * (n - 1) / 2), "pairs_tested" (those
# whose y-ranges overlap, the only ones that can merge), "pairs_merged"
# (those tested that merge) and "groups" (the boxes out);
# pairs_tested / pairs is the share of the pairs tested
seam_counts: collections.Counter = collections.Counter()
_seam_counts_lock = threading.Lock()


def _row_pairs(y0: np.ndarray, y1: np.ndarray):
    """Index pairs (i, j) of the boxes whose y-ranges may overlap: every
    pair with min(y1) > max(y0), and others (a zero-height box). Sorted by
    y0, each box is paired with those after it that start above its
    bottom edge."""
    n = len(y0)
    order = np.argsort(y0, kind="stable")
    ends = np.searchsorted(y0[order], y1[order], side="left")
    cnt = np.maximum(ends - np.arange(1, n + 1), 0)
    a = np.repeat(np.arange(n), cnt)
    b = a + 1 + np.arange(len(a)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return order[a], order[b]


def _merge_seam_boxes(quads, scores, iou_thresh: float, x_bands=(),
                      tile_ids=None) -> Tuple[List[np.ndarray], List[float]]:
    """Union-merge seam duplicates (hull IoU above iou_thresh) and the
    fragments of one line cut by a seam: same row, x-ranges that meet or
    leave a gap of at most 1.5 line heights inside an overlap band. With
    tile_ids the fragment rule joins boxes of different tiles only (two
    neighbour lines of one tile may touch); the IoU rule ignores tiles.
    quads: (n, 4, 2) float32 (an array or a list of quads).

    Both rules need a positive row overlap (iou_thresh >= 0: an IoU above
    it needs one; same_row needs 0.7 of a height of at least 1), so only
    the pairs of _row_pairs are tested, each predicate in the reference's
    float32 expression on the pair vectors; with iou_thresh < 0 every pair
    is a duplicate. A group of one keeps its quad; a larger group becomes
    its members' axis-aligned hull with their best score. Groups come in
    the order of their first member."""
    n = len(quads)
    if n == 0:
        with _seam_counts_lock:
            seam_counts.update(pages=1)
        return [], []
    q = np.asarray(quads, np.float32)
    s = np.asarray(scores)
    x0, y0 = q[:, :, 0].min(axis=1), q[:, :, 1].min(axis=1)
    x1, y1 = q[:, :, 0].max(axis=1), q[:, :, 1].max(axis=1)
    root = np.arange(n)
    tested = merged = 0
    if iou_thresh < 0:
        root[:] = 0
    elif n > 1:
        i, j = _row_pairs(y0, y1)
        iw = np.minimum(x1[i], x1[j]) - np.maximum(x0[i], x0[j])
        ih = np.minimum(y1[i], y1[j]) - np.maximum(y0[i], y0[j])
        inter = np.maximum(iw, 0) * np.maximum(ih, 0)
        area = (x1 - x0) * (y1 - y0)
        iou = inter / np.maximum(area[i] + area[j] - inter, 1e-9)
        h = y1 - y0
        min_h = np.maximum(np.minimum(h[i], h[j]), 1.0)
        same_row = ih >= 0.7 * min_h
        gap0 = np.minimum(x1[i], x1[j])
        gap1 = np.maximum(x0[i], x0[j])
        small_gap = (gap1 - gap0) <= 1.5 * min_h
        in_band = np.zeros(len(i), bool)
        for (b0, b1) in x_bands:
            in_band |= (gap0 >= b0 - 4.0) & (gap1 <= b1 + 4.0)
        frag = same_row & ((iw >= 2.0) | (small_gap & in_band))
        if tile_ids is not None:
            t = np.asarray(tile_ids)
            frag &= t[i] != t[j]
        hit = (iou > iou_thresh) | frag
        tested, merged = len(i), int(hit.sum())
        # each box's label falls to the least label across its merging
        # pairs, then to its label's label, until nothing moves: a label
        # never exceeds its box, so it ends at the group's first member
        a, b = i[hit], j[hit]
        while True:
            lab = root.copy()
            m = np.minimum(root[a], root[b])
            np.minimum.at(lab, a, m)
            np.minimum.at(lab, b, m)
            lab = lab[lab]
            if np.array_equal(lab, root):
                break
            root = lab
    order = np.argsort(root)
    r = root[order]
    starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
    out = q[order[starts]]
    multi = np.diff(np.r_[starts, n]) > 1
    if multi.any():
        hx0 = np.minimum.reduceat(x0[order], starts)[multi]
        hy0 = np.minimum.reduceat(y0[order], starts)[multi]
        hx1 = np.maximum.reduceat(x1[order], starts)[multi]
        hy1 = np.maximum.reduceat(y1[order], starts)[multi]
        out[multi] = np.stack([hx0, hy0, hx1, hy0, hx1, hy1, hx0, hy1],
                              axis=1).reshape(-1, 4, 2)
    with _seam_counts_lock:
        seam_counts.update(pages=1, candidates=n, pairs=n * (n - 1) // 2,
                           pairs_tested=tested, pairs_merged=merged,
                           groups=len(starts))
    return list(out), np.maximum.reduceat(s[order], starts).tolist()


class TileForward(torch.nn.Module):
    """Packed luma tiles (n, th, tw/2) -> candidate dict, on the device:
    unpack the 4-bit upload, normalize, run the tile detector (the
    engine's dedicated one when loaded and cfg.tile_det_enable, else the
    flagship, in int8 under cfg.det_int8), extract_boxes with the per-tile
    candidate cap max(det_max_candidates, tile_max_candidates) and the
    detector's head stride."""

    def __init__(self, engine, model: torch.nn.Module):
        super().__init__()
        cfg = engine.config
        self.cfg = cfg
        self.model = model
        tcfg = cfg.replace(det_max_candidates=max(
            cfg.det_max_candidates, cfg.tile_max_candidates))
        if model is engine.tile_det_model:
            tcfg = tcfg.replace(det_head_stride=int(
                engine.tile_det_arch.get("head_stride", 1)))
            # the reference keeps the tile detector in float: int8 measured
            # a wash at tile shapes on its TPU
            self.int8 = False
        else:
            self.int8 = cfg.det_int8
        self.tcfg = tcfg
        self.program = graphs.Program(self._run, "tile_forward")

    def programs(self):
        return (self.program,)

    def forward(self, tiles_up: torch.Tensor):
        """A program keyed per tile batch shape (the reference's jitted
        tile forward), its graphs split at the stages: tile_det, then
        extract_boxes before, at and after the CCL. The thresholds are the
        config's, closed over as the reference's tile forward closes over
        them: a config change, thresholds included, makes a new
        TileForward (_tile_forward).
        On the card the candidates are the program's static outputs,
        which the next call of the same shape overwrites."""
        return self.program(tiles_up)

    @torch.inference_mode()
    def _run(self, tiles_up: torch.Tensor):
        cfg, tcfg = self.cfg, self.tcfg
        with stage("tile_det"):
            x = preprocess.det_normalize_gray(
                preprocess.unpack_on_device(tiles_up, cfg), cfg.det_mean,
                cfg.det_std)
            prob = db_int8.apply_prob(self.model, x, self.int8)
        with stage("extract_boxes"):
            return db_boxes.extract_boxes(
                prob, thresh=float(tcfg.det_thresh),
                box_thresh=float(tcfg.det_box_thresh),
                unclip_ratio=float(tcfg.det_unclip_ratio),
                min_box_size=float(tcfg.det_min_box_size),
                **db_boxes.static_kwargs_from_config(tcfg))


def _tile_forward(engine) -> TileForward:
    """The engine's TileForward: an entry of its program registry made
    over the whole config (the thresholds are closed over), the detector
    it runs and the tile mesh (graphs.held)."""
    cfg = engine.config
    model = engine.tile_det_model if cfg.tile_det_enable else None
    if model is None:
        model = engine.det_model
    return graphs.held(engine, "tile_forward",
                       lambda: TileForward(engine, model),
                       over=(cfg, model, engine.tile_mesh))


def _prep_page(engine, img: np.ndarray):
    """Host tile plan of a page -> (corners, groups, gray): corners (y, x,
    th, tw) in tile_plan order, groups one (n, th, tw) uint8 luma stack a
    tile shape, concatenated in corner order, gray the page's luma (the
    page itself where it is 2-D, as load_page keeps a grey page), which
    the host fallback crops. The page is padded by edge
    replication (a zero pad would put a stroke-like edge at the border).
    With cfg.tile_blank_skip a tile whose 4x-subsampled luma spans fewer
    than 24 levels holds no ink and is dropped (at least one tile stays)."""
    cfg = engine.config
    h, w = img.shape[:2]
    corners = tile_plan(h, w, cfg)
    gray = preprocess.to_gray(img)
    ph = max(h, max(y + th for (y, _, th, _) in corners))
    pw = max(w, max(x + tw for (_, x, _, tw) in corners))
    padded = np.pad(gray, ((0, ph - h), (0, pw - w)), mode="edge")
    if cfg.tile_blank_skip and len(corners) > 1:
        def has_ink(y, x, th, tw):
            sub = padded[y:y + th, x:x + tw][::4, ::4]
            return int(sub.max()) - int(sub.min()) >= 24
        corners = [c for c in corners if has_ink(*c)] or corners[:1]
    groups = []
    k = 0
    while k < len(corners):
        j = k
        while j < len(corners) and corners[j][2:] == corners[k][2:]:
            j += 1
        groups.append(np.stack([padded[y:y + th, x:x + tw]
                                for (y, x, th, tw) in corners[k:j]]))
        k = j
    return corners, groups, gray


def _dispatch_group(engine, tiles: np.ndarray):
    """Upload one shape group's tiles and launch their detection without
    waiting for it -> (uploaded tiles, candidates, tiles); (None, None,
    tiles) when the card ran out of memory, for _fetch_group to halve.

    With a tile mesh (parallel.mesh.shard_tiled_serving) the tile axis is
    the data-parallel axis: the stack is padded to a dp multiple with white
    (no-ink) tiles, each rank detects its dp slice, the candidates are
    all-gathered and cut back to the real tiles before the host sees them.
    Every rank keeps all the uploaded tiles for the recognition crops.
    The candidates come back packed (api_det.pack_det), so a mesh gathers
    them in one collective."""
    from ocrjax_torch.api_det import pack_det, upload
    mesh = engine.tile_mesh
    try:
        if mesh is None:
            dev = upload(engine,
                         preprocess.pack_for_upload(tiles, engine.config))
            return dev, pack_det(_tile_forward(engine)(dev)), tiles
        from ocrjax_torch.parallel import mesh as M
        n = len(tiles)
        pad = (-n) % mesh.size(0)
        arr = tiles if not pad else np.concatenate(
            [tiles, np.full((pad,) + tiles.shape[1:], 255, tiles.dtype)])
        dev = upload(engine, preprocess.pack_for_upload(arr, engine.config))
        packed = pack_det(_tile_forward(engine)(
            dev[M.dp_slice(mesh, len(arr))]))
        return dev[:n], M.gather_rows(mesh, packed)[:n], tiles
    except torch.cuda.OutOfMemoryError:
        return None, None, tiles


def _det_fetch_adapt(engine) -> dict:
    """The engine's saturation latch for tile candidate fetches (see
    api_det.fetch_det), shared by every tiled call of the engine."""
    adapt = getattr(engine, "_det_fetch_adapt", None)
    if adapt is None:
        adapt = engine._det_fetch_adapt = {}
    return adapt


def _fetch_det_tiles(engine, packed_chunks):
    """fetch_det of pack_det rows of tiles, at the tile candidate cap,
    through the engine's latch; bytes under tile_det_fetch."""
    from ocrjax_torch.api_det import fetch_det
    return fetch_det(packed_chunks, _tile_forward(engine).tcfg,
                     adapt=_det_fetch_adapt(engine), timer=current(),
                     stage="tile_det_fetch")


def _fetch_group(engine, dispatched, depth: int = 0):
    """Copy one dispatched group's candidates to the host -> (uploads,
    boxes, scores, valid). On a device OOM its tiles are redone in halves
    (up to 3 times)."""
    dev, packed, tiles = dispatched
    try:
        if packed is None:
            raise torch.cuda.OutOfMemoryError("out of memory at dispatch")
        return ([dev],) + _fetch_det_tiles(engine, [packed])
    except torch.cuda.OutOfMemoryError:
        if depth >= 3 or len(tiles) <= 1:
            raise
        log_fields(get_logger("ocrjax_torch.tiling"), "warning",
                   "device OOM: halving tile batch",
                   tiles=len(tiles), depth=depth)
        del dev, packed
        mid = len(tiles) // 2
        parts = [_fetch_group(engine, _dispatch_group(engine, t), depth + 1)
                 for t in (tiles[:mid], tiles[mid:])]
        return (parts[0][0] + parts[1][0],) + tuple(
            np.concatenate([parts[0][k], parts[1][k]]) for k in (1, 2, 3))


def _fetch_page(engine, dispatched):
    """Candidates of every shape group of a page -> (uploads, boxes,
    scores, valid), rows in corner order."""
    devs, bs, ss, vs = [], [], [], []
    for d in dispatched:
        dv, b, s, v = _fetch_group(engine, d)
        devs.extend(dv)
        bs.append(b)
        ss.append(s)
        vs.append(v)
    return devs, np.concatenate(bs), np.concatenate(ss), np.concatenate(vs)


def _merge_page(engine, corners, boxes, scores, valid, h, w):
    """Candidates -> (seam-merged page-frame (quads, scores), saturated).
    A tile whose valid candidates reach the per-tile cap may hold more
    lines than it returned (the last in raster order drop first): the page
    is then flagged truncated."""
    cap = _tile_forward(engine).tcfg.det_max_candidates
    saturated = bool((valid.sum(axis=1) >= cap).any())
    if saturated:
        log_fields(get_logger("ocrjax_torch.tiling"), "warning",
                   "tile candidate cap reached — page likely truncated",
                   cap=cap, tiles=len(corners))
    t, i = np.nonzero(valid)                 # tile-major, then row
    off = np.asarray([(x, y) for (y, x, _, _) in corners], np.float32)
    quads = boxes[t, i] + off[t][:, None, :]
    quads[..., 0] = np.clip(quads[..., 0], 0, w - 1)   # the unpadded page
    quads[..., 1] = np.clip(quads[..., 1], 0, h - 1)
    x_bands, _ = _seam_bands(corners)
    merged = _merge_seam_boxes(quads, scores[t, i],
                               engine.config.tile_merge_iou, x_bands,
                               tile_ids=t)
    return merged, saturated


def _run_tiles(engine, img: np.ndarray):
    """Tile one page and detect -> (corners, uploaded tiles, merged
    (quads, scores) in the page frame, saturated)."""
    h, w = img.shape[:2]
    corners, groups, _ = _prep_page(engine, img)
    devs, boxes, scores, valid = _fetch_page(
        engine, [_dispatch_group(engine, g) for g in groups])
    merged, saturated = _merge_page(engine, corners, boxes, scores, valid,
                                    h, w)
    return corners, devs, merged, saturated


def detect_tiled(engine, image) -> List["DetBox"]:
    """Tiled detection: boxes in the original image frame, reading order.
    A page no larger than a tile is one tile."""
    from ocrjax_torch.api import DetBox
    img = preprocess.load_page(image, auto_invert=engine.config.auto_invert)
    _, _, (quads, ss), _ = _run_tiles(engine, img)
    return [DetBox(quads[i], ss[i])
            for i in geometry.sort_reading_order(quads)]


def _assign_quads_to_tiles(cfg, corners, quads, h, w):
    """Each merged quad goes to a tile that contains its expanded crop
    (within the page): of several, the one whose centre is closest, the
    first on a tie. -> (tile_ids, tile-frame quads, tile_bounds (max x,
    max y), pooled_idx, host_idx); host_idx holds the quads no tile
    contains (lines longer than tile_size - 2 overlap)."""
    tile_ids, tile_quads, tile_bounds = [], [], []
    pooled_idx, host_idx = [], []
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
            host_idx.append(qi)
            continue
        t = best[0]
        ty, tx, th, tw = corners[t]
        pooled_idx.append(qi)
        tile_ids.append(t)
        tile_quads.append(q - np.array([tx, ty], np.float32))
        tile_bounds.append([min(tw, w - tx) - 1.0, min(th, h - ty) - 1.0])
    return tile_ids, tile_quads, tile_bounds, pooled_idx, host_idx


def _host_fallback_strips(engine, img, quads, host_idx):
    """Full-resolution host crops, ink-tightened, of the quads no tile
    contains. img: the page's luma from _prep_page (the lane's), or the
    page, whose luma is made here."""
    from ocrjax_torch.api_det import _ink_crop_host
    cfg = engine.config
    h, w = img.shape[:2]
    gray = preprocess.to_gray(img)
    strips = []
    for qi in host_idx:
        q = quads[qi]
        margin = cfg.rec_crop_margin * (q[:, 1].max() - q[:, 1].min() + 1) \
            if cfg.rec_snap_to_ink else 0.0
        x0 = int(max(0, np.floor(q[:, 0].min() - margin)))
        x1 = int(min(w, np.ceil(q[:, 0].max() + margin) + 1))
        y0 = int(max(0, np.floor(q[:, 1].min() - margin)))
        y1 = int(min(h, np.ceil(q[:, 1].max() + margin) + 1))
        strips.append(_ink_crop_host(
            gray, x0, y0, x1, y1,
            margin_left_px=max(0.0, q[:, 0].min() - x0),
            margin_right_px=max(0.0, (x1 - 1) - q[:, 0].max()),
            x_margin_keep=cfg.rec_ink_x_margin_keep,
            flat_frac=cfg.rec_flat_band_frac,
            box_h_px=(float(np.linalg.norm(q[3] - q[0]))
                      if cfg.rec_flat_case_gate else 0.0))
            if cfg.rec_snap_to_ink else gray[y0:y1, x0:x1])
    return strips


def max_pool_tiles(cfg) -> int:
    """Tiles a window may hold, from the device memory budget
    cfg.tile_window_hbm_mb: per tile the normalized float32 copy (4 B/px),
    the packed upload (upload_bits/8 B/px) and the detector's transient
    share (~12 B/px)."""
    bytes_per_tile = cfg.tile_size * cfg.tile_size * (
        4.0 + cfg.upload_bits / 8.0 + 12.0)
    return max(2, int(cfg.tile_window_hbm_mb * 2**20 / bytes_per_tile))


def ocr_tiled_batch(engine, images, beam: bool = False,
                    _allow_rot90: bool = True) -> List["OcrResult"]:
    """Tiled OCR of many pages, one OcrResult each.

    Pages stream in windows of at most max_pool_tiles(cfg) full-tile
    equivalents (min with tile_pipeline_tiles for several pages; the first
    window is one page, so the card starts at once). A window's tiles of
    one shape, across its pages, are detected as one batch, and the next
    window's detection is issued before this one's candidates are read.
    Recognition pools every line of the window (tiles of one page share an
    orientation prior group). A page that fails to decode yields an empty
    result; with rec_try_flip a landscape scan is redone rotated, with its
    peers, at the end (_allow_rot90 keeps that from recursing)."""
    from ocrjax_torch import bucketing
    from ocrjax_torch.api import DetBox, OcrLine, OcrResult
    from ocrjax_torch.api_det import _is_landscape, reading_order

    cfg = engine.config
    B = len(images)
    results: List = [None] * B
    cap = max_pool_tiles(cfg)
    if B > 1 and cfg.tile_pipeline_tiles > 0:
        cap = min(cap, cfg.tile_pipeline_tiles)
    T = cfg.tile_size
    area_terms = cfg.upload_bits / 8.0 + 12.0

    def prep(i):
        with host_stage("tile_prep_work"):
            try:
                img = preprocess.load_page(images[i],
                                           auto_invert=cfg.auto_invert)
                return (i, img) + _prep_page(engine, img)
            except (FileNotFoundError, ValueError, OSError):
                return (i, None, None, None, None)

    def iter_windows():
        window, budget, first = [], 0.0, B > 1
        for page in preprocess.lookahead(prep, range(B), "tile_prep"):
            if page[1] is None:
                results[page[0]] = OcrResult(lines=[])
                continue
            # full-tile equivalents: the float32 copy is counted at a full
            # tile (remainder tiles are padded to T x T for recognition),
            # the upload and detector terms at the tile's area
            n_tiles = sum(g.shape[0] * (4.0 + area_terms * g.shape[1]
                                        * g.shape[2] / float(T * T))
                          for g in page[3]) / (4.0 + area_terms)
            if window and (first or budget + n_tiles > cap):
                yield window
                window, budget, first = [], 0.0, False
            window.append(page)
            budget += n_tiles
        if window:
            yield window

    def dispatch_window(window):
        """One detection batch a tile shape across the window's pages ->
        [(spans [(page position, n tiles)], dispatched)], shapes sorted as
        tile_plan sorts a page's corners."""
        with stage("tile_det_dispatch"):
            by_shape = {}
            for pi, (_, _, _, groups, _) in enumerate(window):
                for g in groups:
                    by_shape.setdefault(g.shape[1:], []).append((pi, g))
            disp = []
            for sh in sorted(by_shape):
                items = by_shape[sh]
                tiles = np.concatenate([g for _, g in items]) \
                    if len(items) > 1 else items[0][1]
                disp.append(([(pi, len(g)) for pi, g in items],
                             _dispatch_group(engine, tiles)))
            return disp

    def fetch_window(window, disp):
        """Candidates of every group -> (per page (boxes, scores, valid,
        rows of its tiles in the window's pooled stack), uploads in group
        order). The groups' rows concatenate on the device (their width is
        the candidate cap's, whatever the tile shape) and come back in one
        fetch; on a device OOM the groups are fetched (and halved) one by
        one."""
        got = None
        if all(d[1] is not None for _, d in disp):
            try:
                b_all, s_all, v_all = _fetch_det_tiles(
                    engine, [torch.cat([d[1] for _, d in disp])])
                got, off = [], 0
                for _, d in disp:
                    n_g = len(d[2])
                    got.append(([d[0]], b_all[off:off + n_g],
                                s_all[off:off + n_g], v_all[off:off + n_g]))
                    off += n_g
            except torch.cuda.OutOfMemoryError:
                got = None
        parts = [[] for _ in window]
        rows = [[] for _ in window]
        devs, row_off = [], 0
        for gi, (spans, d) in enumerate(disp):
            dv, b, s, v = got[gi] if got is not None \
                else _fetch_group(engine, d)
            devs.extend(dv)
            off = 0
            for pi, n in spans:
                parts[pi].append((b[off:off + n], s[off:off + n],
                                  v[off:off + n]))
                rows[pi].extend(range(row_off + off, row_off + off + n))
                off += n
            row_off += off
        per_page = [tuple(np.concatenate(a) for a in zip(*parts[pi]))
                    + (rows[pi],) for pi in range(len(window))]
        return per_page, devs

    rot90_pages = []
    windows = iter_windows()
    w_next = next(windows, None)
    d_next = dispatch_window(w_next) if w_next is not None else None
    while w_next is not None:
        window, disp = w_next, d_next
        # the next window's detection goes out before this one is read
        w_next = next(windows, None)
        d_next = dispatch_window(w_next) if w_next is not None else None

        with stage("tile_det_fetch"):          # once a window
            per_page, devs = fetch_window(window, disp)
        win = []
        for (i, img, corners, _, gray), (boxes, scores, valid, rows) in zip(
                window, per_page):
            h, w = img.shape[:2]
            with stage("tile_seam_merge"):
                (quads, ss), saturated = _merge_page(
                    engine, corners, boxes, scores, valid, h, w)
            if not quads:
                results[i] = OcrResult(lines=[], truncated=saturated)
                continue
            if _allow_rot90 and _is_landscape(cfg, np.asarray(quads)):
                rot90_pages.append((i, img))
                continue
            win.append(dict(i=i, img=img, gray=gray, corners=corners,
                            rows=rows, quads=quads, ss=ss,
                            saturated=saturated))
        if not win:
            continue

        tids, tquads, tbounds, prior, refs = [], [], [], [], []
        with stage("tile_assign"):
            for p in win:
                h, w = p["img"].shape[:2]
                t_ids, t_quads, t_bounds, pooled_idx, host_idx = \
                    _assign_quads_to_tiles(cfg, p["corners"], p["quads"],
                                           h, w)
                n = len(p["quads"])
                p.update(host_idx=host_idx, texts=[None] * n,
                         confs=[0.0] * n, flipped=[False] * n)
                for k, qi in enumerate(pooled_idx):
                    tids.append(p["rows"][t_ids[k]])
                    tquads.append(t_quads[k])
                    tbounds.append(t_bounds[k])
                    prior.append(p["i"])
                    refs.append((p, qi))
            if refs:
                with torch.inference_mode(), stage("warp_refine"):
                    # remainder tiles padded to (T, T) so the window's
                    # tiles stack into one array; the per-quad bounds keep
                    # every sample inside the real tile
                    gray_dev = bucketing.stack_pages(engine, devs, size=T)
        if refs:
            texts, confs, flips = bucketing.recognize_pooled(
                engine, gray_dev, np.asarray(tids, np.int32),
                np.asarray(tquads, np.float32),
                np.asarray(tbounds, np.float32)[:, None, :], beam=beam,
                prior_ids=np.asarray(prior, np.int32))
            for k, (p, qi) in enumerate(refs):
                p["texts"][qi] = texts[k]
                p["confs"][qi] = confs[k]
                p["flipped"][qi] = flips[k]

        for p in win:
            if p["host_idx"]:
                with stage("tile_host_fallback"):
                    rs = engine.recognize_strips(
                        _host_fallback_strips(engine, p["gray"], p["quads"],
                                              p["host_idx"]),
                        beam=beam, same_page=True)
                    for k, qi in enumerate(p["host_idx"]):
                        p["texts"][qi] = rs[k].text
                        p["confs"][qi] = rs[k].confidence
                        p["flipped"][qi] = rs[k].flipped
            with stage("tile_assembly"):
                quads, ss = p["quads"], p["ss"]
                results[p["i"]] = OcrResult(lines=[
                    OcrLine(box=DetBox(quads[k], ss[k]),
                            text=p["texts"][k], confidence=p["confs"][k])
                    for k in reading_order(quads, p["flipped"])],
                    truncated=p["saturated"])

    if rot90_pages:
        redo = ocr_tiled_batch(
            engine, [np.ascontiguousarray(np.rot90(img))
                     for _, img in rot90_pages], beam=beam,
            _allow_rot90=False)
        for (i, img), rr in zip(rot90_pages, redo):
            results[i] = OcrResult(lines=[
                OcrLine(box=DetBox(geometry.rot90_ccw_to_orig(
                    line.box.quad, img.shape[1]), line.box.score),
                    text=line.text, confidence=line.confidence)
                for line in rr.lines], truncated=rr.truncated)
    return results


def ocr_tiled(engine, image, beam: bool = False) -> "OcrResult":
    """Tiled OCR of one page (ocr_tiled_batch of one)."""
    return ocr_tiled_batch(engine, [image], beam=beam)[0]
