"""Serving-distribution training data: refined detector crops with ground
truth labels (port of ocrjax/train/det_crops.py).

Renders pages, runs the port's detection (the DB forward and extract_boxes
with K1 on the card) and the two-pass refined homography warp, matches each
detected line to its ground-truth text by box centre, and returns strips in
the trainers' (u8 images, widths, labels) format. Rendering needs PIL: the
pages are drawn on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ocrjax_torch import preprocess
from ocrjax_torch.charset import Charset
from ocrjax_torch.train import synth


@dataclasses.dataclass
class DetCropSet:
    images: np.ndarray   # (M, rec_height, width) uint8, 0 beyond widths
    widths: np.ndarray   # (M,) int32
    texts: List[str]


def generate_det_crops(engine, n_pages: int = 256, seed: int = 17,
                       width: int = 192, chunk: int = 16,
                       page_size: int = None,
                       max_rotation: float = 0.0,
                       p_word: float = 0.0) -> DetCropSet:
    """Render pages -> detect -> refined warp -> (strip, gt text) pairs.

    Crops whose strip width hits the bucket cap are dropped (their text
    would be truncated). max_rotation: per-line rotation range (degrees)
    of the rendered pages, which the homography warp rectifies."""
    from ocrjax_torch.api_det import det_state, pack_det, unpack_det, upload
    from ocrjax_torch.ops import bytepack
    from ocrjax_torch.ops.warp import (expand_quads_host,
                                       warp_quads_multi_refined)

    cfg = engine.config
    S = page_size or cfg.det_max_side
    st = det_state(engine)
    rng = np.random.RandomState(seed)

    out_imgs, out_ws, out_texts = [], [], []
    for off in range(0, n_pages, chunk):
        B = min(chunk, n_pages - off)
        grays = np.zeros((B, S, S), np.uint8)
        gt = []
        for i in range(B):
            page, quads, texts = synth.render_page(
                rng, engine.charset, size=(S, S),
                max_rotation=max_rotation, p_word=p_word)
            grays[i] = page
            gt.append((quads, texts))

        _, cand = st.forward(upload(engine,
                                    preprocess.pack_for_upload(grays, cfg)))
        # the whole candidate rows, as the reference fetches them here
        boxes, _, valid = unpack_det(bytepack.fetch(pack_det(cand)),
                                     cfg.det_max_candidates)

        page_ids, qs, labels = [], [], []
        for i in range(B):
            gquads, gtexts = gt[i]
            if not gtexts:
                continue
            centers = np.stack([g.mean(axis=0) for g in gquads])
            heights = np.array(
                [g[:, 1].max() - g[:, 1].min() + 1 for g in gquads])
            for j in np.where(valid[i])[0]:
                c = boxes[i, j].mean(axis=0)
                d = np.linalg.norm(centers - c, axis=1)
                k = int(np.argmin(d))
                if d[k] < max(float(heights[k]), 8.0):
                    page_ids.append(i)
                    qs.append(boxes[i, j])
                    labels.append(gtexts[k])
        if not qs:
            continue

        # expanded on the host as ocrjax does (the margins in float32, the
        # sum and the clip in float64), float32 at the upload
        bounds = np.asarray([S - 1.0, S - 1.0], np.float32)
        qe = upload(engine, expand_quads_host(
            np.asarray(qs, np.float32), cfg.rec_crop_margin,
            cfg.rec_crop_margin, bounds=bounds).astype(np.float32))
        b = upload(engine, bounds)
        # normalized on the host in float32, as ocrjax does here
        g = (grays.astype(np.float32) / 255.0 - cfg.rec_mean) / cfg.rec_std
        with torch.inference_mode():
            strips, ws = warp_quads_multi_refined(
                upload(engine, g), upload(engine, np.asarray(page_ids,
                                                             np.int64)),
                qe, b, rec_height=cfg.rec_height, bucket_width=width,
                ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
                margin_fracs=(cfg.rec_crop_margin, cfg.rec_crop_margin),
                x_margin_keep=cfg.rec_ink_x_margin_keep,
                pad_value=(0.0 - cfg.rec_mean) / cfg.rec_std)
        strips = strips.cpu().numpy()
        ws = ws.cpu().numpy()
        # normalized float -> the trainers' u8 convention (0 beyond width,
        # like synth.make_line_batch)
        u8 = np.clip((strips * cfg.rec_std + cfg.rec_mean) * 255.0,
                     0, 255).astype(np.uint8)
        for m in range(len(ws)):
            if ws[m] >= width:      # width cap hit -> text truncated, drop
                continue
            u8[m, :, ws[m]:] = 0
            out_imgs.append(u8[m])
            out_ws.append(ws[m])
            out_texts.append(labels[m])

    if not out_imgs:
        raise RuntimeError("generate_det_crops produced no matched crops")
    return DetCropSet(np.stack(out_imgs), np.asarray(out_ws, np.int32),
                      out_texts)


def sample_batch(crops: DetCropSet, charset: Charset,
                 rng: np.random.RandomState, batch_size: int,
                 max_label: int = 24) -> synth.LineBatch:
    """Uniform with-replacement batch in the trainers' LineBatch format."""
    M = len(crops.texts)
    # only rows whose label fits (mirrors make_line_batch's constraint)
    idx = rng.randint(0, M, size=batch_size * 2)
    idx = [i for i in idx if len(crops.texts[i]) <= max_label][:batch_size]
    while len(idx) < batch_size:
        i = rng.randint(0, M)
        if len(crops.texts[i]) <= max_label:
            idx.append(i)
    labels = np.zeros((batch_size, max_label), np.int32)
    lens = np.zeros((batch_size,), np.int32)
    texts = []
    for r, i in enumerate(idx):
        ids = charset.encode(crops.texts[i])
        labels[r, : len(ids)] = ids
        lens[r] = len(ids)
        texts.append(crops.texts[i])
    return synth.LineBatch(crops.images[idx], crops.widths[idx],
                           labels, lens, texts)
