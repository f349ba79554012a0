"""The bucketed lane's recognition split into its parts (port of
scripts/diag_rec_fetch.py: the same flags and printout):

  A. dispatch: the host issuing every pooled warp + CRNN + CTC chunk;
  B. device_compute: the card finishing that work after the dispatch
     (torch.cuda.synchronize);
  C. fetch: one copy of the concatenated outputs to the host;
  D. host_decode: tokens to strings.

    python -m ocrjax_torch.scripts.diag_rec_fetch [--pages 96] \\
        [--repeats 3] [--cpu]

It mirrors the reference script as it stands, which is older than the
lane it diagnoses (bucketing.recognize_pooled): every quad takes the
refined homography warp (the lane sends near-axis-aligned quads to the
separable warp, bucketing.sep_warp_mask), there is no try-flip, one chunk
per width bucket and count cap, and the chunks' packed rows
(api_det.pack_rec, uint8 under cfg.fetch_bytes) are concatenated and
copied to the host whole (the lane copies the first fetch_max_tokens
token columns first). payload is the bytes of those rows, as the
reference's. The pages are pooled as the lane pools them
(bucketing.stack_pages: on the card the device's shared page buffer, its
page axis rounded up to a power of two). The pages are the fused bench's (det_max_side
canvases, rng seed 0); the engine runs on the card unless given --cpu.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ocrjax_torch.scripts import clock


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.diag_rec_fetch")
    ap.add_argument("--pages", type=int, default=96)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import torch
    from ocrjax_torch import bucketing, preprocess
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.api_det import (_estimate_strip_widths, det_state,
                                      fetch_det, pack_det, pack_rec,
                                      rec_strips, unpack_rec, upload)
    from ocrjax_torch.ops import bytepack
    from ocrjax_torch.ops.warp import (expand_quads_host,
                                       warp_quads_multi_refined)
    from ocrjax_torch.train import synth

    engine = OcrEngine.from_pretrained(device=device)
    engine.config = engine.config.replace(fused_lines_per_page=16)
    cfg = engine.config
    rng = np.random.RandomState(0)
    imgs = []
    for _ in range(args.pages):
        page, _, _ = synth.render_page(
            rng, engine.charset, size=(cfg.det_max_side, cfg.det_max_side))
        imgs.append(np.repeat(page[..., None], 3, axis=2))

    # detection (not the subject: it makes the pooled inputs)
    st = det_state(engine)
    B = len(imgs)
    C = max(1, min(cfg.fused_chunk_pages, B))
    valid_hw = np.zeros((B, 2), np.int64)
    ok = np.ones((B,), bool)
    chunk_devs, cands = [], []
    for lo in range(0, B, C):
        hi = min(lo + C, B)
        grays, _, valid_hw[lo:hi], ok[lo:hi], _ = \
            preprocess.decode_chunk_to_gray(imgs, range(lo, hi), cfg)
        dev = upload(engine, preprocess.pack_for_upload(grays, cfg))
        chunk_devs.append(dev)
        cands.append(pack_det(st.forward(dev)[1]))
    boxes, scores, valid = fetch_det(cands, cfg)
    for i in range(B):
        nh, nw = valid_hw[i]
        cx = boxes[i, :, :, 0].mean(axis=1)
        cy = boxes[i, :, :, 1].mean(axis=1)
        valid[i] &= ok[i] & (cx < nw) & (cy < nh)
    page_ids, quads = [], []
    for i in range(B):
        for j in np.where(valid[i])[0]:
            page_ids.append(i)
            quads.append(boxes[i, j])
    page_ids = np.asarray(page_ids, np.int64)
    quads = np.asarray(quads, np.float32)
    b_all = (valid_hw[page_ids][:, ::-1].astype(np.float32) - 1.0)[:, None, :]
    with torch.inference_mode():
        # each chunk's pages copied out as they are made: the next chunk of
        # the shape replays over gray_norm's output
        gray_dev = bucketing.stack_pages(engine, chunk_devs)
    print(f"pages={B} pooled_lines={len(quads)}", flush=True)

    # recognize_pooled's chunks, every quad on the refined homography warp
    est_w = _estimate_strip_widths(quads, cfg.rec_height) * 1.25
    warp_src = expand_quads_host(quads, cfg.rec_crop_margin,
                                 cfg.rec_crop_margin, bounds=b_all)
    cap = cfg.line_batch_buckets[-1]
    chunks = []
    for bucket_w, idx_all in bucketing.assign_width_buckets(
            est_w, cfg.rec_width_buckets).items():
        for lo in range(0, len(idx_all), cap):
            chunks.append((bucket_w, idx_all[lo:lo + cap]))

    @torch.inference_mode()
    def dispatch():
        pending = []
        for bucket_w, idx in chunks:
            n = len(idx)
            nb = bucketing.pad_count(n, cfg)
            sel = np.concatenate([idx, np.repeat(idx[-1:], nb - n)])
            strips, widths = warp_quads_multi_refined(
                gray_dev, upload(engine, page_ids[sel]),
                upload(engine, warp_src[sel].astype(np.float32)),
                upload(engine, b_all[sel]),
                rec_height=cfg.rec_height, bucket_width=bucket_w,
                ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
                margin_fracs=(cfg.rec_crop_margin, cfg.rec_crop_margin),
                x_margin_keep=cfg.rec_ink_x_margin_keep,
                pad_value=(0.0 - cfg.rec_mean) / cfg.rec_std,
                orig_quads=upload(engine, quads[sel]))
            pending.append((idx, pack_rec(engine, *rec_strips(
                engine, strips, widths, beam=False))))
        return pending, torch.cat([out for _, out in pending])

    dispatch()  # warm
    for r in range(args.repeats):
        t0 = clock(device)
        pending, pcat = dispatch()
        t_dispatch = time.perf_counter() - t0
        t0 = time.perf_counter()
        clock(device)
        t_compute = time.perf_counter() - t0
        t0 = time.perf_counter()
        phost = bytepack.fetch(pcat)
        t_fetch = time.perf_counter() - t0
        t0 = time.perf_counter()
        off = 0
        texts = []
        for idx, out in pending:
            rows = phost[off:off + out.shape[0]]
            off += out.shape[0]
            tokens, n_tokens, conf = unpack_rec(rows, cfg.rec_max_tokens)
            for k in range(len(idx)):
                texts.append(engine.charset.decode(tokens[k][: n_tokens[k]]))
        t_decode = time.perf_counter() - t0
        print(f"run{r}: dispatch={t_dispatch*1e3:.1f}ms "
              f"device_compute={t_compute*1e3:.1f}ms "
              f"fetch={t_fetch*1e3:.1f}ms "
              f"payload={phost.nbytes/1e3:.0f}KB "
              f"host_decode={t_decode*1e3:.1f}ms "
              f"n_chunks={len(chunks)}", flush=True)


if __name__ == "__main__":
    main()
