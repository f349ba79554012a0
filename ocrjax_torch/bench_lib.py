"""The port's bench (port of ocrjax/bench_lib.py run_bench): the tracked
metrics are pages/s end to end, text-line crops/s and p50 per-page latency,
with a device ceiling beside each throughput, dense C5 pages/s, a roofline
of the timed programs against the H100's bf16 peak, and K1's launches by
path in each section.

Measurement. Host clock around work that ends in torch.cuda.synchronize()
(or that returns host results), device ms per stage from CUDA events
(utils.profiling.StageTimer) in the windows, beside each stage's host ms,
calls and the MB it copied. The e2e number is sampled in windows
alternating the two production lanes (fused single-program and
bucketed/pooled), reported as the best window (pages_per_sec) and the
median of all windows (pages_per_sec_median), with every window;
pages_per_sec_device is the same fused program on device-resident inputs,
its packing included.

The host link (PCIe on the card): link_probe, taken first, is the round
trip of a tiny synchronizing program and the upload rate of a 16 MB host
array (_probe_link); before each window a smaller probe, and each
window's fetch stage (fused_fetch or det_fetch) with the ms and MB it
took, so a slow window reads as the link's or the code's. While every
window runs below 0.4x the device ceiling, windows go on being sampled,
20 s apart, for up to extension_budget_s.

Traffic. The reference renders its traffic with train.synth as it runs.
The card's machine has Pillow without libraqm, so text would lay out
with Pillow's basic layout there, in other pixels than the reference's;
the port reads the same traffic from a file rendered on a host with the
reference's layout (render_traffic, with the reference's seeds and order:
RandomState(0) draws 256 strips at width 320, then 16 pages at
det_max_side; dense page s at RandomState(1000 + s)). The default is the
committed ocrjax_torch/testdata/bench_traffic.npz, written by
tests/test_torch_fixture.py --write. The canvas (det_max_side) follows
the traffic's page size, as the reference renders its pages at the
canvas size.

The bench runs on the card unless cpu=True; it never falls back to the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

TRAFFIC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "testdata", "bench_traffic.npz")


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def _join(texts) -> np.ndarray:
    return np.asarray("\n".join(texts))


def _split(arr: np.ndarray) -> list:
    s = str(arr)
    return s.split("\n") if s else []


def _probe_link(probe_fn, device, payload_mb: int = 16, rtt_iters: int = 8,
                up_iters: int = 3) -> Dict:
    """Round trip and upload rate of the host link to `device`.

    rtt_ms: the least time of probe_fn on an 8-float tensor with a
    synchronizing fetch of its result. upload_mb_s: payload_mb MB of host
    zeros uploaded, cast and sliced on the device, fetched, over the time
    beyond the round trip; None when that excess is under a 5 ms timing
    floor (the payload crossed within the round trip's jitter). The first
    upload runs untimed."""
    pd = torch.zeros(8, device=device)
    probe_fn(pd).cpu()
    rtts = []
    for _ in range(rtt_iters):
        t0 = time.perf_counter()
        probe_fn(pd).cpu()
        rtts.append(time.perf_counter() - t0)
    rtt = min(rtts)
    up = np.zeros(payload_mb * 2**20, np.uint8)

    def upload():
        t0 = time.perf_counter()
        probe_fn(torch.from_numpy(up).to(device).float()[:1]).cpu()
        return time.perf_counter() - t0

    upload()
    delta = min(upload() for _ in range(up_iters)) - rtt
    return {"rtt_ms": round(rtt * 1e3, 1),
            "upload_mb_s": (round(payload_mb / delta, 1)
                            if delta > 5e-3 else None)}


def render_traffic(charset, pages: int = 16, lines: int = 256,
                   width_bucket: int = 320, det_max_side: int = 960,
                   rec_height: int = 32, line_bucket: Optional[int] = None,
                   dense_pages: int = 3, dense_size=(3072, 2048),
                   dense_lines: int = 200) -> Dict[str, np.ndarray]:
    """The reference bench's traffic, rendered with train.synth (host only:
    needs PIL and cv2). line_bucket: the strip count (the reference takes
    cfg.line_bucket_for_count(lines)). Texts are newline-joined strings;
    page quads are concatenated with each page's line count."""
    from ocrjax_torch.train import synth
    n = line_bucket or lines
    rng = np.random.RandomState(0)
    strips = np.zeros((n, rec_height, width_bucket), np.uint8)
    widths = np.full((n,), width_bucket, np.int32)
    strip_texts = []
    for i in range(n):
        t = synth.random_text(rng, charset, 4, 12)
        s = synth.render_line(t, rec_height)
        w = min(s.shape[1], width_bucket)
        strips[i, :, :w] = s[:, :w]
        widths[i] = w
        strip_texts.append(t)
    imgs, quads, texts, counts = [], [], [], []
    for _ in range(pages):
        page, q, t = synth.render_page(
            rng, charset, size=(det_max_side, det_max_side))
        imgs.append(page)
        quads += q
        texts += t
        counts.append(len(t))
    dense, dense_texts, dense_counts = [], [], []
    for s in range(dense_pages):
        page, _, t = synth.render_page_dense(
            np.random.RandomState(1000 + s), charset, size=tuple(dense_size),
            n_lines=dense_lines)
        dense.append(page)
        dense_texts += t
        dense_counts.append(len(t))
    return {
        "strips": strips, "strip_widths": widths,
        "strip_texts": _join(strip_texts),
        "pages": np.stack(imgs),
        "page_quads": np.asarray(quads, np.float32).reshape(-1, 4, 2),
        "page_texts": _join(texts),
        "page_line_counts": np.asarray(counts, np.int32),
        "dense": np.stack(dense) if dense else np.zeros(
            (0, *dense_size), np.uint8),
        "dense_texts": _join(dense_texts),
        "dense_line_counts": np.asarray(dense_counts, np.int32),
    }


def load_traffic(path: str = TRAFFIC) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def traffic_texts(traffic, key: str) -> list:
    """The ground-truth texts of "strip", "page" or "dense" traffic; for
    pages and dense pages one list a page."""
    texts = _split(traffic[f"{key}_texts"])
    if key == "strip":
        return texts
    out, k = [], 0
    for n in traffic[f"{key}_line_counts"]:
        out.append(texts[k:k + int(n)])
        k += int(n)
    return out


def _rgb(gray: np.ndarray) -> np.ndarray:
    return np.repeat(gray[..., None], 3, axis=2)


def run_bench(pages: int = 16, lines: int = 256, repeats: int = 3,
              weights: Optional[str] = None, cpu: bool = False,
              width_bucket: int = 320,
              extension_budget_s: float = 5 * 60,
              traffic: Union[str, Dict[str, np.ndarray]] = TRAFFIC,
              results_out: Optional[Dict] = None,
              progress: Optional[Dict] = None) -> Dict:
    """The bench report (ocrjax's keys). traffic: a path or a
    render_traffic dict, holding at least `pages` pages and the strip
    count of `lines`. extension_budget_s: how long windows may go on being
    sampled while all run below 0.4x the device ceiling. results_out,
    when given, receives the last window's OcrResults of each lane under
    its name. progress, when given ({"windows": [], "partial": {}}), is
    fed as the run goes: each e2e window's pages/s, and the section
    metrics as they complete (the live feed of bench_main's watchdog)."""
    from ocrjax_torch import fused as F
    from ocrjax_torch import preprocess as P
    from ocrjax_torch import tiling as TL
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.api_det import pack_det, upload
    from ocrjax_torch.ops import bytepack
    from ocrjax_torch.ops.cc_label import label_components_cuda
    from ocrjax_torch.utils import roofline as RL
    from ocrjax_torch.utils.profiling import StageTimer

    if isinstance(traffic, str):
        traffic = load_traffic(traffic)
    device = "cpu" if cpu else "cuda"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass cpu=True to run "
                           "the bench on the CPU")

    # the link's state first, before anything is built or warm
    def probe_fn(x):
        return x + 1
    link_probe = _probe_link(probe_fn, device)
    if progress is not None:
        progress["partial"]["link_probe"] = link_probe
    engine = OcrEngine.from_pretrained(path=weights, device=device)
    on_card = engine.device.type == "cuda"
    # fused line capacity sized to the workload (bench pages have <= 8
    # lines; 16 leaves 2x margin), a deployment knob like batch size; the
    # canvas is the size the traffic's pages were rendered at
    engine.config = engine.config.replace(
        fused_lines_per_page=16, det_max_side=int(traffic["pages"].shape[1]))
    cfg = engine.config

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def ccl_counts():
        return dict(label_components_cuda.launches_by_path)

    def ccl_since(before):
        return {k: v - before[k] for k, v in ccl_counts().items()}

    ccl: Dict[str, Dict[str, int]] = {}
    report: Dict = {
        "device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
        "pages": pages, "lines": lines, "upload_bits": cfg.upload_bits,
        "link_probe": link_probe,
    }

    # ---- recognition throughput: crops/s ---------------------------------
    n = cfg.line_bucket_for_count(lines)
    if n > len(traffic["strips"]) or pages > len(traffic["pages"]):
        raise ValueError(
            f"the traffic holds {len(traffic['strips'])} strips and "
            f"{len(traffic['pages'])} pages; {n} and {pages} were asked for")
    if traffic["strips"].shape[2] != width_bucket:
        raise ValueError(f"the traffic's strips are "
                         f"{traffic['strips'].shape[2]} wide, not "
                         f"{width_bucket}")
    strips_d = upload(engine, traffic["strips"][:n])
    widths_d = upload(engine, traffic["strip_widths"][:n])
    engine._rec_step(strips_d, widths_d)[0].cpu()       # warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        engine._rec_step(strips_d, widths_d)[0].cpu()
        times.append(time.perf_counter() - t0)
    report["crops_per_sec"] = n / min(times)
    report["rec_batch_ms"] = min(times) * 1e3
    if progress is not None:
        progress["partial"]["crops_per_sec"] = round(
            report["crops_per_sec"], 0)
    # roofline: counted FLOPs of the timed program (FlopCounterMode runs it
    # once more, outside the timed loop), with the BiLSTM's analytic share
    rec_flops = RL.torch_flops(engine._rec_step, strips_d, widths_d)
    lstm_flops = RL.crnn_bilstm_flops(cfg, n, width_bucket)
    roofline = [RL.stage_entry("rec_fwd+ctc", rec_flops, min(times))]
    if rec_flops > 0:
        roofline.append(dict(
            stage="rec_bilstm_share",
            gflops=round(lstm_flops / 1e9, 2),
            pct_of_rec_flops=round(100 * lstm_flops / rec_flops, 1)))

    # ---- end-to-end pages/s: alternating-lane windows ---------------------
    imgs = [_rgb(p) for p in traffic["pages"][:pages]]
    stage_reports: Dict[str, Dict] = {}
    windows_detail: list = []

    def window(path: str) -> float:
        # a small link probe right before the window, and the window's own
        # fetch ms and MB: a slow window with its bytes unchanged and the
        # probe worse waited on the link
        lp = _probe_link(probe_fn, device, payload_mb=8, rtt_iters=3,
                         up_iters=2)
        timer = StageTimer(device)
        t0 = time.perf_counter()
        with timer.active():
            res = engine.ocr_batch(imgs, fused=(path == "fused"))
        dt = time.perf_counter() - t0
        host = timer.host_report(calls=True)
        stage_reports[path] = {"device_ms": timer.report(), "host_ms": host}
        if results_out is not None:
            results_out[path] = res
        pps = pages / dt
        fetch = host.get("fused_fetch" if path == "fused" else "det_fetch",
                         {})
        windows_detail.append({
            "path": path, "pages_per_sec": pps,
            "probe_rtt_ms": lp["rtt_ms"], "probe_up_mb_s": lp["upload_mb_s"],
            "fetch_ms": fetch.get("total_ms"), "fetch_mb": fetch.get("mb")})
        if progress is not None:
            progress["windows"].append(pps)
        return pps

    # warmups at the real batch shape (and the pooled rec count buckets
    # the full batch reaches)
    engine.ocr_batch(imgs, fused=True)
    engine.ocr_batch(imgs, fused=False)
    windows: Dict[str, list] = {"fused": [], "bucketed": []}
    before = ccl_counts()
    for path in ("fused", "bucketed", "fused", "bucketed"):
        windows[path].append(window(path))
    ccl["windows"] = ccl_since(before)

    # device-resident throughput: the same fused program with its inputs
    # already on the device, synchronized once a call
    C = min(cfg.fused_chunk_pages, pages)
    fn = F.FusedOcr(engine, cfg.fused_lines_per_page, width_bucket)
    grays_d = upload(engine, P.pack_for_upload(np.stack(
        [P.to_gray(P.det_resize_to_canvas(imgs[i], cfg)[0])
         for i in range(C)]), cfg))
    thr = (float(cfg.det_thresh), float(cfg.det_box_thresh),
           float(cfg.det_unclip_ratio), float(cfg.det_min_box_size))
    wh_d = upload(engine, np.full((C, 2), float(cfg.det_max_side),
                                  np.float32))
    before = ccl_counts()
    fn(grays_d, thr, wh_d)
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(grays_d, thr, wh_d)
        sync()
        times.append(time.perf_counter() - t0)
    ccl["device_ceiling"] = ccl_since(before)
    report["pages_per_sec_device"] = C / min(times)
    if progress is not None:
        progress["partial"]["device_pages_per_sec"] = round(
            report["pages_per_sec_device"], 1)
    fused_flops = RL.torch_flops(fn, grays_d, thr, wh_d)
    roofline.append(RL.stage_entry(f"fused_e2e_chunk{C}", fused_flops,
                                   min(times)))

    # p50 per-page latency (the single-page fused lane)
    before = ccl_counts()
    lat = []
    engine.ocr(imgs[0])
    for i in range(min(8, pages)):
        t0 = time.perf_counter()
        engine.ocr(imgs[i])
        lat.append(time.perf_counter() - t0)
    ccl["latency"] = ccl_since(before)
    report["p50_page_latency_ms"] = _percentile(lat, 50) * 1e3
    if progress is not None:
        progress["partial"]["p50_page_latency_ms"] = round(
            report["p50_page_latency_ms"], 1)

    before = ccl_counts()
    for path in ("fused", "bucketed"):
        windows[path].append(window(path))

    # while every window so far ran far below the device ceiling, go on
    # sampling alternating windows on a bounded budget
    def best():
        return max(max(windows["fused"]), max(windows["bucketed"]))

    deadline = time.time() + extension_budget_s
    flip = 0
    while (best() < 0.4 * report["pages_per_sec_device"]
           and time.time() < deadline):
        time.sleep(20)
        path = "fused" if flip % 2 == 0 else "bucketed"
        windows[path].append(window(path))
        flip += 1
    ccl["windows"] = {k: v + ccl["windows"][k]
                      for k, v in ccl_since(before).items()}

    # ---- C5 dense-page throughput: spec-density pages through the
    # pipelined tiled batch (a detail metric; the headline stays the
    # standard-page median) --------------------------------------------------
    dense_imgs = [_rgb(p) for p in traffic["dense"]]
    dense_line_counts = traffic["dense_line_counts"]
    before = ccl_counts()
    # warm the batch lane's programs (its pooled recognition shapes)
    engine.ocr_tiled_batch(dense_imgs)
    timer = StageTimer(device)
    t0 = time.perf_counter()
    with timer.active():
        dense_res = engine.ocr_tiled_batch(dense_imgs)
    dense_dt = time.perf_counter() - t0
    ccl["dense"] = ccl_since(before)
    stage_reports["dense"] = {"device_ms": timer.report(),
                              "host_ms": timer.host_report(calls=True)}
    if results_out is not None:
        results_out["dense"] = dense_res
    n_dense_lines = sum(len(r.lines) for r in dense_res)
    report["dense_pages_per_sec"] = len(dense_imgs) / dense_dt
    report["dense_lines_per_sec"] = n_dense_lines / dense_dt
    if progress is not None:
        progress["partial"]["dense_pages_per_sec"] = round(
            report["dense_pages_per_sec"], 2)
        progress["partial"]["dense_lines_per_sec"] = round(
            report["dense_lines_per_sec"], 0)
    report["dense_gt_lines_per_page"] = round(
        float(np.mean(dense_line_counts)), 1)

    # Dense device ceiling: the tile detector on RESIDENT tiles, batched
    # per tile shape as the production window batches them, one fetch for
    # the whole window, plus the recognizer's measured resident-crop rate:
    # ceiling = P / (P * det_page_s + total_lines / crops_per_sec).
    d_by_shape: Dict = {}
    n_dense_tiles = 0
    for img in dense_imgs:
        im = P.load_page(img, auto_invert=cfg.auto_invert)
        _, gs, _ = TL._prep_page(engine, im)
        for g in gs:
            d_by_shape.setdefault(g.shape[1:], []).append(g)
            n_dense_tiles += len(g)
    d_fwd = TL._tile_forward(engine)
    d_devs = [upload(engine, P.pack_for_upload(np.concatenate(gl), cfg))
              for gl in d_by_shape.values()]

    def det_window():
        # one device concat and one fetch of every group's rows
        bytepack.fetch(torch.cat([pack_det(d_fwd(g)) for g in d_devs]))

    before = ccl_counts()
    det_window()
    d_times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        det_window()
        d_times.append(time.perf_counter() - t0)
    ccl["dense_ceiling"] = ccl_since(before)
    det_page_s = min(d_times) / len(dense_imgs)
    dense_ceiling_s = (len(dense_imgs) * det_page_s
                       + n_dense_lines / report["crops_per_sec"])
    report["dense_det_ms_per_page"] = round(det_page_s * 1e3, 1)
    report["dense_tiles_per_page"] = round(n_dense_tiles / len(dense_imgs), 1)
    report["dense_pages_per_sec_device"] = len(dense_imgs) / dense_ceiling_s
    det_flops = sum(RL.torch_flops(d_fwd, gd) for gd in d_devs)
    roofline.append(RL.stage_entry(
        "dense_tile_det_page", det_flops / len(dense_imgs), det_page_s))
    # per-page device time of the two e2e paths: the stage costing the most
    # ms a page is the next compute target; the dense entry adds its
    # per-page recognition time at the measured resident crop rate
    dense_rec_ms = (n_dense_lines / max(len(dense_imgs), 1)
                    / report["crops_per_sec"] * 1e3)
    per_page = {
        f"fused_e2e_chunk{C}": roofline[-2]["ms"] / C,
        "dense_page_det_plus_rec": roofline[-1]["ms"] + dense_rec_ms,
    }
    report["roofline"] = {
        "peak_bf16_tflops": RL.H100_SXM_BF16_PEAK_TFLOPS,
        "stages": roofline,
        "ms_per_page": {k: round(v, 2) for k, v in per_page.items()},
        "top_compute_sink": max(per_page, key=per_page.get),
    }

    all_windows = windows["fused"] + windows["bucketed"]
    report["pages_per_sec_fused"] = max(windows["fused"])
    report["pages_per_sec_bucketed"] = max(windows["bucketed"])
    report["pages_per_sec_fused_windows"] = windows["fused"]
    report["pages_per_sec_bucketed_windows"] = windows["bucketed"]
    report["pages_per_sec"] = best()
    report["pages_per_sec_median"] = _percentile(all_windows, 50)
    report["e2e_batch_ms"] = pages / best() * 1e3
    report["stages_last_window"] = stage_reports
    report["windows_detail"] = windows_detail
    report["cc_label_launches_by_section"] = ccl
    return report
