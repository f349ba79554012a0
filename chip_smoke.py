#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (ocrjax_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. environment: the card's name and power limit, torch and CUDA versions,
     and the build of every kernel under ocrjax_torch/csrc (one nvcc per
     source, all started together);
  1. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes and on edge cases. cc_label: bit-exact, with its time
     (CUDA events, median of 25 launches), the plain version's time and the
     card's lower bound. conv_fused: all 12 production shapes with bf16 x,
     two with float32 x, three edge shapes, within the tolerances below;
  2. fused lane in float32 (TF32 off): OcrEngine.from_pretrained() on cuda,
     ocr_batch(fused=True) over 16 pages at 960 (the 4 committed fixture
     pages, 4 times each) and ocr() on one page, held to the JAX engine's
     float32 outputs on the same pages (identical strings and order, boxes
     within 0.011 px, scores within 2e-3);
  3. fused lane in bfloat16 (the shipped compute dtype): pages/s, device
     time per stage, and the share of lines whose strings equal the float32
     run's (at least 0.9);
  4. conv bench: ocrjax_torch.bench_conv.run() at the 12 shapes (kernel,
     cuDNN and plain times) with each shape's lower bound;
  5. staged and rerouted lanes in float32 over the committed lane fixture
     (a straight, a tilted, a colour, an inverted, a 40-line, an oversize
     and an oversize tilted page; line strips): ocr_batch(fused=True) with
     every reroute firing, ocr_batch(fused=False), ocr() and detect() on the
     oversize page, recognize_strips(), held to the JAX engine's float32
     outputs at the same bar;
  6. the same lanes in bfloat16 with device time per stage.
Each kernel must be launched in the phases that run it (cc_label: 2, 3 and
5; conv_fused: 4); the counts are set to 0 just before such a phase and
read just after. The last lines are the kernels' JSON record, the card's
name and power limit, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(ROOT, "ocrjax_torch")
TESTDATA = os.path.join(PKG, "testdata")

# H100 SXM peaks (NVIDIA data sheet): HBM rate, the float32 rate outside the
# tensor cores (used for the integer min/compare work of the CCL), and the
# dense bf16 tensor-core rate (the conv's products)
HBM_BYTES_PER_S = 3.35e12
SIMT_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# conv_fused against its plain version. Both sum the same <= 4608 exact
# bf16 x bf16 products in float32, in another order: float32 outputs agree
# to rtol 5e-5 / atol 5e-4 (the worst seen on the card is 8.2e-5 at values
# near 10), bf16 outputs to one bf16 step (rtol 2**-7) / atol 5e-4.
CONV_TOL = {"float32": (5e-5, 5e-4), "bfloat16": (2.0 ** -7, 5e-4)}
CONV_FP32_SHAPES = ("db.res3 960/16", "crnn.conv5")
CONV_EDGE_SHAPES = [("edge odd 1x7x13", 1, 7, 13, 3, 5),
                    ("edge 1x1 spatial", 1, 1, 1, 3, 5),
                    ("edge ragged tiles", 2, 9, 33, 17, 70)]

BOX_TOL = 0.011
SCORE_TOL = 2e-3
BF16_AGREE_MIN = 0.9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def build_kernels():
    from ocrjax_torch.ops import _cuda
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(_cuda.CSRC, "*.cu")))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_cuda.build, names))
    print(f"built {names} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {_cuda.build_seconds})")
    return names


def phase_conv_kernel() -> float:
    """conv_fused kernel vs conv_bn_relu_torch on the card; returns the
    largest |kernel - plain| over the 12 production shapes with bf16 x."""
    import torch
    from ocrjax_torch import bench_conv
    from ocrjax_torch.ops import conv_fused
    cases = [(s, torch.bfloat16) for s in bench_conv.SHAPES]
    cases += [(s, torch.float32) for s in bench_conv.SHAPES
              if s[0] in CONV_FP32_SHAPES]
    cases += [(s, dt) for s in CONV_EDGE_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_prod = 0.0
    g = torch.Generator(device="cuda").manual_seed(2)
    for shape, dtype in cases:
        x, w, _, _ = bench_conv.make_inputs(shape, "cuda", dtype)
        scale = torch.rand(shape[5], device="cuda", generator=g) + 0.5
        bias = torch.randn(shape[5], device="cuda", generator=g) * 0.1
        got = conv_fused.conv3x3_bn_relu_cuda(x, w, scale, bias).float()
        torch.cuda.synchronize()
        want = conv_fused.conv_bn_relu_torch(x, w, scale, bias).float()
        name = str(dtype).split(".")[1]
        rtol, atol = CONV_TOL[name]
        diff = (got - want).abs()
        err = float(diff.max())
        over = float((diff - (atol + rtol * want.abs())).max())
        print(f"  conv_fused {shape[0]} {shape[1:]} {name}: "
              f"max |kernel - plain| = {err:.3e}")
        if got.shape != want.shape or not over <= 0.0:
            fail(f"conv_fused kernel differs from its plain version on "
                 f"{shape} {name}: {err} (rtol {rtol}, atol {atol})")
        worst[name] = max(worst[name], err)
        if shape in bench_conv.SHAPES and dtype == torch.bfloat16:
            worst_prod = max(worst_prod, err)
        del x, w, got, want, diff
    print(f"  conv_fused worst error: float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}")
    return worst_prod


def conv_bound(row) -> dict:
    """The card's lower bound for one conv shape with bf16 x: x read once,
    y written once, the packed weights read once; 2 * 9 * Cin * Cout
    operations per output pixel."""
    px = row["B"] * row["H"] * row["W"]
    ops_ms = 2.0 * px * 9 * row["Cin"] * row["Cout"] / BF16_OPS_PER_S * 1e3
    bytes_ms = (px * (row["Cin"] + row["Cout"]) * 2
                + 9 * row["Cin"] * row["Cout"] * 2) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def phase_conv_bench(counters, max_abs_err: float) -> dict:
    """bench_conv.run() at the 12 shapes; returns conv_fused's record."""
    from ocrjax_torch import bench_conv
    reset(counters)
    rows = bench_conv.run()
    launches = read(counters, "conv bench", ["conv3x3_bn_relu_cuda"])
    print(bench_conv.format_table(rows))
    shapes = []
    for r in rows:
        b = conv_bound(r)
        shapes.append({
            "shape": r["label"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "library_ms": r["cudnn_ms"],
            "library_conv_only_ms": r["conv_only_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "max_abs_err": r["max_abs_err"]})
        print(f"  {r['label']}: bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), kernel at "
              f"{b['bound_ms'] / r['kernel_ms']:.3f} of it")
    ops = sum(conv_bound(r)["ops_ms"] for r in rows)
    byt = sum(conv_bound(r)["bytes_ms"] for r in rows)
    # the entry's own numbers are the sums over the 12 shapes
    return {"name": "conv_fused", "route": "cuda",
            "source": "ocrjax_torch/csrc/conv_fused.cu",
            "replaces": "ocrjax/ops/pallas/conv_fused.py:88",
            "launches": launches["conv3x3_bn_relu_cuda"],
            "max_abs_err": max(max_abs_err,
                               max(r["max_abs_err"] for r in rows)),
            "ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(s_["bound_ms"] for s_ in shapes),
            "bound_by": "operations" if ops >= byt else "bytes",
            "library_ms": sum(r["cudnn_ms"] for r in rows),
            "library_conv_only_ms": sum(r["conv_only_ms"] for r in rows),
            "shapes": shapes}


def reset(counters) -> None:
    for c in counters:
        c.launches = 0


def read(counters, phase: str, must_launch) -> dict:
    """The launch counts of a phase; fails if a kernel that the phase runs
    was launched no time."""
    launches = {c.__name__: c.launches for c in counters}
    for name in must_launch:
        if launches[name] == 0:
            fail(f"kernel {name} never launched in phase '{phase}'")
    return launches


def phase_kernels():
    """cc_label kernel vs label_components_torch on the card."""
    import torch
    from ocrjax_torch.ops.cc_label import (label_components_cuda,
                                           label_components_torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(f"16x240^2 density {d}", torch.rand((16, 240, 240),
                                                  generator=g,
                                                  device="cuda") > d, 4)
             for d in (0.3, 0.5, 0.72)]
    snake = torch.zeros((2, 64, 64), dtype=torch.bool, device="cuda")
    snake[:, 2, 2:60] = True
    snake[:, 2:40, 59] = True
    snake[:, 39, 4:60] = True
    snake[0, 50:60, 5:25] = True
    cases += [(f"snakes n_iters {it}", snake, it) for it in (4, 6)]
    cases.append(("4x512^2", torch.rand((4, 512, 512), generator=g,
                                        device="cuda") > 0.5, 4))
    err = 0
    for name, bm, it in cases:
        got = label_components_cuda(bm, it)
        torch.cuda.synchronize()
        want = label_components_torch(bm, it)
        diff = int((got.long() - want.long()).abs().max())
        print(f"  cc_label {name}: max |kernel - plain| = {diff}")
        if diff:
            fail(f"cc_label kernel differs from its plain version on {name}")
        err = max(err, diff)

    # timing at the main path's shape: one fused chunk, 16 pages of the
    # 240x240 OR-pooled grid of a 960 canvas, 4 sweeps
    bm = cases[1][1]
    B, H, W = bm.shape
    ms = time_ms(lambda: label_components_cuda(bm, 4))
    plain_ms = time_ms(lambda: label_components_torch(bm, 4))
    nbytes = B * H * W * (1 + 4)          # bitmap in, int32 labels out
    # per pixel and sweep: 2 row + 2 column run-min steps, 9 window mins
    ops = B * H * W * 4 * 13
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SIMT_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  cc_label 16x240^2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" bound {bound_ms * 1e3:.3f} us "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    return {"name": "cc_label", "route": "cuda",
            "source": "ocrjax_torch/csrc/cc_label.cu",
            "replaces": "ocrjax/ops/pallas/cc_label.py:102",
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def load_fixture():
    import numpy as np
    pages = np.load(os.path.join(TESTDATA, "pages_960.npz"))["pages"]
    with open(os.path.join(TESTDATA, "expected_jax_fp32_960.json")) as f:
        expected = json.load(f)["pages"]
    return [p for p in pages for _ in range(4)], \
        [e for e in expected for _ in range(4)]


def load_lane_fixture():
    """(batch pages, strips, the named pages, the JAX float32 outputs)."""
    import numpy as np
    lanes = np.load(os.path.join(TESTDATA, "lanes_960.npz"))
    with open(os.path.join(TESTDATA,
                           "expected_jax_lanes_fp32_960.json")) as f:
        expected = json.load(f)
    straight = np.load(os.path.join(TESTDATA, "pages_960.npz"))["pages"][0]
    named = {k: lanes[k] for k in lanes.files}
    named["straight"] = straight
    batch = [named[k] for k in expected["batch"]]
    strips = [named[f"strip{k}"]
              for k in range(len(expected["strips"]["strings"]))]
    return batch, strips, named, expected


def check_boxes(tag: str, quads, scores, want) -> float:
    import numpy as np
    if len(quads) != len(want["boxes"]):
        fail(f"{tag}: {len(quads)} boxes != JAX float32 "
             f"{len(want['boxes'])}")
    if not len(quads):
        return 0.0
    db = float(np.abs(np.array(quads) - np.array(want["boxes"])).max())
    ds = float(np.abs(np.array(scores) - np.array(want["scores"])).max())
    if db > BOX_TOL or ds > SCORE_TOL:
        fail(f"{tag}: box diff {db} px / score diff {ds} beyond "
             f"{BOX_TOL} / {SCORE_TOL}")
    return db


def check_against(results, expected, tag: str = "page") -> float:
    """Fails unless every page meets the parity bar; returns the largest
    box-corner difference in px."""
    worst = 0.0
    for i, (r, w) in enumerate(zip(results, expected)):
        got = [line.text for line in r.lines]
        if got != w["strings"]:
            fail(f"{tag} {i}: strings {got} != JAX float32 {w['strings']}")
        worst = max(worst, check_boxes(
            f"{tag} {i}", [line.box.quad for line in r.lines],
            [line.box.score for line in r.lines], w))
    return worst


def phase_fp32(pages, expected, counters):
    from ocrjax_torch.api import OcrEngine, asset_config
    eng = OcrEngine.from_pretrained(
        config=asset_config(compute_dtype="float32"))
    eng.ocr_batch(pages[:1], fused=True)                   # warm-up
    reset(counters)
    results = eng.ocr_batch(pages, fused=True)
    single = eng.ocr(pages[0])
    launches = read(counters, "fused float32", ["label_components_cuda"])
    worst = max(check_against(results, expected),
                check_against([single], expected[:1]))
    n_lines = sum(len(r.lines) for r in results)
    print(f"  fp32: {len(pages)} pages ({n_lines} lines) + ocr() match the "
          f"JAX float32 outputs, max box diff {worst:.5f} px; "
          f"launches {launches}")
    return eng, results


def phase_bf16(pages, fp32_results, counters, reps: int = 3):
    import torch
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.utils.profiling import StageTimer
    eng = OcrEngine.from_pretrained()
    assert eng.config.compute_dtype == "bfloat16"
    eng.ocr_batch(pages, fused=True)                       # warm-up
    torch.cuda.synchronize()
    reset(counters)
    t0 = time.perf_counter()
    for _ in range(reps):
        results = eng.ocr_batch(pages, fused=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters, "fused bfloat16", ["label_components_cuda"])
    timer = StageTimer()
    with timer.active():
        eng.ocr_batch(pages, fused=True)
    stages = timer.report()
    # the host steps of one chunk, alone, on the host clock
    from ocrjax_torch import preprocess
    t0 = time.perf_counter()
    grays = preprocess.decode_chunk_to_gray(pages, range(len(pages)),
                                            eng.config)[0]
    t1 = time.perf_counter()
    preprocess.pack_for_upload(grays, eng.config)
    t2 = time.perf_counter()
    same = total = 0
    for r, w in zip(results, fp32_results):
        a = [line.text for line in r.lines]
        b = [line.text for line in w.lines]
        total += len(b)
        same += sum(x == y for x, y in zip(a, b))
    agree = same / max(total, 1)
    pages_s = len(pages) * reps / wall
    print(f"  bf16: {pages_s:.2f} pages/s ({reps} x {len(pages)} pages, "
          f"host clock, {wall:.3f} s)")
    print("  bf16 stage device ms per 16-page chunk: "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    print(f"  host per 16-page chunk: decode+luma {(t1 - t0) * 1e3:.2f} ms,"
          f" Bayer pack {(t2 - t1) * 1e3:.2f} ms (host clock)")
    print(f"  bf16: {same}/{total} lines equal the fp32 strings "
          f"({agree:.4f})")
    if agree < BF16_AGREE_MIN:
        fail(f"bf16 strings agree with fp32 on {agree:.3f} < "
             f"{BF16_AGREE_MIN}")
    return eng, launches


def phase_lanes_fp32(eng, fixture, counters):
    """Every staged and rerouted lane, float32, against the JAX engine."""
    import numpy as np
    batch, strips, named, want = fixture
    reset(counters)
    fused = eng.ocr_batch(batch, fused=True)
    bucketed = eng.ocr_batch(batch, fused=False)
    big = eng.ocr(named["big"])
    det_big = eng.detect(named["big"])
    det_tilted = eng.detect(named["tilted"])
    recs = eng.recognize_strips(strips)
    launches = read(counters, "staged lanes float32",
                    ["label_components_cuda"])
    worst = max(
        check_against(fused, want["fused_batch"], "fused batch page"),
        check_against(bucketed, want["bucketed_batch"], "bucketed page"),
        check_against([big], [want["ocr_big"]], "ocr(oversize)"),
        check_boxes("detect(oversize)", [b.quad for b in det_big],
                    [b.score for b in det_big], want["detect_big"]),
        check_boxes("detect(tilted)", [b.quad for b in det_tilted],
                    [b.score for b in det_tilted], want["detect_tilted"]))
    got = [r.text for r in recs]
    if got != want["strips"]["strings"]:
        fail(f"recognize_strips: {got} != JAX float32 "
             f"{want['strips']['strings']}")
    dconf = float(np.abs(np.array([r.confidence for r in recs])
                         - np.array(want["strips"]["conf"])).max())
    if dconf > SCORE_TOL:
        fail(f"recognize_strips: confidence differs by {dconf}")
    n_lines = sum(len(r.lines) for r in fused + bucketed + [big])
    print(f"  fp32 lanes: fused batch (tilted, colour, 40-line and oversize "
          f"tilted pages rerouted), bucketed batch, ocr() and detect() on "
          f"the oversize page, {len(recs)} strips: {n_lines} lines match "
          f"the JAX float32 outputs, max box diff {worst:.5f} px, strip "
          f"confidence diff {dconf:.2e}; launches {launches}")
    return fused, bucketed


def phase_lanes_bf16(eng, fixture, fp32_results):
    """The same lanes in bfloat16: device ms per stage and the share of
    lines that read as in float32."""
    from ocrjax_torch.utils.profiling import StageTimer
    batch, strips, named, _ = fixture
    calls = {"ocr_batch(fused=True)":
             lambda: eng.ocr_batch(batch, fused=True),
             "ocr_batch(fused=False)":
             lambda: eng.ocr_batch(batch, fused=False),
             "ocr(oversize)": lambda: [eng.ocr(named["big"])],
             "detect(oversize)": lambda: eng.detect(named["big"]),
             "recognize_strips": lambda: eng.recognize_strips(strips)}
    outs = {}
    for name, call in calls.items():
        call()                                             # warm-up
        timer = StageTimer()
        t0 = time.perf_counter()
        with timer.active():
            outs[name] = call()
        stages = timer.report()
        wall = (time.perf_counter() - t0) * 1e3
        print(f"  bf16 {name}: wall {wall:.1f} ms (host clock), device ms "
              + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    same = total = 0
    pages = fixture[3]["batch"]
    for name, want in zip(("ocr_batch(fused=True)", "ocr_batch(fused=False)"),
                          fp32_results):
        for page, r, w in zip(pages, outs[name], want):
            a = [line.text for line in r.lines]
            b = [line.text for line in w.lines]
            n_same = sum(x == y for x, y in zip(a, b))
            total += len(b)
            same += n_same
            if n_same != len(b) or len(a) != len(b):
                print(f"  bf16 {name}, {page} page: {len(b) - n_same} of "
                      f"{len(b)} fp32 lines read differently "
                      f"({len(a)} lines in bf16)")
    agree = same / max(total, 1)
    print(f"  bf16 lanes: {same}/{total} lines equal the fp32 strings "
          f"({agree:.4f})")
    if agree < BF16_AGREE_MIN:
        fail(f"bf16 lane strings agree with fp32 on {agree:.3f} < "
             f"{BF16_AGREE_MIN}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(PKG):
        print(f"chip_smoke: {PKG} is missing: run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = smi_line()
    print(f"== 0. environment: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_kernels()
    from ocrjax_torch.ops.cc_label import label_components_cuda
    from ocrjax_torch.ops.conv_fused import conv3x3_bn_relu_cuda
    counters = [label_components_cuda, conv3x3_bn_relu_cuda]

    print("== 1. kernels vs their plain versions")
    ccl = phase_kernels()
    conv_err = phase_conv_kernel()
    print("== 2. fused lane, float32")
    pages, expected = load_fixture()
    eng32, fp32 = phase_fp32(pages, expected, counters)
    print("== 3. fused lane, bfloat16")
    eng16, launches = phase_bf16(pages, fp32, counters)
    print("== 4. conv bench")
    conv = phase_conv_bench(counters, conv_err)
    print("== 5. staged and rerouted lanes, float32")
    fixture = load_lane_fixture()
    lanes32 = phase_lanes_fp32(eng32, fixture, counters)
    print("== 6. staged and rerouted lanes, bfloat16")
    phase_lanes_bf16(eng16, fixture, lanes32)
    kernels = [{**ccl, "launches": launches["label_components_cuda"]}, conv]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
