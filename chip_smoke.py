#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (ocrjax_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. environment: the card's name and power limit, torch and CUDA versions,
     the build of every kernel under ocrjax_torch/csrc (one nvcc per
     source, and g++ for the native host library csrc/ocr_native.cpp, all
     started together) and, where cuobjdump is found, how
     often HGMMA occurs in the built conv_fused library's SASS;
  1. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes and on edge cases, with the path every launch took.
     cc_label: bit-exact on all three paths (labels in one block's shared
     memory, in a thread-block cluster's distributed shared memory, in
     device memory); the 240^2 and 128^2 grids must take the shared path
     unforced, every C5 grid (512^2, 512x192, 448x512, 448x192; at
     densities 0.3, 0.5, 0.72, n_iters 4-6, all background, all
     foreground, a snake across every band boundary, runs on band-boundary
     rows, H no multiple of 8) the cluster path, and each of them the
     general path forced; the shared path's time on 16 x 240^2 and the
     cluster path's on 2 x 512^2 (CUDA events, median of 25 launches),
     each beside the general path's in turns (at most 1/4 and 1/8 of it),
     the profiler's device-only time, an empty launch's, the plain
     version's and the card's lower bound. conv_fused: the weight
     pre-kernel against pack_weights_torch bit for bit, then all 12
     production shapes with bf16 x (11 must take the wgmma path, crnn.conv0
     the small-Cin path), two with float32 x, the edge shapes (the general
     path) and two small wgmma shapes, within the tolerances below;
  2. fused lane in float32 (TF32 off): OcrEngine.from_pretrained() on cuda,
     ocr_batch(fused=True) over 16 pages at 960 (the 4 committed fixture
     pages, 4 times each) and ocr() on one page, held to the JAX engine's
     float32 outputs on the same pages (identical strings and order, boxes
     within 0.011 px, scores within 2e-3);
  3. fused lane in bfloat16 (the shipped compute dtype): pages/s, device
     time per stage, the share of the line slots recognized
     (fused.slot_counts: at least the occupied ones, fewer than all), and
     the share of lines whose strings equal the float32 run's (at least
     0.9);
  4. conv bench: ocrjax_torch.bench_conv.run() at the 12 shapes (the
     kernel the wrapper picks and the general kernel in turns, cuDNN and
     plain times) with each shape's lower bound; the picked kernels must sum
     to less than the general one;
  5. staged and rerouted lanes in float32 over the committed lane fixture
     (a straight, a tilted, a colour, an inverted, a 40-line, an oversize
     and an oversize tilted page; line strips): ocr_batch(fused=True) with
     every reroute firing, ocr_batch(fused=False), ocr() and detect() on the
     oversize page, recognize_strips(), held to the JAX engine's float32
     outputs at the same bar; the fused lane's log lines (the redo counts
     rotated, saturated, colorful) equal ocrjax's on the same batch
     (expected_jax_logs.json);
  6. the same lanes in bfloat16 with device time per stage;
  7. beam CTC in float32: the fused lane (the 16 pages of phase 2), the
     bucketed lane on the mixed batch and recognize_strips with beam=True,
     held to the JAX engine's float32 beam outputs at the same bar; then,
     in bfloat16, the `ctc` stage's device ms of beam beside greedy's;
  8. orientation (rec_try_flip) in float32 on the flip fixture (an
     upright, a 180-degree and a 90-degree rotated page at 960): ocr() on
     each page, ocr_batch(fused=True) and ocr_batch(fused=False), held to
     the JAX try-flip engine's outputs; then, in bfloat16, the `cls` stage;
  9. C5 at full width: ocr_tiled_batch on two A4 pages at 300 dpi (dense,
     sparse, dense) and detect_tiled on the dense one, shipped tile settings
     (2048-pixel tiles, the tile detector, 384 candidates a tile), float32,
     held to the JAX engine's outputs: strings, order, truncation and scores
     to its float32 run, boxes within 0.011 px of the reference evaluated
     with exact moment sums (as the port sums them; at 2048-pixel tiles the
     reference's float32 sums move its own boxes by up to the recorded
     reference_moment_error_px) and within that error + 0.011 px of its
     float32 run; every cc_label launch of the phase must take the
     cluster path, as every C5 grid is past 65,535 pixels. Then, in
     bfloat16: pages/s, device ms per stage, host ms of the host stages,
     K1's ms per window, and the peak device memory.
  10. the opt-in paths in float32 against the JAX engine's float32 outputs
     with the same flag (expected_jax_optin_fp32_960.json,
     expected_jax_curl_fp32_960.json): det_int8 on the fused lane (the 16
     pages), ocr() and the bucketed lane batch, first with ocrjax's own BN
     fold (det_int8_fold_jax.npz, XLA:CPU's rsqrt) at the bar above, then
     with the port's (the correctly rounded rsqrt): at least
     OWN_FOLD_AGREE_MIN of the lines read as in JAX, with the worst box and
     score gaps printed;
     the int8 product (torch._int_mm) against its plain float64 version at
     every int8 layer's shape of a 16-page chunk, bit for bit; the fused
     program with the exact homography warp (separable_warp=False);
     rec_dewarp_curl without and with rec_try_flip on the curl pages
     through ocr(), ocr_batch fused and bucketed and recognize_strips, and
     the dewarp's curved masks identical; rec_flat_case_gate on the lane
     batch, fused and bucketed. Every cc_label launch on the shared path;
  11. the same in bfloat16: det_forward of int8 beside float on one
     16-page chunk and warp_refine of the grouped program beside the
     separable one (in turns), the dewarp's own ms, and the share of
     float32 lines that read the same in bfloat16, counted as multisets per
     page as in phase 9 (at least 0.9);
  12. the CLI on the card: fixture pages written to PNG by this script's
     own zlib encoder, cli.main(["ocr", a, b, "--json"]), (["detect", a,
     "--json"]) and (["ocr", sparse A4 page, "--tiled", "--json"]) in
     process, their JSON equal to the engine's results on the same arrays
     rounded as the CLI rounds; the --tiled call labels on the cluster path,
     the others on the shared path; wall time of each call.
  13. the bench: bench_lib.run_bench on the committed traffic
     (bench_traffic.npz: 256 strips, 16 pages at 960, 3 dense pages of
     3072x2048) at the reference's sizes, bf16; its report on a line of
     its own; every key of the reference's report (the link probe and
     each window's probe and fetch fields among them), every number
     finite; the device ceiling at or above the fused lane's
     pages/s; the last fused window's strings read as a direct float32
     ocr_batch on the same pages on at least 0.9 of the lines; K1 on the
     shared path in the page sections and on the cluster path in the C5
     sections (counted by the bench, by section and path);
  14. e2e_eval: score_e2e of the committed pages (e2e_pages.npz, the 8
     pages of evaluate_e2e at seed 123) in float32, equal to ocrjax's
     line exact match, detection recall and CER
     (expected_jax_e2e_fp32.json), and the same in bfloat16 beside them;
  15. training: 3 steps of the rec, det and cls step functions on the
     committed batches (train_batches.npz) from the shipped assets at
     full width, float32 with cuDNN deterministic, held to ocrjax's
     losses, per-leaf update norms and BatchNorm statistics at the bars
     that expected_jax_train_fp32.json states; bfloat16 losses finite and
     within its bar of float32's; ms a step (CUDA events); a checkpoint
     written and read back resumes to the same next loss. The steps run
     as the trainers run them by default: captured programs (phase 24).
     (Phases 16 and 18 train through the same programs.)
  16. parallel (ocrjax_torch.parallel.mesh), in a child process that is
     one NCCL rank on the card (world size 1; the card machine has one
     GPU, so multi-rank results are held on the CPU by the tests): the
     dp-sharded fused program on phase 2's 16 pages in float32 (its packed
     rows gathered by one all_gather a call) and sharded tiled serving on
     the A4 pages, each against the unsharded run at the goldens' bar;
     three sharded rec steps at full width (a captured program, its NCCL
     collectives inside the graph) against the unsharded steps at phase
     15's loss and update bars, with each step program's keys, replays
     and recaptures recorded for phase 24; the sharded and
     the unsharded fused call's ms; then dryrun_multichip(1) on a CPU rank;
  17. the native host library: built and taken by the pack and the chunk
     decode in phase 3, its canvases and packed bytes bit-equal to the
     numpy twins on every fixture page (phase 2's, the lane fixture's and
     the A4 pages), host ms of a 16-page chunk's decode and pack on both
     routes in turns, and phase 3's fused window on both routes in turns.
  18. assets: the reference's asset recipes through the port's scripts
     (ocrjax_torch.scripts), at full width from the shipped assets, against
     ocrjax's scripts run on the same cut recipes on a CPU
     (expected_jax_assets_fp32.json, written by tests/test_torch_fixture.py
     --write-assets). (a) the renderer's versions and layout engine (libraqm
     or Pillow's basic layout); digests of the eval tiers' pages, the e2e
     pages and render_traffic's first 16 pages against ocrjax's under the
     same layout, equal or not (under raqm render_traffic's pages must then
     equal bench_traffic.npz's); (b) scripts/finetune_r5_soft.sh's flags
     through train_rec_assets in float32 with the steps and det-crop pages
     cut, a first invocation ending after its checkpoint at step 20 and a
     second resuming there; (c) finetune_r3_det.sh's through
     train_det_assets; (d) train_cls_assets, steps and crop pages cut, from
     flax's initial classifier (cls_init_jax.npz); the rec and cls runs
     train on ocrjax's det crop sets (det_crops_jax.npz), and the crops
     the port makes are held against them (at least crops_paired of them
     paired by text and width); (e) soup_weights of the
     shipped rec asset and (b)'s candidate; (f) eval_multiseed --degrade,
     seeds cut, on the shipped assets and on the soup. Bars (the JSON's):
     (i) the shipped assets' eval numbers equal ocrjax's on every tier
     whose pages equal its pages (within eval_atol otherwise, printed);
     the soup's, averaged over the tiers, within eval_atol;
     (ii) where this layout is the reference runs' and a recipe's batches
     equal ocrjax's (by digest), the loss at each such step within
     loss_rtol; (iii) always, the mean loss of each 20-step window within
     5% and each final eval number within 0.03; (g) (b)-(d) again in
     bfloat16 without the resume: (iv) windowed losses within 5% of
     float32's over the windows of the same batches in both runs (the
     float32 rec run's resume reseeds its second half); the device's busy
     share and operations a step over steps 3-7 (torch.profiler), ms a
     step and render ms a step over steps 9 to N-1 (host clock). The whole
     record goes to ocrjax_torch/_build/assets_phase.json.
  19. the reference's hardware gates: every test of tests/test_tpu.py as a
     gate function below (gate_<name>, GATE_LINES), on
     OcrEngine.from_pretrained() on the card in bfloat16, the shipped
     dtype, each bar copied as it stands: K2 against its plain version,
     recognize, extract_boxes, e2e (8 pages), K1 against its plain
     version, rotated, try-flip (set after construction), inverted and
     degraded pages, dense C5, the tiled batch against the serial calls
     (host clock, the card synchronized before each reading), tiled e2e,
     short strips and projective pages. Each gate's numbers print beside
     its bar; a gate that misses saves the pages it drew to
     ocrjax_torch/_build/gate_pages_<name>.npz and fails the phase.
  20. the reference's evaluation and bench scripts through the port's
     (ocrjax_torch.scripts: eval_quality_breakdown, eval_xheight,
     eval_beam, bench_int8_det, bench_try_flip, eval_tiled_quality,
     probe_dense, calibrate_unclip) in bfloat16 through their main(), with
     pages or seeds cut (SCRIPT_CUTS); each printout parsed, its keys
     those of the reference's printout (expected_jax_scripts_fp32.json)
     and every number finite; bench_int8_det's int8 convolutions all on
     db_int8's _int_mm route, its bitmap agreement at least
     INT8_AGREE_MIN.
  21. the reference's diagnostic scripts through the port's (diag_dense,
     diag_dense_stages, diag_tile_det, diag_rec_fetch, diag_reroute) in
     bfloat16 through their main(), with pages or repeats cut
     (DIAG_CUTS); each printout parsed, its keys those of the reference's
     printout (expected_jax_diag_fp32.json) and every number finite; the
     phase within DIAG_PHASE_MAX_S. Phases 19-21's record goes to
     ocrjax_torch/_build/gates_scripts.json.
  22. transport (ops.bytepack, api_det.fetch_det): (a) phase 2's 16 pages
     at 960 in float32 in chunks of 4 under fetch_bytes x fetch_max_tokens
     in {True, False} x {48, 0} and under fetch_max_tokens=2,
     det_fetch_candidates=1: results bit-identical across the settings
     and at the goldens bar against expected_jax_fp32_960.json, the forced
     setting refetching every chunk, the default exactly the chunks with a
     line past 48 tokens; (b) the pooled lane, detect, ocr and ocr_tiled
     (dense, then sparse) on phase 9's A4 pages under the same settings,
     bit-identical, the tiled latch full after the dense page and reset
     after the sparse one at the default prefix; (c) the bytes each fetch
     stage copied, equal to the payload formulas; (d) a pinned
     non-blocking copy issued behind a long device queue, still pending
     when issued, equal to a blocking .cpu() once its event is waited on;
     (e) phase 13's fused and bucketed windows by host stage (ms, calls,
     MB) beside the device stages, with the link probe; (f) phase 16's
     sharded fused program: one gathered payload, at the goldens bar of
     the unsharded program. Every one of ocrjax's 13 host stage names
     opens in the phase's runs and phase 13's windows.
  23. compiled programs (ocrjax_torch.graphs: every serving program
     captured once per static shape as CUDA graphs and replayed, phases
     0-22 included), on fresh engines after phase 15's deterministic
     algorithms: (a)+(b) every lane in bf16 (the fused lane on phase 2's
     pages and 2 more in chunks of 4, in fp32 too; the mixed batch fused
     and bucketed; staged ocr() on the tilted page; the full-resolution
     batch; detect; pooled strips; ocr_tiled_batch, detect_tiled and
     ocr_tiled on the A4 pages; beam, the grouped warp,
     try-flip, det_int8, dewarp_curl and the case gate) op by op under
     graphs.eager() and torch.cuda.set_sync_debug_mode("error"), at its
     first graphed call (the capture) and at a replay under the same
     check: bit for bit, K1's launches equal on the three runs; (c) three
     det_unclip_ratio values replaying one set of graphs, each equal to
     its eager run, and fetch_max_tokens=2 refetching every chunk after
     the later chunks replayed; (d) torch.profiler's launch calls and
     device operations of a 16-page fused chunk, the largest pooled
     recognition chunk and a detector chunk, eager against graphed; (e)
     host and device stage ms and pages/s of the bench's 16- and 96-page
     fused and bucketed windows and the A4 tiled batch, eager and graphed
     in turns; (f) capture ms a key and peak memory eager against graphed
     (a 16 x 960 fused call in bf16 and in fp32, the C5 batch); (g)
     graphs.EAGER; the phase within GRAPH_PHASE_MAX_S. The record goes to
     ocrjax_torch/_build/graphs_phase.json.
  24. training programs (graphs.StepProgram: the rec, det and cls train
     steps; graphs.Program: their evaluation forwards), on fresh models
     from the shipped assets at full width after phase 15's deterministic
     algorithms: for each trainer in float32 and bfloat16,
     TRAIN_GRAPH_STEPS steps on phase 15's committed batches op by op
     (graphs.eager()) and graphed under graphs.sync_checked() (the first
     call of a key, its capture, then replays), equal bit for bit in the
     losses (and det's parts), every parameter, the BatchNorm statistics,
     mu, nu, the optimizer's per-step values and its count; in bfloat16,
     ms a step on both routes in turns (eager, graphed, graphed, eager;
     CUDA events) and torch.profiler's launch calls and device operations
     of one step on each route; capture ms a key, replays, peak memory over
     the start on each route; each evaluation forward (rec exact match,
     det recall and precision with K1 inside, cls logits) op by op and
     graphed, equal, with K1's launches equal on both routes and on the
     shared path; phase 16's sharded and unsharded rec steps replayed
     (their programs' record); graphs.EAGER; the phase within
     TRAIN_GRAPH_PHASE_MAX_S. The record goes to
     ocrjax_torch/_build/train_graphs.json.
Each kernel must be launched in the phases that run it (cc_label: 2, 3, 5,
7-12, 13, 14, 16, 18, 19, 20, 21, 22, 23 and 24; conv_fused: 4 and 19's
conv gate); the
counts are set to 0 just before such a phase, or gate or script, and read
just after, in all and by path; the lane phases 2, 3, 5-8, 10, 11, 12's
page calls, 13's page sections, 14, 16's fused call, 18, 19's page gates
and 20's page scripts and 21's diag_rec_fetch and diag_reroute and 24's
det evaluation must label on the shared path only, phase 9, 12's tiled
call, 13's C5 sections, 16's tiled call, 19's C5 gates and its 256x256
bitmaps (extract_boxes, ccl), 20's eval_tiled_quality and probe_dense,
21's diag_dense,
diag_dense_stages and diag_tile_det (a 512x512 grid at every head stride)
and 22's ocr_tiled calls on the cluster path only; 22's fused, pooled,
detect and ocr calls on the shared path only. The last lines
are the kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": ...}.
"""

from __future__ import annotations

import ast
import collections
import concurrent.futures
import contextlib
import gc
import glob
import json
import os
import shutil
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
# small shapes of the wgmma path: ragged pixel tiles with one k16 step of
# which half is zero fill, and a short map with two Cout tiles whose 4 x 16
# patches span four images, one more than the batch has
CONV_WGMMA_EDGE_SHAPES = [("wgmma ragged 8->8", 2, 9, 33, 8, 8),
                          ("wgmma short map", 3, 4, 80, 128, 256)]

BOX_TOL = 0.011
SCORE_TOL = 2e-3
BF16_AGREE_MIN = 0.9
# det_int8 with the port's own BN fold (the correctly rounded rsqrt, where
# XLA:CPU's differs by an ulp on ~13% of channels): an ulp of a folded
# weight flips an int8 code now and then, and the flip moves the next
# layers' activation scales. On the CPU at 960 one of 12 pages read a line
# otherwise, boxes moved by up to 0.54 px and scores by up to 0.024; the
# lines are held to the share that bf16 is held to
OWN_FOLD_AGREE_MIN = 0.9


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
    """One nvcc for each .cu source and one g++ for the native host
    library, all started together."""
    from ocrjax_torch.ops import _cuda
    from ocrjax_torch.postprocess import native_boxes
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(_cuda.CSRC, "*.cu")))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        native = pool.submit(native_boxes.build_library)
        list(pool.map(_cuda.build, names))
        native.result()
    print(f"built {names} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {_cuda.build_seconds}); the native host library "
          f"(g++) in {native_boxes.build_seconds} s (None: a build of this "
          f"source was there)")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", _cuda.library_path("conv_fused")],
            capture_output=True, text=True).stdout
        print(f"conv_fused library: HGMMA occurs {sass.count('HGMMA')} times "
              f"in its SASS")
    return names


def phase_conv_kernel() -> float:
    """conv_fused kernels vs conv_bn_relu_torch on the card; returns the
    largest |kernel - plain| over the 12 production shapes with bf16 x."""
    import torch
    from ocrjax_torch import bench_conv
    from ocrjax_torch.ops import conv_fused
    # the weight pre-kernel first: a wrong layout there is a wrong product
    for cin, cout in ((64, 64), (96, 24), (8, 8), (512, 512)):
        plan = conv_fused.conv_plan(1, 8, 16, cin, cout)
        w = torch.randn((3, 3, cin, cout), device="cuda")
        got = conv_fused.pack_weights_cuda(w, plan["cin_pad"],
                                           plan["cout_pad"])
        torch.cuda.synchronize()
        want = conv_fused.pack_weights_torch(w, plan["cin_pad"],
                                             plan["cout_pad"])
        same = torch.equal(got.view(torch.int16), want.view(torch.int16))
        print(f"  pack_weights {cin}->{cout} -> {tuple(got.shape)}: "
              f"{'bit-equal to' if same else 'DIFFERS from'} its plain "
              f"version")
        if not same:
            fail(f"pack_weights kernel differs from pack_weights_torch at "
                 f"{cin}->{cout}")
    cases = [(s, torch.bfloat16) for s in bench_conv.SHAPES]
    cases += [(s, torch.float32) for s in bench_conv.SHAPES
              if s[0] in CONV_FP32_SHAPES]
    cases += [(s, dt) for s in CONV_EDGE_SHAPES + CONV_WGMMA_EDGE_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_prod = 0.0
    counter = conv_fused.conv3x3_bn_relu_cuda
    g = torch.Generator(device="cuda").manual_seed(2)
    for shape, dtype in cases:
        x, w, _, _ = bench_conv.make_inputs(shape, "cuda", dtype)
        scale = torch.rand(shape[5], device="cuda", generator=g) + 0.5
        bias = torch.randn(shape[5], device="cuda", generator=g) * 0.1
        before = dict(counter.launches_by_path)
        got = counter(x, w, scale, bias).float()
        torch.cuda.synchronize()
        path = path_taken(counter, before)
        want = conv_fused.conv_bn_relu_torch(x, w, scale, bias).float()
        name = str(dtype).split(".")[1]
        rtol, atol = CONV_TOL[name]
        diff = (got - want).abs()
        err = float(diff.max())
        over = float((diff - (atol + rtol * want.abs())).max())
        print(f"  conv_fused {shape[0]} {shape[1:]} {name}, {path} path: "
              f"max |kernel - plain| = {err:.3e}")
        if got.shape != want.shape or not over <= 0.0:
            fail(f"conv_fused kernel ({path} path) differs from its plain "
                 f"version on {shape} {name}: {err} (rtol {rtol}, "
                 f"atol {atol})")
        if shape in bench_conv.SHAPES:
            expect = "wgmma" if shape[4] >= 64 else "small_cin"
        elif shape in CONV_WGMMA_EDGE_SHAPES:
            expect = "wgmma"
        else:
            expect = "generic"
        if path != expect:
            fail(f"conv_fused took the {path} path on {shape}, not {expect}")
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
    from ocrjax_torch.ops.conv_fused import conv3x3_bn_relu_cuda
    reset(counters)
    rows = bench_conv.run()
    launches = read(counters, "conv bench", ["conv3x3_bn_relu_cuda"])
    by_path = dict(conv3x3_bn_relu_cuda.launches_by_path)
    print(bench_conv.format_table(rows))
    print(f"  launches by path: {by_path}")
    shapes = []
    for r in rows:
        b = conv_bound(r)
        shapes.append({
            "shape": r["label"], "path": r["path"], "ms": r["kernel_ms"],
            "generic_ms": r["generic_ms"],
            "device_only_ms": r["kernel_device_ms"],
            "plain_ms": r["plain_ms"], "library_ms": r["cudnn_ms"],
            "library_conv_only_ms": r["conv_only_ms"],
            "library_conv_only_device_only_ms": r["conv_only_device_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "max_abs_err": r["max_abs_err"]})
        print(f"  {r['label']}: {r['path']} path {r['kernel_ms']:.4f} ms, "
              f"general path {r['generic_ms']:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), kernel at "
              f"{b['bound_ms'] / r['kernel_ms']:.3f} of it")
        expect = "wgmma" if r["Cin"] >= 64 else "small_cin"
        if r["path"] != expect:
            fail(f"{r['label']} took the {r['path']} path, not {expect}")
    ms = sum(r["kernel_ms"] for r in rows)
    generic_ms = sum(r["generic_ms"] for r in rows)
    def total(key):         # None if the profiler left one shape out
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals)
    device_only_ms = total("kernel_device_ms")
    print(f"  12 shapes summed: picked kernels {ms:.4f} ms (device only, by "
          f"torch.profiler: {device_only_ms}), general kernel "
          f"{generic_ms:.4f} ms, in turns; cuDNN's convolution alone "
          f"{total('conv_only_ms'):.4f} ms (device only: "
          f"{total('conv_only_device_ms')})")
    if not ms < generic_ms:
        fail(f"the wgmma and small-Cin kernels sum to {ms} ms, not below "
             f"the general kernel's {generic_ms} ms")
    ops = sum(conv_bound(r)["ops_ms"] for r in rows)
    byt = sum(conv_bound(r)["bytes_ms"] for r in rows)
    # the entry's own numbers are the sums over the 12 shapes
    return {"name": "conv_fused", "route": "cuda",
            "source": "ocrjax_torch/csrc/conv_fused.cu",
            "replaces": "ocrjax/ops/pallas/conv_fused.py:88",
            "launches": launches["conv3x3_bn_relu_cuda"],
            "launches_by_path": by_path,
            "max_abs_err": max(max_abs_err,
                               max(r["max_abs_err"] for r in rows)),
            "ms": ms, "generic_ms": generic_ms,
            "device_only_ms": device_only_ms,
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(s_["bound_ms"] for s_ in shapes),
            "bound_by": "operations" if ops >= byt else "bytes",
            "library_ms": sum(r["cudnn_ms"] for r in rows),
            "library_conv_only_ms": total("conv_only_ms"),
            "library_conv_only_device_only_ms": total("conv_only_device_ms"),
            "shapes": shapes}


def path_taken(counter, before: dict) -> str:
    """The path whose count moved since `before` was copied."""
    return next(k for k, v in counter.launches_by_path.items()
                if v != before[k])


def reset(counters) -> None:
    for c in counters:
        c.launches = 0
        c.launches_by_path = {k: 0 for k in c.launches_by_path}


def read(counters, phase: str, must_launch) -> dict:
    """The launch counts of a phase; fails if a kernel that the phase runs
    was launched no time."""
    launches = {c.__name__: c.launches for c in counters}
    for name in must_launch:
        if launches[name] == 0:
            fail(f"kernel {name} never launched in phase '{phase}'")
    return launches


CCL_WHY = {"shared": "the lanes' 240x240 grids belong on the shared path",
           "cluster": "the C5 tile grids (98,304 to 262,144 pixels) belong "
                      "on the cluster path"}


def only_path(phase: str, path: str, by_path: dict | None = None) -> dict:
    """Fails unless every cc_label launch in by_path (default: those counted
    since the last reset) took `path`, and one did at least. Returns
    by_path."""
    from ocrjax_torch.ops.cc_label import label_components_cuda
    if by_path is None:
        by_path = dict(label_components_cuda.launches_by_path)
    if not by_path[path] or any(v for k, v in by_path.items() if k != path):
        fail(f"phase '{phase}': cc_label launches by path {by_path}; "
             f"{CCL_WHY[path]}")
    return by_path


def ccl_bound(pixels: int, n_iters: int = 4) -> dict:
    """The card's lower bound for labeling `pixels` grid pixels: the
    bitmap read once and the int32 labels written once; per pixel and
    sweep 2 row + 2 column run-min steps and 9 window mins."""
    bytes_ms = pixels * (1 + 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = pixels * n_iters * 13 / SIMT_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def phase_kernels():
    """cc_label kernels vs label_components_torch on the card."""
    import torch
    from ocrjax_torch import bench_conv
    from ocrjax_torch.ops.cc_label import (empty_launch_cuda,
                                           label_components_cuda,
                                           label_components_torch)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, density):
        return torch.rand(shape, generator=g, device="cuda") > density
    # name, bitmap, sweeps, the path it must take unforced
    cases = [(f"16x240^2 density {d}", rand((16, 240, 240), d), 4, "shared")
             for d in (0.3, 0.5, 0.72)]
    snake = torch.zeros((2, 64, 64), dtype=torch.bool, device="cuda")
    snake[:, 2, 2:60] = True
    snake[:, 2:40, 59] = True
    snake[:, 39, 4:60] = True
    snake[0, 50:60, 5:25] = True
    cases += [(f"snakes n_iters {it}", snake, it, "shared") for it in (4, 6)]
    cases += [("4x128^2", rand((4, 128, 128), 0.5), 4, "shared"),
              ("255x257", rand((1, 255, 257), 0.5), 4, "shared"),
              ("3x37x70", rand((3, 37, 70), 0.3), 5, "shared"),
              ("1x1", rand((1, 1, 1), 0.0), 4, "shared"),
              ("256^2", rand((1, 256, 256), 0.5), 4, "cluster"),
              ("4x512^2", rand((4, 512, 512), 0.5), 4, "cluster"),
              ("1x70x1100", rand((1, 70, 1100), 0.5), 4, "global")]
    # the cluster path: the four C5 grids, two a launch as a C5 window
    # batches a page's kept tiles, at three densities
    cases += [(f"2x{h}x{w} density {d}", rand((2, h, w), d), 4, "cluster")
              for h, w in ((512, 512), (512, 192), (448, 512), (448, 192))
              for d in (0.3, 0.5, 0.72)]
    cases += [(f"2x512^2 n_iters {it}", rand((2, 512, 512), 0.5), it,
               "cluster") for it in (5, 6)]
    blank = torch.zeros((1, 512, 512), dtype=torch.bool, device="cuda")
    cases += [("512^2 all background", blank, 4, "cluster"),
              ("512^2 all foreground", ~blank, 4, "cluster")]
    # a snake whose vertical runs cross every band boundary (8 bands of 64
    # rows), joined at alternate ends, and runs that begin and end exactly
    # on band-boundary rows (63/64, 127/128, ...)
    snake = blank.clone()
    for x in range(2, 510, 4):
        snake[0, 1:511, x] = True
        snake[0, 1 if (x // 4) % 2 else 510, x:x + 5] = True
    edges = blank.clone()
    for k in range(1, 8):
        edges[0, 64 * k - 1:64 * k + 1, 10 * k:10 * k + 30] = True
        edges[0, 64 * k:64 * k + 3, 200 + 5 * k] = True
        edges[0, 64 * k - 3:64 * k, 300 + 5 * k] = True
        edges[0, 64 * k - 1, 400 + 5 * k] = True
        edges[0, 64 * k, 402 + 5 * k] = True
    cases += [(f"512^2 snake across bands, n_iters {it}", snake, it,
               "cluster") for it in (4, 24)]
    cases += [("512^2 runs on band edges", edges, 4, "cluster"),
              ("2x301x258 (H no multiple of 8)", rand((2, 301, 258), 0.4),
               5, "cluster")]
    err = 0
    for name, bm, it, expect in cases:
        want = label_components_torch(bm, it)
        # unforced, then the general path forced on the same grid
        for forced in (None,) if expect == "global" else (None, "global"):
            before = dict(label_components_cuda.launches_by_path)
            got = label_components_cuda(bm, it, path=forced)
            torch.cuda.synchronize()
            path = path_taken(label_components_cuda, before)
            diff = int((got.long() - want.long()).abs().max())
            print(f"  cc_label {name}, {path} path"
                  f"{' (forced)' if forced else ''}: "
                  f"max |kernel - plain| = {diff}")
            if diff:
                fail(f"cc_label kernel ({path} path) differs from its plain "
                     f"version on {name}")
            if path != (forced or expect):
                fail(f"cc_label took the {path} path on {name}, not "
                     f"{forced or expect}")
            err = max(err, diff)

    # timing at the main path's shape: one fused chunk, 16 pages of the
    # 240x240 OR-pooled grid of a 960 canvas, 4 sweeps; the shared path and
    # the general path in turns, then an empty launch by the same events
    bm = cases[1][1]
    B, H, W = bm.shape
    ms, global_ms = bench_conv.time_in_turns_ms(
        lambda: label_components_cuda(bm, 4),
        lambda: label_components_cuda(bm, 4, path="global"), 25, True)
    empty_ms = time_ms(empty_launch_cuda)
    device_only_ms = bench_conv.device_ms(
        lambda: label_components_cuda(bm, 4))
    plain_ms = time_ms(lambda: label_components_torch(bm, 4))
    b = ccl_bound(B * H * W)
    print(f"  cc_label 16x240^2: shared path {ms:.4f} ms, general path "
          f"{global_ms:.4f} ms (in turns; {global_ms / ms:.2f}x), shared path "
          f"device only by torch.profiler {device_only_ms} ms, empty "
          f"launch {empty_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b['bound_ms'] * 1e3:.3f} us ({b['bound_by']})")
    if not ms * 4 <= global_ms:
        fail(f"cc_label's shared path takes {ms} ms, more than a quarter of "
             f"the general path's {global_ms} ms")
    # the cluster path at a C5 window's shape: two 512x512 grids, 4 sweeps,
    # against the general path in turns
    bm = rand((2, 512, 512), 0.5)
    cl_ms, cl_global_ms = bench_conv.time_in_turns_ms(
        lambda: label_components_cuda(bm, 4),
        lambda: label_components_cuda(bm, 4, path="global"), 25, True)
    cl_device_ms = bench_conv.device_ms(lambda: label_components_cuda(bm, 4))
    cl_plain_ms = time_ms(lambda: label_components_torch(bm, 4))
    cl = ccl_bound(bm.numel())
    print(f"  cc_label 2x512^2: cluster path {cl_ms:.4f} ms, general path "
          f"{cl_global_ms:.4f} ms (in turns; {cl_global_ms / cl_ms:.2f}x), "
          f"cluster path device only by torch.profiler {cl_device_ms} ms, "
          f"empty launch {empty_ms:.4f} ms, plain {cl_plain_ms:.4f} ms, "
          f"bound {cl['bound_ms'] * 1e3:.3f} us ({cl['bound_by']})")
    if not cl_ms * 8 <= cl_global_ms:
        fail(f"cc_label's cluster path takes {cl_ms} ms, more than an eighth "
             f"of the general path's {cl_global_ms} ms")
    return {"name": "cc_label", "route": "cuda",
            "source": "ocrjax_torch/csrc/cc_label.cu",
            "replaces": "ocrjax/ops/pallas/cc_label.py:102",
            "max_abs_err": float(err), "ms": ms, "global_path_ms": global_ms,
            "device_only_ms": device_only_ms,
            "empty_launch_ms": empty_ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None,
            "cluster": {"grid": "2x512x512", "ms": cl_ms,
                        "global_path_ms": cl_global_ms,
                        "device_only_ms": cl_device_ms,
                        "plain_ms": cl_plain_ms, **cl}}


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


def check_boxes(tag: str, quads, scores, want,
                score_tol: float = SCORE_TOL) -> float:
    import numpy as np
    if len(quads) != len(want["boxes"]):
        fail(f"{tag}: {len(quads)} boxes != JAX float32 "
             f"{len(want['boxes'])}")
    if not len(quads):
        return 0.0
    db = float(np.abs(np.array(quads) - np.array(want["boxes"])).max())
    ds = float(np.abs(np.array(scores) - np.array(want["scores"])).max())
    if db > BOX_TOL or ds > score_tol:
        fail(f"{tag}: box diff {db} px / score diff {ds} beyond "
             f"{BOX_TOL} / {score_tol}")
    return db


def check_against(results, expected, tag: str = "page",
                  score_tol: float = SCORE_TOL) -> float:
    """Fails unless every page meets the parity bar; returns the largest
    box-corner difference in px."""
    worst = 0.0
    for i, (r, w) in enumerate(zip(results, expected)):
        got = [line.text for line in r.lines]
        if got != w["strings"]:
            fail(f"{tag} {i}: strings {got} != JAX float32 {w['strings']}")
        worst = max(worst, check_boxes(
            f"{tag} {i}", [line.box.quad for line in r.lines],
            [line.box.score for line in r.lines], w, score_tol))
    return worst


def gaps(results, expected) -> dict:
    """Lines whose strings equal the JAX outputs' by position, of how many,
    and the largest box-corner and score differences over the pages whose
    strings all agree."""
    import numpy as np
    out = {"same": 0, "total": 0, "box_px": 0.0, "score": 0.0}
    for r, w in zip(results, expected):
        got = [line.text for line in r.lines]
        out["total"] += len(w["strings"])
        out["same"] += sum(a == b for a, b in zip(got, w["strings"]))
        if got == w["strings"] and got:
            out["box_px"] = max(out["box_px"], float(np.abs(
                np.array([line.box.quad for line in r.lines])
                - np.array(w["boxes"])).max()))
            out["score"] = max(out["score"], float(np.abs(
                np.array([line.box.score for line in r.lines])
                - np.array(w["scores"])).max()))
    return out


def line_agreement(results, reference) -> tuple:
    """(lines of `reference` whose strings `results` reads by position, the
    same counted as multisets per page, lines of `reference`). By position,
    one line more or less shifts every later line of its page out of step;
    phase 9 counts multisets for that reason."""
    pos = bag = total = 0
    for r, w in zip(results, reference):
        a = [line.text for line in r.lines]
        b = [line.text for line in w.lines]
        total += len(b)
        pos += sum(x == y for x, y in zip(a, b))
        bag += sum((collections.Counter(a) & collections.Counter(b)).values())
    return pos, bag, total


def phase_fp32(pages, expected, counters):
    from ocrjax_torch.api import OcrEngine, asset_config
    eng = OcrEngine.from_pretrained(
        config=asset_config(compute_dtype="float32"))
    eng.ocr_batch(pages[:1], fused=True)                   # warm-up
    reset(counters)
    results = eng.ocr_batch(pages, fused=True)
    single = eng.ocr(pages[0])
    launches = read(counters, "fused float32", ["label_components_cuda"])
    by_path = only_path("fused float32", "shared")
    worst = max(check_against(results, expected),
                check_against([single], expected[:1]))
    n_lines = sum(len(r.lines) for r in results)
    print(f"  fp32: {len(pages)} pages ({n_lines} lines) + ocr() match the "
          f"JAX float32 outputs, max box diff {worst:.5f} px; "
          f"launches {launches}")
    return eng, results, by_path


def phase_bf16(pages, fp32_results, counters, reps: int = 3):
    import torch
    from ocrjax_torch import fused as F
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.utils.profiling import StageTimer
    eng = OcrEngine.from_pretrained()
    assert eng.config.compute_dtype == "bfloat16"
    eng.ocr_batch(pages, fused=True)                       # warm-up
    torch.cuda.synchronize()
    reset(counters)
    slots0 = dict(F.slot_counts)
    t0 = time.perf_counter()
    for _ in range(reps):
        results = eng.ocr_batch(pages, fused=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slots = {k: F.slot_counts[k] - slots0.get(k, 0)
             for k in ("chunks", "slots", "occupied", "recognized")}
    launches = read(counters, "fused bfloat16", ["label_components_cuda"])
    ccl_by_path = only_path("fused bfloat16", "shared")
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
    # the fused lane recognizes the occupied slots at their count bucket
    print(f"  fused slots: {slots['recognized']} of {slots['slots']} "
          f"recognized ({100 * slots['recognized'] / slots['slots']:.1f}%), "
          f"{slots['occupied']} occupied, {slots['chunks']} chunks")
    if not slots["occupied"] <= slots["recognized"] < slots["slots"]:
        fail(f"fused slots: {slots}")
    print("  bf16 stage device ms per 16-page chunk: "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    print(f"  host per 16-page chunk: decode+luma {(t1 - t0) * 1e3:.2f} ms,"
          f" Bayer pack {(t2 - t1) * 1e3:.2f} ms (host clock)")
    print(f"  bf16: {same}/{total} lines equal the fp32 strings "
          f"({agree:.4f})")
    if agree < BF16_AGREE_MIN:
        fail(f"bf16 strings agree with fp32 on {agree:.3f} < "
             f"{BF16_AGREE_MIN}")
    return eng, launches, ccl_by_path


@contextlib.contextmanager
def capture_logs(name: str):
    """The (level, message, fields) records of logger `name` from INFO up
    while the block runs."""
    import logging
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.levelname, record.getMessage(),
                            dict(getattr(record, "fields", {}))))
    logger = logging.getLogger(name)
    h, level = Keep(), logger.level
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)


def phase_lanes_fp32(eng, fixture, counters):
    """Every staged and rerouted lane, float32, against the JAX engine."""
    import numpy as np
    batch, strips, named, want = fixture
    reset(counters)
    with capture_logs("ocrjax_torch.fused") as logs:
        fused = eng.ocr_batch(batch, fused=True)
    bucketed = eng.ocr_batch(batch, fused=False)
    big = eng.ocr(named["big"])
    det_big = eng.detect(named["big"])
    det_tilted = eng.detect(named["tilted"])
    recs = eng.recognize_strips(strips)
    launches = read(counters, "staged lanes float32",
                    ["label_components_cuda"])
    by_path = only_path("staged lanes float32", "shared")
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
    want_logs = [(r["level"], r["msg"], r["fields"]) for r in
                 load_json("expected_jax_logs.json")["fused"]]
    if logs != want_logs:
        fail(f"fused lane log lines {logs} != ocrjax's {want_logs}")
    print(f"  fused lane log lines equal ocrjax's on the mixed batch: {logs}")
    n_lines = sum(len(r.lines) for r in fused + bucketed + [big])
    print(f"  fp32 lanes: fused batch (tilted, colour, 40-line and oversize "
          f"tilted pages rerouted), bucketed batch, ocr() and detect() on "
          f"the oversize page, {len(recs)} strips: {n_lines} lines match "
          f"the JAX float32 outputs, max box diff {worst:.5f} px, strip "
          f"confidence diff {dconf:.2e}; launches {launches}, cc_label by "
          f"path {by_path}")
    return (fused, bucketed), by_path


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


def load_json(name: str):
    with open(os.path.join(TESTDATA, name)) as f:
        return json.load(f)


def phase_beam_fp32(eng, pages, lane_fixture, counters) -> dict:
    """beam=True on the fused lane, the bucketed lane and recognize_strips,
    float32, against the JAX beam outputs."""
    import numpy as np
    want = load_json("expected_jax_beam_fp32_960.json")
    batch, strips, _, _ = lane_fixture
    reset(counters)
    fused = eng.ocr_batch(pages, fused=True, beam=True)
    bucketed = eng.ocr_batch(batch, fused=False, beam=True)
    recs = eng.recognize_strips(strips, beam=True)
    launches = read(counters, "beam float32", ["label_components_cuda"])
    by_path = only_path("beam float32", "shared")
    worst = max(
        check_against(fused, [e for e in want["fused"] for _ in range(4)],
                      "beam fused page"),
        check_against(bucketed, want["bucketed_batch"], "beam bucketed page"))
    got = [r.text for r in recs]
    if got != want["strips"]["strings"]:
        fail(f"recognize_strips(beam=True): {got} != JAX float32 "
             f"{want['strips']['strings']}")
    dconf = float(np.abs(np.array([r.confidence for r in recs])
                         - np.array(want["strips"]["conf"])).max())
    if dconf > SCORE_TOL:
        fail(f"recognize_strips(beam=True): confidence differs by {dconf}")
    n_lines = sum(len(r.lines) for r in fused + bucketed)
    print(f"  beam fp32: fused lane ({len(pages)} pages), bucketed lane "
          f"({len(batch)} pages), {len(recs)} strips: {n_lines} lines match "
          f"the JAX float32 beam outputs, max box diff {worst:.5f} px, strip "
          f"confidence diff {dconf:.2e}; launches {launches}")
    return by_path


def phase_beam_bf16(eng, pages) -> dict:
    """Device ms of the `ctc` stage, beam beside greedy, on one 16-page
    chunk of the fused lane in bfloat16."""
    from ocrjax_torch.utils.profiling import StageTimer
    out = {}
    for beam in (False, True):
        eng.ocr_batch(pages, fused=True, beam=beam)        # warm-up
        timer = StageTimer()
        t0 = time.perf_counter()
        with timer.active():
            eng.ocr_batch(pages, fused=True, beam=beam)
        stages = timer.report()
        wall = (time.perf_counter() - t0) * 1e3
        name = "beam" if beam else "greedy"
        out[name] = stages
        print(f"  bf16 fused lane, {name}: wall {wall:.1f} ms (host clock), "
              f"device ms " + json.dumps({k: round(v, 4)
                                          for k, v in stages.items()}))
    ratio = out["beam"]["ctc"] / out["greedy"]["ctc"]
    print(f"  bf16 ctc stage per 16-page chunk: beam {out['beam']['ctc']:.4f}"
          f" ms, greedy {out['greedy']['ctc']:.4f} ms ({ratio:.1f}x); beam's "
          f"share of the chunk's device stages "
          f"{out['beam']['ctc'] / sum(v for k, v in out['beam'].items() if k != 'ccl'):.3f}")
    return {"ctc_beam_ms": out["beam"]["ctc"],
            "ctc_greedy_ms": out["greedy"]["ctc"]}


def load_flip_fixture():
    import numpy as np
    flip = np.load(os.path.join(TESTDATA, "flip_960.npz"))
    want = load_json("expected_jax_flip_fp32_960.json")
    return [flip[k] for k in want["pages"]], want


def phase_flip_fp32(counters) -> dict:
    """The try-flip engine on the flip fixture, float32, against JAX."""
    from ocrjax_torch.api import OcrEngine, asset_config
    batch, want = load_flip_fixture()
    eng = OcrEngine.from_pretrained(config=asset_config(
        compute_dtype="float32", rec_try_flip=True))
    reset(counters)
    singles = [eng.ocr(p) for p in batch]
    fused = eng.ocr_batch(batch, fused=True)
    bucketed = eng.ocr_batch(batch, fused=False)
    launches = read(counters, "orientation float32",
                    ["label_components_cuda"])
    by_path = only_path("orientation float32", "shared")
    worst = max(check_against(singles, want["ocr"], "flip ocr() page"),
                check_against(fused, want["fused_batch"], "flip fused page"),
                check_against(bucketed, want["bucketed_batch"],
                              "flip bucketed page"))
    n_lines = sum(len(r.lines) for r in singles + fused + bucketed)
    print(f"  flip fp32: ocr() on {want['pages']}, ocr_batch fused and "
          f"bucketed: {n_lines} lines match the JAX try-flip outputs "
          f"(order reversed on the upside-down page, the landscape page "
          f"redone rotated), max box diff {worst:.5f} px; launches "
          f"{launches}")
    return by_path


def phase_flip_bf16() -> dict:
    """Device ms per stage, the orientation stage `cls` among them, of the
    try-flip engine in bfloat16."""
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.utils.profiling import StageTimer
    batch, _ = load_flip_fixture()
    eng = OcrEngine.from_pretrained(config=asset_config(rec_try_flip=True))
    out = {}
    for name, fused in (("ocr_batch(fused=True)", True),
                        ("ocr_batch(fused=False)", False)):
        eng.ocr_batch(batch, fused=fused)                  # warm-up
        timer = StageTimer()
        t0 = time.perf_counter()
        with timer.active():
            eng.ocr_batch(batch, fused=fused)
        stages = timer.report()
        wall = (time.perf_counter() - t0) * 1e3
        out[name] = stages
        print(f"  bf16 try-flip {name} (3 pages): wall {wall:.1f} ms (host "
              f"clock), device ms " + json.dumps(
                  {k: round(v, 4) for k, v in stages.items()}))
    return {k: v.get("cls") for k, v in out.items()}


def load_c5_fixture():
    import numpy as np
    c5 = np.load(os.path.join(TESTDATA, "c5_pages.npz"))
    want = load_json("expected_jax_c5_fp32.json")
    return {k: c5[k] for k in c5.files}, want


def phase_c5_fp32(counters) -> tuple:
    """ocr_tiled_batch and detect_tiled on the A4 pages, float32, against
    JAX; every CCL launch on the general path."""
    import numpy as np
    from ocrjax_torch.api import OcrEngine, asset_config
    c5, want = load_c5_fixture()
    eng = OcrEngine.from_pretrained(config=asset_config(
        compute_dtype="float32"))
    cfg = eng.config
    if eng.tile_det_model is None or (
            cfg.tile_size, cfg.tile_overlap, cfg.tile_max_candidates) != (
            want["tile_size"], want["tile_overlap"],
            want["tile_max_candidates"]):
        fail("the C5 phase needs the tile detector and the shipped tile "
             "settings")
    batch = [c5[k] for k in want["batch"]]
    reset(counters)
    res = eng.ocr_tiled_batch(batch)
    det = eng.detect_tiled(c5["dense"])
    launches = read(counters, "C5 float32", ["label_components_cuda"])
    by_path = only_path("C5 float32", "cluster")
    # held to the reference evaluated with exact moment sums (the port's
    # own summation; test_torch_fixture.exact_moments) at the goldens bar,
    # and to the reference's float32 outputs with the same strings, order,
    # truncation and scores, boxes within its recorded moment error + bar
    exact = want["exact_moments"]
    worst = max(check_against(res, exact["ocr_tiled_batch"], "C5 page"),
                check_boxes("detect_tiled(dense)", [b.quad for b in det],
                            [b.score for b in det],
                            exact["detect_tiled_dense"]))
    gap_bar = want["reference_moment_error_px"] + BOX_TOL
    gap = 0.0
    pairs = [(f"C5 page {i}", [line.box for line in r.lines], w)
             for i, (r, w) in enumerate(zip(res, want["ocr_tiled_batch"]))]
    pairs.append(("detect_tiled(dense)", det, want["detect_tiled_dense"]))
    for i, (r, w) in enumerate(zip(res, want["ocr_tiled_batch"])):
        if [line.text for line in r.lines] != w["strings"]:
            fail(f"C5 page {i}: strings differ from the JAX float32 run's")
        if r.truncated != w["truncated"]:
            fail(f"C5 page {i}: truncated {r.truncated} != JAX "
                 f"{w['truncated']}")
    for tag, boxes, w in pairs:
        if len(boxes) != len(w["boxes"]):
            fail(f"{tag}: {len(boxes)} boxes != JAX float32 "
                 f"{len(w['boxes'])}")
        gap = max(gap, float(np.abs(np.array([b.quad for b in boxes])
                                    - np.array(w["boxes"])).max()))
        ds = float(np.abs(np.array([b.score for b in boxes])
                          - np.array(w["scores"])).max())
        if ds > SCORE_TOL:
            fail(f"{tag}: score diff {ds} beyond {SCORE_TOL}")
    if gap > gap_bar:
        fail(f"C5: boxes {gap} px from the JAX float32 run's, beyond its "
             f"own moment error + bar {gap_bar}")
    print(f"  C5 fp32: {want['batch']} ({[len(r.lines) for r in res]} "
          f"lines) and detect_tiled(dense) ({len(det)} boxes): strings, "
          f"order, truncation and scores equal the JAX float32 run's; boxes "
          f"within {worst:.5f} px of the reference with exact moment sums "
          f"and {gap:.5f} px of its float32 run (whose own moment error is "
          f"{want['reference_moment_error_px']:.5f} px); launches "
          f"{launches}, cc_label by path {by_path}")
    return by_path, res


def phase_c5_bf16(counters, fp32_results, reps: int = 2) -> tuple:
    """C5 in bfloat16: pages/s, device and host ms per stage, K1's ms per
    window, the peak device memory."""
    import torch
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.utils.profiling import StageTimer
    c5, want = load_c5_fixture()
    batch = [c5[k] for k in want["batch"]]
    eng = OcrEngine.from_pretrained()
    eng.ocr_tiled_batch(batch)                             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t0 = time.perf_counter()
    for _ in range(reps):
        res = eng.ocr_tiled_batch(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters, "C5 bfloat16", ["label_components_cuda"])
    by_path = only_path("C5 bfloat16", "cluster")
    peak = torch.cuda.max_memory_allocated()
    timer = StageTimer()
    with timer.active():
        eng.ocr_tiled_batch(batch)
    dev = timer.report()
    host = timer.host_report()
    windows = len(timer.events["tile_det_fetch"])
    n_ccl = len(timer.events["ccl"])
    # strings matched as multisets per page: one line more or less in
    # bf16 shifts every later line of a 200-line page out of step
    same = total = 0
    for r, w in zip(res, fp32_results):
        a = collections.Counter(line.text for line in r.lines)
        b = collections.Counter(line.text for line in w.lines)
        same += sum((a & b).values())
        total += sum(b.values())
    pages_s = len(batch) * reps / wall
    print(f"  C5 bf16: {pages_s:.3f} pages/s ({reps} x {len(batch)} A4 "
          f"pages, host clock, {wall:.3f} s); peak device memory "
          f"{peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    print("  C5 bf16 device ms per 3-page batch: "
          + json.dumps({k: round(v, 4) for k, v in dev.items()}))
    print("  C5 bf16 host ms per 3-page batch: "
          + json.dumps({k: round(host[k], 3) for k in (
              "tile_prep", "tile_seam_merge", "tile_det_fetch")}))
    # K1's bound for the grids this batch labels: every kept tile of the
    # three pages, OR-pooled 4x; bitmap in and int32 labels out, 13
    # operations a pixel and sweep (as in phase 1)
    from ocrjax_torch import preprocess, tiling
    px = sum(th * tw // eng.config.det_cc_downsample ** 2
             for img in batch
             for (_, _, th, tw) in tiling._prep_page(
                 eng, preprocess.load_page(img))[0])
    bound_ms = ccl_bound(px)["bound_ms"]
    print(f"  C5 K1 (cluster path): {dev['ccl']:.4f} ms over {n_ccl} "
          f"launches in {windows} windows: {dev['ccl'] / windows:.4f} ms a "
          f"window, {dev['ccl'] / n_ccl:.4f} ms a launch; bound for the "
          f"batch's {px} grid pixels {bound_ms * 1e3:.3f} us (bytes); "
          f"launches {launches}")
    print(f"  C5 bf16: {same}/{total} fp32 strings read the same in bf16 "
          f"(lines a page, bf16 / fp32: "
          f"{[(len(r.lines), len(w.lines)) for r, w in zip(res, fp32_results)]})")
    if same < BF16_AGREE_MIN * total:
        fail(f"C5 bf16 strings agree with fp32 on {same}/{total}")
    return by_path, {"c5_ccl_ms": dev["ccl"], "c5_ccl_bound_ms": bound_ms,
                     "c5_ccl_ms_per_window": dev["ccl"] / windows,
                     "c5_ccl_ms_per_launch": dev["ccl"] / n_ccl,
                     "c5_windows": windows, "c5_pages_s": pages_s,
                     "c5_peak_mib": peak / 2**20}


def reference_fold(model, fold):
    """db_int8.fold_bn with ocrjax's folded values (det_int8_fold_jax.npz,
    by module name) for every BatchNorm of `model`."""
    import torch
    names = {id(m): name for name, m in model.named_modules()}

    def fold_bn(weight, bn):
        name = names[id(bn)]
        g = torch.from_numpy(fold[name]).to(weight.device)
        b = torch.from_numpy(fold[name + ".bias"]).to(weight.device)
        return weight.float() * g[:, None, None, None], b
    return fold_bn


def int8_layer_shapes(model, x) -> list:
    """(input shape, weight shape, stride) of every int8 conv of one
    forward of `model` on x, recorded through db_int8.int8_conv."""
    from ocrjax_torch.models import db_int8
    seen, conv = [], db_int8.int8_conv

    def record(xq, wq, stride):
        seen.append((tuple(xq.shape), tuple(wq.shape), stride))
        return conv(xq, wq, stride)
    db_int8.int8_conv = record
    try:
        db_int8.prob_int8(model, x)
    finally:
        db_int8.int8_conv = conv
    return seen


def check_int8_product(model, x) -> int:
    """torch._int_mm's route against the plain float64 convolution, bit
    for bit, at every int8 layer's shape of one forward on x (random int8
    codes); returns the number of shapes."""
    import torch
    from ocrjax_torch.models import db_int8
    g = torch.Generator(device="cuda").manual_seed(5)
    shapes = sorted(set(int8_layer_shapes(model, x)))
    for xs, ws, stride in shapes:
        xq = torch.randint(-127, 128, xs, dtype=torch.int8, device="cuda",
                           generator=g)
        wq = torch.randint(-127, 128, ws, dtype=torch.int8, device="cuda",
                           generator=g)
        got = db_int8.int8_conv_int_mm(xq, wq, stride)
        want = db_int8.int8_conv_plain(xq, wq, stride)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            fail(f"int8 product via _int_mm differs from the float64 "
                 f"convolution at x {xs}, w {ws}, stride {stride}")
    return len(shapes)


def port_curved_masks(pages, boxes, device: str = "cuda") -> list:
    """dewarp_curl's curved mask over each page's staged strips, as
    tests/test_torch_fixture.jax_curved_masks computes ocrjax's: the quads
    expanded by the crop margin, two-pass warp with the ink refine (bucket
    512) off the page normalized in float32 on the host."""
    import numpy as np
    import torch
    from ocrjax_torch.api import asset_config
    from ocrjax_torch.ops import warp
    cfg = asset_config()
    out = []
    for page, quads in zip(pages, boxes):
        quads = np.asarray(quads, np.float32)
        bounds = np.asarray([page.shape[1] - 1.0, page.shape[0] - 1.0],
                            np.float32)
        gray = (page.astype(np.float32) / 255.0 - cfg.rec_mean) / cfg.rec_std
        exp = warp.expand_quads_host(quads, cfg.rec_crop_margin,
                                     cfg.rec_crop_margin, bounds=bounds)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                    ).to(device)
        with torch.inference_mode():
            strips, widths = warp.warp_quads_refined(
                dev(gray), dev(exp), dev(bounds), rec_height=cfg.rec_height,
                bucket_width=512,
                ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
                margin_fracs=(cfg.rec_crop_margin, cfg.rec_crop_margin),
                x_margin_keep=cfg.rec_ink_x_margin_keep,
                pad_value=(0.0 - cfg.rec_mean) / cfg.rec_std,
                orig_quads=dev(quads), flat_frac=cfg.rec_flat_band_frac)
            curved = warp.dewarp_curl(
                strips, widths,
                ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
                min_dev_px=cfg.rec_dewarp_min_dev_px,
                max_shift_px=cfg.rec_dewarp_max_px,
                pad_value=(0.0 - cfg.rec_mean) / cfg.rec_std)[1]
        out.append(curved.cpu().numpy().tolist())
    return out


def load_curl_fixture():
    import numpy as np
    curl = np.load(os.path.join(TESTDATA, "curl_960.npz"))
    want = load_json("expected_jax_curl_fp32_960.json")
    pages = [curl[f"page{k}"] for k in range(want["pages"])]
    strips = [curl[k] for k in sorted(
        (f for f in curl.files if f.startswith("strip")),
        key=lambda f: int(f[5:]))]
    return pages, strips, want


def run_curl(eng, pages, strips) -> dict:
    return {"ocr": [eng.ocr(p) for p in pages],
            "fused_batch": eng.ocr_batch(pages, fused=True),
            "bucketed_batch": eng.ocr_batch(pages, fused=False),
            "strips": eng.recognize_strips(strips)}


def check_strips(tag: str, recs, want) -> float:
    import numpy as np
    if [r.text for r in recs] != want["strings"]:
        fail(f"{tag}: {[r.text for r in recs]} != JAX float32 "
             f"{want['strings']}")
    if [bool(r.flipped) for r in recs] != want["flipped"]:
        fail(f"{tag}: flips {[r.flipped for r in recs]} != JAX "
             f"{want['flipped']}")
    d = float(np.abs(np.array([r.confidence for r in recs])
                     - np.array(want["conf"])).max())
    if d > SCORE_TOL:
        fail(f"{tag}: confidence differs by {d}")
    return d


def phase_optin_fp32(counters, pages, lane_fixture) -> tuple:
    """The opt-in paths in float32 against the JAX float32 outputs with
    the same flags; returns (cc_label by path, results for phase 11)."""
    import numpy as np
    import torch
    from ocrjax_torch import fused as F
    from ocrjax_torch import graphs, preprocess
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.api_det import upload
    from ocrjax_torch.models import db_int8
    want = load_json("expected_jax_optin_fp32_960.json")
    fold = np.load(os.path.join(TESTDATA, "det_int8_fold_jax.npz"))
    batch = lane_fixture[0]
    curl_pages, curl_strips, curl_want = load_curl_fixture()
    cfg32 = asset_config(compute_dtype="float32")
    eng8 = OcrEngine.from_pretrained(config=cfg32.replace(det_int8=True))
    with torch.inference_mode():
        x = preprocess.det_normalize_gray(preprocess.unpack_on_device(
            upload(eng8, preprocess.pack_for_upload(
                preprocess.decode_chunk_to_gray(pages, range(len(pages)),
                                                eng8.config)[0],
                eng8.config)), eng8.config),
            eng8.config.det_mean, eng8.config.det_std)
        n_shapes = check_int8_product(eng8.det_model, x)
    del x
    print(f"  int8 product (torch._int_mm) bit-equal to the float64 "
          f"convolution at the {n_shapes} int8 layer shapes of a "
          f"{len(pages)}-page chunk")
    eng32 = OcrEngine.from_pretrained(config=cfg32)
    engs = {flip: OcrEngine.from_pretrained(config=cfg32.replace(
        rec_dewarp_curl=True, rec_try_flip=flip)) for flip in (False, True)}
    gate = OcrEngine.from_pretrained(config=cfg32.replace(
        rec_flat_case_gate=True))

    def int8_lanes():
        return (eng8.ocr_batch(pages, fused=True), [eng8.ocr(pages[0])],
                eng8.ocr_batch(batch, fused=False))
    reset(counters)
    own_fold = db_int8.fold_bn
    db_int8.fold_bn = reference_fold(eng8.det_model, fold)
    try:
        # op by op: the injected fold is a patch of a module function, and
        # a captured program would keep it (and its host copies) for the
        # own-fold run that follows
        with graphs.eager():
            ref8 = int8_lanes()
    finally:
        db_int8.fold_bn = own_fold
    own8 = int8_lanes()
    grouped = F.ocr_pages_fused(eng32, pages, separable_warp=False)
    curl = {flip: run_curl(engs[flip], curl_pages, curl_strips)
            for flip in (False, True)}
    gated = (gate.ocr_batch(batch, fused=True),
             gate.ocr_batch(batch, fused=False))
    launches = read(counters, "opt-in float32", ["label_components_cuda"])
    by_path = only_path("opt-in float32", "shared")

    w8 = want["int8"]
    int8_want = ([e for e in w8["fused"] for _ in range(4)], [w8["ocr"]],
                 w8["bucketed_batch"])
    names = ("int8 fused page", "int8 ocr()", "int8 bucketed page")
    worst = {"int8, ocrjax's fold": max(
        check_against(r, w, f"{n} (ocrjax's fold)")
        for r, w, n in zip(ref8, int8_want, names))}
    ref_gap = gaps([r for rs in ref8 for r in rs],
                   [w for ws in int8_want for w in ws])
    own_gap = gaps([r for rs in own8 for r in rs],
                   [w for ws in int8_want for w in ws])
    if own_gap["same"] < OWN_FOLD_AGREE_MIN * own_gap["total"]:
        fail(f"int8 with the port's own BN fold: {own_gap['same']}/"
             f"{own_gap['total']} lines read as in JAX")
    worst["grouped fused program"] = check_against(
        grouped, [e for e in want["grouped"] for _ in range(4)],
        "grouped fused page")
    strip_conf = 0.0
    for flip in (False, True):
        key = "try_flip" if flip else "plain"
        w = curl_want[key]
        worst[f"dewarp {key}"] = max(
            check_against(curl[flip][lane], w[lane], f"curl {key} {lane}")
            for lane in ("ocr", "fused_batch", "bucketed_batch"))
        strip_conf = max(strip_conf, check_strips(
            f"curl {key} recognize_strips", curl[flip]["strips"],
            w["strips"]))
    masks = port_curved_masks(curl_pages, [p["boxes"]
                                           for p in curl_want["plain"]["ocr"]])
    if masks != curl_want["curved"]:
        fail(f"dewarp curved masks {masks} != JAX {curl_want['curved']}")
    worst["case gate"] = max(
        check_against(r, w, f"case gate {k}") for r, w, k in zip(
            gated, (want["case_gate"]["fused_batch"],
                    want["case_gate"]["bucketed_batch"]),
            ("fused", "bucketed")))
    n_curved = sum(map(sum, masks))
    print(f"  opt-in fp32: every lane matches the JAX float32 outputs with "
          f"the same flag; worst box diff by path {json.dumps(worst)}; int8 "
          f"with ocrjax's fold {json.dumps(ref_gap)}, with the port's own "
          f"{json.dumps(own_gap)}; curl strip confidence diff "
          f"{strip_conf:.2e}; curved masks identical ({n_curved} of "
          f"{sum(map(len, masks))} staged strips curved); launches "
          f"{launches}, cc_label by path {by_path}")
    return by_path, {"int8": own8, "grouped": grouped,
                     "curl": curl[False], "gate": gated,
                     "int8_ocrjax_fold": ref_gap, "int8_own_fold": own_gap,
                     "worst_box_px": worst}


def phase_optin_bf16(counters, pages, lane_fixture, fp32) -> tuple:
    """The opt-in lanes in bfloat16: stage times and the share of lines
    that read as in float32."""
    import torch
    from ocrjax_torch import fused as F
    from ocrjax_torch import preprocess
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.api_det import upload
    from ocrjax_torch.models import db_int8
    from ocrjax_torch.utils.profiling import StageTimer
    batch = lane_fixture[0]
    curl_pages, _, _ = load_curl_fixture()
    cfg = asset_config()
    assert cfg.compute_dtype == "bfloat16"
    eng = OcrEngine.from_pretrained(config=cfg)
    eng8 = OcrEngine.from_pretrained(config=cfg.replace(det_int8=True))
    engd = OcrEngine.from_pretrained(config=cfg.replace(rec_dewarp_curl=True))
    gate = OcrEngine.from_pretrained(config=cfg.replace(
        rec_flat_case_gate=True))
    reset(counters)
    outs = {"int8": (eng8.ocr_batch(pages, fused=True), [eng8.ocr(pages[0])],
                     eng8.ocr_batch(batch, fused=False)),
            "grouped": F.ocr_pages_fused(eng, pages, separable_warp=False),
            "curl": {"ocr": [engd.ocr(p) for p in curl_pages],
                     "fused_batch": engd.ocr_batch(curl_pages, fused=True),
                     "bucketed_batch": engd.ocr_batch(curl_pages,
                                                      fused=False)},
            "gate": (gate.ocr_batch(batch, fused=True),
                     gate.ocr_batch(batch, fused=False))}
    launches = read(counters, "opt-in bfloat16", ["label_components_cuda"])
    by_path = only_path("opt-in bfloat16", "shared")
    per = {"int8": [line_agreement(a, b)
                    for a, b in zip(outs["int8"], fp32["int8"])],
           "grouped": [line_agreement(outs["grouped"], fp32["grouped"])],
           "curl": [line_agreement(outs["curl"][k], fp32["curl"][k])
                    for k in outs["curl"]],
           "case gate": [line_agreement(a, b)
                         for a, b in zip(outs["gate"], fp32["gate"])]}
    per = {k: tuple(map(sum, zip(*v))) for k, v in per.items()}
    pos, same, total = map(sum, zip(*per.values()))
    agree = same / max(total, 1)

    # the detector alone on one 16-page chunk: float and int8 in turns
    from ocrjax_torch import bench_conv
    with torch.inference_mode():
        x = preprocess.det_normalize_gray(preprocess.unpack_on_device(
            upload(eng, preprocess.pack_for_upload(
                preprocess.decode_chunk_to_gray(pages, range(len(pages)),
                                                eng.config)[0],
                eng.config)), eng.config),
            eng.config.det_mean, eng.config.det_std)
        float_ms, int8_ms = bench_conv.time_in_turns_ms(
            lambda: db_int8.apply_prob(eng.det_model, x, False),
            lambda: db_int8.apply_prob(eng.det_model, x, True), 10, True)
    del x
    stages = {}
    for name, call in (
            ("fused float", lambda: eng.ocr_batch(pages, fused=True)),
            ("fused int8", lambda: eng8.ocr_batch(pages, fused=True)),
            ("fused separable", lambda: F.ocr_pages_fused(eng, pages)),
            ("fused grouped", lambda: F.ocr_pages_fused(
                eng, pages, separable_warp=False)),
            ("curl fused dewarp", lambda: engd.ocr_batch(curl_pages,
                                                         fused=True))):
        call()                                              # warm-up
        stages[name] = []
        for _ in range(3):
            timer = StageTimer()
            with timer.active():
                call()
            stages[name].append(timer.report())
    med = {name: {k: statistics.median(r[k] for r in runs)
                  for k in runs[0]} for name, runs in stages.items()}
    for name, st in med.items():
        print(f"  bf16 {name}: device ms (median of 3) "
              + json.dumps({k: round(v, 4) for k, v in st.items()}))
    print(f"  bf16 det forward, one {len(pages)}-page chunk at 960, in "
          f"turns: float {float_ms:.4f} ms, int8 {int8_ms:.4f} ms "
          f"({int8_ms / float_ms:.2f}x); det_forward stage float "
          f"{med['fused float']['det_forward']:.4f} ms, int8 "
          f"{med['fused int8']['det_forward']:.4f} ms")
    print(f"  bf16 warp_refine a 16-page chunk: separable "
          f"{med['fused separable']['warp_refine']:.4f} ms, grouped "
          f"{med['fused grouped']['warp_refine']:.4f} ms; dewarp "
          f"{med['curl fused dewarp']['dewarp']:.4f} ms of a "
          f"{len(curl_pages)}-page chunk")
    print(f"  bf16 opt-in lanes: {same}/{total} fp32 strings read the same "
          f"in bf16 as multisets per page ({agree:.4f}; {pos} by position); "
          f"by path (by position, as multisets, lines) {per}; launches "
          f"{launches}")
    if agree < BF16_AGREE_MIN:
        fail(f"bf16 opt-in strings agree with fp32 on {agree:.3f} < "
             f"{BF16_AGREE_MIN}")
    return by_path, {
        "det_forward_float_ms": float_ms, "det_forward_int8_ms": int8_ms,
        "det_forward_stage_float_ms": med["fused float"]["det_forward"],
        "det_forward_stage_int8_ms": med["fused int8"]["det_forward"],
        "warp_refine_separable_ms": med["fused separable"]["warp_refine"],
        "warp_refine_grouped_ms": med["fused grouped"]["warp_refine"],
        "dewarp_ms": med["curl fused dewarp"]["dewarp"],
        "bf16_agree": agree}


def encode_png(gray) -> bytes:
    """uint8 (H, W) -> 8-bit grey PNG, this script's own encoder: rows
    filtered Sub and Up in turn, zlib level 6."""
    import struct
    import zlib
    import numpy as np

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    H, W = gray.shape
    g = gray.astype(np.int16)
    sub = (g - np.pad(g, ((0, 0), (1, 0)))[:, :-1]) & 0xFF
    up = (g - np.pad(g, ((1, 0), (0, 0)))[:-1]) & 0xFF
    ftype = np.arange(H) % 2 + 1                       # 1 Sub, 2 Up
    rows = np.where((ftype == 1)[:, None], sub, up).astype(np.uint8)
    raw = np.concatenate([ftype[:, None].astype(np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def run_cli(argv) -> tuple:
    """cli.main(argv) in process -> (parsed JSON, wall ms)."""
    import contextlib
    import io
    from ocrjax_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = (time.perf_counter() - t0) * 1e3
    if rc != 0:
        fail(f"cli {argv} exited {rc}")
    return json.loads(buf.getvalue()), wall


def cli_lines(res) -> list:
    """An OcrResult as the CLI's JSON lines."""
    from ocrjax_torch.cli import _quad_list
    return [{"text": line.text, "confidence": round(line.confidence, 4),
             "quad": _quad_list(line.box.quad),
             "score": round(line.box.score, 4)} for line in res.lines]


def phase_cli(counters, pages) -> tuple:
    """The CLI on PNG files written here, against the engine on the same
    arrays; returns (cc_label by path of the page calls, of the tiled
    call, wall ms)."""
    from ocrjax_torch import preprocess
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.cli import _quad_list
    from ocrjax_torch.ops.cc_label import label_components_cuda
    out_dir = os.path.join(PKG, "_build", "cli_pngs")   # git-ignored
    os.makedirs(out_dir, exist_ok=True)
    c5, _ = load_c5_fixture()
    arrays = {"a.png": pages[0], "b.png": pages[1], "sparse.png": c5["sparse"]}
    paths = {}
    for name, arr in arrays.items():
        paths[name] = os.path.join(out_dir, name)
        with open(paths[name], "wb") as f:
            f.write(encode_png(arr))
        if not (preprocess.load_image(paths[name])
                == preprocess.load_image(arr)).all():
            fail(f"{name}: the PNG does not decode to the array written")
    eng = OcrEngine.from_pretrained()
    want_ocr = eng.ocr_batch([arrays["a.png"], arrays["b.png"]])
    want_det = eng.detect(arrays["a.png"])
    want_tiled = eng.ocr_tiled(arrays["sparse.png"])
    run_cli(["ocr", paths["a.png"], paths["b.png"], "--json"])   # warm-up
    by_path, walls = {}, {}
    for tag, argv in (
            ("ocr a b", ["ocr", paths["a.png"], paths["b.png"], "--json"]),
            ("detect a", ["detect", paths["a.png"], "--json"]),
            ("ocr --tiled sparse", ["ocr", paths["sparse.png"], "--tiled",
                                    "--json"])):
        reset(counters)
        got, walls[tag] = run_cli(argv)
        read(counters, f"CLI {tag}", ["label_components_cuda"])
        by_path[tag] = dict(label_components_cuda.launches_by_path)
        if tag == "ocr a b":
            for item, w in zip(got, want_ocr):
                if item["lines"] != cli_lines(w) or item["text"] != w.text:
                    fail(f"CLI ocr {item['image']}: JSON differs from the "
                         f"engine's results on the same array")
        elif tag == "detect a":
            boxes = [{"quad": _quad_list(b.quad), "score": round(b.score, 4)}
                     for b in want_det]
            if got[0]["boxes"] != boxes:
                fail("CLI detect: JSON differs from engine.detect")
        elif got[0]["lines"] != cli_lines(want_tiled):
            fail("CLI ocr --tiled: JSON differs from engine.ocr_tiled")
    tiled = only_path("CLI ocr --tiled", "cluster",
                      by_path.pop("ocr --tiled sparse"))
    shared = only_path("CLI page calls", "shared",
                       {k: sum(v[k] for v in by_path.values())
                        for k in label_components_cuda.launches_by_path})
    print(f"  CLI on PNG files: JSON of ocr (2 pages), detect and ocr "
          f"--tiled (A4) equals the engine's results on the same arrays; "
          f"wall ms (host clock, PNG decode included) "
          + json.dumps({k: round(v, 1) for k, v in walls.items()})
          + f"; cc_label page calls {shared}, tiled call {tiled}")
    return shared, tiled, walls


# the bench report's keys (ocrjax's run_bench report minus its link fields)
BENCH_KEYS = ("device", "pages", "lines", "upload_bits", "link_probe",
              "crops_per_sec",
              "rec_batch_ms", "pages_per_sec_device", "p50_page_latency_ms",
              "dense_pages_per_sec", "dense_lines_per_sec",
              "dense_gt_lines_per_page", "dense_det_ms_per_page",
              "dense_tiles_per_page", "dense_pages_per_sec_device",
              "roofline", "pages_per_sec_fused", "pages_per_sec_bucketed",
              "pages_per_sec_fused_windows",
              "pages_per_sec_bucketed_windows", "pages_per_sec",
              "pages_per_sec_median", "e2e_batch_ms", "stages_last_window",
              "windows_detail", "cc_label_launches_by_section")
# where the bench labels 240x240 grids (K1's shared path) and where it
# labels C5 tile grids (the cluster path)
BENCH_SHARED_SECTIONS = ("windows", "device_ceiling", "latency")
BENCH_C5_SECTIONS = ("dense", "dense_ceiling")


def _numbers(x, key=""):
    """(key, value) of every number in a nested report."""
    if isinstance(x, bool):
        return
    if isinstance(x, (int, float)):
        yield key, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _numbers(v, f"{key}.{k}" if key else k)
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _numbers(v, f"{key}[{i}]")


def phase_bench(counters) -> tuple:
    """run_bench on the committed traffic at the reference's sizes, bf16;
    its report on a line of its own. Returns (K1 launches by path in the
    page sections, in the C5 sections, the report)."""
    import math
    import numpy as np
    from ocrjax_torch import bench_lib
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.ops.cc_label import PATHS
    traffic = bench_lib.load_traffic()
    windows = {}
    reset(counters)
    rep = bench_lib.run_bench(traffic=traffic, results_out=windows)
    launches = read(counters, "bench", ["label_components_cuda"])
    print("  bench report: " + json.dumps(rep))
    missing = [k for k in BENCH_KEYS if k not in rep]
    bad = [k for k, v in _numbers(rep) if not math.isfinite(v)]
    if missing or bad:
        fail(f"bench report: missing keys {missing}, non-finite {bad}")
    if rep["pages_per_sec_device"] < rep["pages_per_sec_fused"]:
        fail(f"bench: the device ceiling {rep['pages_per_sec_device']} "
             f"pages/s is below the fused lane's {rep['pages_per_sec_fused']}")
    sec = rep["cc_label_launches_by_section"]
    shared = only_path("bench page sections", "shared", {
        p: sum(sec[s][p] for s in BENCH_SHARED_SECTIONS) for p in PATHS})
    dense = only_path("bench C5 sections", "cluster", {
        p: sum(sec[s][p] for s in BENCH_C5_SECTIONS) for p in PATHS})
    # the last fused window against a direct float32 run on the same pages
    eng32 = OcrEngine.from_pretrained(
        config=asset_config(compute_dtype="float32"))
    eng32.config = eng32.config.replace(fused_lines_per_page=16)
    imgs = [np.repeat(p[..., None], 3, axis=2)
            for p in traffic["pages"][:rep["pages"]]]
    fp32 = eng32.ocr_batch(imgs, fused=True)
    pos, _, total = line_agreement(windows["fused"], fp32)
    # and both against the traffic's ground truth, by position
    truth = bench_lib.traffic_texts(traffic, "page")[:rep["pages"]]

    def exact(res):
        return sum(line.text in set(t) for r, t in zip(res, truth)
                   for line in r.lines)
    n_truth = sum(len(t) for t in truth)
    print(f"  bench fused window, bf16: {pos}/{total} lines read as the "
          f"direct fp32 ocr_batch; lines found in the ground truth: bf16 "
          f"{exact(windows['fused'])}, fp32 {exact(fp32)} of {n_truth}; "
          f"cc_label by path: page sections {shared}, C5 sections {dense}; "
          f"launches {launches}")
    if pos < BF16_AGREE_MIN * total:
        fail(f"bench fused window agrees with fp32 on {pos}/{total} lines")
    return shared, dense, rep


def phase_e2e(counters) -> dict:
    """evaluate_e2e's scoring of the committed pages in float32 (held to
    ocrjax's numbers exactly) and in bfloat16."""
    import numpy as np
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.train import e2e_eval
    with np.load(os.path.join(TESTDATA, "e2e_pages.npz")) as f:
        pages, texts, counts = f["pages"], str(f["texts"]), f["line_counts"]
    flat = texts.split("\n")
    gts, k = [], 0
    for n in counts:
        gts.append(flat[k:k + int(n)])
        k += int(n)
    want = load_json("expected_jax_e2e_fp32.json")
    keys = ("line_exact_match", "det_recall", "char_error_rate")
    eng32 = OcrEngine.from_pretrained(
        config=asset_config(compute_dtype="float32"))
    reset(counters)
    got32 = e2e_eval.score_e2e(eng32, list(pages), gts)
    launches = read(counters, "e2e float32", ["label_components_cuda"])
    by_path = only_path("e2e float32", "shared")
    got16 = e2e_eval.score_e2e(OcrEngine.from_pretrained(), list(pages), gts)
    print(f"  e2e on {len(pages)} pages ({sum(map(len, gts))} lines): fp32 "
          + json.dumps({k: got32[k] for k in keys}) + ", ocrjax fp32 "
          + json.dumps({k: want[k] for k in keys}) + ", bf16 "
          + json.dumps({k: got16[k] for k in keys})
          + f"; launches {launches}")
    if any(got32[k] != want[k] for k in keys):
        fail("e2e: the float32 numbers differ from ocrjax's")
    return by_path


def _train_models(name: str, dtype: str, device: str):
    """(model, optimizer, step) of one trainer from the shipped asset at
    full width, each trainer's optimizer at its default lr and steps."""
    from ocrjax_torch import weights as W
    from ocrjax_torch.api import ASSETS, asset_config
    from ocrjax_torch.charset import Charset
    from ocrjax_torch.models.cls import create_cls
    from ocrjax_torch.models.crnn import create_crnn
    from ocrjax_torch.models.db import create_db
    from ocrjax_torch.train import cls_trainer, det_trainer, rec_trainer
    from ocrjax_torch.train.optim import train_device
    want = load_json("expected_jax_train_fp32.json")
    lr, steps = want["steps"][name]["lr"], want["steps"][name]["steps"]
    device = train_device(device)           # TF32 off on the card
    cfg = asset_config(compute_dtype=dtype)
    flat = W.read_safetensors(os.path.join(ASSETS, f"{name}.safetensors"))[0]
    if name == "rec":
        cs = Charset.from_file(os.path.join(ASSETS, "rec.charset.txt"))
        model = create_crnn(cfg, cs.num_classes)
    else:
        model = create_db(cfg) if name == "det" else create_cls(cfg)
    W.load_model_variables(model, flat)
    model.to(device)
    if name == "rec":
        opt = rec_trainer.rec_optimizer(model, lr, steps)
        step = rec_trainer.make_train_step(model, opt)
    elif name == "det":
        opt = det_trainer.det_optimizer(model, lr, steps)
        step = det_trainer.make_det_train_step(model, opt, cfg)
    else:
        opt = cls_trainer.cls_optimizer(model, lr, steps)
        step = cls_trainer.make_cls_train_step(
            model, opt, cfg.rec_mean, cfg.rec_std, antisym=0.5)
    return model, opt, step


def _train_inputs(batches, name: str, i: int, device: str) -> tuple:
    import numpy as np
    import torch
    from ocrjax_torch.train import det_gt
    if name == "det":
        pages = batches[f"det{i}_pages"]
        quads = batches[f"det{i}_quads"]
        counts = batches[f"det{i}_line_counts"]
        maps, k = [], 0
        for n in counts:
            maps.append(det_gt.db_gt_maps(list(quads[k:k + n]),
                                          pages.shape[1:]))
            k += n
        arrays = (np.repeat(pages[..., None], 3, axis=3),
                  *(np.stack(m) for m in zip(*maps)))
    else:
        keys = (("images", "widths", "labels", "label_lengths")
                if name == "rec" else ("images", "widths", "labels"))
        arrays = tuple(batches[f"{name}{i}_{k}"] for k in keys)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _loss_of(out):
    return out[0] if isinstance(out, tuple) else out


def phase_train(device: str = "cuda") -> dict:
    """3 steps of each trainer's step function on the committed batches at
    full width: float32 against ocrjax's numbers at the bars the JSON
    states, bfloat16 within its bar of float32, ms a step, and a
    checkpoint round trip. Returns ms a step by trainer and dtype."""
    import numpy as np
    import torch
    from ocrjax_torch import weights as W
    want = load_json("expected_jax_train_fp32.json")
    bars, noise = want["bars"], set(want["noise_leaves"])
    # determinism for the parity runs (cuDNN's conv and LSTM backward pick
    # nondeterministic algorithms otherwise); TF32 stays off
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    with np.load(os.path.join(TESTDATA, "train_batches.npz")) as f:
        batches = {k: f[k] for k in f.files}
    ms, worst = {}, {}
    for name in ("rec", "det", "cls"):
        inputs = [_train_inputs(batches, name, i, device) for i in range(3)]
        losses32 = None
        for dtype in ("float32", "bfloat16"):
            model, opt, step = _train_models(name, dtype, device)
            before = W.model_variables(model)
            losses, times = [], []
            for x in inputs + inputs[1:] * 2:       # 3 parity + 4 timed
                if device == "cuda":
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    loss = _loss_of(step(*x))
                    e.record()
                    e.synchronize()
                    times.append(s.elapsed_time(e))
                else:
                    loss = _loss_of(step(*x))
                losses.append(float(loss))
                if len(losses) == 3:
                    after = W.model_variables(model)
            if times:
                ms[f"{name}_{dtype}"] = statistics.median(times[3:])
            losses = losses[:3]
            if not all(np.isfinite(losses)):
                fail(f"train {name} {dtype}: losses {losses}")
            if dtype == "float32":
                losses32 = losses
                worst[name] = _hold_train(name, losses, before, after,
                                          want[name], bars, noise)
                if name == "rec":
                    _round_trip(name, model, opt, step, inputs[0], device)
            else:
                gap = max(abs(a - b) / abs(b) for a, b in
                          zip(losses, losses32))
                worst[name]["bf16_loss_rel"] = gap
                print(f"  train {name} bf16: losses {losses} (fp32 "
                      f"{losses32}), worst relative gap {gap:.5f}")
                if gap > bars["bf16_loss_rtol"]:
                    fail(f"train {name} bf16 losses {losses} are not within "
                         f"{bars['bf16_loss_rtol']} of fp32's {losses32}")
    print("  train worst gaps against ocrjax fp32 (bars "
          + json.dumps(bars) + "): " + json.dumps(worst))
    print("  train ms a step (CUDA events, median of 4 steps after 3): "
          + json.dumps({k: round(v, 3) for k, v in ms.items()}))
    return ms


def _hold_train(name, losses, before, after, want, bars, noise) -> dict:
    """float32 steps against ocrjax's: losses, the per-leaf update norms
    (noise leaves aside) and the BatchNorm statistics' norms."""
    import numpy as np
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(losses, want["losses"]))
    upd_gap, upd_leaf = 0.0, None
    for k, w in want["update_norms"].items():
        if k in noise:
            continue
        g = float(np.linalg.norm(after[k] - before[k]))
        rel = abs(g - w) / max(w, 1e-12)
        if rel > upd_gap:
            upd_gap, upd_leaf = rel, k
    bn_gap = max([abs(float(np.linalg.norm(after[k])) - w) / max(w, 1e-12)
                  for k, w in want["bn_norms"].items()] or [0.0])
    print(f"  train {name} fp32: losses {losses} (ocrjax {want['losses']}); "
          f"worst gaps: loss {loss_gap:.2e}, update norm {upd_gap:.2e} "
          f"({upd_leaf}), BN statistics {bn_gap:.2e}")
    if (loss_gap > bars["loss_rtol"] or upd_gap > bars["update_rtol"]
            or bn_gap > bars["bn_rtol"]):
        fail(f"train {name} fp32 is off ocrjax's numbers beyond the bars "
             f"{bars}")
    return {"loss_rel": loss_gap, "update_rel": upd_gap, "bn_rel": bn_gap}


def _round_trip(name, model, opt, step, x, device) -> None:
    """A checkpoint written and read back resumes to the same next loss."""
    from ocrjax_torch.train import checkpoint
    path = os.path.join(PKG, "_build", "ckpt",         # git-ignored
                        f"{name}_{opt.count}.safetensors")
    checkpoint.save_train_state(path, opt.count, model, opt)
    model2, opt2, step2 = _train_models(name, "float32", device)
    if checkpoint.load_train_state(path, model2, opt2) != opt.count:
        fail("checkpoint: the step did not round-trip")
    a, b = float(_loss_of(step(*x))), float(_loss_of(step2(*x)))
    print(f"  train {name} checkpoint round trip: next loss {a} live, "
          f"{b} resumed")
    if abs(a - b) > 1e-6 * abs(a):
        fail(f"checkpoint round trip: next loss {b} != {a}")


# ---------------------------------------------------------------------------
# 16. parallel: the sharded paths at world size 1 over NCCL
# ---------------------------------------------------------------------------

def _fused_lines(out, charset, i) -> list:
    """(string, quad, score) of page i's valid lines, slot order."""
    import numpy as np
    v = out["valid"][i]
    return [(charset.decode(out["tokens"][i, k][:out["n_tokens"][i, k]]),
             out["quads"][i, k], float(out["scores"][i, k]))
            for k in np.where(v)[0]]


def _same_lines(tag, got, want) -> float:
    """Identical strings, boxes within BOX_TOL, scores within SCORE_TOL;
    returns the worst box gap."""
    import numpy as np
    if [t for t, _, _ in got] != [t for t, _, _ in want]:
        fail(f"{tag}: strings differ from the unsharded run's")
    worst = 0.0
    for (_, qa, sa), (_, qb, sb) in zip(got, want):
        worst = max(worst, float(np.abs(np.asarray(qa)
                                        - np.asarray(qb)).max()))
        if abs(sa - sb) > SCORE_TOL:
            fail(f"{tag}: score {sa} != unsharded {sb}")
    if worst > BOX_TOL:
        fail(f"{tag}: boxes {worst} px from the unsharded run's")
    return worst


def _parallel_child(rank, init_file, out_file):
    """Phase 16's checks in a process of its own: one NCCL rank on the card.
    Writes its numbers and K1's launches by path to out_file."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ocrjax_torch import fused as F
    from ocrjax_torch import preprocess
    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.ops.cc_label import label_components_cuda
    from ocrjax_torch.parallel import mesh as M
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=1)
    try:
        mesh = M.make_mesh(n_dp=1, n_tp=1)
        out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "backend": dist.get_backend()}
        counters = [label_components_cuda]
        # the fused program over the 16 pages of phase 2, float32
        pages, _ = load_fixture()
        eng = OcrEngine.from_pretrained(
            config=asset_config(compute_dtype="float32"))
        cfg = eng.config
        K = cfg.fused_lines_per_page
        Wb = cfg.rec_bucket_for_width(10 * cfg.rec_height)
        grays, _, valid_hw, _, _ = preprocess.decode_chunk_to_gray(
            pages, range(len(pages)), cfg)
        packed = preprocess.pack_for_upload(grays, cfg)
        wh = valid_hw[:, ::-1].astype(np.float32).copy()
        thr = (float(cfg.det_thresh), float(cfg.det_box_thresh),
               float(cfg.det_unclip_ratio), float(cfg.det_min_box_size))
        plain = F.FusedOcr(eng, K, Wb)
        sharded = M.make_sharded_fused_ocr_fn(eng, mesh, K, Wb)
        packed_d, wh_d = (torch.from_numpy(a).cuda() for a in (packed, wh))
        T, flip = cfg.rec_max_tokens, cfg.rec_try_flip
        want_p = plain(packed_d, thr, wh_d).cpu().numpy()
        real_gather, gathers = dist.all_gather, []

        def counted_gather(*a, **k):
            gathers.append(1)
            return real_gather(*a, **k)
        with patched(dist, "all_gather", counted_gather):
            reset(counters)
            got_p = sharded(packed_d, thr, wh_d).cpu().numpy()
            out["ccl_fused"] = only_path("sharded fused", "shared")
        # one collective a call, for one packed row a page
        out["fused_payload"] = {"gathers": len(gathers),
                                "shape": list(got_p.shape),
                                "dtype": str(got_p.dtype),
                                "equal_bytes": bool(
                                    np.array_equal(got_p, want_p))}
        if len(gathers) != 1 or got_p.shape != want_p.shape \
                or got_p.dtype != want_p.dtype:
            fail(f"sharded fused: {len(gathers)} all_gathers for a "
                 f"{got_p.dtype} {got_p.shape} payload (unsharded: "
                 f"{want_p.dtype} {want_p.shape}); one is due")
        want = F.unpack_fused(want_p, K, T, flip)
        got = F.unpack_fused(got_p, K, T, flip)
        worst = max(_same_lines(f"sharded fused page {i}",
                                _fused_lines(got, eng.charset, i),
                                _fused_lines(want, eng.charset, i))
                    for i in range(len(pages)))
        out["fused_lines"] = int(want["valid"].sum())
        out["fused_worst_box_px"] = worst
        out["fused_ms"] = {
            "sharded": time_ms(lambda: sharded(packed_d, thr, wh_d), n=5),
            "unsharded": time_ms(lambda: plain(packed_d, thr, wh_d), n=5)}
        # tiled serving over the A4 pages, float32, shipped tile settings
        c5, cwant = load_c5_fixture()
        batch = [c5[k] for k in cwant["batch"]]
        want_t = eng.ocr_tiled_batch(batch)
        M.shard_tiled_serving(eng, mesh)
        reset(counters)
        got_t = eng.ocr_tiled_batch(batch)
        out["ccl_tiled"] = only_path("sharded tiled", "cluster")
        M.shard_tiled_serving(eng, None)

        def lines(r):
            return [(x.text, x.box.quad, x.box.score) for x in r.lines]
        out["tiled_worst_box_px"] = max(
            _same_lines(f"sharded C5 page {i}", lines(a), lines(b))
            for i, (a, b) in enumerate(zip(got_t, want_t)))
        out["tiled_lines"] = sum(len(r.lines) for r in want_t)
        # rec steps at full width, sharded against unsharded: phase 15's
        # three batches (the warmup's first update has learning rate 0)
        want_tr = load_json("expected_jax_train_fp32.json")
        bars, noise = want_tr["bars"], set(want_tr["noise_leaves"])
        with np.load(os.path.join(TESTDATA, "train_batches.npz")) as f:
            arrays = [[f[f"rec{i}_{k}"] for k in (
                "images", "widths", "labels", "label_lengths")]
                for i in range(3)]
        losses, updates, programs = [], [], {}
        for shard in (False, True):
            model, opt, step = _train_models("rec", "float32", "cuda")
            before = W.model_variables(model)
            if shard:
                M.prepare_training(mesh, model, opt)
                step = M.make_sharded_rec_train_step(model, opt, mesh)
            losses.append([float(step(*(
                M.shard_batch(mesh, a) if shard else
                tuple(torch.from_numpy(x).cuda() for x in a))))
                for a in arrays])
            after = W.model_variables(model)
            updates.append({k: float(np.linalg.norm(after[k] - before[k]))
                            for k in before if k.startswith("params/")
                            and k not in noise})
            stats = list(step.program.stats().values())
            programs["sharded" if shard else "unsharded"] = {
                "name": step.program.name, "keys": len(stats),
                "replays": sum(st["replays"] for st in stats),
                "recaptures": step.program.recaptures}
        loss_rel = max(abs(s - u) / abs(u) for s, u in zip(*losses[::-1]))
        upd_rel = max(abs(updates[1][k] - w) / max(w, 1e-12)
                      for k, w in updates[0].items())
        out["rec_step"] = {"losses": losses, "loss_rel": loss_rel,
                           "update_rel": upd_rel, "programs": programs}
        if loss_rel > bars["loss_rtol"] or upd_rel > bars["update_rtol"]:
            fail(f"sharded rec step: loss gap {loss_rel}, update gap "
                 f"{upd_rel} beyond {bars}")
        with open(out_file, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_parallel() -> dict:
    """The sharded fused program, sharded tiled serving and a sharded rec
    step in a child at world size 1 over NCCL, each against its unsharded
    run; then dryrun_multichip(1) on a CPU rank. Returns (K1's launches by
    path in the child's fused and tiled runs, the child's record)."""
    import tempfile
    import torch.multiprocessing as mp
    from ocrjax_torch.parallel.dryrun import dryrun_multichip
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_",
                                     dir=os.path.join(PKG, "_build")) as d:
        out_file = os.path.join(d, "parallel.json")
        try:
            mp.spawn(_parallel_child, args=(os.path.join(d, "pg"), out_file),
                     nprocs=1, join=True)
            with open(out_file) as f:
                r = json.load(f)
        except Exception as e:  # noqa: BLE001 - a failed child fails here
            fail(f"phase 16: the NCCL child failed: {e}")
    print(f"  {r['backend']} mesh {r['mesh']}: sharded fused program on "
          f"{r['fused_lines']} lines equals the unsharded one (worst box "
          f"{r['fused_worst_box_px']:.5f} px), cc_label by path "
          f"{r['ccl_fused']}; sharded tiled serving on the A4 pages "
          f"({r['tiled_lines']} lines, worst box "
          f"{r['tiled_worst_box_px']:.5f} px), cc_label by path "
          f"{r['ccl_tiled']}")
    print(f"  sharded rec steps at full width: losses "
          f"{r['rec_step']['losses']} (unsharded, sharded), worst loss gap "
          f"{r['rec_step']['loss_rel']:.2e}, worst update-norm gap "
          f"{r['rec_step']['update_rel']:.2e}")
    print("  fused 16-page call, ms (CUDA events, median of 5): "
          + json.dumps({k: round(v, 3) for k, v in r["fused_ms"].items()}))
    print(f"  sharded fused payload: {r['fused_payload']}")
    line = dryrun_multichip(1)
    if not line.startswith("dryrun_multichip OK"):
        fail(f"dryrun_multichip(1): {line}")
    return {"16 fused": r["ccl_fused"], "16 tiled": r["ccl_tiled"]}, r


# ---------------------------------------------------------------------------
# 17. the native host library
# ---------------------------------------------------------------------------

def phase_native(eng16, pages, lane_fixture, native_in_phase3,
                 reps: int = 3) -> dict:
    """The C++ host library: built and taken on phase 3's pages, bit-equal
    to the numpy twins on every fixture page, host ms of a 16-page chunk's
    decode and pack on both routes in turns, and phase 3's fused window on
    both routes in turns (a note, not a claim)."""
    import numpy as np
    import torch
    from ocrjax_torch import preprocess as P
    from ocrjax_torch.postprocess import native_boxes as NB
    if not NB.native_available():
        fail("the native host library did not build")
    if min(native_in_phase3.values()) == 0:
        fail(f"phase 3 did not take the native library: calls "
             f"{native_in_phase3}")
    cfg = eng16.config
    c5, _ = load_c5_fixture()
    batch, _, named, _ = lane_fixture
    fixture = ([(f"page{i}", p) for i, p in enumerate(pages[::4])]
               + [(k, v) for k, v in named.items()
                  if not k.startswith("strip") and v.ndim >= 2
                  and v.dtype == np.uint8 and min(v.shape[:2]) >= 64]
               + [(f"A4 {k}", c5[k]) for k in c5])
    for tag, img in fixture:
        a = P.decode_canvas_native(img, cfg)
        b = P.decode_canvas_luma_first(img, cfg)
        if not (np.array_equal(a[0], b[0]) and a[1:] == b[1:]):
            fail(f"native decode of {tag} differs from its numpy twin")
        if not np.array_equal(P.pack_nibbles(a[0][None]),
                              P.pack_nibbles_numpy(a[0][None])):
            fail(f"native pack of {tag} differs from its numpy twin")
    chunk = pages[:16]
    ms = {"decode": {"native": [], "numpy": []},
          "pack": {"native": [], "numpy": []}}
    for _ in range(reps):
        for route in ("native", "numpy"):
            with NB.disabled() if route == "numpy" else \
                    contextlib.nullcontext():
                t0 = time.perf_counter()
                grays = P.decode_chunk_to_gray(chunk, range(len(chunk)),
                                               cfg)[0]
                t1 = time.perf_counter()
                packed = P.pack_nibbles(grays)
                t2 = time.perf_counter()
            ms["decode"][route].append((t1 - t0) * 1e3)
            ms["pack"][route].append((t2 - t1) * 1e3)
            if route == "native":
                want = packed
            elif not np.array_equal(packed, want):
                fail("a 16-page chunk packs otherwise on the numpy route")
    host = {s: {r: statistics.median(v) for r, v in d.items()}
            for s, d in ms.items()}
    eng16.ocr_batch(pages, fused=True)                 # warm-up
    pps = {"native": [], "numpy": []}
    for _ in range(reps):
        for route in ("native", "numpy"):
            with NB.disabled() if route == "numpy" else \
                    contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng16.ocr_batch(pages, fused=True)
                torch.cuda.synchronize()
            pps[route].append(len(pages) / (time.perf_counter() - t0))
    print(f"  native library: built in "
          f"{NB.build_seconds if NB.build_seconds is not None else 'cached'}"
          f" s; taken in phase 3 {dict(native_in_phase3)}; decode and pack "
          f"bit-equal to the numpy twins on {len(fixture)} fixture pages")
    print("  host ms per 16-page chunk, median of "
          f"{reps} in turns (host clock): " + json.dumps(
              {s: {r: round(v, 2) for r, v in d.items()}
               for s, d in host.items()}))
    print("  fused window (phase 3's 16 pages, bf16) pages/s in turns: "
          + json.dumps({r: [round(v, 2) for v in vs]
                        for r, vs in pps.items()}))
    return {"host_ms": host, "fused_pages_per_sec": pps}



# ---------------------------------------------------------------------------
# 18. assets: the reference's asset recipes through the port's scripts
# ---------------------------------------------------------------------------

# scripts/finetune_r5_soft.sh's and scripts/finetune_r3_det.sh's flags but
# --ckpt-dir and --out (the runner gives its own); train_cls_assets and
# eval_multiseed run at their defaults but the cuts below
REC_RECIPE = ["--finetune", "--steps", "4000", "--lr", "3e-4",
              "--mix-det-crops", "192", "--det-rotation", "10",
              "--p-word", "0.25", "--confusable-bias", "2", "--l-bias", "2",
              "--p-space", "0.06", "--aug-rotation", "4", "--quantize-p",
              "0.5", "--stretch", "0.15", "--font-bias", "DejaVuSans.ttf:2",
              "--font-anneal-frac", "0.25", "--degrade", "0.45",
              "--degrade-anneal-frac", "0.1", "--flat-snap", "0.3",
              "--ent-reg", "0.03"]
DET_RECIPE = ["--finetune", "--steps", "1500", "--p-dense", "0.35",
              "--degrade", "0.3", "--p-word", "0.25"]
# what each run cuts: flag -> (the recipe's value, this run's)
ASSET_CUTS = {
    "rec": {"--steps": (4000, 40), "--mix-det-crops": (192, 24)},
    "det": {"--steps": (1500, 40)},
    "cls": {"--steps": (8000, 40), "--crop-pages": (96, 8)},
    "eval": {"--straight-seeds": (8, 1), "--rotated-seeds": (6, 1),
             "--degrade-seeds": (4, 1)},
}
# the rec run's first invocation ends right after its checkpoint here; a
# second invocation resumes from it
ASSET_RESUME_AT = 20
SOUP_ALPHA = 0.5
# the eval tiers of eval_multiseed --degrade: (name, seeds' start, pages,
# render kwargs); the count of seeds is the cut's
EVAL_TIERS = (("straight", 123, 8, {}),
              ("rotated", 9, 4, {"max_rotation": 10.0}),
              ("heldout_renderer", 123, 8, {"supersample": 3}),
              *((f"degraded_{lv}", 321, 4, {"degrade_level": lv})
                for lv in (0.25, 0.5, 0.75, 1.0)))
EVAL_KEYS = ("line_exact_match", "det_recall", "char_error_rate")
STEP_FACTORY = {"rec": "make_train_step", "det": "make_det_train_step",
                "cls": "make_cls_train_step"}
RESULT_KEYS = ("exact_match", "recall", "precision", "accuracy")


def cut_argv(recipe: list, kind: str) -> list:
    """The recipe's flags with ASSET_CUTS[kind]'s values in place."""
    argv = list(recipe)
    for flag, (_, v) in ASSET_CUTS[kind].items():
        if flag in argv:
            argv[argv.index(flag) + 1] = str(v)
        else:
            argv += [flag, str(v)]
    return argv


def digest(a) -> str:
    """A short sha256 of an array's bytes."""
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


class Preempted(Exception):
    """Raised right after a checkpoint is written: the end of a run window."""


@contextlib.contextmanager
def patched(obj, name: str, value):
    """obj.name = value for the duration. The attribute held in obj's own
    namespace comes back as it was (a classmethod included); one that obj
    only inherits is removed again."""
    had = name in vars(obj)
    old = vars(obj).get(name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


def crop_key(n_pages: int = 256, seed: int = 17, width: int = 192,
             max_rotation: float = 0.0, p_word: float = 0.0) -> str:
    """A generate_det_crops call's name (its defaults filled in)."""
    return (f"n{n_pages}_s{seed}_w{width}_r{float(max_rotation)}"
            f"_p{float(p_word)}")


def compare_crops(got, want) -> dict:
    """A crop set against ocrjax's (images, widths, texts): crops paired
    in order by (text, width) (difflib), the pairs' largest pixel gap and
    the share of their pixels that differ."""
    import difflib
    import numpy as np
    a = list(zip(want[2], (int(w) for w in want[1])))
    b = list(zip(got.texts, (int(w) for w in got.widths)))
    blocks = difflib.SequenceMatcher(a=a, b=b, autojunk=False
                                     ).get_matching_blocks()
    pairs = [(i + k, j + k) for i, j, n in blocks for k in range(n)]
    gaps = [np.abs(got.images[j].astype(np.int16) - want[0][i])
            for i, j in pairs]
    return {"ocrjax": len(a), "port": len(b), "paired": len(pairs),
            "max_px": int(max((g.max() for g in gaps), default=0)),
            "px_share": float(sum((g > 0).sum() for g in gaps)
                              / max(sum(g.size for g in gaps), 1))}


def _loss_value(out) -> float:
    """The scalar loss in a step function's output (the port's steps
    return it, alone or first; ocrjax's return it after the state)."""
    if getattr(out, "ndim", None) == 0:
        return float(out)
    return float(next(x for x in out if getattr(x, "ndim", None) == 0))


def run_script(mods: dict, main, argv: list, kind: str = None,
               fp32: bool = True, first_step: int = 1,
               ckpt_every: int = None, stop_at: int = None,
               cls_init: dict = None, crops: dict = None,
               profile: bool = False) -> dict:
    """Runs a script's main() with sys.argv = argv, in the package whose
    modules `mods` holds (this port's or, from the tests, ocrjax's: the same
    layout), with the trainer `kind` ("rec", "det", "cls") instrumented:
      * it logs every step's loss (log_every=1) and, with ckpt_every,
        checkpoints that often; with stop_at, the run ends by Preempted
        right after the checkpoint at that step, as a run window would;
      * fp32: the trainer's config and every OcrEngine.from_pretrained in
        float32 (mods["fp32_config"]); else the scripts' default, bf16;
      * each step's input images are hashed (the batches' digests), and
        so is every synthetic render (make_line_batch, make_det_batch,
        render_page: the render digests; det crops are not renders);
      * cls_init (flat flax variables) stands in for the port's random
        init of the classifier (the cls script trains from scratch, and
        the port's init is not flax's);
      * every det crop set that train.det_crops.generate_det_crops makes
        is kept (crop_sets, by crop_key); with crops (crop_key -> ocrjax's
        set) the set made here is held against ocrjax's (compare_crops)
        and ocrjax's trains: which crops survive the width cap follows the
        ink refinement, which a box 0.004 px off can tip, and a set one
        crop longer draws other crops at every later step;
      * profile (the card only): steps 3 to 2 + PROFILED_STEPS in
        torch.profiler (CUDA activity): the device's busy share (kernel
        and copy time over the wall) and the device operations a step;
        the later steps but the last on the host clock alone: ms a step
        and render ms a step (make_line_batch, make_det_batch).
    Returns {losses: [[step, loss]], digests, render_digests, result:
    {eval numbers}, crop_sets, crop_pages (the digests of the pages each
    crop set was cut from), crops: {crop_key: compare_crops}, timing}.
    """
    rec = {"losses": [], "digests": [], "render_digests": [], "renders": [],
           "crop_sets": {}, "crop_pages": {}, "crops": {}}
    calls = []
    patches = [patched(sys, "argv", [f"{kind or 'script'}"] + list(argv))]
    if fp32:
        api = mods["api"]
        orig_fp = api.OcrEngine.from_pretrained

        def from_pretrained(*a, **kw):
            if kw.get("config") is None:
                kw["config"] = mods["fp32_config"]()
            return orig_fp(*a, **kw)
        patches.append(patched(api.OcrEngine, "from_pretrained",
                               from_pretrained))
    if kind:
        tmod = mods[f"{kind}_trainer"]
        orig_train = getattr(tmod, f"train_{kind}")
        orig_factory = getattr(tmod, STEP_FACTORY[kind])

        def train(*a, **kw):
            if fp32:
                kw["config"] = kw["config"].replace(compute_dtype="float32")
            kw["log_every"] = 1
            if ckpt_every:
                kw["ckpt_every"] = ckpt_every
            rec["steps"] = kw["steps"]
            res = orig_train(*a, **kw)
            rec["result"] = {k: float(getattr(res, k)) for k in RESULT_KEYS
                             if hasattr(res, k)}
            return res

        def factory(*a, **kw):
            step = orig_factory(*a, **kw)

            def counted(*args, **kws):
                i = len(calls)
                if profile and i in (2, 2 + PROFILED_STEPS,
                                     rec["steps"] - first_step):
                    _profile_edge(rec, i, rec["steps"] - first_step)
                calls.append(time.perf_counter())
                images = next(x for x in args
                              if str(getattr(x, "dtype", "")).endswith(
                                  "uint8"))
                rec["digests"].append(digest(mods["to_numpy"](images)))
                out = step(*args, **kws)
                rec["losses"].append([first_step + i, _loss_value(out)])
                return out
            return counted

        def hashed(fn, images, timed):
            def render(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if timed:
                    rec["renders"].append((t0, time.perf_counter()))
                rec["render_digests"].append(digest(images(out)))
                return out
            return render

        synth = mods["synth"]
        patches += [patched(tmod, f"train_{kind}", train),
                    patched(tmod, STEP_FACTORY[kind], factory),
                    patched(synth, "make_line_batch", hashed(
                        synth.make_line_batch, lambda o: o.images, True)),
                    patched(mods["det_gt"], "make_det_batch", hashed(
                        mods["det_gt"].make_det_batch, lambda o: o[0],
                        True)),
                    patched(synth, "render_page", hashed(
                        synth.render_page, lambda o: o[0], False))]
        if stop_at:
            ck = mods["checkpoint"]
            orig_save = ck.save_train_state

            def save(path, step, *a, **kw):
                orig_save(path, step, *a, **kw)
                if step == stop_at:
                    raise Preempted(step)
            patches.append(patched(ck, "save_train_state", save))
        dc = mods["det_crops"]
        orig_crops = dc.generate_det_crops

        def generate_det_crops(engine, **kw):
            key = crop_key(**kw)
            n = len(rec["render_digests"])
            made = orig_crops(engine, **kw)
            rec["crop_sets"][key] = made
            rec["crop_pages"][key] = rec["render_digests"][n:]
            if crops is None:
                return made
            if key not in crops:
                fail(f"no committed ocrjax crop set for {key}")
            rec["crops"][key] = compare_crops(made, crops[key])
            return dc.DetCropSet(*crops[key])
        patches.append(patched(dc, "generate_det_crops", generate_det_crops))
        if cls_init is not None:
            W = mods["weights"]
            patches.append(patched(
                W, "init_random_",
                lambda model, seed: W.load_model_variables(model, cls_init)))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        try:
            main()
        except Preempted:
            if not stop_at:
                raise
    rec["first_step"] = first_step
    if profile:
        t0, t1 = rec.pop("window")
        p0, p1 = rec.pop("profiled")
        n = rec["steps"] - first_step - 2 - PROFILED_STEPS
        render = sum(b - a for a, b in rec["renders"] if t0 <= a < t1)
        rec["timing"] = {"ms_a_step": (t1 - t0) * 1e3 / n,
                         "render_ms_a_step": render * 1e3 / n,
                         "steps_timed": n,
                         "device_busy_share": rec.pop("device_s") / (p1 - p0),
                         "kernels_a_step": rec.pop("kernels") / PROFILED_STEPS,
                         "steps_profiled": PROFILED_STEPS}
    del rec["renders"]
    return rec


# run_script's profile: steps 3 to 2 + PROFILED_STEPS in torch.profiler (a
# rec step launches thousands of kernels, and parsing 37 steps of them took
# a minute on the card's host), then the rest but the last on the host
# clock alone
PROFILED_STEPS = 5


def _profile_edge(rec: dict, i: int, last: int) -> None:
    """At step call i (0-based): 2 opens the profiler; 2 + PROFILED_STEPS
    closes it and opens the host-clock window; the last call (`last`)
    closes that. The device is idle there: the trainer read the last
    loss."""
    import torch
    torch.cuda.synchronize()
    now = time.perf_counter()
    if i == 2:
        if last <= 2 + PROFILED_STEPS + 1:
            fail(f"{last + 1} steps are too few to profile")
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        rec["prof"], rec["profiled"] = prof, [now]
    elif i == 2 + PROFILED_STEPS:
        prof = rec.pop("prof")
        prof.stop()
        rec["profiled"].append(now)
        events = prof.key_averages()
        rec["device_s"] = sum(e.self_device_time_total for e in events) / 1e6
        rec["kernels"] = sum(e.count for e in events)
        rec["window"] = [time.perf_counter()]
    elif i == last:
        rec["window"].append(now)


def windowed(losses: list, width: int) -> list:
    """Mean loss of each whole window of `width` steps."""
    vals = [v for _, v in losses]
    return [sum(vals[i:i + width]) / width
            for i in range(0, len(vals) - width + 1, width)]


def run_rec_recipe(mods, main, workdir: str, extra=(), fp32=True,
                   crops=None, resume=True, profile=False) -> dict:
    """finetune_r5_soft.sh's cut recipe: with resume, a first invocation
    ends after its checkpoint at ASSET_RESUME_AT and a second resumes
    there; the candidate lands in workdir/rec_candidate.safetensors."""
    out = os.path.join(workdir, "rec_candidate.safetensors")
    argv = cut_argv(REC_RECIPE, "rec") + [
        "--ckpt-dir", os.path.join(workdir, "rec_ckpt"), "--out", out,
        *extra]
    if not resume:
        return run_script(mods, main, argv, "rec", fp32=fp32, crops=crops,
                          profile=profile)
    first = run_script(mods, main, argv, "rec", fp32=fp32, crops=crops,
                       ckpt_every=ASSET_RESUME_AT, stop_at=ASSET_RESUME_AT)
    second = run_script(mods, main, argv, "rec", fp32=fp32, crops=crops,
                        ckpt_every=ASSET_RESUME_AT,
                        first_step=ASSET_RESUME_AT + 1)
    if len(first["losses"]) != ASSET_RESUME_AT:
        fail(f"rec: the first invocation ran {len(first['losses'])} steps, "
             f"not {ASSET_RESUME_AT}")
    return {**second, "resumed_at": ASSET_RESUME_AT,
            **{k: first[k] + second[k] for k in (
                "losses", "digests", "render_digests")}}


def run_asset_recipes(mods: dict, scripts: dict, workdir: str, extra=(),
                      fp32: bool = True, cls_init: dict = None,
                      crops: dict = None, on_phase=None) -> dict:
    """(b)-(f) of phase 18 in one package: the cut rec recipe with its
    resume, the det recipe, train_cls_assets, the soup of the shipped rec
    asset and the rec candidate, and eval_multiseed --degrade on the
    shipped assets and on the soup. scripts: name -> main; extra: flags
    for every script but the soup (the port's --cpu); crops, cls_init: as
    run_script's; on_phase(name) is called after each part (launch
    counts). Every det crop set made lands in out["crop_sets"]."""
    os.makedirs(workdir, exist_ok=True)
    on_phase = on_phase or (lambda name: None)
    out = {}
    out["rec"] = run_rec_recipe(mods, scripts["train_rec_assets"], workdir,
                                extra, fp32, crops)
    on_phase("rec")
    det_out = os.path.join(workdir, "det_candidate.safetensors")
    out["det"] = run_script(mods, scripts["train_det_assets"], cut_argv(
        DET_RECIPE, "det") + ["--ckpt-dir", os.path.join(workdir, "det_ckpt"),
                              "--out", det_out, *extra], "det", fp32=fp32)
    on_phase("det")
    out["cls"] = run_script(mods, scripts["train_cls_assets"], cut_argv(
        [], "cls") + ["--out", os.path.join(workdir, "cls.safetensors"),
                      *extra], "cls", fp32=fp32, cls_init=cls_init,
        crops=crops)
    on_phase("cls")
    out["crop_sets"] = {}
    for kind in ("rec", "det", "cls"):
        out["crop_sets"].update(out[kind].pop("crop_sets"))
    shipped = os.path.join(ROOT, "assets", "rec.safetensors")
    soup = os.path.join(workdir, "rec_soup.safetensors")
    run_script(mods, scripts["soup_weights"], [
        shipped, os.path.join(workdir, "rec_candidate.safetensors"), soup,
        "--alpha", str(SOUP_ALPHA)], fp32=False)
    for name, weights in (("eval_shipped", []), ("eval_soup",
                                                ["--weights", soup])):
        js = os.path.join(workdir, f"{name}.json")
        run_script(mods, scripts["eval_multiseed"], [
            "--degrade", *cut_argv([], "eval"), "--json", js, *weights,
            *extra], fp32=fp32)
        with open(js) as f:
            out[name] = json.load(f)
        on_phase(name)
    return out


def render_digests(synth, e2e_pages, traffic_pages) -> dict:
    """Digests of what one package's renderers draw: each eval tier's
    pages at the cut seeds (and its count of ground-truth lines),
    evaluate_e2e's default 8 pages (seed 123), the bench traffic's first 16
    pages, and the six font files. e2e_pages(n_pages, seed, **kw) -> (pages,
    their ground-truth texts) and traffic_pages() render; synth is the
    package's renderer module."""
    import numpy as np
    n_seeds = {"straight": "--straight-seeds", "rotated": "--rotated-seeds",
               "heldout_renderer": "--straight-seeds"}
    out = {}
    for name, start, n_pages, kw in EVAL_TIERS:
        seeds = ASSET_CUTS["eval"][n_seeds.get(name, "--degrade-seeds")][1]
        drawn = [e2e_pages(n_pages, s, **kw)
                 for s in range(start, start + seeds)]
        out[f"eval_{name}"] = digest(np.stack([p for d in drawn
                                               for p in d[0]]))
        out[f"lines_eval_{name}"] = sum(len(t) for d in drawn for t in d[1])
    out["e2e_default"] = digest(np.stack(e2e_pages(8, 123)[0]))
    out["traffic_pages16"] = digest(traffic_pages())
    fonts = b""
    for path in synth.FONTS:
        with open(path, "rb") as f:
            fonts += f.read()
    out["fonts"] = digest(np.frombuffer(fonts, np.uint8))
    return out


def port_modules() -> dict:
    """The port's modules as run_script takes them."""
    from ocrjax_torch import api, weights
    from ocrjax_torch.train import (checkpoint, cls_trainer, det_crops,
                                    det_gt, det_trainer, rec_trainer, synth)
    return {"api": api, "weights": weights, "checkpoint": checkpoint,
            "rec_trainer": rec_trainer, "det_trainer": det_trainer,
            "cls_trainer": cls_trainer, "synth": synth, "det_gt": det_gt,
            "det_crops": det_crops,
            "fp32_config": lambda: api.asset_config(compute_dtype="float32"),
            "to_numpy": lambda t: t.cpu().numpy()}


def port_scripts() -> dict:
    """name -> main of the port's asset scripts."""
    from ocrjax_torch.scripts import (eval_multiseed, soup_weights,
                                      train_cls_assets, train_det_assets,
                                      train_rec_assets)
    return {m.__name__.rsplit(".", 1)[1]: m.main for m in (
        train_rec_assets, train_det_assets, train_cls_assets, soup_weights,
        eval_multiseed)}


def port_render_digests() -> dict:
    """render_digests of the port's renderers (train.e2e_eval.render_e2e,
    bench_lib.render_traffic's first 16 pages)."""
    from ocrjax_torch import bench_lib
    from ocrjax_torch.api import ASSETS, asset_config
    from ocrjax_torch.charset import Charset
    from ocrjax_torch.train import e2e_eval, synth
    charset = Charset.from_file(os.path.join(ASSETS, "rec.charset.txt"))
    n = asset_config().line_bucket_for_count(256)
    return render_digests(
        synth,
        lambda n_pages, seed, **kw: e2e_eval.render_e2e(
            charset, n_pages=n_pages, seed=seed, **kw),
        lambda: bench_lib.render_traffic(charset, pages=16, dense_pages=0,
                                         line_bucket=n)["pages"])


def load_cls_init() -> dict:
    """flax's initial classifier variables (train_cls's model.init at seed
    0), committed: the card's cls runs start where ocrjax's start."""
    import numpy as np
    with np.load(os.path.join(TESTDATA, "cls_init_jax.npz")) as f:
        return {k: f[k] for k in f.files}


def load_crops() -> dict:
    """ocrjax's det crop sets of the cut recipes, committed: crop_key ->
    (images, widths, texts)."""
    import numpy as np
    with np.load(os.path.join(TESTDATA, "det_crops_jax.npz")) as f:
        keys = {k.rsplit("__", 1)[0] for k in f.files}
        return {k: (f[f"{k}__images"], f[f"{k}__widths"],
                    str(f[f"{k}__texts"]).split("\n")) for k in keys}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def hold_recipe(kind: str, got: dict, want: dict, bars: dict,
                same_layout: bool, failures: list) -> dict:
    """Bars (ii) and (iii) of one cut recipe against ocrjax's run, a
    missed bar appended to failures; returns the gaps. (ii) holds where
    this renderer's layout is the reference runs' and every synthetic
    render of the run equals ocrjax's."""
    steps = [s for s, _ in want["losses"]]
    if [s for s, _ in got["losses"]] != steps:
        fail(f"assets {kind}: steps {[s for s, _ in got['losses']]} "
             f"against ocrjax's {steps}")
    renders_equal = got["render_digests"] == want["render_digests"]
    out = {"batches_equal": sum(a == b for a, b in zip(got["digests"],
                                                      want["digests"])),
           "renders_equal": renders_equal, "steps": len(steps)}
    print(f"  (a) {kind}: first batch equal to ocrjax's "
          f"{got['digests'][0] == want['digests'][0]}, {out['batches_equal']}"
          f" of {len(steps)} batches equal; synthetic renders equal "
          f"{renders_equal} ({len(got['render_digests'])})")
    bar = bars["loss_rtol"][kind]
    if same_layout and renders_equal:
        out["loss_gap"] = max(_rel(a, b) for (_, a), (_, b) in
                              zip(got["losses"], want["losses"]))
        print(f"  (ii) {kind}: worst relative loss gap over the "
              f"{len(steps)} steps {out['loss_gap']:.3e} (bar {bar:.3e})")
        if out["loss_gap"] > bar:
            failures.append(f"{kind}: the loss gap {out['loss_gap']} to "
                            f"ocrjax passes bar (ii) {bar}")
    else:
        why = ("its synthetic renders differ from ocrjax's" if same_layout
               else "this Pillow lays text out otherwise than the "
                    "reference runs'")
        print(f"  (ii) {kind}: not applied: {why}")
    wg = windowed(got["losses"], bars["window"])
    ww = windowed(want["losses"], bars["window"])
    out["window_gap"] = max(_rel(a, b) for a, b in zip(wg, ww))
    out["eval"] = got["result"]
    out["eval_gap"] = max(abs(got["result"][k] - v)
                          for k, v in want["result"].items())
    print(f"  (iii) {kind}: {bars['window']}-step mean losses "
          f"{[round(v, 5) for v in wg]} (ocrjax {[round(v, 5) for v in ww]})"
          f", worst gap {out['window_gap']:.4f} (bar {bars['window_rtol']});"
          f" eval {got['result']} (ocrjax {want['result']}), worst gap "
          f"{out['eval_gap']:.4f} (bar {bars['eval_atol']})")
    if out["window_gap"] > bars["window_rtol"]:
        failures.append(f"{kind}: windowed losses {wg} not within "
                        f"{bars['window_rtol']} of ocrjax's {ww}")
    if out["eval_gap"] > bars["eval_atol"]:
        failures.append(f"{kind}: eval {got['result']} not within "
                        f"{bars['eval_atol']} of ocrjax's {want['result']}")
    return out


def hold_eval(name: str, got: dict, want: dict, pages_equal: dict,
              lines: dict, bars: dict, exact: bool, failures: list) -> dict:
    """eval_multiseed's numbers against ocrjax's. exact (the shipped
    assets, bar (i)): equal on every tier whose pages equal ocrjax's
    pages; on a tier whose pages differ (lines: its ground-truth lines),
    within eval_atol or one line's share, whichever is more. Else (the
    soup, whose candidate trained here): each number's mean over the tiers
    within eval_atol (a tier holds 20-30 lines, so one line moves it by
    0.03-0.05). A missed bar is appended to failures."""
    if list(got) != list(want):
        fail(f"assets {name}: tiers {list(got)} against {list(want)}")
    worst = {t: max(abs(got[t][k] - w[k]) for k in EVAL_KEYS)
             for t, w in want.items()}
    if exact:
        for tier, gap in worst.items():
            if pages_equal.get(f"eval_{tier}"):
                if gap != 0:
                    failures.append(
                        f"{name} {tier}: {got[tier]} on the pages ocrjax "
                        f"read differ from its {want[tier]} (bar (i))")
                continue
            allow = max(bars["eval_atol"], 1.0 / lines[f"lines_eval_{tier}"])
            print(f"  (i) {name} {tier}: other pages than ocrjax's; gap "
                  f"{gap:.4f} against {allow:.4f} (one line of "
                  f"{lines[f'lines_eval_{tier}']})")
            if gap > allow + 1e-9:
                failures.append(f"{name} {tier}: a gap of {gap} to "
                                f"ocrjax's numbers on other pages passes "
                                f"{allow}")
    else:
        for k in EVAL_KEYS:
            gap = abs(sum(got[t][k] - w[k] for t, w in want.items())
                      / len(want))
            if gap > bars["eval_atol"]:
                failures.append(f"{name}: the tiers' mean {k} is {gap} "
                                f"off ocrjax's, past {bars['eval_atol']}")
    print(f"  {name}: line exact by tier "
          + json.dumps({t: round(got[t]["line_exact_match"], 4)
                        for t in got})
          + " (ocrjax " + json.dumps(
              {t: round(want[t]["line_exact_match"], 4) for t in want})
          + "); worst gap a tier over exact, recall, CER "
          + json.dumps({t: round(v, 5) for t, v in worst.items()}))
    return worst


def phase_assets(counters) -> tuple:
    """(a)-(g) of phase 18; returns (K1's launches by part, the record)."""
    import cv2
    import numpy as np
    import PIL
    from PIL import features
    from ocrjax_torch.train import synth
    want = load_json("expected_jax_assets_fp32.json")
    bars = want["bars"]
    layout = synth.layout_engine()
    versions = {"pillow": PIL.__version__,
                "freetype": features.version("freetype2"),
                "raqm": features.version("raqm"), "layout": layout,
                "opencv": cv2.__version__}
    print(f"  renderer here: {json.dumps(versions)}; ocrjax's runs: "
          + json.dumps(want["renderer"]))
    print("  cuts, flag: [the recipe's value, this run's]: "
          + json.dumps(ASSET_CUTS) + f"; rec resumes at step "
          f"{ASSET_RESUME_AT}; soup alpha {SOUP_ALPHA}")
    # (a) rendering
    t0 = time.perf_counter()
    got_dig = port_render_digests()
    ref_dig = want["digests"].get(layout, {})
    pages_equal = {k: v == ref_dig.get(k) for k, v in got_dig.items()
                   if not k.startswith("lines_")}
    print(f"  (a) renders equal to ocrjax's under the {layout} layout "
          f"({time.perf_counter() - t0:.1f} s): " + json.dumps(pages_equal))
    if not pages_equal["fonts"]:
        fail("the shipped fonts differ from the reference's")
    if layout == "raqm" and pages_equal["traffic_pages16"]:
        from ocrjax_torch import bench_lib
        from ocrjax_torch.api import ASSETS, asset_config
        from ocrjax_torch.charset import Charset
        cs = Charset.from_file(os.path.join(ASSETS, "rec.charset.txt"))
        pages = bench_lib.render_traffic(
            cs, pages=16, dense_pages=0,
            line_bucket=asset_config().line_bucket_for_count(256))["pages"]
        with np.load(os.path.join(TESTDATA, "bench_traffic.npz")) as f:
            if not np.array_equal(pages, f["pages"][:16]):
                fail("render_traffic's pages differ from bench_traffic.npz")
        print("  render_traffic's 16 pages equal bench_traffic.npz's")
    # (b)-(f) in float32
    work = os.path.join(PKG, "_build", "assets_run")
    shutil.rmtree(work, ignore_errors=True)
    launches = {}

    def on_phase(name):
        launches[name] = only_path(f"assets {name}", "shared")
        reset(counters)
    mods, scripts = port_modules(), port_scripts()
    cls_init, crops = load_cls_init(), load_crops()
    reset(counters)
    t0 = time.perf_counter()
    got = run_asset_recipes(mods, scripts, os.path.join(work, "fp32"),
                            cls_init=cls_init, crops=crops,
                            on_phase=on_phase)
    fp32_s = time.perf_counter() - t0
    del got["crop_sets"]
    failures = []
    for kind in ("rec", "cls"):
        for key, c in got[kind]["crops"].items():
            same = (got[kind]["crop_pages"][key]
                    == want["jax"][kind]["crop_pages"][key])
            print(f"  det crops {key} ({kind}): {c['port']} crops against "
                  f"ocrjax's {c['ocrjax']}, {c['paired']} paired by text "
                  f"and width, their pixels differing at {c['px_share']:.4f}"
                  f" of pixels by at most {c['max_px']}; pages equal to "
                  f"ocrjax's {same}")
            if same and c["paired"] < bars["crops_paired"] * c["ocrjax"]:
                failures.append(
                    f"det crops {key}: {c['paired']} of ocrjax's "
                    f"{c['ocrjax']} paired on equal pages, under "
                    f"{bars['crops_paired']}")
    same_layout = layout == want["renderer"]["layout"]
    held = {kind: hold_recipe(kind, got[kind], want["jax"][kind], bars,
                              same_layout, failures)
            for kind in ("rec", "det", "cls")}
    held["eval_shipped"] = hold_eval("eval_shipped", got["eval_shipped"],
                                     want["jax"]["eval_shipped"],
                                     pages_equal, got_dig, bars, True,
                                     failures)
    held["eval_soup"] = hold_eval("eval_soup", got["eval_soup"],
                                  want["jax"]["eval_soup"], pages_equal,
                                  got_dig, bars, False, failures)
    # (g) the training recipes again in bf16, without the resume
    t0 = time.perf_counter()
    bf16 = {"rec": run_rec_recipe(mods, scripts["train_rec_assets"],
                                  os.path.join(work, "bf16"), fp32=False,
                                  crops=crops, resume=False, profile=True)}
    bf16["det"] = run_script(mods, scripts["train_det_assets"], cut_argv(
        DET_RECIPE, "det") + ["--out", os.path.join(work, "bf16", "det.st")],
        "det", fp32=False, profile=True)
    bf16["cls"] = run_script(mods, scripts["train_cls_assets"], cut_argv(
        [], "cls") + ["--out", os.path.join(work, "bf16", "cls.st")], "cls",
        fp32=False, cls_init=cls_init, crops=crops, profile=True)
    for r in bf16.values():
        r.pop("crop_sets")
        r.pop("crop_pages")
    launches["bf16"] = only_path("assets bf16", "shared")
    bf16_s = time.perf_counter() - t0
    width = bars["window"]
    for kind, r in bf16.items():
        w16 = windowed(r["losses"], width)
        w32 = windowed(got[kind]["losses"], width)
        # the fp32 rec run resumed at ASSET_RESUME_AT, which reseeds its
        # batches: only windows of the same batches in both runs compare
        same = [r["digests"][i * width:(i + 1) * width]
                == got[kind]["digests"][i * width:(i + 1) * width]
                for i in range(len(w16))]
        gaps = [_rel(a, b) for a, b, k in zip(w16, w32, same) if k]
        if not gaps:
            fail(f"assets {kind}: no window of the bf16 run has the fp32 "
                 f"run's batches")
        held[kind]["bf16_window_gap"] = max(gaps)
        held[kind]["bf16_timing"] = r["timing"]
        print(f"  (iv) {kind} bf16: {width}-step mean losses "
              f"{[round(v, 5) for v in w16]} (fp32 "
              f"{[round(v, 5) for v in w32]}, the same batches {same}), "
              f"worst gap {max(gaps):.4f} (bar {bars['bf16_window_rtol']})"
              f"; eval {r['result']}; timing: " + json.dumps(
                  {k: round(v, 4) if isinstance(v, float) else v
                   for k, v in r["timing"].items()}))
        if max(gaps) > bars["bf16_window_rtol"]:
            failures.append(f"{kind}: bf16 windowed losses {w16} not "
                            f"within {bars['bf16_window_rtol']} of fp32's "
                            f"{w32}")
    print(f"  wall: fp32 (b)-(f) {fp32_s:.1f} s, bf16 (g) {bf16_s:.1f} s; "
          f"cc_label by part " + json.dumps(launches))
    record = {"renderer": versions, "pages_equal": pages_equal,
              "failures": failures, "held": held, "fp32": got,
              "bf16": bf16,
              "wall_s": {"fp32": fp32_s, "bf16": bf16_s}}
    shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(PKG, "_build", "assets_phase.json"), "w") as f:
        json.dump(record, f, indent=1)
    if failures:
        fail("assets: " + "; ".join(failures))
    return launches, record


# ---------------------------------------------------------------------------
# 19. the reference's hardware gates (tests/test_tpu.py)
# ---------------------------------------------------------------------------

# name -> the line of tests/test_tpu.py whose test the gate function copies;
# each function takes the device and the compute dtype, and the gate's
# sizes as keywords whose defaults are the reference's (the CPU tests call
# them at smaller cuts), and returns the gate's numbers beside its bar
GATE_LINES = {"conv": 12, "recognize": 28, "extract_boxes": 37, "e2e": 47,
              "ccl": 63, "rotated": 77, "try_flip": 113, "inverted": 145,
              "degraded": 169, "dense_c5": 185, "tiled_batch": 221,
              "tiled_e2e": 262, "short_strips": 304, "projective": 350}
# the gates that draw no page
GATE_UNITS = ("conv", "recognize", "extract_boxes", "ccl")
GATE_BAR_BATCH_TIME = 1.10
_gate_engines = {}


def gate_engine(device: str, dtype: str):
    """OcrEngine.from_pretrained() with the shipped config in `dtype`, one
    per device and dtype (a gate that changes its config builds its own)."""
    from ocrjax_torch.api import OcrEngine, asset_config
    key = (device, dtype)
    if key not in _gate_engines:
        _gate_engines[key] = OcrEngine.from_pretrained(
            device=device, config=asset_config(compute_dtype=dtype))
    return _gate_engines[key]


def _gate(name: str, numbers: dict, bar: dict, ok: bool,
          pages: dict = None) -> dict:
    return {"gate": name, "test": f"tests/test_tpu.py:{GATE_LINES[name]}",
            "numbers": numbers, "bar": bar, "ok": bool(ok),
            "pages": pages or {}}


def _rgb(page):
    import numpy as np
    return np.repeat(page[..., None], 3, axis=2)


def multiset_hits(texts, preds) -> int:
    """Lines of `preds` that take one ground-truth line of `texts` each by
    equal text (the gates' `rem.remove` loops)."""
    rem, hits = list(texts), 0
    for p in preds:
        if p in rem:
            rem.remove(p)
            hits += 1
    return hits


def draw_pages(synth, charset, seed: int, n: int, **kw) -> list:
    """n pages of synth.render_page from RandomState(seed), as a gate draws
    them: [(page, quads, texts)]."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [synth.render_page(rng, charset, **kw) for _ in range(n)]


def draw_short_strips(synth, charset, n_pages: int = 8, size: int = 640
                      ) -> dict:
    """The short-strip gate's pages: glyph count L -> [(page, quads,
    texts)] from RandomState(42 + L)."""
    return {L: draw_pages(synth, charset, 42 + L, n_pages, size=(size, size),
                          n_lines=(5, 8), max_len=L, min_len=L)
            for L in (1, 2)}


def draw_dense(synth, charset, size=(3072, 2048), n_lines: int = 200):
    import numpy as np
    return synth.render_page_dense(np.random.RandomState(5), charset,
                                   size=tuple(size), n_lines=n_lines)


def _e2e_gate(name, device, dtype, n_pages, seed, bar, **kw) -> dict:
    from ocrjax_torch.train import e2e_eval
    eng = gate_engine(device, dtype)
    pages, gts = e2e_eval.render_e2e(eng.charset, n_pages=n_pages, seed=seed,
                                     **kw)
    m = e2e_eval.score_e2e(eng, pages, gts)
    ok = (m["det_recall"] >= bar["det_recall"]
          and m["line_exact_match"] >= bar["line_exact_match"]
          and m.get("char_error_rate", 0) <= bar.get("char_error_rate", 1))
    return _gate(name, dict(m), bar, ok, {"pages": pages})


def gate_conv(device: str = "cuda", dtype: str = "bfloat16") -> dict:
    """K2 on (2, 32, 64, 128 -> 128) float32 x against its plain version on
    bf16 x (the compute dtype plays no part)."""
    import numpy as np
    import torch
    from ocrjax_torch.ops import conv_fused
    rng = np.random.RandomState(0)
    B, H, W, Cin, Cout = 2, 32, 64, 128, 128
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    w = rng.randn(3, 3, Cin, Cout).astype(np.float32) * 0.05
    scale = rng.rand(Cout).astype(np.float32) + 0.5
    bias = rng.randn(Cout).astype(np.float32) * 0.1
    x, w, scale, bias = (torch.from_numpy(a).to(device)
                         for a in (x, w, scale, bias))
    got = conv_fused.conv3x3_bn_relu(x, w, scale, bias).float()
    want = conv_fused.conv_bn_relu_torch(x.bfloat16(), w, scale,
                                         bias).float()
    atol, rtol = 0.25, 0.1
    d = (got - want).abs()
    over = float((d - (atol + rtol * want.abs())).max())
    return _gate("conv", {"max_abs_err": float(d.max()),
                          "worst_over_tolerance": over},
                 {"atol": atol, "rtol": rtol}, over <= 0.0)


def gate_recognize(device: str = "cuda", dtype: str = "bfloat16") -> dict:
    from ocrjax_torch.train import synth
    text = gate_engine(device, dtype).recognize(
        synth.render_line("TPU 123", height=32)).text
    return _gate("recognize", {"text": text}, {"text": "TPU 123"},
                 text == "TPU 123")


def gate_extract_boxes(device: str = "cuda", dtype: str = "bfloat16"
                       ) -> dict:
    import numpy as np
    import torch
    from ocrjax_torch.postprocess import db_boxes
    prob = np.zeros((256, 256), np.float32)
    prob[30:50, 20:200] = 0.9
    out = db_boxes.extract_boxes(torch.from_numpy(prob)[None].to(device),
                                 max_candidates=16)
    n = int(out["valid"].sum())
    return _gate("extract_boxes", {"valid": n}, {"valid": 1}, n == 1)


def gate_ccl(device: str = "cuda", dtype: str = "bfloat16") -> dict:
    """The wrapper (K1 on the card) against the plain version."""
    import numpy as np
    import torch
    from ocrjax_torch.ops import cc_label
    bm = np.zeros((256, 256), bool)
    bm[10:30, 10:100] = True
    bm[50:60, 5:250] = True
    bm[100:140, 100:140] = True
    t = torch.from_numpy(bm)[None].to(device)
    got = cc_label.label_components(t, n_iters=4).cpu()
    want = cc_label.label_components_torch(t, n_iters=4).cpu()
    differ = int((got != want).sum())
    return _gate("ccl", {"labels_differing": differ,
                         "components": int(torch.unique(want[want < cc_label.BIG]).numel())},
                 {"labels_differing": 0}, differ == 0)


def gate_e2e(device="cuda", dtype="bfloat16", n_pages: int = 8) -> dict:
    return _e2e_gate("e2e", device, dtype, n_pages, 123,
                     {"det_recall": 0.95, "line_exact_match": 0.92,
                      "char_error_rate": 0.02})


def gate_rotated(device="cuda", dtype="bfloat16", n_pages: int = 4) -> dict:
    from ocrjax_torch.scripts.probe_dense import match
    from ocrjax_torch.train import synth
    eng = gate_engine(device, dtype)
    drawn = draw_pages(synth, eng.charset, 9, n_pages, max_rotation=10)
    tot = found = exact = 0
    for page, quads, texts in drawn:
        f, e = match(quads, texts, eng.ocr(_rgb(page)).lines)
        tot, found, exact = tot + len(texts), found + f, exact + e
    bar = {"found": 0.95, "exact": 0.92}
    return _gate("rotated", {"lines": tot, "found": found / tot,
                             "exact": exact / tot}, bar,
                 found / tot >= bar["found"] and exact / tot >= bar["exact"],
                 {"pages": [d[0] for d in drawn]})


def gate_try_flip(device="cuda", dtype="bfloat16", n_pages: int = 3) -> dict:
    """rec_try_flip set after construction, as the reference does."""
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.train import synth
    eng = OcrEngine.from_pretrained(device=device,
                                    config=asset_config(compute_dtype=dtype))
    eng.config = eng.config.replace(rec_try_flip=True)
    drawn = draw_pages(synth, eng.charset, 11, n_pages)
    tot = up = dn = 0
    for page, _, texts in drawn:
        img = _rgb(page)
        up += multiset_hits(texts, [l.text for l in eng.ocr(img).lines])
        dn += multiset_hits(texts, [l.text for l in
                                    eng.ocr(img[::-1, ::-1]).lines])
        tot += len(texts)
    bar = {"upright": 0.90, "upside_down": 0.85}
    return _gate("try_flip", {"lines": tot, "upright": up / tot,
                              "upside_down": dn / tot}, bar,
                 up / tot >= bar["upright"] and dn / tot >= bar["upside_down"],
                 {"pages": [d[0] for d in drawn]})


def gate_inverted(device="cuda", dtype="bfloat16", n_pages: int = 3) -> dict:
    from ocrjax_torch.train import synth
    eng = gate_engine(device, dtype)
    drawn = draw_pages(synth, eng.charset, 17, n_pages)
    tot = exact = 0
    for page, _, texts in drawn:
        res = eng.ocr(_rgb(255 - page))
        exact += multiset_hits(texts, [l.text for l in res.lines])
        tot += len(texts)
    bar = {"exact": 0.90}
    return _gate("inverted", {"lines": tot, "exact": exact / tot}, bar,
                 exact / tot >= bar["exact"],
                 {"pages": [255 - d[0] for d in drawn]})


def gate_degraded(device="cuda", dtype="bfloat16", n_pages: int = 4) -> dict:
    return _e2e_gate("degraded", device, dtype, n_pages, 321,
                     {"det_recall": 0.95, "line_exact_match": 0.88},
                     degrade_level=0.5)


def gate_dense_c5(device="cuda", dtype="bfloat16", size=(3072, 2048),
                  n_lines: int = 200) -> dict:
    from ocrjax_torch.scripts.probe_dense import match
    from ocrjax_torch.train import synth
    eng = gate_engine(device, dtype)
    page, quads, texts = draw_dense(synth, eng.charset, size, n_lines)
    res = eng.ocr_tiled(_rgb(page))
    found, exact = match(quads, texts, res.lines)
    n = len(texts)
    bar = {"rendered": 150, "truncated": False, "found": 0.95,
           "exact": 0.90}
    return _gate("dense_c5", {"rendered": n, "truncated": bool(res.truncated),
                              "found": found / n, "exact": exact / n}, bar,
                 n >= 150 and not res.truncated and found / n >= 0.95
                 and exact / n >= 0.90, {"pages": [page]})


def gate_tiled_batch(device="cuda", dtype="bfloat16", n_pages: int = 4,
                     size: int = 2048) -> dict:
    """ocr_tiled_batch against the serial ocr_tiled calls, both warmed;
    the host clock with the card synchronized before each reading."""
    from ocrjax_torch.scripts import clock
    from ocrjax_torch.train import synth
    eng = gate_engine(device, dtype)
    drawn = draw_pages(synth, eng.charset, 21, n_pages, size=(size, size),
                       n_lines=(10, 14), max_len=12)
    imgs = [_rgb(d[0]) for d in drawn]
    eng.ocr_tiled(imgs[0])
    eng.ocr_tiled_batch(imgs)
    t0 = clock(device)
    serial = [eng.ocr_tiled(im) for im in imgs]
    t_serial = clock(device) - t0
    t0 = clock(device)
    batch = eng.ocr_tiled_batch(imgs)
    t_batch = clock(device) - t0
    same = all([l.text for l in rs.lines] == [l.text for l in rb.lines]
               for rs, rb in zip(serial, batch))
    bar = {"same_strings": True, "batch_over_serial": GATE_BAR_BATCH_TIME}
    return _gate("tiled_batch", {
        "same_strings": same, "lines": [len(r.lines) for r in batch],
        "strings": [[l.text for l in r.lines] for r in batch],
        "serial_s": t_serial, "batch_s": t_batch,
        "batch_over_serial": t_batch / t_serial}, bar,
        same and t_batch <= t_serial * GATE_BAR_BATCH_TIME,
        {"pages": [d[0] for d in drawn]})


def gate_tiled_e2e(device="cuda", dtype="bfloat16", seeds=(42, 43, 44, 45),
                   size: int = 2048) -> dict:
    from ocrjax_torch.train import synth
    eng = gate_engine(device, dtype)
    per_seed, lines, truth, pages = [], [], [], []
    for seed in seeds:
        (page, _, texts), = draw_pages(synth, eng.charset, seed, 1,
                                       size=(size, size), n_lines=(12, 16),
                                       max_len=12)
        preds = [l.text for l in eng.ocr_tiled(_rgb(page)).lines]
        per_seed.append(multiset_hits(texts, preds) / len(texts))
        lines.append(len(preds))
        truth.append(len(texts))
        pages.append(page)
    mean = float(sum(per_seed) / len(per_seed))
    bar = {"lines_each": "truth - 1", "mean_exact": 0.88}
    return _gate("tiled_e2e", {"per_seed_exact": per_seed, "mean_exact": mean,
                               "lines": lines, "truth": truth}, bar,
                 all(n >= t - 1 for n, t in zip(lines, truth))
                 and mean >= 0.88, {"pages": pages})


def gate_short_strips(device="cuda", dtype="bfloat16", n_pages: int = 8
                      ) -> dict:
    import numpy as np
    from ocrjax_torch.scripts.eval_quality_breakdown import _align_subs
    from ocrjax_torch.scripts.eval_xheight import case_flip
    from ocrjax_torch.train import synth
    from ocrjax_torch.train.e2e_eval import _levenshtein
    eng = gate_engine(device, dtype)
    flat_frac = eng.config.rec_flat_band_frac
    stats, case_misses, pages = {}, 0, []
    for L, drawn in draw_short_strips(synth, eng.charset, n_pages).items():
        total = exact = 0
        for page, _, texts in drawn:
            preds = [ln.text for ln in eng.ocr(_rgb(page)).lines]
            total += len(texts)
            for t in texts:
                if t in preds:
                    preds.remove(t)
                    exact += 1
                elif preds:
                    d = [_levenshtein(t, p) for p in preds]
                    p = preds.pop(int(np.argmin(d)))
                    case_misses += any(
                        "∅" not in s and case_flip(*s)
                        for s in _align_subs(t, p))
            pages.append(page)
        stats[L] = (exact, total)
    bar = {"rec_flat_band_frac": "> 0", "len1": 0.62, "len2": 0.85,
           "case_misses": 4}
    len1, len2 = (stats[L][0] / stats[L][1] for L in (1, 2))
    return _gate("short_strips", {
        "rec_flat_band_frac": flat_frac, "len1": len1, "len2": len2,
        "counts": {str(L): list(v) for L, v in stats.items()},
        "case_misses": int(case_misses)}, bar,
        flat_frac > 0 and len1 >= 0.62 and len2 >= 0.85
        and case_misses <= 4, {"pages": pages})


def gate_projective(device="cuda", dtype="bfloat16", n_pages: int = 8
                    ) -> dict:
    return _e2e_gate("projective", device, dtype, n_pages, 555,
                     {"det_recall": 0.95, "line_exact_match": 0.90},
                     projective=0.3, curl=0.3)


GATE_FNS = {name: globals()[f"gate_{name}"] for name in GATE_LINES}
# the K1 path of each gate's grids: the lanes' 240x240 grids (the 960-side
# canvas pooled 4x) on the shared path; the C5 tile grids and the 256x256
# bitmaps of the extract_boxes and ccl gates (65,536 pixels, one past the
# shared path's limit) on the cluster path; None: the gate labels nothing
GATE_CCL_PATH = {"conv": None, "recognize": None, "extract_boxes": "cluster",
                 "ccl": "cluster", "dense_c5": "cluster",
                 "tiled_batch": "cluster", "tiled_e2e": "cluster"}


def save_gate_pages(name: str, pages: dict) -> str:
    """A missed gate's pages as an npz in the ignored ocrjax_torch/_build/;
    returns the path."""
    import numpy as np
    arrays = {f"{k}_{i}": np.asarray(p) for k, ps in pages.items()
              for i, p in enumerate(ps)}
    path = os.path.join(PKG, "_build", f"gate_pages_{name}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def phase_gates(counters) -> tuple:
    """Every gate of tests/test_tpu.py on OcrEngine.from_pretrained() on the
    card in bfloat16, each with its numbers beside its bar; returns (K1's
    launches by path per gate, K2's launches, the record)."""
    from ocrjax_torch.ops.cc_label import label_components_cuda
    from ocrjax_torch.ops.conv_fused import conv3x3_bn_relu_cuda
    ccl, record, missed = {}, {}, []
    conv_launches = 0
    t_phase = time.perf_counter()
    for name, fn in GATE_FNS.items():
        reset(counters)
        t0 = time.perf_counter()
        r = fn("cuda", "bfloat16")
        secs = time.perf_counter() - t0
        by_path = dict(label_components_cuda.launches_by_path)
        path = GATE_CCL_PATH.get(name, "shared")
        if path is None:
            if any(by_path.values()):
                fail(f"gate {name} labels nothing, yet cc_label launched "
                     f"{by_path}")
        else:
            ccl[f"19 {name}"] = only_path(f"19 {name}", path, by_path)
        if name == "conv":
            conv_launches = read(counters, "19 conv",
                                 ["conv3x3_bn_relu_cuda"])[
                                     "conv3x3_bn_relu_cuda"]
            if conv3x3_bn_relu_cuda.launches_by_path["wgmma"] != \
                    conv_launches:
                fail(f"gate conv: K2 took "
                     f"{conv3x3_bn_relu_cuda.launches_by_path}, not wgmma")
        shown = {k: v for k, v in r["numbers"].items() if k != "strings"}
        print(f"  gate {name} ({r['test']}): {json.dumps(shown)}; bar "
              f"{json.dumps(r['bar'])}: {'pass' if r['ok'] else 'MISSED'} "
              f"({secs:.1f} s; K1 {by_path})")
        if not r["ok"]:
            missed.append(name)
            print(f"    its pages: {save_gate_pages(name, r['pages'])}")
        record[name] = {"numbers": r["numbers"], "bar": r["bar"],
                        "ok": r["ok"], "s": secs}
    print(f"  phase 19: {time.perf_counter() - t_phase:.1f} s")
    if missed:
        fail(f"gates missed their bars: {missed}")
    return ccl, conv_launches, record


# ---------------------------------------------------------------------------
# 20. the reference's evaluation and bench scripts through the port's
# ---------------------------------------------------------------------------

SCRIPTS = ("eval_quality_breakdown", "eval_xheight", "eval_beam",
           "bench_int8_det", "bench_try_flip", "eval_tiled_quality",
           "probe_dense", "calibrate_unclip")
# what each run cuts, pages or seeds only: flag -> (the reference's
# default, this run's)
SCRIPT_CUTS = {
    "eval_quality_breakdown": {"--pages-per-font": (6, 2)},
    "eval_xheight": {"--pages": (12, 3)},
    "eval_beam": {"--seeds": (4, 1)},
    "bench_int8_det": {},
    "bench_try_flip": {"--pages": (48, 16)},
    "eval_tiled_quality": {"--seeds": (8, 4)},
    "probe_dense": {"--pages": (4, 2)},
    "calibrate_unclip": {"--pages": (6, 3)},
}
# the fields of each parsed output that are times (held to being there
# and finite, not to a value)
SCRIPT_TIMINGS = {
    "eval_beam": ("throughput.crops_per_sec_greedy",
                  "throughput.crops_per_sec_beam", "throughput.beam_cost_x"),
    "bench_int8_det": ("float_ms", "float_pages_per_s", "int8_ms",
                       "int8_pages_per_s", "speedup", "verdict"),
    "bench_try_flip": ("flip_off.pages_per_sec", "flip_off.windows",
                       "flip_on.pages_per_sec", "flip_on.windows",
                       "summary.overhead_frac", "summary.pair_ratios",
                       "summary.default_on_ok"),
    "probe_dense": ("warm_s", "result.pages_per_sec",
                    "result.lines_per_sec", "result.batch_s"),
}
INT8_AGREE_MIN = 0.9

# 21. the reference's diagnostic scripts; what each run cuts, pages and
# repeats only: flag -> (the reference's default, this run's)
DIAG_SCRIPTS = ("diag_dense", "diag_dense_stages", "diag_tile_det",
                "diag_rec_fetch", "diag_reroute")
DIAG_CUTS = {
    "diag_dense": {},
    "diag_dense_stages": {"--repeats": (2, 1)},
    "diag_tile_det": {},
    "diag_rec_fetch": {"--pages": (96, 32), "--repeats": (3, 1)},
    "diag_reroute": {},
}
# K1's path in each: the C5 tile grids, the 960 canvases' 240^2 grids
DIAG_CCL_PATH = {"diag_dense": "cluster", "diag_dense_stages": "cluster",
                 "diag_tile_det": "cluster", "diag_rec_fetch": "shared",
                 "diag_reroute": "shared"}
DIAG_PHASE_MAX_S = 60.0


def script_argv(name: str) -> list:
    cuts = DIAG_CUTS if name in DIAG_SCRIPTS else SCRIPT_CUTS
    return [a for flag, (_, v) in cuts[name].items() for a in (flag, str(v))]


def _lines_after(text: str, header: str) -> list:
    """The lines of `text` after the line `header` up to the next blank
    line."""
    lines = text.splitlines()
    if header not in lines:
        return []
    out = []
    for line in lines[lines.index(header) + 1:]:
        if not line.strip():
            break
        out.append(line)
    return out


def _json_lines(text: str) -> list:
    """(prefix, object) of each line that ends in a JSON object."""
    out = []
    for line in text.splitlines():
        i = line.find("{")
        if i >= 0 and line.rstrip().endswith("}"):
            try:
                out.append((line[:i].strip(), json.loads(line[i:])))
            except ValueError:
                pass
    return out


def _subs(lines) -> list:
    """[gt, pred, count] of the substitution histogram lines."""
    import re
    out = []
    for line in lines:
        m = re.match(r"^  (.+?)\s*→ (.+?)\s+×(\d+)$", line)
        if m:
            out.append([ast.literal_eval(m.group(1)),
                        ast.literal_eval(m.group(2)), int(m.group(3))])
    return out


def parse_script_output(name: str, text: str) -> dict:
    """The numbers a script printed, by what they are: the same parse for
    the reference's printout and the port's."""
    import re
    if name == "eval_quality_breakdown":
        fonts = {}
        for line in _lines_after(text, "== per-font line-exact =="):
            m = re.match(r"^  (\S+)\s+(\d+)/(\d+) = ([\d.]+)$", line)
            fonts[m.group(1)] = [int(m.group(2)), int(m.group(3)),
                                 float(m.group(4))]
        misses = [list(m.groups()) for m in re.finditer(
            r"^  \[(.+?)\] (.+) → (.+)$", text, re.M)]
        return {"per_font": fonts, "all": fonts.pop("ALL", None),
                "substitutions": _subs(_lines_after(
                    text, "== top substitutions (gt→pred, ∅=ins/del) ==")),
                "misses": misses}
    if name == "eval_xheight":
        per_len, total = {}, None
        for line in _lines_after(text, "== line-exact per glyph count =="):
            m = re.match(r"^  len (\d+): (\d+)/(\d+) = ([\d.]+)\s+"
                         r"case-flip misses: (\d+) \(([\d.]+)\)$", line)
            if m:
                per_len[m.group(1)] = [int(m.group(2)), int(m.group(3)),
                                       float(m.group(4)), int(m.group(5)),
                                       float(m.group(6))]
            m = re.match(r"^  ALL: (\d+)/(\d+) = ([\d.]+)\s+case-flip (\d+)$",
                         line)
            if m:
                total = [int(m.group(1)), int(m.group(2)),
                         float(m.group(3)), int(m.group(4))]
        frac = re.search(r"^rec_flat_band_frac: (\S+)$", text, re.M)
        return {"rec_flat_band_frac": float(frac.group(1)),
                "per_len": per_len, "all": total,
                "case_flip_subs": _subs(_lines_after(
                    text, "== case-flip substitutions =="))}
    if name == "eval_beam":
        objs = _json_lines(text)
        return {"throughput": objs[0][1],
                "tiers": {k: v for k, v in objs[1:]}}
    if name == "bench_int8_det":
        out = {}
        for line in text.splitlines():
            m = re.match(r"^(float \S+|int8)\s*: ([\d.]+) ms / \d+ pages "
                         r"\((\d+) pages/s det-forward\)$", line)
            if m:
                key = m.group(1).split()[0]
                out[f"{key}_ms"] = float(m.group(2))
                out[f"{key}_pages_per_s"] = float(m.group(3))
        m = re.search(r"^bitmap agreement @ det_thresh: ([\d.]+)$", text,
                      re.M)
        out["agreement"] = float(m.group(1))
        m = re.search(r"^mean \|prob diff\|: ([\d.]+)  max: ([\d.]+)$",
                      text, re.M)
        out["mean_abs_diff"] = float(m.group(1))
        out["max_abs_diff"] = float(m.group(2))
        m = re.search(r"^speedup: ([\d.]+)x → (\S+)", text, re.M)
        out["speedup"] = float(m.group(1))
        out["verdict"] = m.group(2)
        return out
    if name == "bench_try_flip":
        objs = [o for _, o in _json_lines(text)]
        return {"flip_off": objs[0], "flip_on": objs[1], "summary": objs[2]}
    if name == "eval_tiled_quality":
        return {"result": _json_lines(text)[-1][1],
                "misses": [[int(m.group(1)), ast.literal_eval(m.group(2))]
                           for m in re.finditer(
                               r"^  miss seed=(\d+) gt=(.+)$", text, re.M)]}
    if name == "probe_dense":
        pages = [{"gt": int(a), "det": int(b), "found": int(c),
                  "exact": int(d), "truncated": e == "True"}
                 for a, b, c, d, e in re.findall(
                     r"^page: gt=(\d+) det=(\d+) found=(\d+) exact=(\d+) "
                     r"truncated=(\w+)$", text, re.M)]
        warm = re.search(r"^warm batch: ([\d.]+)s, (\d+) lines, "
                         r"truncated=(\w+)$", text, re.M)
        return {"rendered": [int(v) for v in re.findall(
                    r"^rendered (\d+) lines$", text, re.M)],
                "warm_s": float(warm.group(1)),
                "warm_lines": int(warm.group(2)),
                "warm_truncated": warm.group(3) == "True",
                "pages": pages, "result": _json_lines(text)[-1][1]}
    if name == "calibrate_unclip":
        return {"ratios": {k.split("=")[1].rstrip(":"): v
                           for k, v in _json_lines(text)},
                "best": float(re.search(r"^best ratio: (\S+)$", text,
                                        re.M).group(1))}
    if name in DIAG_SCRIPTS:
        return _parse_diag(name, text)
    raise KeyError(name)


def _literal(s: str):
    return ast.literal_eval(s.strip())


def _parse_diag(name: str, text: str) -> dict:
    """parse_script_output of the diagnostic scripts. What a script prints
    a variable number of times (runs, pages, misses, stages) parses to a
    list, whose key_shape is a leaf, so the parse's keys do not depend on
    the cut or on the stage names (the port's table holds ocrjax's host
    stages and, nested in them, its own device stages)."""
    import re

    def num(pattern, cast=float, default=None):
        m = re.search(pattern, text, re.M)
        return cast(m.group(1)) if m else default
    if name == "diag_dense":
        found = re.search(r"^found (\d+)/(\d+) = [\d.]+   exact (\d+)/\d+",
                          text, re.M)
        pred = re.search(r"^pred lines: (\d+) truncated=(\w+)$", text, re.M)
        seam = re.search(r"^  seam_dist: median (\S+), <(\d+)px: (\d+)/(\d+)$",
                         text, re.M)
        gt_h = re.search(r"^  miss h: median (\S+) \(all-gt median (\S+)\)$",
                         text, re.M)
        y_range = re.search(r"^  miss y range: (\S+)\.\.(\S+) \(page H=",
                            text, re.M)
        return {
            "gt_lines": num(r"^gt lines: (\d+)$", int),
            "pred_lines": int(pred.group(1)),
            "truncated": pred.group(2) == "True",
            "found": int(found.group(1)), "n": int(found.group(2)),
            "exact": int(found.group(3)),
            "n_misses": num(r"^-- MISSES \(no box near gt center\): (\d+)$",
                            int),
            "misses": [[float(a), float(b), float(c), float(d), float(e),
                        _literal(t)] for a, b, c, d, e, t in re.findall(
                r"^  y=\s*(\S+) x=\s*(\S+) h=\s*(\S+) w=\s*(\S+) "
                r"seam_d=\s*(\S+) t=(.+)$", text, re.M)],
            # printed only where there are misses: None otherwise
            "miss_summary": {
                "seam_median": float(seam.group(1)) if seam else None,
                "seam_within": [int(seam.group(3)), int(seam.group(4))]
                if seam else None,
                "h_median": float(gt_h.group(1)) if gt_h else None,
                "gt_h_median": float(gt_h.group(2)) if gt_h else None,
                "w_median": num(r"^  miss w: median (\S+)$"),
                "x_median": num(r"^  miss x: median (\S+)  \(page W="),
                "y_range": [float(y_range.group(1)), float(y_range.group(2))]
                if y_range else None},
            "n_wrong": num(r"^-- WRONG TEXT \(box found\): (\d+)$", int),
            "wrong": [[float(y), float(h), _literal(gt), _literal(pr)]
                      for y, h, gt, pr in re.findall(
                r"^  y=\s*(\S+) h=\s*(\S+) gt=('(?:[^'\\]|\\.)*'|"
                r"\"(?:[^\"\\]|\\.)*\") pred=(.+)$", text, re.M)]}
    if name == "diag_dense_stages":
        runs = []
        for block in re.split(r"\n(?=run \d+: )", text)[1:]:
            head = re.match(r"^run (\d+): (\S+) ms total = (\S+) pages/s, "
                            r"(\S+) lines/s \((\d+) lines\)$",
                            block.splitlines()[0])
            total = re.search(r"^  \(sum of stages\)\s+(\S+) ms  "
                              r"\(unattributed (\S+) ms\)$", block, re.M)
            body = block.split("\n\n")[0]
            host, _, dev = body.partition("  device ms (CUDA events):")
            runs.append({
                "ms": float(head.group(2)),
                "pages_per_sec": float(head.group(3)),
                "lines_per_sec": float(head.group(4)),
                "lines": int(head.group(5)),
                "stages": [[k, float(ms), int(n)] for k, ms, n in re.findall(
                    r"^  (\S+)\s+(\S+) ms  x(\d+)(?:  \S+ MB)?$", host,
                    re.M)],
                "sum_ms": float(total.group(1)),
                "unattributed_ms": float(total.group(2)),
                # the port's device ms per stage; ocrjax prints none
                "device_ms": (dev.strip() if dev.strip() == "not measured"
                              else [[k, float(ms)] for k, ms in re.findall(
                                  r"^  (\S+)\s+(\S+) ms$", dev, re.M)])})
        res = re.search(r"^resident det fwd \((.+) tiles/page\): (\S+) "
                        r"ms/page$", text, re.M)
        return {"gt_lines": [int(v) for v in re.findall(
                    r"^page \d+: (\d+) gt lines$", text, re.M)],
                "tile_cap": num(r"^window tile cap: (\d+)$", int),
                "warm_s": num(r"^warm \(compile\) run: (\S+)s$"),
                "runs": runs,
                "resident": {"tiles": [list(t) for t in _literal(
                    res.group(1))], "ms_per_page": float(res.group(2))}}
    if name == "diag_tile_det":
        return {hs: {"prob_ms": float(a), "full_ms": float(b),
                     "boxes_ms": float(c), "tiles": int(n)}
                for hs, a, b, c, n in re.findall(
                    r"^head_stride=(\d+): prob\s+(\S+) ms  prob\+boxes\s+"
                    r"(\S+) ms  \(boxes\s+(\S+) ms\)  \[(\d+) tiles\]$",
                    text, re.M)}
    if name == "diag_rec_fetch":
        head = re.search(r"^pages=(\d+) pooled_lines=(\d+)$", text, re.M)
        return {"pages": int(head.group(1)),
                "pooled_lines": int(head.group(2)),
                "runs": [{"dispatch_ms": float(a),
                          "device_compute_ms": float(b),
                          "fetch_ms": float(c), "payload_kb": float(d),
                          "host_decode_ms": float(e), "n_chunks": int(f)}
                         for a, b, c, d, e, f in re.findall(
                    r"^run\d+: dispatch=(\S+)ms device_compute=(\S+)ms "
                    r"fetch=(\S+)ms payload=(\S+)KB host_decode=(\S+)ms "
                    r"n_chunks=(\d+)$", text, re.M)]}
    if name == "diag_reroute":
        head = re.search(r"^det=(\S+)  pages=(\d+)  reroutes=(\d+)$", text,
                         re.M)
        return {"det": head.group(1), "pages": int(head.group(2)),
                "reroutes": int(head.group(3)),
                "decisions": [{"page": int(i), "reroute": flag == "REROUTE",
                               "boxes": int(b), "max_gated_tilt": float(t),
                               "thresh": float(th),
                               "offender_aspect": float(a),
                               "med_tilt90": float(m)}
                              for i, flag, b, t, th, a, m in re.findall(
                    r"^  page\s+(\d+) (REROUTE|       ) boxes=\s*(\d+) "
                    r"max_gated_tilt=\s*(\S+) \(thresh (\S+)\) "
                    r"offender_aspect=\s*(\S+) med_tilt90=\s*(\S+)$",
                    text, re.M)]}
    raise KeyError(name)


def drop_timings(name: str, parsed: dict) -> dict:
    """parsed without the fields that are times."""
    out = json.loads(json.dumps(parsed))
    for path in SCRIPT_TIMINGS.get(name, ()):
        *head, leaf = path.split(".")
        d = out
        for k in head:
            d = d[k]
        del d[leaf]
    return out


def key_shape(x):
    """The nested dicts' keys of a parsed output (lists are leaves)."""
    if isinstance(x, dict):
        return {k: key_shape(v) for k, v in x.items()}
    return None


def all_finite(x) -> bool:
    import math
    if isinstance(x, dict):
        return all(all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(all_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


def run_port_script(name: str, argv: list) -> tuple:
    """The port's script `name` through its main(argv); (its printout,
    the parse of it)."""
    import importlib
    import io
    main = importlib.import_module(f"ocrjax_torch.scripts.{name}").main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    text = buf.getvalue()
    return text, parse_script_output(name, text)


def phase_scripts(counters) -> tuple:
    """The eight scripts through their main() on the card in bfloat16 at
    SCRIPT_CUTS; each output's keys as the reference's printout's
    (expected_jax_scripts_fp32.json) and every number finite;
    bench_int8_det through db_int8's _int_mm route with its bitmap
    agreement at least INT8_AGREE_MIN. Returns (K1's launches by path per
    script, the record)."""
    from ocrjax_torch.models import db_int8
    from ocrjax_torch.ops.cc_label import label_components_cuda
    want = load_json("expected_jax_scripts_fp32.json")
    ccl, record = {}, {}
    t_phase = time.perf_counter()
    for name in SCRIPTS:
        routes = collections.Counter()

        def counted(fn, key):
            def wrap(*a, **k):
                routes[key] += 1
                return fn(*a, **k)
            return wrap
        reset(counters)
        t0 = time.perf_counter()
        with patched(db_int8, "int8_conv_int_mm",
                     counted(db_int8.int8_conv_int_mm, "_int_mm")), \
                patched(db_int8, "int8_conv_plain",
                        counted(db_int8.int8_conv_plain, "plain")):
            text, got = run_port_script(name, script_argv(name))
        secs = time.perf_counter() - t0
        by_path = dict(label_components_cuda.launches_by_path)
        print(f"  -- {name} {' '.join(script_argv(name))} ({secs:.1f} s; "
              f"K1 {by_path})")
        print("\n".join("    " + line for line in text.splitlines()))
        if key_shape(got) != key_shape(want[name]["parsed"]):
            fail(f"{name}: its output's keys {key_shape(got)} are not the "
                 f"reference's {key_shape(want[name]['parsed'])}")
        if not all_finite(got):
            fail(f"{name}: a number of its output is not finite: {got}")
        if name == "bench_int8_det":
            if not routes["_int_mm"] or routes["plain"]:
                fail(f"bench_int8_det: the int8 convolutions took {routes}, "
                     f"not only _int_mm")
            if not got["agreement"] >= INT8_AGREE_MIN:
                fail(f"bench_int8_det: bitmap agreement {got['agreement']} "
                     f"under {INT8_AGREE_MIN}")
            if any(by_path.values()):
                fail(f"bench_int8_det labels nothing, yet cc_label launched "
                     f"{by_path}")
        else:
            path = ("cluster" if name in ("eval_tiled_quality", "probe_dense")
                    else "shared")
            ccl[f"20 {name}"] = only_path(f"20 {name}", path, by_path)
        record[name] = {"argv": script_argv(name), "s": secs,
                        "parsed": got, "int8_routes": dict(routes)}
    print(f"  phase 20: {time.perf_counter() - t_phase:.1f} s")
    return ccl, record


def phase_diag(counters) -> tuple:
    """The five diagnostic scripts through their main() on the card in
    bfloat16 at DIAG_CUTS; each output's keys as the reference's printout's
    (expected_jax_diag_fp32.json), every number finite, K1 on
    DIAG_CCL_PATH's path in each, and the phase within DIAG_PHASE_MAX_S.
    Returns (K1's launches by path per script, the record)."""
    from ocrjax_torch.ops.cc_label import label_components_cuda
    want = load_json("expected_jax_diag_fp32.json")
    ccl, record = {}, {}
    t_phase = time.perf_counter()
    for name in DIAG_SCRIPTS:
        reset(counters)
        t0 = time.perf_counter()
        text, got = run_port_script(name, script_argv(name))
        secs = time.perf_counter() - t0
        by_path = dict(label_components_cuda.launches_by_path)
        print(f"  -- {name} {' '.join(script_argv(name))} ({secs:.1f} s; "
              f"K1 {by_path})")
        print("\n".join("    " + line for line in text.splitlines()))
        if key_shape(got) != key_shape(want[name]["parsed"]):
            fail(f"{name}: its output's keys {key_shape(got)} are not the "
                 f"reference's {key_shape(want[name]['parsed'])}")
        if not all_finite(got):
            fail(f"{name}: a number of its output is not finite: {got}")
        ccl[f"21 {name}"] = only_path(f"21 {name}", DIAG_CCL_PATH[name],
                                      by_path)
        record[name] = {"argv": script_argv(name), "s": secs, "parsed": got}
    secs = time.perf_counter() - t_phase
    print(f"  phase 21: {secs:.1f} s")
    if secs > DIAG_PHASE_MAX_S:
        fail(f"phase 21 took {secs:.1f} s, past {DIAG_PHASE_MAX_S} s")
    return ccl, record


# ---------------------------------------------------------------------------
# 22. transport: packed payloads, truncated first fetches, the async copy
# ---------------------------------------------------------------------------

# the settings of phase 22, the first the shipped one
TRANSPORT_SETTINGS = (
    ("bytes, 48 tokens", dict(fetch_bytes=True, fetch_max_tokens=48)),
    ("bytes, whole", dict(fetch_bytes=True, fetch_max_tokens=0)),
    ("float32, 48 tokens", dict(fetch_bytes=False, fetch_max_tokens=48)),
    ("float32, whole", dict(fetch_bytes=False, fetch_max_tokens=0)),
    ("forced refetch", dict(fetch_max_tokens=2, det_fetch_candidates=1)))
TRANSPORT_CHUNK = 4             # pages a fused chunk in 22 (a)
# ocrjax's host stages (its StageTimer names)
HOST_STAGES = ("host_decode", "fused_dispatch", "fused_fetch", "det_dispatch",
               "det_fetch", "cls_margins", "rec_dispatch", "rec_fetch_decode",
               "warp_norm", "tile_det_dispatch", "tile_assign",
               "tile_host_fallback", "tile_assembly")
TRANSPORT_SLEEP_CYCLES = 200_000_000     # the device queue of 22 (d)


def _exact_lines(res) -> list:
    """Every number of a lane's results, as bits: strings, boxes, scores,
    confidences, truncation."""
    import numpy as np
    return [(r.truncated, [(line.text, np.asarray(line.box.quad,
                                                   np.float32).tobytes(),
                            float(line.box.score), float(line.confidence))
                           for line in r.lines]) for r in res]


def _exact_boxes(boxes) -> list:
    import numpy as np
    return [(np.asarray(b.quad, np.float32).tobytes(), float(b.score))
            for b in boxes]


def _fused_row_bytes(cfg, K: int, T: int) -> int:
    """Bytes of one fused payload row (ocrjax/fused.py:176-202 as coded):
    K * (T + 42) as bytes, 4 * K * (T + 12) as float32, one more K
    columns under rec_try_flip."""
    flip = 1 if cfg.rec_try_flip else 0
    return K * (T + 42 + flip) if cfg.fetch_bytes \
        else 4 * K * (T + 12 + flip)


def _long_line_page(charset):
    """A 320 x 1100 page whose one line is longer than a 512-pixel tile
    holds: tiled at 512 it goes to the host fallback."""
    import numpy as np
    from ocrjax_torch.train import synth
    text = "".join(c for c in "Transport host fallback 0123456789 ABCDEFGH"
                   if c == " " or c in charset.chars)
    strip = synth.render_line(text, 48)[:, :1000]
    page = np.full((320, 1100), 255, np.uint8)
    page[140:140 + strip.shape[0], 50:50 + strip.shape[1]] = strip
    return np.repeat(page[..., None], 3, axis=2)


def phase_transport(counters, smi: str, bench: dict, parallel: dict) -> tuple:
    """Phase 22 (see the module docstring). Returns (K1's launches by path
    per part, the record)."""
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.ops import bytepack
    from ocrjax_torch.utils.profiling import StageTimer
    t_phase = time.perf_counter()
    ccl, record, seen = {}, {"card": smi}, set()
    pages, expected = load_fixture()
    eng = OcrEngine.from_pretrained(config=asset_config(
        compute_dtype="float32", fused_chunk_pages=TRANSPORT_CHUNK))
    base = eng.config
    K, T = base.fused_lines_per_page, base.rec_max_tokens
    n_chunks = -(-len(pages) // TRANSPORT_CHUNK)
    # chunks with a line past 48 tokens in the reference's float32 run
    long_chunks = sum(
        any(len(s) > 48 for e in expected[lo:lo + TRANSPORT_CHUNK]
            for s in e["strings"])
        for lo in range(0, len(pages), TRANSPORT_CHUNK))

    def run(tag, fn):
        """fn under a StageTimer with fresh refetch counts -> (its
        result, the timer, the refetches by stage)."""
        bytepack.refetches.clear()
        timer = StageTimer()
        with timer.active():
            out = fn()
        seen.update(timer.host)
        return out, timer, dict(bytepack.refetches)

    # (a) the fused lane under every setting
    print(f"  (a) fused lane, {len(pages)} pages at 960, float32, chunks of "
          f"{TRANSPORT_CHUNK} ({smi})")
    fused_ref, rows = None, {}
    reset(counters)
    for tag, over in TRANSPORT_SETTINGS:
        eng.config = base.replace(**over)
        res, timer, again = run(tag, lambda: eng.ocr_batch(pages,
                                                          fused=True))
        worst = check_against(res, expected, f"22 (a) {tag} page")
        exact = _exact_lines(res)
        if fused_ref is None:
            fused_ref = exact
        elif exact != fused_ref:
            fail(f"22 (a) {tag}: results differ from "
                 f"{TRANSPORT_SETTINGS[0][0]}'s")
        cfg = eng.config
        t_f = cfg.fetch_max_tokens if 0 < cfg.fetch_max_tokens < T else T
        n_re = again.get("fused_fetch", 0)
        want_re = {"forced refetch": n_chunks}.get(
            tag, long_chunks if t_f == 48 else 0)
        got_b = timer.bytes["fused_fetch"]
        want_b = (len(pages) * _fused_row_bytes(cfg, K, t_f)
                  + n_re * TRANSPORT_CHUNK * _fused_row_bytes(cfg, K, T))
        rows[tag] = {"refetches": n_re, "bytes": got_b,
                     "bytes_per_chunk": got_b / n_chunks,
                     "formula_bytes": want_b, "worst_box_px": worst}
        print(f"    {tag}: refetched {n_re} of {n_chunks} chunks "
              f"(due {want_re}); fused_fetch copied {got_b} bytes, "
              f"{got_b / n_chunks:.0f} a chunk (formula {want_b}); worst "
              f"box {worst:.5f} px against JAX float32")
        if n_re != want_re:
            fail(f"22 (a) {tag}: {n_re} chunks refetched, {want_re} due")
        if got_b != want_b:
            fail(f"22 (a) {tag}: {got_b} bytes fetched, the formula says "
                 f"{want_b}")
    ccl["22 fused"] = only_path("22 (a) fused lane", "shared")
    record["fused"] = rows
    print(f"  (a) {len(TRANSPORT_SETTINGS)} settings bit-identical, each "
          f"at the goldens bar")

    # (b) the pooled lane, detect, ocr and ocr_tiled on the A4 pages
    c5, _ = load_c5_fixture()
    a4 = [c5["dense"], c5["sparse"]]
    print(f"  (b) pooled lane, detect, ocr, ocr_tiled on the A4 pages, "
          f"float32 ({smi})")
    lane_ref = tiled_ref = None
    rows = {}
    for tag, over in TRANSPORT_SETTINGS:
        eng.config = base.replace(**over)
        reset(counters)
        pooled, timer, again = run(tag, lambda: eng.ocr_batch(a4,
                                                             fused=False))
        # detect and ocr (on the sparse page: the dense one's lines are
        # too small to detect on the 960 canvas) fetch outside any timer's
        # bytes, as ocrjax's do
        (det, single), _, d_again = run(tag, lambda: (
            eng.detect(a4[1]), eng.ocr(a4[1])))
        ccl[f"22 lanes {tag}"] = only_path(f"22 (b) {tag}", "shared")
        exact = (_exact_lines(pooled), _exact_boxes(det),
                 _exact_lines([single]))
        eng._det_fetch_adapt = {}
        states, tiled = [], []
        reset(counters)
        for page in a4:
            r, t_timer, t_again = run(tag, lambda: eng.ocr_tiled(page))
            tiled.append(r)
            states.append(eng._det_fetch_adapt.get("full"))
            for k, v in t_again.items():
                again[f"tiled {k}"] = again.get(f"tiled {k}", 0) + v
            for k, v in t_timer.bytes.items():
                timer.bytes[f"tiled {k}"] += v
        ccl[f"22 tiled {tag}"] = only_path(f"22 (b) {tag} tiled", "cluster")
        if lane_ref is None:
            lane_ref, tiled_ref = exact, _exact_lines(tiled)
        elif exact != lane_ref or _exact_lines(tiled) != tiled_ref:
            fail(f"22 (b) {tag}: results differ from "
                 f"{TRANSPORT_SETTINGS[0][0]}'s")
        for k, v in d_again.items():
            again[f"detect, ocr {k}"] = v
        rows[tag] = {"refetches": again, "bytes": dict(timer.bytes),
                     "latch": states}
        cfg = eng.config
        C, Kf = cfg.det_max_candidates, cfg.det_fetch_candidates
        n_det = again.get("det_fetch", 0)
        want_b = (len(a4) * 4 * ((Kf * 10 + 1) if 0 < Kf < C else C * 10)
                  + n_det * len(a4) * 4 * C * 10)
        print(f"    {tag}: lines {[len(r.lines) for r in pooled]} pooled, "
              f"{len(det)} detected, {len(single.lines)} by ocr(), "
              f"{[len(r.lines) for r in tiled]} tiled; refetches {again}; "
              f"bytes {dict(timer.bytes)} (det_fetch formula {want_b}); "
              f"tiled latch after dense, sparse: {states}")
        if timer.bytes["det_fetch"] != want_b:
            fail(f"22 (b) {tag}: det_fetch copied "
                 f"{timer.bytes['det_fetch']} bytes, the formula says "
                 f"{want_b}")
        if cfg.det_fetch_candidates == base.det_fetch_candidates \
                and states != [True, False]:
            fail(f"22 (b) {tag}: the tiled latch read {states} after the "
                 f"dense and the sparse page, not [True, False]")
    record["lanes"] = rows

    # the two host stages the A4 pages do not open: cls_margins (the
    # pooled lane under try-flip) and tile_host_fallback (a line longer
    # than a tile)
    flip_pages, _ = load_flip_fixture()
    eng.config = base.replace(rec_try_flip=True)
    reset(counters)
    _, timer, again = run("try-flip", lambda: eng.ocr_batch(
        flip_pages, fused=False))
    ccl["22 try-flip"] = only_path("22 try-flip pooled lane", "shared")
    rec_b = timer.bytes["rec_fetch_decode"]
    eng.config = base.replace(tile_size=512, tile_overlap=64)
    long = _long_line_page(eng.charset)
    reset(counters)
    fallback, _, _ = run("fallback", lambda: eng.ocr_tiled(long))
    # 512-pixel tiles label 128 x 128 grids: the shared path
    ccl["22 fallback"] = only_path("22 tiled at 512", "shared")
    print(f"    try-flip pooled lane on the flip pages: rec_fetch_decode "
          f"{rec_b} bytes, refetches {again}; tiled page with a "
          f"{long.shape[1] - 100}-pixel line at 512-pixel tiles: "
          f"{[line.text for line in fallback.lines]}")
    eng.config = base

    # (d) the async copy, behind a long device queue
    record["async_copy"], ccl["22 async copy"] = transport_async_copy(
        counters, eng, pages[:4], smi)

    # (e) the bench's windows by host stage (phase 13's report)
    print(f"  (e) the bench's last windows (phase 13, bf16), host ms / calls"
          f" / MB and device ms by stage ({smi}); link_probe "
          f"{bench['link_probe']}")
    for lane in ("fused", "bucketed"):
        rep = bench["stages_last_window"][lane]
        seen.update(rep["host_ms"])
        # host steps and call spans have no device ms
        dev = rep["device_ms"]
        rows = {k: [v["total_ms"], v["calls"], v.get("mb"),
                    round(dev[k], 3) if isinstance(dev.get(k), float)
                    else dev.get(k)]
                for k, v in sorted(rep["host_ms"].items(),
                                   key=lambda kv: -kv[1]["total_ms"])}
        print(f"    {lane}: " + json.dumps(rows))
    for w in bench["windows_detail"]:
        print(f"    window {w['path']}: {w['pages_per_sec']:.2f} pages/s, "
              f"probe rtt {w['probe_rtt_ms']} ms, up {w['probe_up_mb_s']} "
              f"MB/s, fetch {w['fetch_ms']} ms / {w['fetch_mb']} MB")
        if w["fetch_ms"] is None or w["fetch_mb"] is None:
            fail(f"22 (e): a bench window has no fetch fields: {w}")
    record["bench_link_probe"] = bench["link_probe"]

    # (f) phase 16's sharded fused program
    fp = parallel["fused_payload"]
    print(f"  (f) sharded fused program (phase 16): {fp['gathers']} "
          f"all_gather a call for the {fp['dtype']} {fp['shape']} payload, "
          f"bytes equal to the unsharded program's {fp['equal_bytes']}, "
          f"worst box {parallel['fused_worst_box_px']:.5f} px ({smi})")
    record["sharded"] = fp
    missing = [s for s in HOST_STAGES if s not in seen]
    if missing:
        fail(f"22: ocrjax's host stages {missing} never opened")
    secs = time.perf_counter() - t_phase
    record["s"] = secs
    print(f"  all 13 of ocrjax's host stages opened; phase 22: {secs:.1f} s "
          f"({smi})")
    with open(os.path.join(PKG, "_build", "transport.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return ccl, record


def transport_async_copy(counters, eng, pages, smi: str) -> tuple:
    """22 (d): a pinned non-blocking copy issued behind a long device queue
    (a device sleep, then a matmul) is still pending when HostCopy
    returns, and equals a blocking .cpu() once its event is waited on; a
    fused payload's copy too. Returns (the record, K1's launches by path
    in the fused call)."""
    import numpy as np
    import torch
    from ocrjax_torch import fused as F
    from ocrjax_torch.ops import bytepack
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(TRANSPORT_SLEEP_CYCLES)
    y = (x @ x)[:, :64] + 1.0
    t0 = time.perf_counter()
    cp = bytepack.HostCopy(y)
    issue_ms = (time.perf_counter() - t0) * 1e3
    pending = not cp.event.query()
    t0 = time.perf_counter()
    got = cp.result()
    wait_ms = (time.perf_counter() - t0) * 1e3
    want = y.cpu().numpy()
    packed, thr, wh = _fused_inputs(eng, pages)
    reset(counters)
    payload = F.FusedOcr(eng, eng.config.fused_lines_per_page, 320)(
        torch.from_numpy(packed).cuda(), tuple(float(v) for v in thr),
        torch.from_numpy(wh).cuda())
    by_path = only_path("22 (d) fused payload", "shared")
    p_copy = bytepack.HostCopy(payload)
    same_payload = bool(np.array_equal(p_copy.result(),
                                       payload.cpu().numpy()))
    rec = {"pinned": cp.buf.is_pinned() and p_copy.buf.is_pinned(),
           "pending": pending, "issue_ms": issue_ms, "wait_ms": wait_ms,
           "equal": bool(np.array_equal(got, want)),
           "fused_payload_equal": same_payload}
    print(f"  (d) pinned non-blocking copy behind a {TRANSPORT_SLEEP_CYCLES}"
          f"-cycle device sleep: pinned {rec['pinned']}, still pending when"
          f" issued {pending}, issued in {issue_ms:.3f} ms, read after its "
          f"event in {wait_ms:.1f} ms (host clock), equal to .cpu() "
          f"{rec['equal']}; a fused payload's copy equal {same_payload} "
          f"({smi})")
    if not (rec["pinned"] and pending and rec["equal"] and same_payload):
        fail(f"22 (d): the async copy {rec}")
    return rec, by_path


GRAPH_CHUNK = 4                 # pages a fused chunk in 23 (b), (c)
GRAPH_PHASE_MAX_S = 60.0
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def _launch_counts(fn) -> dict:
    """torch.profiler over fn(): the device's kernels, copies and sets,
    and the host's launch calls by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device, host = 0, collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device += 1
        elif e.name in LAUNCH_CALLS:
            host[e.name] += 1
    return {"device_ops": device, "host_launch_calls": sum(host.values()),
            "by_call": dict(host)}


def _program(eng, name: str):
    from ocrjax_torch import graphs
    return next(p for p in graphs.all_programs(eng) if p.name == name)


def phase_graphs(counters, smi: str) -> tuple:
    """Phase 23 (see the module docstring). Returns (K1's launches by path
    per part, the record)."""
    import numpy as np
    import torch
    from ocrjax_torch import api_det, graphs
    from ocrjax_torch import fused as F
    from ocrjax_torch.api import OcrEngine, asset_config
    from ocrjax_torch.ops import bytepack
    from ocrjax_torch.ops.cc_label import label_components_cuda as K1
    from ocrjax_torch.utils.profiling import StageTimer
    t_phase = time.perf_counter()
    pages, _ = load_fixture()
    batch, strips, named, _ = load_lane_fixture()
    c5, c5_want = load_c5_fixture()
    c5_batch = [c5[k] for k in c5_want["batch"]]
    flip_pages, _ = load_flip_fixture()
    curl_pages, _, _ = load_curl_fixture()
    # bf16, the shipped dtype, apart from the float32 fused lane
    cfg16 = asset_config(fused_chunk_pages=GRAPH_CHUNK)
    caps = collections.defaultdict(list)

    def note_captures(e):
        for p in graphs.all_programs(e):
            caps[p.name] += [s["capture_ms"] for s in p.stats().values()]

    failures, record = [], {"card": smi}
    ccl = {"graphed": {p: 0 for p in K1.launches_by_path}}

    def k1(fn):
        before = dict(K1.launches_by_path)
        out = fn()
        return out, {p: v - before[p] for p, v in K1.launches_by_path.items()}

    def exact(tag, fn):
        """(a) and (b): fn's results op by op (graphs.eager) under the
        sync check, at its first graphed call (the capture) and at a
        replay under the sync check, bit for bit; K1's launches the same
        on the three runs."""
        try:
            with graphs.eager(), graphs.sync_checked():
                want, n0 = k1(fn)
            got1, n1 = k1(fn)
            with graphs.sync_checked():
                got2, n2 = k1(fn)
        except RuntimeError as e:             # a sync or a failed capture
            failures.append(f"{tag}: {type(e).__name__}: {e}")
            print(f"    {tag}: RAISED {type(e).__name__}: {e}")
            return None
        ok = want == got1 == got2
        if not ok:
            failures.append(f"{tag}: graphed results differ from eager "
                            f"(first call {want == got1}, replay "
                            f"{want == got2})")
        if not n0 == n1 == n2:
            failures.append(f"{tag}: K1 launches eager {n0}, first call "
                            f"{n1}, replay {n2}")
        for p, v in n2.items():
            ccl["graphed"][p] += v
        print(f"    {tag}: bit-identical {ok}; K1 launches eager "
              f"{sum(n0.values())}, replay {sum(n2.values())}")
        return want

    lines = _exact_lines

    # (a) + (b), lanes grouped by engine; each engine is dropped after its
    # lanes (its graphs' pool goes with it)
    print(f"  (a)+(b) every lane, bf16 (the 18 pages in fp32 too): eager "
          f"under the sync check, its first graphed call, a replay under "
          f"the sync check ({smi})")
    pages18 = pages + pages[:2]          # four chunks of 4 and one of 2

    def lanes16(e):
        return [
            ("fused, 18 pages", lambda: lines(e.ocr_batch(
                pages18, fused=True))),
            ("fused, mixed batch", lambda: lines(e.ocr_batch(batch,
                                                            fused=True))),
            ("bucketed, mixed batch", lambda: lines(e.ocr_batch(batch))),
            ("staged ocr(tilted)", lambda: lines([api_det.ocr(
                e, named["tilted"], force_staged=True)])),
            ("full-resolution batch", lambda: lines(
                api_det.ocr_fullres_batch(e, [named["big"],
                                              named["bigtilt"]]))),
            ("detect", lambda: [_exact_boxes(e.detect(named[k]))
                                for k in ("tilted", "big")]),
            ("pooled strips", lambda: [(r.text, r.confidence, r.flipped)
                                       for r in e.recognize_strips(strips)]),
            ("beam, fused", lambda: lines(e.ocr_batch(
                pages[:4], fused=True, beam=True))),
            ("beam, bucketed", lambda: lines(e.ocr_batch(batch, beam=True))),
            ("grouped warp, fused", lambda: lines(F.ocr_pages_fused(
                e, pages[:4], separable_warp=False))),
        ]

    def lanes_c5(e):
        return [
            ("ocr_tiled_batch (C5)", lambda: lines(e.ocr_tiled_batch(
                c5_batch))),
            ("detect_tiled (C5)", lambda: _exact_boxes(
                e.detect_tiled(c5["dense"]))),
            ("ocr_tiled (C5)", lambda: lines([e.ocr_tiled(c5["sparse"])])),
        ]

    def fused_bucketed(name, pgs):
        def make(e):
            return [(f"{name}, fused", lambda: lines(e.ocr_batch(
                        pgs, fused=True))),
                    (f"{name}, bucketed", lambda: lines(e.ocr_batch(pgs)))]
        return make

    def lanes_flip(e):
        return fused_bucketed("try-flip", flip_pages)(e) + [
            ("try-flip, staged", lambda: lines([api_det.ocr(
                e, p, force_staged=True) for p in flip_pages]))]

    groups = [
        ({}, lanes16),
        ({"compute_dtype": "float32"}, lambda e: [
            ("fused fp32, 18 pages", lambda: lines(e.ocr_batch(
                pages18, fused=True)))]),
        ({}, lanes_c5),
        ({"rec_try_flip": True}, lanes_flip),
        ({"det_int8": True}, fused_bucketed("det_int8", batch)),
        ({"rec_dewarp_curl": True}, fused_bucketed("dewarp_curl",
                                                   curl_pages)),
        ({"rec_flat_case_gate": True}, fused_bucketed("case gate", batch)),
    ]
    reset(counters)
    n_lanes = 0
    for over, make in groups:
        e = OcrEngine.from_pretrained(config=cfg16.replace(**over))
        for tag, fn in make(e):
            exact(tag, fn)
            n_lanes += 1
        note_captures(e)
        del e
        gc.collect()
    record["lanes"] = n_lanes
    record["launches_lanes"] = read(counters, "23 lanes",
                                    ["label_components_cuda"])

    # (c) the traps
    print("  (c) a threshold sweep, a forced refetch, K1's counters")
    ec = OcrEngine.from_pretrained(config=cfg16)
    fused_c = F._fused_for(ec, ec.config.fused_lines_per_page,
                           ec.config.rec_bucket_for_width(
                               10 * ec.config.rec_height), False)
    base = ec.config
    ec.ocr_batch(pages, fused=True)             # the captures
    keys0 = set(fused_c.program.stats())
    replays0 = sum(s["replays"] for s in fused_c.program.stats().values())
    for ratio in (1.5, 2.0, 0.0):
        ec.config = base.replace(det_unclip_ratio=ratio)
        exact(f"det_unclip_ratio {ratio}, fused",
              lambda: lines(ec.ocr_batch(pages, fused=True)))
    ec.config = base
    st = fused_c.program.stats()
    sweep_replays = sum(s["replays"] for s in st.values()) - replays0
    if set(st) != keys0 or sweep_replays != 3 * 2 * len(pages) // GRAPH_CHUNK:
        failures.append(f"23 (c) sweep: keys {len(keys0)} -> {len(st)}, "
                        f"{sweep_replays} replays")
    print(f"    the sweep replayed the fused program {sweep_replays} times "
          f"on {len(st)} keys, none new")
    note_captures(ec)           # a config change drops the engine's programs
    ec.config = base.replace(fetch_max_tokens=2)
    bytepack.refetches.clear()
    exact("fetch_max_tokens=2, fused", lambda: lines(ec.ocr_batch(
        pages, fused=True)))
    n_chunks = len(pages) // GRAPH_CHUNK
    if bytepack.refetches["fused_fetch"] != 3 * n_chunks:
        failures.append(f"23 (c) forced refetch: "
                        f"{bytepack.refetches['fused_fetch']} refetches in "
                        f"3 runs of {n_chunks} chunks")
    print(f"    forced refetch: {bytepack.refetches['fused_fetch']} "
          f"refetches in 3 runs of {n_chunks} chunks, chunk 0's rows "
          f"read after chunks 1-3 replayed")
    note_captures(ec)
    ec.config = base
    del ec, fused_c
    gc.collect()

    # (e) host stages, eager against graphed, in turns
    print(f"  (e) host and device stage ms, eager / graphed in turns "
          f"(eager, graphed, graphed, eager), bf16 ({smi})")
    traffic = np.load(os.path.join(TESTDATA, "bench_traffic.npz"))
    bench_pages = [np.repeat(p[..., None], 3, axis=2)
                   for p in traffic["pages"]]
    et = OcrEngine.from_pretrained()
    eb = OcrEngine.from_pretrained()
    eb.config = eb.config.replace(
        fused_lines_per_page=16,
        det_max_side=int(traffic["pages"].shape[1]))
    windows = {
        "fused": lambda: eb.ocr_batch(bench_pages[:16], fused=True),
        "bucketed": lambda: eb.ocr_batch(bench_pages[:16]),
        "tiled": lambda: et.ocr_tiled_batch(c5_batch),
        "fused 96": lambda: eb.ocr_batch(bench_pages, fused=True),
        "bucketed 96": lambda: eb.ocr_batch(bench_pages),
    }
    for fn in windows.values():
        fn()                                    # captures
    stage_rows = {}
    for name, fn in windows.items():
        runs = {"eager": [], "graphed": []}
        for route in ("eager", "graphed", "graphed", "eager"):
            timer = StageTimer()
            ctx = graphs.eager() if route == "eager" \
                else contextlib.nullcontext()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx, timer.active():
                res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[route].append((len(res) / wall, timer.host_report(),
                                timer.report()))
        def mean(vals):
            vals = list(vals)
            return statistics.mean(vals) if all(
                isinstance(v, float) for v in vals) else vals[0]
        row = {}
        for route, rs in runs.items():
            host = {k: mean(r[1].get(k, 0.0) for r in rs) for k in rs[0][1]}
            dev = {k: mean(r[2].get(k, 0.0) for r in rs) for k in rs[0][2]}
            row[route] = {"pages_per_s": statistics.mean(r[0] for r in rs),
                          "host_ms": host, "device_ms": dev}
        stage_rows[name] = row
        keys = [k for k in ("fused_dispatch", "fused_fetch", "det_dispatch",
                            "det_fetch", "rec_dispatch", "rec_fetch_decode",
                            "tile_det_dispatch", "tile_det_fetch")
                if k in row["eager"]["host_ms"]]
        print(f"    {name}: pages/s eager "
              f"{row['eager']['pages_per_s']:.2f}, graphed "
              f"{row['graphed']['pages_per_s']:.2f}; host ms "
              + ", ".join(f"{k} {row['eager']['host_ms'][k]:.2f} / "
                          f"{row['graphed']['host_ms'].get(k, 0.0):.2f}"
                          for k in keys)
              + "; device ms "
              + ", ".join(f"{k} {row['eager']['device_ms'][k]} / "
                          f"{row['graphed']['device_ms'].get(k)}"
                          for k in ("det_forward", "extract_boxes", "ccl",
                                    "warp_refine", "crnn", "ctc",
                                    "tile_det")
                          if k in row["eager"]["device_ms"]))
    record["stages"] = stage_rows

    # (d) kernels per chunk, eager against graphed, over the static inputs
    # of a real chunk (the bench's 16-page fused chunk's two programs, its
    # largest pooled recognition chunk, its detector chunk)
    print(f"  (d) launches a chunk, torch.profiler, bf16 ({smi})")
    counts = {}
    for name, arg in (("fused", 0), ("fused_rec", 0), ("rec_chunk", 2),
                      ("det", 0)):
        prog = _program(eb, name)
        entry = max(prog.entries.values(),
                    key=lambda en: en.static_in[arg].shape[0])
        args = entry.static_in
        with graphs.eager():
            eager = _launch_counts(lambda: prog(*args))
        graphed = _launch_counts(lambda: prog(*args))
        counts[name] = {"eager": eager, "graphed": graphed,
                        "graphs": entry.tape.n_graphs,
                        "shape": list(args[arg].shape)}
        print(f"    {name} {list(args[arg].shape)}: eager "
              f"{eager['host_launch_calls']} launch calls "
              f"({eager['device_ops']} device ops), graphed "
              f"{graphed['host_launch_calls']} ({entry.tape.n_graphs} "
              f"graphs; {graphed['device_ops']} device ops)")
    record["launches"] = counts

    # (f) capture ms and memory
    print(f"  (f) capture ms a key (the first call whole: its eager run "
          f"and the capture), peak memory ({smi})")
    note_captures(eb)
    note_captures(et)
    del eb, et
    gc.collect()
    record["capture_ms"] = {
        n: {"keys": len(v), "median": statistics.median(v), "max": max(v)}
        for n, v in caps.items()}
    print("    " + "; ".join(f"{n}: {r['keys']} keys, median "
                             f"{r['median']:.1f}, max {r['max']:.1f}"
                             for n, r in record["capture_ms"].items()))
    mem = {}
    for tag, make, fn in (
            ("fused 16 x 960", lambda: OcrEngine.from_pretrained(),
             lambda e: e.ocr_batch(pages, fused=True)),
            ("fused 16 x 960 fp32", lambda: OcrEngine.from_pretrained(
                config=asset_config(compute_dtype="float32")),
             lambda e: e.ocr_batch(pages, fused=True)),
            ("C5 batch", lambda: OcrEngine.from_pretrained(),
             lambda e: e.ocr_tiled_batch(c5_batch))):
        row = {}
        for route in ("eager", "graphed"):
            e = make()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_b = torch.cuda.memory_allocated()
            ctx = graphs.eager() if route == "eager" \
                else contextlib.nullcontext()
            with ctx:
                fn(e)
                fn(e)
            torch.cuda.synchronize()
            row[route] = {
                "peak_mib": (torch.cuda.max_memory_allocated() - base_b)
                / 2**20,
                "held_mib": (torch.cuda.memory_allocated() - base_b) / 2**20}
            del e
            gc.collect()
        mem[tag] = row
        print(f"    {tag}: peak {row['eager']['peak_mib']:.0f} MiB eager, "
              f"{row['graphed']['peak_mib']:.0f} MiB graphed; held after "
              f"{row['eager']['held_mib']:.0f} / "
              f"{row['graphed']['held_mib']:.0f} MiB")
    record["memory"] = mem

    # (g)
    print(f"  (g) graphs.EAGER: {graphs.EAGER or 'empty'}")
    record["eager_programs"] = dict(graphs.EAGER)
    took = time.perf_counter() - t_phase
    record["seconds"] = took
    print(f"  phase 23: {took:.1f} s ({smi})")
    with open(os.path.join(PKG, "_build", "graphs_phase.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    if failures:
        fail("phase 23: " + "; ".join(failures))
    if took > GRAPH_PHASE_MAX_S:
        fail(f"phase 23 took {took:.1f} s, past {GRAPH_PHASE_MAX_S} s")
    return ccl, record


# ---------------------------------------------------------------------------
# 24. training programs: the train steps and evaluation forwards as graphs
# ---------------------------------------------------------------------------

TRAIN_GRAPH_STEPS = 7           # phase 15's 3 batches, then 1, 2 twice
TRAIN_TIMED_STEPS = 3           # steps a turn in 24's ms a step
TRAIN_GRAPH_PHASE_MAX_S = 60.0


def _step_state(model, opt) -> dict:
    """Every tensor a step updates, cloned, and the count."""
    from ocrjax_torch.train.optim import step_state
    out = {k: t.detach().clone() for k, t in step_state(model, opt).items()}
    out["opt/count"] = opt.count
    return out


def _train_route(name: str, dtype: str, route: str, seq: list) -> dict:
    """TRAIN_GRAPH_STEPS steps of one trainer on one route from the
    shipped asset: losses (and det's parts) cloned a step, the state
    after, the peak memory over the start; the model, optimizer and step
    for the timings."""
    import torch
    from ocrjax_torch import graphs
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, opt, step = _train_models(name, dtype, "cuda")
    outs = []
    ctx = graphs.eager() if route == "eager" else graphs.sync_checked()
    with ctx:
        for x in seq:
            out = step(*x)
            outs.append([t.clone() for t in (
                [out[0], *out[1].values()] if isinstance(out, tuple)
                else [out])])
    torch.cuda.synchronize()
    return {"outs": outs, "state": _step_state(model, opt),
            "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
            "model": model, "opt": opt, "step": step}


def _equal_state(a: dict, b: dict) -> list:
    """The names whose values differ in any bit."""
    import torch
    return [k for k in a if (a[k] != b[k] if not torch.is_tensor(a[k])
                             else not torch.equal(a[k], b[k]))]


def _route_ms(runs: dict, seq: list) -> dict:
    """ms a step on each route, in turns (eager, graphed, graphed, eager),
    TRAIN_TIMED_STEPS steps a turn, CUDA events around each step; the
    median of each route's steps."""
    import torch
    from ocrjax_torch import graphs
    times = {"eager": [], "graphed": []}
    for route in ("eager", "graphed", "graphed", "eager"):
        step = runs[route]["step"]
        ctx = graphs.eager() if route == "eager" \
            else contextlib.nullcontext()
        with ctx:
            for x in seq[:TRAIN_TIMED_STEPS]:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                step(*x)
                e.record()
                e.synchronize()
                times[route].append(s.elapsed_time(e))
    return {r: statistics.median(v) for r, v in times.items()}


def _eval_programs(name: str) -> dict:
    """The trainer's evaluation forward op by op and graphed (a capture,
    then replays) on fresh inputs: equal bit for bit; the det evaluation's
    K1 launches on the graphed route (counted at every replay)."""
    import numpy as np
    import torch
    from ocrjax_torch import graphs
    from ocrjax_torch.api import asset_config
    from ocrjax_torch.charset import Charset
    from ocrjax_torch.api import ASSETS
    from ocrjax_torch.ops.cc_label import label_components_cuda as K1
    from ocrjax_torch.train import cls_trainer, det_trainer, rec_trainer
    from ocrjax_torch.train import synth
    cfg = asset_config()
    cs = Charset.from_file(os.path.join(ASSETS, "rec.charset.txt"))
    model = _train_models(name, "bfloat16", "cuda")[0]
    got, out = {}, {}
    for route in ("eager", "graphed"):
        rng = np.random.RandomState(5)
        ctx = graphs.eager() if route == "eager" else graphs.sync_checked()
        k1_before = K1.launches
        with ctx:
            if name == "det":
                got[route] = det_trainer.eval_detection(
                    model, cfg, cs, rng, n_pages=3)
            elif name == "rec":
                batches = [synth.make_line_batch(rng, cs, 32, 192,
                                                 cfg.rec_height, max_len=10)
                           for _ in range(3)]
                got[route] = rec_trainer.evaluate_exact_match(model, cs,
                                                              batches)
            else:
                lb = synth.make_line_batch(rng, cs, 64, 192, cfg.rec_height,
                                           max_len=16)
                imgs, ws = (torch.from_numpy(a).cuda()
                            for a in (lb.images, lb.widths))
                got[route] = [cls_trainer.cls_logits(
                    model, imgs, ws, cfg.rec_mean, cfg.rec_std).clone()
                    for _ in range(3)]
        if name == "det":
            out[f"k1_{route}"] = K1.launches - k1_before
    if name == "cls":
        same = all(torch.equal(a, b) for a, b in zip(got["eager"],
                                                     got["graphed"]))
        got = {k: [float(t.float().abs().sum()) for t in v]
               for k, v in got.items()}
    else:
        same = got["eager"] == got["graphed"]
    prog = model.__dict__["_programs"][f"{name}_eval"]
    out.update({"result": got, "equal": same, "program": {
        str(i): s for i, s in enumerate(prog.stats().values())}})
    return out


def phase_train_graphs(smi: str, parallel: dict) -> dict:
    """Phase 24 (see the module docstring). Returns the record."""
    import numpy as np
    import torch
    from ocrjax_torch import graphs
    t_phase = time.perf_counter()
    with np.load(os.path.join(TESTDATA, "train_batches.npz")) as f:
        batches = {k: f[k] for k in f.files}
    record, failures = {"card": smi}, []
    for name in ("rec", "det", "cls"):
        inputs = [_train_inputs(batches, name, i, "cuda") for i in range(3)]
        seq = (inputs + inputs[1:] * 2)[:TRAIN_GRAPH_STEPS]
        rec = record[name] = {}
        for dtype in ("float32", "bfloat16"):
            runs = {r: _train_route(name, dtype, r, seq)
                    for r in ("eager", "graphed")}
            e, g = runs["eager"], runs["graphed"]
            loss_same = all(torch.equal(a, b) for sa, sb in
                            zip(e["outs"], g["outs"])
                            for a, b in zip(sa, sb))
            differ = _equal_state(e["state"], g["state"])
            prog = g["step"].program
            stats = list(prog.stats().values())
            row = {"losses": [float(o[0]) for o in g["outs"]],
                   "losses_equal": loss_same, "state_tensors": len(e["state"]),
                   "state_differ": differ[:5], "n_differ": len(differ),
                   "keys": len(stats), "replays": sum(s["replays"]
                                                     for s in stats),
                   "capture_ms": [s["capture_ms"] for s in stats],
                   "graphs_a_replay": [s["graphs"] for s in stats],
                   "recaptures": prog.recaptures,
                   "peak_mib": {r: runs[r]["peak_mib"] for r in runs}}
            if dtype == "bfloat16":
                row["ms_a_step"] = _route_ms(runs, seq)
                row["launches_a_step"] = {}
                for route in ("eager", "graphed"):
                    ctx = graphs.eager() if route == "eager" \
                        else contextlib.nullcontext()
                    with ctx:
                        row["launches_a_step"][route] = _launch_counts(
                            lambda: runs[route]["step"](*seq[0]))
            rec[dtype] = row
            print(f"  {name} {dtype}: {TRAIN_GRAPH_STEPS} steps graphed "
                  f"{'equal' if loss_same and not differ else 'NOT equal'} "
                  f"to op by op (losses, {len(e['state'])} state tensors, "
                  f"count); {row['keys']} key(s), capture ms "
                  f"{[round(c, 1) for c in row['capture_ms']]}, "
                  f"{row['replays']} replays, peak MiB "
                  f"{ {r: round(v, 1) for r, v in row['peak_mib'].items()} }")
            if not loss_same or differ:
                failures.append(f"{name} {dtype}: graphed differs from op by "
                                f"op (losses equal: {loss_same}; state "
                                f"{differ[:5]})")
            if row["replays"] != TRAIN_GRAPH_STEPS - row["keys"]:
                failures.append(f"{name} {dtype}: {row['replays']} replays "
                                f"for {TRAIN_GRAPH_STEPS} steps")
            del runs, e, g
            gc.collect()
        ev = rec["eval"] = _eval_programs(name)
        print(f"  {name} evaluation forward: graphed "
              f"{'equal' if ev['equal'] else 'NOT equal'} to op by op "
              f"({ev['result']['graphed']}); program {ev['program']}"
              + (f"; K1 launches {ev['k1_eager']} op by op, "
                 f"{ev['k1_graphed']} graphed" if name == "det" else ""))
        if not ev["equal"]:
            failures.append(f"{name} evaluation: graphed differs")
        if name == "det" and (ev["k1_graphed"] != ev["k1_eager"]
                              or ev["k1_graphed"] == 0):
            failures.append(f"det evaluation: K1 launched "
                            f"{ev['k1_graphed']} times graphed, "
                            f"{ev['k1_eager']} op by op")
        b = rec["bfloat16"]
        print(f"    bf16 ms a step (CUDA events, turns e g g e, median of "
              f"{2 * TRAIN_TIMED_STEPS}): "
              + json.dumps({k: round(v, 3) for k, v in b["ms_a_step"].items()})
              + "; launch calls a step: " + json.dumps(
                  {r: v["host_launch_calls"]
                   for r, v in b["launches_a_step"].items()})
              + ", device operations: " + json.dumps(
                  {r: v["device_ops"]
                   for r, v in b["launches_a_step"].items()}))
    sharded = parallel.get("rec_step", {}).get("programs", {})
    record["sharded_rec"] = sharded
    print(f"  phase 16's rec steps as programs: {sharded}")
    for tag in ("sharded", "unsharded"):
        s = sharded.get(tag)
        if tag not in graphs.EAGER and (not s or s["replays"] < 1):
            failures.append(f"phase 16's {tag} rec step never replayed")
    record["eager_programs"] = dict(graphs.EAGER)
    took = time.perf_counter() - t_phase
    record["seconds"] = took
    print(f"  graphs.EAGER: {graphs.EAGER or 'empty'}; phase 24: "
          f"{took:.1f} s ({smi})")
    with open(os.path.join(PKG, "_build", "train_graphs.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    if failures:
        fail("phase 24: " + "; ".join(failures))
    if took > TRAIN_GRAPH_PHASE_MAX_S:
        fail(f"phase 24 took {took:.1f} s, past {TRAIN_GRAPH_PHASE_MAX_S} s")
    return record


def _fused_inputs(eng, pages) -> tuple:
    """(packed canvases, thresholds, valid (w, h)) of pages for FusedOcr."""
    import numpy as np
    from ocrjax_torch import preprocess
    cfg = eng.config
    grays, _, valid_hw, _, _ = preprocess.decode_chunk_to_gray(
        pages, range(len(pages)), cfg)
    return (preprocess.pack_for_upload(grays, cfg),
            np.asarray([cfg.det_thresh, cfg.det_box_thresh,
                        cfg.det_unclip_ratio, float(cfg.det_min_box_size)],
                       np.float32),
            valid_hw[:, ::-1].astype(np.float32).copy())


# the script's start on the host clock, for the phase headers
T0 = [0.0]


def header(line: str) -> None:
    """A phase's header line with the seconds since the script started."""
    print(f"{line} [t={time.perf_counter() - T0[0]:.1f} s]", flush=True)


def main() -> int:
    # cuBLAS's deterministic mode (phase 15) needs this before it starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    T0[0] = time.perf_counter()
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
    header(f"== 0. environment: {smi}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_kernels()
    from ocrjax_torch.ops.cc_label import label_components_cuda
    from ocrjax_torch.ops.conv_fused import conv3x3_bn_relu_cuda
    counters = [label_components_cuda, conv3x3_bn_relu_cuda]

    header("== 1. kernels vs their plain versions")
    ccl = phase_kernels()
    conv_err = phase_conv_kernel()
    header("== 2. fused lane, float32")
    pages, expected = load_fixture()
    ccl_phases = {}
    eng32, fp32, ccl_phases["2"] = phase_fp32(pages, expected, counters)
    header("== 3. fused lane, bfloat16")
    from ocrjax_torch.preprocess import native_calls
    before = dict(native_calls)
    eng16, _, ccl_phases["3"] = phase_bf16(pages, fp32, counters)
    native3 = {k: native_calls[k] - before.get(k, 0)
               for k in ("pack", "decode")}
    header("== 4. conv bench")
    conv = phase_conv_bench(counters, conv_err)
    header("== 5. staged and rerouted lanes, float32")
    fixture = load_lane_fixture()
    lanes32, ccl_phases["5"] = phase_lanes_fp32(eng32, fixture, counters)
    header("== 6. staged and rerouted lanes, bfloat16")
    phase_lanes_bf16(eng16, fixture, lanes32)
    header("== 7. beam CTC")
    ccl_phases["7"] = phase_beam_fp32(eng32, pages, fixture, counters)
    # its graphs hold memory of the float32 16-page chunk's size (phase 23
    # (f) measures it); no later phase uses it
    del eng32
    beam = phase_beam_bf16(eng16, pages)
    header("== 8. orientation (rec_try_flip)")
    ccl_phases["8"] = phase_flip_fp32(counters)
    cls_ms = phase_flip_bf16()
    header("== 9. C5 tiled OCR at 2048-pixel tiles")
    ccl_phases["9"], c5_32 = phase_c5_fp32(counters)
    ccl_phases["9 bf16"], c5 = phase_c5_bf16(counters, c5_32)
    header("== 10. opt-in paths, float32")
    ccl_phases["10"], optin32 = phase_optin_fp32(counters, pages, fixture)
    header("== 11. opt-in paths, bfloat16")
    ccl_phases["11"], optin16 = phase_optin_bf16(counters, pages, fixture,
                                                 optin32)
    header("== 12. the CLI on PNG files")
    ccl_phases["12"], ccl_phases["12 tiled"], cli_ms = phase_cli(counters,
                                                                 pages)
    header("== 13. the bench (run_bench on the committed traffic)")
    ccl_phases["13"], ccl_phases["13 C5"], bench = phase_bench(counters)
    header("== 14. e2e_eval on the committed pages")
    ccl_phases["14"] = phase_e2e(counters)
    header("== 15. training: rec, det and cls steps at full width")
    phase_train()
    header("== 16. parallel: sharded serving and training, NCCL, world size 1")
    par_ccl, parallel = phase_parallel()
    ccl_phases.update(par_ccl)
    header("== 17. the native host library")
    phase_native(eng16, pages, fixture, native3)
    header("== 18. assets: the reference's recipes through the port's scripts")
    assets, _ = phase_assets(counters)
    ccl_phases.update({f"18 {k}": v for k, v in assets.items()})
    t19 = time.perf_counter()
    header("== 19. the reference's hardware gates (tests/test_tpu.py), "
           "bfloat16")
    gates_ccl, conv19, gates = phase_gates(counters)
    ccl_phases.update(gates_ccl)
    header("== 20. the reference's evaluation and bench scripts, bfloat16")
    scripts_ccl, scripts = phase_scripts(counters)
    ccl_phases.update(scripts_ccl)
    header("== 21. the reference's diagnostic scripts, bfloat16")
    diag_ccl, diag = phase_diag(counters)
    ccl_phases.update(diag_ccl)
    print(f"  phases 19-21: {time.perf_counter() - t19:.1f} s")
    with open(os.path.join(PKG, "_build", "gates_scripts.json"), "w") as f:
        json.dump({"gates": gates, "scripts": scripts, "diag": diag}, f,
                  indent=1)
    header(f"== 22. transport: packed payloads, truncated fetches, the "
           f"async copy ({smi})")
    transport_ccl, _ = phase_transport(counters, smi, bench, parallel)
    ccl_phases.update(transport_ccl)
    header(f"== 23. compiled programs: CUDA graphs against the op-by-op "
           f"route ({smi})")
    graphs_ccl, _ = phase_graphs(counters, smi)
    ccl_phases.update({f"23 {k}": v for k, v in graphs_ccl.items()})
    header(f"== 24. training programs: train steps and evaluation forwards "
           f"as CUDA graphs against the op-by-op route ({smi})")
    reset(counters)
    phase_train_graphs(smi, parallel)
    ccl_phases["24"] = only_path("24 det evaluation", "shared")
    read(counters, "24", ["label_components_cuda"])
    print(f"  beam ctc {beam}, cls stage {cls_ms}")
    print("  opt-in: " + json.dumps({
        **optin16, "int8_own_fold": optin32["int8_own_fold"],
        "int8_ocrjax_fold": optin32["int8_ocrjax_fold"],
        "worst_box_px": optin32["worst_box_px"], "cli_wall_ms": cli_ms}))
    by_path = {p: sum(v[p] for v in ccl_phases.values())
               for p in label_components_cuda.launches_by_path}
    conv["launches_by_phase"] = {"4": conv["launches"], "19 conv": conv19}
    conv["launches"] += conv19
    conv["launches_by_path"]["wgmma"] += conv19
    kernels = [{**ccl, **c5, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_by_phase": ccl_phases}, conv]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
