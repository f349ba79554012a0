"""Float against int8 detection, with the int8 path's quality beside its
cost (port of scripts/bench_int8_det.py: the same printout).

Times the DB detection forward, the float model in the compute dtype
against its int8 mirror (models.db_int8: per-channel weight and
activation scales, torch._int_mm with int32 accumulation on the card), at
the serving shape (the fused lane's 16-page chunk on the det_max_side
canvas), the two in turns, with CUDA events. Reports the probability
maps' bitmap agreement at det_thresh with the shipped weights, and a
wire/retire recommendation (det_int8's default flips only on a measured
win).

    python -m ocrjax_torch.scripts.bench_int8_det [--cpu]

The pages are rendered on the host; the engine runs on the card unless
given --cpu (there the int8 product is its exact float64 plain version).
The detector timed is the one the engine serves with
(api_det.det_state(engine).model).
"""

from __future__ import annotations

import argparse

import numpy as np

from ocrjax_torch.scripts import describe, device_ms

CHUNK = 16      # pages a forward: the fused lane's chunk
REPEATS = 5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.bench_int8_det")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import torch
    from ocrjax_torch import api_det, preprocess
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.charset import default_charset
    from ocrjax_torch.models import db_int8
    from ocrjax_torch.train import synth

    eng = OcrEngine.from_pretrained(device=device)
    print(f"device: {describe(device)}", flush=True)
    cfg = eng.config
    model = api_det.det_state(eng).model
    S, B = cfg.det_max_side, CHUNK

    rng = np.random.RandomState(0)
    grays = np.zeros((B, S, S), np.uint8)
    for i in range(B):
        page, _, _ = synth.render_page(rng, default_charset(), size=(S, S))
        grays[i] = page
    x = preprocess.det_normalize_gray(api_det.upload(eng, grays),
                                      cfg.det_mean, cfg.det_std)

    def forward(int8):
        with torch.inference_mode():
            return db_int8.apply_prob(model, x, int8)

    # each path once before any timing, then the two in turns
    out = {int8: forward(int8) for int8 in (False, True)}
    times = {False: [], True: []}
    for _ in range(REPEATS):
        for int8 in (False, True):
            times[int8].append(device_ms(lambda: forward(int8), device))
    dtype = {"bfloat16": "bf16", "float32": "fp32"}.get(
        cfg.compute_dtype, cfg.compute_dtype)
    labels = {False: f"float {dtype}", True: "int8      "}
    ms = {}
    for int8 in (False, True):
        ms[int8] = min(times[int8])
        print(f"{labels[int8]}: {ms[int8]:.1f} ms / {B} pages "
              f"({B / (ms[int8] / 1e3):.0f} pages/s det-forward)",
              flush=True)

    pf, pq = out[False].float(), out[True].float()
    thr = cfg.det_thresh
    agree = float(((pf > thr) == (pq > thr)).double().mean())
    diff = (pf - pq).abs()
    print(f"bitmap agreement @ det_thresh: {agree:.6f}")
    print(f"mean |prob diff|: {float(diff.double().mean()):.6f}  "
          f"max: {float(diff.max()):.4f}")
    speedup = ms[False] / ms[True]
    print(f"speedup: {speedup:.2f}x → "
          + ("WIRE (flip det_int8 default after e2e quality gates)"
             if speedup > 1.1 and agree > 0.999 else
             "RETIRE/HOLD (keep det_int8 opt-in; record numbers in "
             "DESIGN.md §6)"))


if __name__ == "__main__":
    main()
