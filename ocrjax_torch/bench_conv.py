"""Times the fused conv kernels against cuDNN, each other and the plain
version at the stride-1 3x3 conv shapes of the production models (counterpart
of scripts/bench_pallas_conv.py).

    python -m ocrjax_torch.bench_conv            # on the card
    python -m ocrjax_torch.bench_conv --device cpu --reps 2

DB backbone ResBlock bodies run at 1/4 .. 1/32 of the 960 canvas with a
16-page chunk; the CRNN convs at the (256, 32, 320) strip bucket. On the card
the times are CUDA events around each call (median), and the kernel the
wrapper picks (wgmma or small-Cin) and the general kernel are timed in turns;
on the CPU the wrapper runs the plain version and the host clock times it,
which says nothing about the card.
"""

from __future__ import annotations

import argparse
import functools
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ocrjax_torch.ops import conv_fused

Shape = Tuple[str, int, int, int, int, int]   # label, B, H, W, Cin, Cout

SHAPES: List[Shape] = [
    ("db.res1 960/4", 16, 240, 240, 64, 64),
    ("db.res2 960/8", 16, 120, 120, 128, 128),
    ("db.res3 960/16", 16, 60, 60, 256, 256),
    ("db.res4 960/32", 16, 30, 30, 512, 512),
    ("db.fpn.smooth", 16, 240, 240, 96, 24),
    ("db.head.conv", 16, 240, 240, 96, 24),
    ("crnn.conv0", 256, 32, 320, 1, 64),
    ("crnn.conv1", 256, 16, 160, 64, 128),
    ("crnn.conv2", 256, 8, 80, 128, 256),
    ("crnn.conv3", 256, 8, 80, 256, 256),
    ("crnn.conv4", 256, 4, 80, 256, 512),
    ("crnn.conv5", 256, 4, 80, 512, 512),
]


def make_inputs(shape: Shape, device, dtype=torch.bfloat16, seed: int = 0):
    """Seeded (x, w, scale, bias) for one shape, as the reference's bench
    makes them: x uniform in [0, 1), w normal * 0.05, identity scale/bias."""
    _, B, H, W, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(B, H, W, cin).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, cin, cout).astype(np.float32) * 0.05)
    scale = torch.ones(cout)
    bias = torch.zeros(cout)
    return (x.to(device=device, dtype=dtype), w.to(device), scale.to(device),
            bias.to(device))


def _once_ms(fn: Callable[[], torch.Tensor], cuda: bool) -> float:
    if cuda:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def time_ms(fn: Callable[[], torch.Tensor], reps: int, cuda: bool) -> float:
    """Median time of one call: CUDA events on the card, host clock on the
    CPU. One warm-up call first."""
    fn()
    return statistics.median(_once_ms(fn, cuda) for _ in range(reps))


def device_ms(fn: Callable[[], torch.Tensor], reps: int = 10,
              tries: int = 3) -> Optional[float]:
    """Time the card spends in the kernels of one call of fn, from
    torch.profiler over `reps` calls: the mean duration of each kernel,
    summed over the kernels (fn launches each of its kernels once; no host
    time, no launch gaps). A trace that comes back empty is taken again, up
    to `tries` times; None where the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_call_us = sum(
            k.device_time_total / k.count for k in prof.key_averages()
            if getattr(k, "device_time_total", 0) > 0 and k.count)
        if per_call_us > 0:
            return per_call_us / 1e3
    return None


def time_in_turns_ms(a: Callable[[], torch.Tensor],
                     b: Callable[[], torch.Tensor], reps: int, cuda: bool
                     ) -> Tuple[float, float]:
    """Median times of a and b, called in turns (a b, b a, a b, ...) so that
    both see the same card in the same state."""
    a()
    b()
    ta, tb = [], []
    for i in range(reps):
        for fn, out in ((a, ta), (b, tb)) if i % 2 == 0 else ((b, tb),
                                                               (a, ta)):
            out.append(_once_ms(fn, cuda))
    return statistics.median(ta), statistics.median(tb)


def run(device: str = "cuda", shapes: Sequence[Shape] = SHAPES,
        reps: int = 20) -> List[Dict]:
    """Per shape: path (the kernel the wrapper picks; "plain" on the CPU),
    kernel_ms (conv3x3_bn_relu) and generic_ms (the general kernel forced on
    the same inputs; on the CPU the plain version again) timed in turns,
    kernel_device_ms (the card's time in the call's kernels by torch.profiler,
    without the wrapper's host time; None on the CPU or without a trace),
    cudnn_ms (conv_bn_relu_cudnn, the whole function through the library),
    conv_only_ms (F.conv2d alone on operands already cast to bf16
    channels-last: the library's convolution without cast or epilogue) and
    conv_only_device_ms (the same by torch.profiler, kernels only),
    plain_ms, and the max |kernel - plain| on bf16 inputs."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the bench on the CPU")
    cuda = dev.type == "cuda"
    rows = []
    for shape in shapes:
        label, B, H, W, cin, cout = shape
        args = make_inputs(shape, dev)
        got = conv_fused.conv3x3_bn_relu(*args)
        want = conv_fused.conv_bn_relu_torch(*args)
        err = float((got.float() - want.float()).abs().max())
        del got, want
        xr = args[0].permute(0, 3, 1, 2)
        wr = args[1].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        if cuda:
            aligned = all(t.data_ptr() % 16 == 0 for t in args)
            path = conv_fused.conv_path(B, H, W, cin, cout, aligned)
            generic = functools.partial(conv_fused.conv3x3_bn_relu_cuda,
                                        *args, path="generic")
        else:
            path = "plain"
            generic = functools.partial(conv_fused.conv3x3_bn_relu, *args)
        kernel_ms, generic_ms = time_in_turns_ms(
            lambda: conv_fused.conv3x3_bn_relu(*args), generic, reps, cuda)
        rows.append({
            "label": label, "B": B, "H": H, "W": W, "Cin": cin, "Cout": cout,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "path": path, "kernel_ms": kernel_ms, "generic_ms": generic_ms,
            "kernel_device_ms": device_ms(
                lambda: conv_fused.conv3x3_bn_relu(*args)) if cuda else None,
            "cudnn_ms": time_ms(lambda: conv_fused.conv_bn_relu_cudnn(*args),
                                reps, cuda),
            "conv_only_ms": time_ms(
                lambda: torch.nn.functional.conv2d(xr, wr, padding=1),
                reps, cuda),
            "conv_only_device_ms": device_ms(
                lambda: torch.nn.functional.conv2d(xr, wr, padding=1))
            if cuda else None,
            "plain_ms": time_ms(lambda: conv_fused.conv_bn_relu_torch(*args),
                                reps, cuda),
            "max_abs_err": err,
        })
    return rows


def _fmt(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.3f}"


def format_table(rows: Sequence[Dict]) -> str:
    out = ["| shape | B | HxW | Cin->Cout | path | cuDNN ms | conv only ms "
           "| conv only ms, device only | kernel ms | kernel ms, device only "
           "| general kernel ms | plain ms | cuDNN/kernel | max err |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['label']} | {r['B']} | {r['H']}x{r['W']} "
            f"| {r['Cin']}->{r['Cout']} | {r['path']} | {r['cudnn_ms']:.3f} "
            f"| {r['conv_only_ms']:.3f} "
            f"| {_fmt(r['conv_only_device_ms'])} | {r['kernel_ms']:.3f} "
            f"| {_fmt(r['kernel_device_ms'])} "
            f"| {r['generic_ms']:.3f} | {r['plain_ms']:.3f} "
            f"| {r['cudnn_ms'] / r['kernel_ms']:.2f}x "
            f"| {r['max_abs_err']:.2e} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    if a.device == "cuda" and torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    else:
        print(f"device: {a.device} (host-clock times of the plain version)")
    print(format_table(run(a.device, reps=a.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
