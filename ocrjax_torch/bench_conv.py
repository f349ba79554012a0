"""Times the fused conv kernel against cuDNN and its plain version at the
stride-1 3x3 conv shapes of the production models (counterpart of
scripts/bench_pallas_conv.py).

    python -m ocrjax_torch.bench_conv            # on the card
    python -m ocrjax_torch.bench_conv --device cpu --reps 2

DB backbone ResBlock bodies run at 1/4 .. 1/32 of the 960 canvas with a
16-page chunk; the CRNN convs at the (256, 32, 320) strip bucket. On the card
the times are CUDA events around each call (median); on the CPU the wrapper
runs the plain version and the host clock times it, which says nothing about
the card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Sequence, Tuple

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


def time_ms(fn: Callable[[], torch.Tensor], reps: int, cuda: bool) -> float:
    """Median time of one call: CUDA events on the card, host clock on the
    CPU. One warm-up call first."""
    fn()
    times = []
    for _ in range(reps):
        if cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device: str = "cuda", shapes: Sequence[Shape] = SHAPES,
        reps: int = 20) -> List[Dict]:
    """Per shape: kernel_ms (conv3x3_bn_relu), cudnn_ms (conv_bn_relu_cudnn,
    the whole function through the library), conv_only_ms (F.conv2d alone on
    operands already cast to bf16 channels-last: the library's convolution
    without cast or epilogue), plain_ms, and the max |kernel - plain| on
    bf16 inputs."""
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
        rows.append({
            "label": label, "B": B, "H": H, "W": W, "Cin": cin, "Cout": cout,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "kernel_ms": time_ms(lambda: conv_fused.conv3x3_bn_relu(*args),
                                 reps, cuda),
            "cudnn_ms": time_ms(lambda: conv_fused.conv_bn_relu_cudnn(*args),
                                reps, cuda),
            "conv_only_ms": time_ms(
                lambda: torch.nn.functional.conv2d(xr, wr, padding=1),
                reps, cuda),
            "plain_ms": time_ms(lambda: conv_fused.conv_bn_relu_torch(*args),
                                reps, cuda),
            "max_abs_err": err,
        })
    return rows


def format_table(rows: Sequence[Dict]) -> str:
    out = ["| shape | B | HxW | Cin->Cout | cuDNN ms | conv only ms "
           "| kernel ms | plain ms | cuDNN/kernel | max err |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['label']} | {r['B']} | {r['H']}x{r['W']} "
            f"| {r['Cin']}->{r['Cout']} | {r['cudnn_ms']:.3f} "
            f"| {r['conv_only_ms']:.3f} | {r['kernel_ms']:.3f} "
            f"| {r['plain_ms']:.3f} "
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
