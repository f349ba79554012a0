"""The reference's scripts/ with the same flags, each run as
`python -m ocrjax_torch.scripts.<name>`: the drivers of the shipped
assets' recipes (train_rec_assets, train_det_assets, train_cls_assets,
soup_weights, eval_multiseed), the evaluation and bench scripts
(eval_quality_breakdown, eval_xheight, eval_beam, bench_int8_det,
bench_try_flip, eval_tiled_quality, probe_dense, calibrate_unclip) and the
diagnostic scripts (diag_dense, diag_dense_stages, diag_tile_det,
diag_rec_fetch, diag_reroute). They run on the card unless given --cpu."""

from __future__ import annotations

import os
import socket
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def describe(device: str) -> str:
    """The device a script runs on, as its `devices:` line shows it."""
    import torch
    if device == "cuda":
        return f"cuda ({torch.cuda.get_device_name(0)})"
    return "cpu"


def clock(device: str) -> float:
    """The host clock once the card has finished the work queued on it."""
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return time.perf_counter()


def device_ms(fn, device: str) -> float:
    """Milliseconds of one call of fn: CUDA events around it on the card,
    the host clock on the CPU."""
    import torch
    if device != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def mesh_from_flag(spec: str, device: str):
    """A parallel.mesh mesh for --mesh DP[,TP]. The process group comes
    from the environment where a launcher (torchrun) set RANK and
    WORLD_SIZE; without them this process is a group of one on a free
    localhost port. NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist
    from ocrjax_torch.parallel import mesh as M
    parts = [int(v) for v in spec.split(",")]
    n_dp, n_tp = (parts + [1])[:2]
    if not dist.is_initialized():
        backend = "nccl" if device == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{port}", rank=0,
                world_size=1)
    mesh = M.make_mesh(n_dp=n_dp, n_tp=n_tp)
    print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
    return mesh, n_dp


def is_writer() -> bool:
    """Whether this process writes the script's output: always, but for
    ranks other than 0 of a --mesh run."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0
