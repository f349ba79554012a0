"""Multi-process dry run of every sharded path (port of
__graft_entry__.dryrun_multichip).

    python -m ocrjax_torch.parallel.dryrun [n_devices]

dryrun_multichip(n) spawns n CPU ranks (gloo, torch.multiprocessing) and
runs, at TINY widths, on an (n/tp, tp) mesh with tp = 2 when n is even:
one dp x tp sharded rec train step; then on an (n, 1) mesh the dp-sharded
fused program with rec_try_flip, one dp step each of train_det and
train_cls, and sharded tiled serving on a 600 x 600 page. Rank 0 reports;
the parent prints one `dryrun_multichip OK: ...` line and returns it. A
watchdog ends the process with exit code 4 past OCRJAX_DRYRUN_DEADLINE_S
seconds (default 2400). The det and cls steps render their batches as the
reference's do; only on a machine without PIL do they run on random
batches through the same step functions in place of train_det /
train_cls.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import threading


def _can_render() -> bool:
    """Whether train.synth can render here: PIL (the fonts ship with the
    package)."""
    return importlib.util.find_spec("PIL") is not None


def _det_cls_steps(TINY, charset, mesh, B: int) -> None:
    """One dp-sharded step of the det and cls step functions on random
    batches (for a host where train.synth cannot render)."""
    import numpy as np
    import torch

    from ocrjax_torch import weights as W
    from ocrjax_torch.models.cls import create_cls
    from ocrjax_torch.models.db import create_db
    from ocrjax_torch.parallel import mesh as M
    from ocrjax_torch.train import cls_trainer, det_trainer
    rng = np.random.RandomState(1)
    det = create_db(TINY)
    W.init_random_(det, 0)
    opt = det_trainer.det_optimizer(det, 3e-4, 2)
    M.prepare_training(mesh, det, opt)
    S = 64
    batch = ((rng.rand(B, S, S, 3) * 255).astype(np.uint8),
             (rng.rand(B, S, S) > 0.8).astype(np.float32),
             rng.rand(B, S, S).astype(np.float32),
             (rng.rand(B, S, S) > 0.5).astype(np.float32))
    loss, _ = det_trainer.make_det_train_step(det, opt, TINY)(
        *M.shard_batch(mesh, batch))
    assert torch.isfinite(loss), "sharded det step produced NaN"
    cls = create_cls(TINY)
    W.init_random_(cls, 0)
    opt = cls_trainer.cls_optimizer(cls, 1e-3, 2)
    M.prepare_training(mesh, cls, opt)
    batch = ((rng.rand(B, TINY.rec_height, 64) * 255).astype(np.uint8),
             np.full((B,), 64, np.int32),
             (rng.rand(B) > 0.5).astype(np.float32))
    loss = cls_trainer.make_cls_train_step(cls, opt)(
        *M.shard_batch(mesh, batch))
    assert torch.isfinite(loss), "sharded cls step produced NaN"


def _rank(rank: int, n: int, init_file: str, out_file: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=n)
    try:
        from ocrjax_torch import preprocess
        from ocrjax_torch.api import OcrEngine
        from ocrjax_torch.charset import Charset, default_charset
        from ocrjax_torch.config import TINY
        from ocrjax_torch.parallel import mesh as M

        n_tp = 2 if n % 2 == 0 and n >= 2 else 1
        m = M.make_mesh(n_dp=n // n_tp, n_tp=n_tp)
        charset = Charset("abcdefg")              # 8 classes: tp-divisible
        model, tx = M.init_sharded_rec_state(TINY, charset, m, width=64)
        step = M.make_sharded_rec_train_step(model, tx, m)
        B = max(8, n)
        rng = np.random.RandomState(0)
        batch = M.shard_batch(m, (
            (rng.rand(B, 32, 64) * 255).astype(np.uint8),
            np.full((B,), 64, np.int32),
            rng.randint(1, 8, size=(B, 6)).astype(np.int32),
            np.full((B,), 6, np.int32)))
        loss = float(step(*batch))
        assert np.isfinite(loss), "sharded train step produced NaN"

        # the fused page program, dp-sharded, with the orientation stage
        eng = OcrEngine(config=TINY.replace(fused_lines_per_page=4,
                                            rec_try_flip=True), device="cpu")
        cfg = eng.config
        m_dp = M.make_mesh(n_dp=n, n_tp=1)
        fused = M.make_sharded_fused_ocr_fn(eng, m_dp, 4,
                                            cfg.rec_width_buckets[-1])
        S = cfg.det_max_side
        grays = preprocess.pack_for_upload(
            (rng.rand(n, S, S) * 255).astype(np.uint8), cfg)
        thr = (cfg.det_thresh, cfg.det_box_thresh, cfg.det_unclip_ratio,
               float(cfg.det_min_box_size))
        out = fused(grays, thr, np.full((n, 2), float(S), np.float32))
        payload = tuple(out.shape)
        assert payload[0] == n

        # one dp step each of the det and cls trainers
        if _can_render():
            from ocrjax_torch.train.cls_trainer import train_cls
            from ocrjax_torch.train.det_trainer import train_det
            r_det = train_det(config=TINY, charset=charset, steps=2,
                              batch_size=B, size=64, log=lambda _s: None,
                              mesh=m_dp)
            assert all(np.isfinite(v) for _, v in r_det.history)
            r_cls = train_cls(config=TINY, charset=default_charset(),
                              steps=2, batch_size=B, widths=(64,),
                              mesh=m_dp, eval_batches=1)
            assert np.isfinite(r_cls.accuracy)
        else:
            _det_cls_steps(TINY, charset, m_dp, B)

        # tiled serving with the tile axis dp-sharded
        M.shard_tiled_serving(eng, m_dp)
        page = np.full((600, 600, 3), 255, np.uint8)
        page[40:60, 40:200] = 0
        tiled = eng.ocr_tiled(page)
        M.shard_tiled_serving(eng, None)
        assert tiled is not None
        if rank == 0:
            with open(out_file, "w") as f:
                json.dump({"mesh": dict(zip(m.mesh_dim_names, m.shape)),
                           "loss": loss,
                           "fused": dict(zip(m_dp.mesh_dim_names,
                                             m_dp.shape)),
                           "payload": payload}, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> str:
    """Runs the dry run on n_devices CPU ranks; prints and returns its OK
    line. Raises if a rank fails."""
    import torch.multiprocessing as mp

    deadline = float(os.environ.get("OCRJAX_DRYRUN_DEADLINE_S", 2400.0))
    done = threading.Event()

    def _watchdog():
        if not done.wait(deadline):
            print(f"dryrun_multichip FAILED: exceeded {deadline:.0f}s "
                  "deadline", flush=True)
            os._exit(4)

    threading.Thread(target=_watchdog, daemon=True).start()
    try:
        with tempfile.TemporaryDirectory(prefix="ocrjax_torch_dryrun_") as d:
            out_file = os.path.join(d, "rank0.json")
            mp.spawn(_rank, args=(n_devices, os.path.join(d, "pg"),
                                  out_file), nprocs=n_devices, join=True)
            with open(out_file) as f:
                r = json.load(f)
    finally:
        done.set()
    line = (f"dryrun_multichip OK: mesh={r['mesh']} loss={r['loss']:.4f}"
            f" fused_ocr_dp={r['fused']} payload={tuple(r['payload'])}"
            f" det/cls trainers sharded, tiled serving sharded")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
