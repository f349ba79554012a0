"""Train the orientation classifier and write a cls safetensors (port of
scripts/train_cls_assets.py: the same flags, the same kwargs to
train.cls_trainer.train_cls, the same file and metadata).

    python -m ocrjax_torch.scripts.train_cls_assets [flags] [--cpu]

Half the batches are real refined detector crops from an OcrEngine built
on the same device. Runs on the card unless given --cpu (a flag the
reference, which runs where JAX's default platform is, does not have).
Without --out it writes the shipped assets/cls.safetensors.
"""

from __future__ import annotations

import argparse
import json
import os

from ocrjax_torch.scripts import ROOT, describe, is_writer, mesh_from_flag


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.train_cls_assets")
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--widths", type=int, nargs="+",
                    default=[64, 128, 192, 320])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crop-pages", type=int, default=96,
                    help="rendered pages per width bucket for the real "
                         "refined-detector-crop half of training")
    ap.add_argument("--p-crop", type=float, default=0.5)
    ap.add_argument("--antisym", type=float, default=0.5,
                    help="antisymmetry penalty weight; > 0 certifies the "
                         "asset for single-pass serving (cls_single_pass)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", default=None, metavar="DP[,TP]",
                    help="run the train step over a DP[,TP] mesh "
                         "(parallel.mesh): '8' = 8-way data parallel, "
                         "'4,2' = dp=4 x tp=2; one process a rank "
                         "(torchrun), or a group of one without a launcher")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print("devices:", describe(device), flush=True)

    from ocrjax_torch import weights as W
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.train.cls_trainer import train_cls

    # the engine supplies real refined detector crops (the serving domain)
    # for half the batches
    engine = OcrEngine.from_pretrained(device=device)
    cfg = engine.config
    mesh = None
    if args.mesh:
        mesh, _ = mesh_from_flag(args.mesh, device)
    res = train_cls(config=cfg, charset=engine.charset, steps=args.steps,
                    batch_size=args.batch, widths=tuple(args.widths),
                    seed=args.seed, verbose=True, eval_batches=30,
                    engine=engine, crop_pages=args.crop_pages,
                    p_crop=args.p_crop, mesh=mesh, antisym=args.antisym,
                    device=device)
    print(f"final orientation accuracy (serving distribution): "
          f"{res.accuracy:.4f}")
    if not is_writer():
        return
    out = args.out or os.path.join(ROOT, "assets", "cls.safetensors")
    W.save_variables(out, res.variables, metadata={
        "config": json.dumps({"compute_dtype": cfg.compute_dtype}),
        "accuracy": f"{res.accuracy:.4f}",
        "steps": str(args.steps),
        # an antisym-trained asset is certified for single-pass serving
        "antisym": "1" if args.antisym > 0 else "0",
    })
    print("wrote", out)


if __name__ == "__main__":
    main()
