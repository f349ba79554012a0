"""Train the DB detector on synthetic pages and write a det safetensors
(port of scripts/train_det_assets.py: the same flags, the same kwargs to
train.det_trainer.train_det, the same file and metadata).

    python -m ocrjax_torch.scripts.train_det_assets [flags] [--cpu]

Runs on the card unless given --cpu. Without --out it writes the shipped
assets/det.safetensors (assets/det_<arch>.safetensors for --arch tile).
The shipped fine-tune is scripts/finetune_r3_det.sh's flag set.
"""

from __future__ import annotations

import argparse
import json
import os

from ocrjax_torch.scripts import ROOT, describe, is_writer, mesh_from_flag


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.train_det_assets")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--p-word", type=float, default=0.0,
                    help="prob of word-like lines (synth.word_text) per "
                         "page line")
    ap.add_argument("--finetune", action="store_true",
                    help="warm-start from the shipped assets/det.safetensors")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume dir for bounded run windows")
    ap.add_argument("--head-stride", type=int, default=1, choices=(1, 2, 4),
                    help="det head output stride (4 = detect on the FPN's "
                         "native S/4 grid)")
    ap.add_argument("--degrade", type=float, default=0.0,
                    help="probability of scan-degradation augmentation per "
                         "training page (synth.degrade_image; the ground "
                         "truth maps stay exact)")
    ap.add_argument("--arch", default=None, choices=(None, "flagship", "tile"),
                    help="architecture preset (models.db.DB_ARCHS); 'tile' "
                         "trains the tile-scale detector and defaults --out "
                         "to assets/det_tile.safetensors")
    ap.add_argument("--mesh", default=None, metavar="DP[,TP]",
                    help="run the train step over a DP[,TP] mesh "
                         "(parallel.mesh): '8' = 8-way data parallel, "
                         "'4,2' = dp=4 x tp=2; one process a rank "
                         "(torchrun), or a group of one without a launcher")
    ap.add_argument("--p-dense", type=float, default=0.0,
                    help="probability of a DENSE page layout per training "
                         "page (synth.render_page_dense)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print("devices:", describe(device), flush=True)

    from ocrjax_torch import weights as W
    from ocrjax_torch.charset import default_charset
    from ocrjax_torch.config import OcrConfig
    from ocrjax_torch.train.det_trainer import train_det

    config = OcrConfig(det_head_stride=args.head_stride)
    arch = None
    asset_name = "det.safetensors"
    if args.arch:
        from ocrjax_torch.models.db import DB_ARCHS
        arch = dict(DB_ARCHS[args.arch])
        if args.arch != "flagship":
            asset_name = f"det_{args.arch}.safetensors"
    init_variables = None
    out_default = os.path.join(ROOT, "assets", asset_name)
    if args.finetune:
        init_variables = W.read_safetensors(out_default)[0]
        print("warm-starting from", out_default, flush=True)
    mesh = None
    if args.mesh:
        mesh, _ = mesh_from_flag(args.mesh, device)
    result = train_det(
        config=config, charset=default_charset(), steps=args.steps,
        batch_size=args.batch, size=args.size, lr=args.lr, seed=args.seed,
        log=lambda m: print(m, flush=True),
        p_word=args.p_word, init_variables=init_variables,
        ckpt_dir=args.ckpt_dir,
        degrade=args.degrade, p_dense=args.p_dense, arch=arch, mesh=mesh,
        device=device,
    )
    if not is_writer():
        return
    out = args.out or out_default
    meta = {
        "kind": "db",
        "recall": f"{result.recall:.4f}",
        "precision": f"{result.precision:.4f}",
        "steps": str(args.steps),
        "config": json.dumps({"det_head_stride": args.head_stride}),
    }
    if arch is not None:
        # a variant asset carries its whole architecture, from which the
        # engine rebuilds the model
        meta["arch"] = json.dumps(arch)
        meta["config"] = json.dumps(
            {"det_head_stride": int(arch.get("head_stride", 1))})
    W.save_variables(out, result.variables, metadata=meta)
    print("saved", out, "recall", result.recall, "precision",
          result.precision, flush=True)


if __name__ == "__main__":
    main()
