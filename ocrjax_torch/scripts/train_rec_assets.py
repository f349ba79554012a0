"""Train the flagship CRNN on synthetic text and write a rec safetensors
(port of scripts/train_rec_assets.py: the same flags, the same kwargs to
train.rec_trainer.train_rec, the same file and metadata).

    python -m ocrjax_torch.scripts.train_rec_assets [flags] [--cpu]

Runs on the card unless given --cpu. Without --out it writes the shipped
assets/rec.safetensors, as the reference does. The shipped fine-tune is
scripts/finetune_r5_soft.sh's flag set.
"""

from __future__ import annotations

import argparse
import json
import os

from ocrjax_torch.scripts import ROOT, describe, is_writer, mesh_from_flag

CONFUSABLE = "Il|1iO0osScCzZxXvVwW_"


def _char_weights(args):
    w = {}
    if args.confusable_bias != 1.0:
        w = {c: args.confusable_bias for c in CONFUSABLE}
    if args.l_bias != 1.0:
        w["l"] = w.get("l", 1.0) * args.l_bias
    return w or None


def font_weights_of(spec, fonts):
    """--font-bias NAME:W[,NAME:W] -> one weight a font, NAME matched as a
    substring of the font's base name; None without the flag."""
    if not spec:
        return None
    weights = [1.0] * len(fonts)
    for part in spec.split(","):
        if ":" not in part:
            raise SystemExit(f"--font-bias: expected NAME:WEIGHT, got "
                             f"{part!r}")
        name, w = part.rsplit(":", 1)
        hit = [i for i, f in enumerate(fonts)
               if name in os.path.basename(f)]
        if not hit:
            raise SystemExit(f"--font-bias: no font matches {name!r}")
        for i in hit:
            weights[i] *= float(w)
    print("font weights:", {os.path.basename(f): round(w, 2)
                            for f, w in zip(fonts, weights)}, flush=True)
    return weights


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.train_rec_assets")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-len", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--finetune", action="store_true",
                    help="warm-start from the shipped assets/rec.safetensors")
    ap.add_argument("--finetune-from", default=None, metavar="PATH",
                    help="warm-start from an arbitrary rec safetensors file")
    ap.add_argument("--rec-height", type=int, default=32,
                    help="strip height of the trained model")
    ap.add_argument("--hidden", type=int, default=160,
                    help="BiLSTM hidden size of the trained model")
    ap.add_argument("--channels", default="32,64,128,256",
                    help="conv channel progression, comma-separated")
    ap.add_argument("--p-space", type=float, default=0.0,
                    help="per-char space probability in synthetic text")
    ap.add_argument("--aug-rotation", type=float, default=0.0,
                    help="rotate half the synthetic strips by +-DEG")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume dir: reruns continue from the "
                         "latest step")
    ap.add_argument("--quantize-p", type=float, default=0.0,
                    help="prob of the 4-bit dither transport round-trip "
                         "per training strip (match upload_bits=4 serving)")
    ap.add_argument("--stretch", type=float, default=0.0,
                    help="width-rescale half the strips by a log-uniform "
                         "factor in [1/(1+S), 1+S]")
    ap.add_argument("--p-word", type=float, default=0.0,
                    help="prob of word-like text per synthetic line")
    ap.add_argument("--confusable-bias", type=float, default=1.0,
                    help="sampling weight of the confusable glyph clusters "
                         "(Il|1i O0o sS cC zZ xX vV wW _) relative to other "
                         "chars")
    ap.add_argument("--font-bias", default=None, metavar="NAME:W[,NAME:W]",
                    help="per-font sampling weight multipliers, matched as "
                         "base-name substrings ('DejaVuSans.ttf:4' for the "
                         "regular face alone; 'DejaVuSans' also matches "
                         "Mono and Bold). Unmatched fonts keep weight 1")
    ap.add_argument("--l-bias", type=float, default=1.0,
                    help="sampling weight of 'l' relative to other chars")
    ap.add_argument("--font-anneal-frac", type=float, default=0.0,
                    help="switch --font-bias back to uniform fonts for the "
                         "final FRAC of steps")
    ap.add_argument("--degrade", type=float, default=0.0,
                    help="probability of scan-degradation augmentation per "
                         "synthetic strip (synth.degrade_image)")
    ap.add_argument("--degrade-anneal-frac", type=float, default=0.0,
                    help="drop --degrade to 0 for the final fraction of "
                         "steps")
    ap.add_argument("--det-rotation", type=float, default=0.0,
                    help="per-line rotation range of det-crop pages")
    ap.add_argument("--mix-det-crops", type=int, default=0, metavar="PAGES",
                    help="render PAGES pages, run the detection and refined "
                         "warp path, and mix the ground-truth-labelled "
                         "crops into training 50/50")
    ap.add_argument("--flat-snap", type=float, default=0.0,
                    help="probability of the serving flat-band geometry "
                         "augmentation per eligible strip")
    ap.add_argument("--ent-reg", type=float, default=0.0,
                    help="frame-entropy maximization weight")
    ap.add_argument("--mesh", default=None, metavar="DP[,TP]",
                    help="train the same step dp(+tp)-sharded "
                         "(parallel.mesh): '8' = 8-way data parallel, "
                         "'4,2' = dp=4 x tp=2; one process a rank "
                         "(torchrun), or a group of one without a launcher")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print("devices:", describe(device), flush=True)

    from ocrjax_torch import weights as W
    from ocrjax_torch.charset import default_charset
    from ocrjax_torch.config import OcrConfig
    from ocrjax_torch.train import synth
    from ocrjax_torch.train.rec_trainer import train_rec

    font_weights = font_weights_of(args.font_bias, synth.FONTS)
    config = OcrConfig(
        rec_hidden=args.hidden,
        rec_height=args.rec_height,
        rec_conv_channels=tuple(int(c) for c in args.channels.split(",")),
    )
    if args.rec_height != 32:
        # the width buckets scale with the strip height
        k = args.rec_height / 32.0
        config = config.replace(rec_width_buckets=tuple(
            int(round(b * k / 32)) * 32 for b in config.rec_width_buckets))
    charset = default_charset()

    assets_p = os.path.join(ROOT, "assets", "rec.safetensors")
    out = args.out or assets_p

    init_variables = None
    if args.finetune or args.finetune_from:
        src = args.finetune_from or assets_p
        init_variables = W.read_safetensors(src)[0]
        print("warm-starting from", src, flush=True)

    det_crops = None
    if args.mix_det_crops:
        from ocrjax_torch.api import OcrEngine
        from ocrjax_torch.train.det_crops import generate_det_crops

        eng = OcrEngine.from_pretrained(device=device)
        # the crops take the trained model's strip geometry (the engine's
        # own rec weights are unused: detection and warp only)
        eng.config = eng.config.replace(
            rec_height=config.rec_height,
            rec_width_buckets=config.rec_width_buckets)
        det_crops = generate_det_crops(
            eng, n_pages=args.mix_det_crops, width=args.width,
            max_rotation=args.det_rotation, p_word=args.p_word)
        print(f"det crops: {det_crops.images.shape[0]} strips from "
              f"{args.mix_det_crops} pages", flush=True)

    mesh = None
    if args.mesh:
        mesh, n_dp = mesh_from_flag(args.mesh, device)
        if args.batch % n_dp:
            raise SystemExit(f"--batch {args.batch} must divide dp={n_dp}")

    result = train_rec(
        config=config, charset=charset, steps=args.steps,
        batch_size=args.batch, width=args.width, lr=args.lr,
        mesh=mesh,
        ent_reg=args.ent_reg,
        seed=args.seed, max_len=args.max_len,
        log=lambda m: print(m, flush=True),
        init_variables=init_variables,
        ckpt_dir=args.ckpt_dir,
        det_crops=det_crops,
        p_space=args.p_space,
        aug_rotation=args.aug_rotation,
        quantize_p=args.quantize_p,
        p_word=args.p_word,
        stretch=args.stretch,
        char_weights=_char_weights(args),
        font_weights=font_weights,
        font_anneal_frac=args.font_anneal_frac,
        degrade=args.degrade,
        degrade_anneal_frac=args.degrade_anneal_frac,
        flat_snap=args.flat_snap,
        device=device,
    )
    if not is_writer():
        return
    cfg_json = json.dumps({
        "rec_hidden": config.rec_hidden,
        "rec_height": config.rec_height,
        "rec_width_buckets": list(config.rec_width_buckets),
        "rec_conv_channels": list(config.rec_conv_channels),
    })
    W.save_variables(out, result.variables, metadata={
        "kind": "crnn",
        "config": cfg_json,
        "exact_match": f"{result.exact_match:.4f}",
        "steps": str(args.steps),
    })
    W.save_charset_sidecar(out, charset)
    print("saved", out, "exact_match", result.exact_match, flush=True)


if __name__ == "__main__":
    main()
