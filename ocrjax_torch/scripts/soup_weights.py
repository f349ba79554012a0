"""Linear weight soup of two compatible safetensors checkpoints (port of
scripts/soup_weights.py: the same CLI, keys, metadata and arithmetic, with
the port's own safetensors reader and writer).

    python -m ocrjax_torch.scripts.soup_weights A.safetensors B.safetensors \\
        OUT.safetensors --alpha 0.5     # OUT = (1-alpha)*A + alpha*B

Both checkpoints must come from the same architecture (identical key sets
and shapes). Each tensor is interpolated in float64 and cast back to A's
dtype; the metadata is B's (the candidate's) with a `soup` note.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ocrjax_torch import weights as W


def soup(ta: dict, tb: dict, alpha: float) -> dict:
    """(1 - alpha) * A + alpha * B, key by key; SystemExit on a key or
    shape mismatch."""
    if set(ta) != set(tb):
        raise SystemExit("key mismatch: %s" % (set(ta) ^ set(tb)))
    out = {}
    for k in ta:
        if ta[k].shape != tb[k].shape:
            raise SystemExit("shape mismatch at %s: %s vs %s"
                             % (k, ta[k].shape, tb[k].shape))
        a64 = ta[k].astype(np.float64)
        b64 = tb[k].astype(np.float64)
        out[k] = ((1.0 - alpha) * a64 + alpha * b64).astype(ta[k].dtype)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ocrjax_torch.scripts.soup_weights")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("out")
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="weight on B: out = (1-alpha)*A + alpha*B")
    args = ap.parse_args(argv)

    ta, _ = W.read_safetensors(args.a)
    tb, mb = W.read_safetensors(args.b)
    out = soup(ta, tb, args.alpha)
    mb = dict(mb)
    mb["soup"] = json.dumps({"a": args.a, "b": args.b, "alpha": args.alpha})
    W.save_variables(args.out, out, metadata=mb)
    print("wrote %s (%d tensors, alpha=%.2f on %s)"
          % (args.out, len(out), args.alpha, args.b))


if __name__ == "__main__":
    main()
