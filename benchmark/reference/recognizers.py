"""The recognizer of a configuration, found by name.

A configuration names its recognizer in `ocr_config["rec_arch"]` ("crnn"
where the key is absent), the value the program reads too; the
architecture's widths are further `ocr_config` keys. The harness loads
`reference/rec_<arch>.py`, so a new recognizer is one new file. Such a
module is plain float32 torch, imports nothing of the program or JAX,
and defines:

  logits(p, cfg, strips, widths) -> (logits (N, T, C), lengths (N,))
      p: models.Params of the configuration's "rec" asset; cfg: the
      OcrConfig values as attributes; strips (N, H, W) normalized,
      widths (N,) valid widths. Its products run through models._mm and
      models.conv (or count themselves the same way) so that
      models.counting sees them. With p.lowp == "fp8" it runs one step
      below the configuration's precision, as models.Params documents:
      that is the check's control.
  flops(p, cfg, widths) -> np.ndarray
      The FLOPs of one strip at each of its own widths (no bucket or
      padding counted), float64: what models.counting reads from its
      logits over that strip.
  parts(cfg, widths) -> {name: (flops, bytes)}          (optional)
      Sub-parts a per-layer roofline divides by, each a float64 array over
      the strips; lib/work.py sums them a call and the run's record
      carries them as record["work"]["<name>_flops"], ["<name>_bytes"].
  init(cfg, num_classes) -> [(flat name, shape, rule)]  (optional)
      The parameters that a seeded "rec" asset ({"seed": n, "sha256":
      ...}) of a configuration that names this recognizer draws, in
      flax-style flat names; rule as lib/seeded.py states it.
"""

from __future__ import annotations

import importlib
import re
from typing import Mapping

_NAME = re.compile(r"[A-Za-z0-9_]+")


def arch(cfg) -> str:
    """The configuration's recognizer: a mapping's or a namespace's
    rec_arch, "crnn" where it has none."""
    if isinstance(cfg, Mapping):
        return cfg.get("rec_arch", "crnn")
    return getattr(cfg, "rec_arch", "crnn")


def load(name: str):
    """reference/<name>.py, name "rec_<arch>"."""
    if not name.startswith("rec_") or not _NAME.fullmatch(name):
        raise ValueError(f"no recognizer module {name!r}: the name is "
                         f"rec_<arch> of letters, digits and _")
    return importlib.import_module(f"{__package__}.{name}")


def resolve(cfg):
    """The reference module of the configuration's recognizer."""
    return load("rec_" + arch(cfg))
