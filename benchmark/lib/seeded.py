"""Weight assets drawn from a seed, written once and pinned by sha256.

The recognizer's weights, the asset named "rec" under a configuration's
`assets`, may be

    {"seed": n, "sha256": "..."}

in place of {"path": ..., "sha256": ...}. The configuration's recognizer
(reference/rec_<arch>.py, by its `rec_arch`) lists its parameters with
`init(cfg, num_classes)` as (flat name, shape, rule); tensor i of that
list is drawn from np.random.default_rng([n, i]) by its rule:
  * "normal": standard normal times 1 / sqrt(fan_in), fan_in the product
    of every dimension but the last (a flax kernel's inputs);
  * ("normal", std): standard normal times std;
  * "ones", "zeros" (norm scales; biases and norm offsets).
The tensors are written in float32 under those names, in that order, as
one safetensors file into the checkout's cache under the name of its
content (.bench_cache/assets/<sha256>.safetensors), and only when that
sha256 is the pinned one. A later run reads the cached file, after
checking its sha256 again; a file of another pin is never read. Whoever
reads an asset then reads it as a file.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct
from types import SimpleNamespace
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from benchmark.reference import models as M
from benchmark.reference import recognizers

_SHA256 = re.compile(r"[0-9a-f]{64}")


def check_pin(label: str, got: str, pin: str) -> None:
    """A changed asset is refused."""
    if got != pin:
        raise SystemExit(f"asset {label} has sha256 {got}, the "
                         f"configuration pins {pin}")


def draw(spec: Sequence[Tuple[str, Sequence[int], object]], seed: int
         ) -> List[Tuple[str, np.ndarray]]:
    """(flat name, shape, rule) a tensor -> (flat name, float32 array)."""
    out = []
    for i, (name, shape, rule) in enumerate(spec):
        shape = tuple(int(s) for s in shape)
        if rule in ("ones", "zeros"):
            a = (np.ones if rule == "ones" else np.zeros)(shape, np.float32)
        else:
            if rule == "normal":
                std = 1.0 / np.sqrt(float(np.prod(shape[:-1], dtype=np.int64)))
            elif isinstance(rule, (tuple, list)) and rule[0] == "normal":
                std = float(rule[1])
            else:
                raise ValueError(f"{name}: unknown rule {rule!r}")
            rng = np.random.default_rng([int(seed), i])
            a = (rng.standard_normal(shape) * std).astype(np.float32)
        out.append((name, a))
    return out


def encode(tensors: Sequence[Tuple[str, np.ndarray]],
           meta: Mapping[str, str]) -> bytes:
    """One safetensors file: the header in the tensors' order, padded with
    spaces to 8 bytes, then the little-endian float32 data."""
    header: Dict = {"__metadata__": dict(meta)}
    lo, data = 0, []
    for name, a in tensors:
        b = np.ascontiguousarray(a, "<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [lo, lo + len(b)]}
        lo += len(b)
        data.append(b)
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    return struct.pack("<Q", len(h)) + h + b"".join(data)


def asset(name: str, entry: Mapping, ocr_config: Mapping, charset: str,
          cache: str) -> str:
    """The seeded asset `name` of a configuration as a file in the
    directory `cache`: written there from the seed if it is not there
    yet, refused if its sha256 is not the pin."""
    if name != "rec":
        raise SystemExit(f"asset {name} is drawn from a seed; only the "
                         f"recognizer's weights (rec) may be")
    pin = entry["sha256"]
    if not _SHA256.fullmatch(pin):
        raise SystemExit(f"asset {name} pins {pin!r}, not a sha256")
    arch = recognizers.arch(ocr_config)
    path = os.path.join(cache, f"{pin}.safetensors")
    label = f"{name} (rec_{arch} seed {entry['seed']}, {path})"
    if os.path.exists(path):
        check_pin(label, M.sha256(path), pin)
        return path
    cfg = SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in ocr_config.items()})
    spec = recognizers.resolve(ocr_config).init(
        cfg, len(M.load_charset(charset)) + 1)
    blob = encode(draw(spec, entry["seed"]),
                  {"seed": str(entry["seed"]), "rec_arch": arch})
    check_pin(label, hashlib.sha256(blob).hexdigest(), pin)
    os.makedirs(cache, exist_ok=True)
    part = path + ".part"
    with open(part, "wb") as f:
        f.write(blob)
    os.replace(part, path)
    return path
