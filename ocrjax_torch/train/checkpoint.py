"""Training checkpoint and resume (port of ocrjax/train/checkpoint.py).

One safetensors file per checkpoint: the model's params and BatchNorm
statistics in flax's flat layout ("params/...", "batch_stats/...", so
ocrjax.weights.load_variables reads them), the optimizer state in the
port's own layout ("opt/count", "opt/mu/<torch name>", "opt/nu/<torch
name>" of train.optim.Adam) and the step in the metadata. Files are named
`<prefix><step>.safetensors`, as ocrjax names them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ocrjax_torch import weights as W


def save_train_state(path: str, step: int, model: torch.nn.Module, opt,
                     extra_meta: Optional[Dict[str, str]] = None) -> None:
    tree = dict(W.model_variables(model))
    tree.update({f"opt/{k}": v for k, v in opt.state_dict().items()})
    meta = {"step": str(step)}
    meta.update(extra_meta or {})
    W.save_variables(path, tree, metadata=meta)


def load_train_state(path: str, model: torch.nn.Module, opt) -> int:
    """Loads the model's variables and the optimizer state in place (into
    the tensors they hold, which a captured training step goes on
    updating); returns the step."""
    flat, meta = W.read_safetensors(path)
    W.load_model_variables(model, {k: v for k, v in flat.items()
                                   if not k.startswith("opt/")})
    opt.load_state_dict({k[len("opt/"):]: v for k, v in flat.items()
                         if k.startswith("opt/")})
    return int(meta.get("step", "0"))


def latest_checkpoint(ckpt_dir: str, prefix: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        if name.startswith(prefix) and name.endswith(".safetensors"):
            try:
                step = int(name[len(prefix):-len(".safetensors")].strip("_"))
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(ckpt_dir, name), step
    return best
