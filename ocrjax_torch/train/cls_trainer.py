"""Orientation-classifier training (port of ocrjax/train/cls_trainer.py).

Batches render lines with the serving-distribution knobs (word-mode text,
spaces, dither-transport noise, small residual rotation), snap a share of
them to their ink rows (the serving refine's geometry) and rotate a random
half by 180 degrees in place, width-aware; binary cross-entropy on the
flip logit, with the antisymmetry term that lets serving run one
classifier pass (cls_single_pass). Adam with cosine decay to 0.1 of lr, no
clipping, as ocrjax trains it.

Differences from ocrjax, by design: the model starts from
weights.init_random_, not from flax's initializers. With mesh= the step
runs dp-sharded as train_rec's does (parallel.mesh): the losses are means
over the whole batch; the classifier replicates over tp.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ocrjax_torch import graphs, preprocess
from ocrjax_torch import weights as W
from ocrjax_torch.charset import Charset, default_charset
from ocrjax_torch.config import OcrConfig
from ocrjax_torch.models.cls import create_cls, flip_strips_by_width
from ocrjax_torch.train import synth
from ocrjax_torch.train.optim import (Adam, cosine_decay_schedule,
                                      halves, step_state, train_device,
                                      trainable)


@dataclasses.dataclass
class ClsTrainResult:
    variables: Dict[str, np.ndarray]      # flat flax layout
    history: list
    accuracy: float


def snap_rows_to_ink(rng: np.random.RandomState, batch: synth.LineBatch,
                     p: float = 0.7, thresh: int = 128) -> None:
    """In place: crop a strip to its ink ROW band (+2 px) and rescale it to
    the full height, the serving refine's transform, with probability p
    (host only: cv2)."""
    import cv2
    H = batch.images.shape[1]
    for i in range(len(batch.widths)):
        if rng.rand() >= p:
            continue
        w = int(batch.widths[i])
        s = batch.images[i, :, :w]
        rows = np.where((s < thresh).sum(axis=1) > 0)[0]
        if len(rows) == 0:
            continue
        y0 = max(0, rows[0] - 2)
        y1 = min(H, rows[-1] + 3)
        band = s[y0:y1].copy()  # s views batch.images, zeroed next line
        new_w = min(batch.images.shape[2],
                    max(4, round(w * H / band.shape[0])))
        batch.images[i] = 0
        batch.images[i, :, :new_w] = cv2.resize(
            band, (new_w, H), interpolation=cv2.INTER_LINEAR)
        batch.widths[i] = new_w


def flip_half(rng: np.random.RandomState, batch: synth.LineBatch
              ) -> np.ndarray:
    """Rotate a random half of the batch's strips 180 degrees in place
    (within each strip's valid width). Returns the (B,) float32 labels."""
    B = len(batch.widths)
    labels = (rng.rand(B) < 0.5).astype(np.float32)
    for i in np.where(labels > 0.5)[0]:
        w = int(batch.widths[i])
        batch.images[i, :, :w] = batch.images[i, :, :w][::-1, ::-1]
    return labels


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, element-wise."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


def cls_optimizer(model: torch.nn.Module, lr: float, steps: int) -> Adam:
    """ocrjax's cls tx: Adam with cosine decay to 0.1 * lr, no clip."""
    return Adam(trainable(model), cosine_decay_schedule(lr, steps, alpha=0.1),
                clip=None)


def make_cls_train_step(model, opt: Adam, mean: float = 0.5,
                        std: float = 0.5, antisym: float = 0.0):
    """-> step(images u8 (B, H, W), widths (B,), labels (B,)) -> loss,
    device tensors in; updates the model and optimizer in place. mean/std
    are the serving config's rec_mean/rec_std. antisym > 0 adds
    antisym * mean((l(s) + l(rot180 s))^2) and the rotated copy's own BCE
    (labels inverted), averaged with the plain BCE."""

    red = opt.sync         # batch-wide means (sharded under a mesh)
    prepare, apply = halves(opt)

    def body(images, widths, labels, mean, std, antisym):
        opt.zero_grad()
        x = preprocess.rec_normalize(images, mean, std)
        logits = model(x, widths)
        bce = red.mean(sigmoid_bce(logits, labels))
        if antisym <= 0:
            loss = bce
        else:
            pad = (0.0 - mean) / std
            rot = flip_strips_by_width(
                x[:, 0], widths, torch.ones(x.shape[0], dtype=torch.bool,
                                            device=x.device), pad)
            l_rot = model(rot[:, None], widths)
            bce_rot = red.mean(sigmoid_bce(l_rot, 1.0 - labels))
            loss = (0.5 * (bce + bce_rot)
                    + antisym * red.mean((logits + l_rot) ** 2))
        loss.backward()
        apply()
        return loss.detach()

    program = graphs.StepProgram(body, "cls_train_step",
                                 lambda: step_state(model, opt))

    def step(images, widths, labels):
        model.train()
        prepare()
        return program(images, widths, labels, float(mean), float(std),
                       float(antisym))

    step.program = program
    return step


def cls_logits(model, images, widths, mean: float = 0.5,
               std: float = 0.5) -> torch.Tensor:
    """The evaluation forward: the flip logits (B,) of uint8 strips in eval
    mode, one program of the model (captured once per batch shape on the
    card); the program's static output."""
    model.eval()

    @torch.inference_mode()
    def forward(images, widths, mean, std):
        return model(preprocess.rec_normalize(images, mean, std), widths)

    return graphs.owned_program(model, "cls_eval", forward)(
        images, widths, float(mean), float(std))


def train_cls(
    config: Optional[OcrConfig] = None,
    charset: Optional[Charset] = None,
    steps: int = 1500,
    batch_size: int = 64,
    widths: tuple = (64, 128, 192, 320),
    lr: float = 1e-3,
    seed: int = 0,
    eval_batches: int = 20,
    log_every: int = 200,
    verbose: bool = False,
    engine=None,
    crop_pages: int = 48,
    p_crop: float = 0.5,
    mesh=None,
    antisym: float = 0.5,
    device: str = "cuda",
) -> ClsTrainResult:
    """ocrjax's train_cls: batches cycle through the width buckets;
    with an engine, p_crop of them are real refined detector crops
    (train.det_crops) and accuracy is taken on held-out crops. Returns the
    variables in flax's flat layout, the loss history and accuracy. mesh:
    as train_rec's; the accuracy is every rank's, on the whole eval
    batches."""
    from ocrjax_torch.train import det_crops as DC

    if mesh is not None:
        from ocrjax_torch.parallel import mesh as M
        device = str(M.mesh_device(mesh))
    dev = train_device(device)
    config = config or OcrConfig()
    charset = charset or default_charset()
    crop_sets = []
    if engine is not None:
        for ci, w in enumerate(w for w in widths if w >= 128):
            crop_sets.append(DC.generate_det_crops(
                engine, n_pages=crop_pages, width=w, seed=seed + 31 * ci,
                p_word=0.5))
            if verbose:
                print(f"det crops @width {w}: "
                      f"{len(crop_sets[-1].texts)} strips", flush=True)
    model = create_cls(config)
    W.init_random_(model, seed)
    model.to(dev)
    rng = np.random.RandomState(seed)
    opt = cls_optimizer(model, lr, steps)
    if mesh is not None:
        M.prepare_training(mesh, model, opt)
    step = make_cls_train_step(model, opt, config.rec_mean, config.rec_std,
                               antisym=antisym)

    def batch_kwargs(width):
        # longer buckets hold longer text (about 12 px a char at h=32)
        return dict(p_space=0.2, p_word=0.5, noise=0.02, quantize_p=0.3,
                    max_rotation=3.0, max_len=max(4, width // 12))

    def make_batch(i):
        if crop_sets and rng.rand() < p_crop:
            return DC.sample_batch(crop_sets[i % len(crop_sets)], charset,
                                   rng, batch_size)
        w = widths[i % len(widths)]
        lb = synth.make_line_batch(rng, charset, batch_size, w,
                                   height=config.rec_height,
                                   **batch_kwargs(w))
        snap_rows_to_ink(rng, lb)
        return lb

    def put(*arrays):
        return tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in arrays)

    history = []
    for it in range(steps):
        lb = make_batch(it)
        labels = flip_half(rng, lb)
        if mesh is not None:
            loss = step(*M.shard_batch(mesh, (lb.images, lb.widths, labels)))
        else:
            loss = step(*put(lb.images, lb.widths, labels))
        if it % log_every == 0:
            history.append((it, float(loss)))
            if verbose:
                print(f"cls step {it}: loss {float(loss):.4f}", flush=True)

    eval_crops = []
    if engine is not None:
        # held-out crops (fresh pages, disjoint seed)
        eval_crops.append(DC.generate_det_crops(
            engine, n_pages=max(8, crop_pages // 4), width=192,
            seed=seed + 7777, p_word=0.5))
    hits = total = 0
    for b in range(eval_batches):
        if eval_crops:
            lb = DC.sample_batch(eval_crops[b % len(eval_crops)], charset,
                                 rng, batch_size)
        else:
            w = widths[b % len(widths)]
            lb = synth.make_line_batch(rng, charset, batch_size, w,
                                       height=config.rec_height,
                                       **batch_kwargs(w))
            snap_rows_to_ink(rng, lb)
        labels = flip_half(rng, lb)
        logits = cls_logits(model, *put(lb.images, lb.widths),
                            config.rec_mean, config.rec_std)
        pred = logits.cpu().numpy() > 0.0
        hits += int((pred == (labels > 0.5)).sum())
        total += len(labels)
    variables = W.model_variables(model) if mesh is None \
        else M.model_variables(mesh, model)
    return ClsTrainResult(variables=variables, history=history,
                          accuracy=hits / max(total, 1))
