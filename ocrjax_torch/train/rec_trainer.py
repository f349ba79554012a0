"""CRNN training on synthetic rendered text (port of
ocrjax/train/rec_trainer.py).

The step is forward (BatchNorm in flax's train mode) + CTC loss (optax's
recursion, ops.ctc.ctc_loss) + clip-by-global-norm + Adam, with autograd
for the backward pass, updating the model and the optimizer in place.
Batches come from train.synth, which renders on the host (PIL): on the
card's machine, which has no PIL, the step functions run on batches
rendered elsewhere (testdata/train_batches.npz).

Differences from ocrjax, by design: a model without init_variables starts
from weights.init_random_, not from flax's initializers. With mesh= (a
parallel.mesh.make_mesh mesh; one process a rank, all running train_rec)
the same step runs dp(+tp)-sharded: every rank renders the whole batch and
takes its dp slice, and only global rank 0 logs and writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ocrjax_torch import graphs, preprocess
from ocrjax_torch import weights as W
from ocrjax_torch.charset import Charset, default_charset
from ocrjax_torch.config import OcrConfig
from ocrjax_torch.models.crnn import create_crnn
from ocrjax_torch.ops import ctc
from ocrjax_torch.train import synth
from ocrjax_torch.train.optim import (Adam, halves, step_state, train_device,
                                      trainable, trainer_schedule)


@dataclasses.dataclass
class TrainResult:
    variables: Dict[str, np.ndarray]      # flat flax layout
    history: list
    exact_match: float


def rec_optimizer(model: torch.nn.Module, lr: float, steps: int) -> Adam:
    """ocrjax's rec tx: clip_by_global_norm(5.0), then Adam with warmup
    and cosine decay over `steps`."""
    return Adam(trainable(model), trainer_schedule(lr, steps), clip=5.0)


def make_train_step(model, opt: Adam, ent_reg: float = 0.0) -> Callable:
    """-> step(images u8 (B, H, W), widths (B,), labels (B, U), label_lengths
    (B,)) -> loss, device tensors in; the model's parameters, BatchNorm
    statistics and the optimizer state are updated in place.

    ent_reg > 0 subtracts ent_reg times the mean frame entropy over valid
    frames (ocrjax's soft-posterior term). Batch-wide reductions go through
    opt.sync, so the same step runs sharded (parallel.mesh).

    The device work is one graphs.StepProgram, ocrjax's jitted step: on
    the card captured once per batch shape and replayed (graphs.eager()
    runs it op by op); the optimizer's host half (Adam.prepare) runs
    before it at every step. The loss is the program's static output,
    which the next step overwrites."""
    red = opt.sync
    prepare, apply = halves(opt)

    def body(images, widths, labels, label_lengths, ent_reg):
        opt.zero_grad()
        x = preprocess.rec_normalize(images)
        logits, frame_lengths = model(x, widths)
        loss = red.mean(ctc.ctc_loss_per_seq(logits, frame_lengths, labels,
                                             label_lengths))
        if ent_reg > 0:
            logp = torch.log_softmax(logits.float(), dim=-1)
            ent = -torch.sum(torch.exp(logp) * logp, dim=-1)      # (B, T)
            t = torch.arange(logits.shape[1], device=logits.device)
            mask = (t[None, :] < frame_lengths[:, None]).float()
            loss = loss - ent_reg * (
                red.sum(torch.sum(ent * mask))
                / torch.clamp(red.sum(mask.sum()), min=1.0))
        loss.backward()
        apply()
        return loss.detach()

    program = graphs.StepProgram(body, "rec_train_step",
                                 lambda: step_state(model, opt))

    def step(images, widths, labels, label_lengths):
        model.train()      # flax's BN train mode; cuDNN's LSTM backward
        prepare()
        return program(images, widths, labels, label_lengths,
                       float(ent_reg))

    step.program = program
    return step


def evaluate_exact_match(model, charset, batches) -> float:
    """Fraction of lines whose greedy decode equals the ground-truth text.
    The forward and the decode are one program of the model (captured once
    per batch shape on the card)."""
    model.eval()
    device = next(model.parameters()).device

    @torch.inference_mode()
    def forward(images, widths):
        logits, fl = model(preprocess.rec_normalize(images), widths)
        toks, n, _ = ctc.ctc_greedy_decode(logits, fl, max_tokens=64)
        return toks, n

    program = graphs.owned_program(model, "rec_eval", forward)
    hits = total = 0
    for lb in batches:
        toks, n = program(torch.from_numpy(lb.images).to(device),
                          torch.from_numpy(lb.widths).to(device))
        toks, n = toks.cpu().numpy(), n.cpu().numpy()
        for i, text in enumerate(lb.texts):
            hits += int(charset.decode(toks[i][: n[i]]) == text)
            total += 1
    return hits / max(total, 1)


def train_rec(
    config: Optional[OcrConfig] = None,
    charset: Optional[Charset] = None,
    steps: int = 1500,
    batch_size: int = 64,
    width: int = 192,
    lr: float = 1e-3,
    seed: int = 0,
    max_len: int = 10,
    log_every: int = 100,
    log: Callable[[str], None] = print,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 500,
    init_variables=None,
    det_crops=None,
    det_crop_frac: float = 0.5,
    p_space: float = 0.0,
    aug_rotation: float = 0.0,
    char_weights=None,
    quantize_p: float = 0.0,
    p_word: float = 0.0,
    stretch: float = 0.0,
    font_weights=None,
    font_anneal_frac: float = 0.0,
    degrade: float = 0.0,
    degrade_anneal_frac: float = 0.0,
    flat_snap: float = 0.0,
    mesh=None,
    ent_reg: float = 0.0,
    device: str = "cuda",
) -> TrainResult:
    """ocrjax's train_rec: init_variables (flat or nested flax variables,
    e.g. the shipped asset) warm-starts the model; det_crops mixes real
    detector crops into the batches with probability det_crop_frac; the
    augmentation knobs go to synth.make_line_batch, with font_weights and
    degrade switched off for the last font_anneal_frac /
    degrade_anneal_frac of the steps; checkpoints every ckpt_every steps
    and resumes from the latest in ckpt_dir. Returns the final variables
    in flax's flat layout, the loss history and exact match on 4 clean
    eval batches. mesh: see the module docstring; batch_size must be a
    multiple of its dp size."""
    if mesh is not None:
        from ocrjax_torch.parallel import mesh as M
        log, device = M.rank0_log(log), str(M.mesh_device(mesh))
    dev = train_device(device)
    config = config or OcrConfig()
    charset = charset or default_charset()
    model = create_crnn(config, charset.num_classes)
    if init_variables is not None:
        W.load_model_variables(model, W.flatten(init_variables))
    else:
        W.init_random_(model, seed)
    model.to(dev)
    opt = rec_optimizer(model, lr, steps)

    start_step = 0
    if ckpt_dir:
        from ocrjax_torch.train import checkpoint as C
        latest = C.latest_checkpoint(ckpt_dir, "rec_")
        if latest:
            start_step = C.load_train_state(latest, model, opt)
            log(f"[rec] resumed from {latest} at step {start_step}")
    if mesh is not None:
        M.prepare_training(mesh, model, opt)
    rng = np.random.RandomState(seed + start_step)

    def put(*arrays):
        if mesh is not None:
            return M.shard_batch(mesh, arrays)
        return tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in arrays)

    train_step = make_train_step(model, opt, ent_reg=ent_reg)
    history = []
    t0 = time.time()
    for step in range(start_step + 1, steps + 1):
        if det_crops is not None and rng.rand() < det_crop_frac:
            from ocrjax_torch.train.det_crops import sample_batch
            lb = sample_batch(det_crops, charset, rng, batch_size)
        else:
            fw = font_weights
            if (fw is not None and font_anneal_frac > 0
                    and step > steps * (1.0 - font_anneal_frac)):
                fw = None
            dg = degrade
            if (degrade_anneal_frac > 0
                    and step > steps * (1.0 - degrade_anneal_frac)):
                dg = 0.0
            lb = synth.make_line_batch(
                rng, charset, batch_size, width, config.rec_height,
                max_len=max_len, p_space=p_space, max_rotation=aug_rotation,
                char_weights=char_weights, quantize_p=quantize_p,
                p_word=p_word, stretch=stretch, font_weights=fw,
                degrade=dg, flat_snap=flat_snap)
        loss = train_step(*put(lb.images, lb.widths, lb.labels,
                               lb.label_lengths))
        if step % log_every == 0 or step == steps:
            loss = float(loss)
            history.append((step, loss))
            log(f"[rec {step}/{steps}] loss={loss:.4f} "
                f"({time.time() - t0:.0f}s)")
        if ckpt_dir and (step % ckpt_every == 0 or step == steps):
            from ocrjax_torch.train import checkpoint as C
            os.makedirs(ckpt_dir, exist_ok=True)
            path = os.path.join(ckpt_dir, f"rec_{step}.safetensors")
            if mesh is None:
                C.save_train_state(path, step, model, opt)
            else:
                M.save_train_state(mesh, path, step, model, opt)

    eval_rng = np.random.RandomState(seed + 777)
    eval_batches = [
        synth.make_line_batch(eval_rng, charset, 32, width,
                              config.rec_height, max_len=max_len)
        for _ in range(4)
    ]
    em = evaluate_exact_match(model, charset, eval_batches)
    log(f"[rec] eval exact-match: {em:.3f}")
    variables = W.model_variables(model) if mesh is None \
        else M.model_variables(mesh, model)
    return TrainResult(variables, history, em)
