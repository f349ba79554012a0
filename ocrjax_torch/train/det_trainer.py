"""DB detector training (port of ocrjax/train/det_trainer.py).

DB loss = OHEM-balanced BCE on the prob map (hard-negative ratio 3:1)
        + dice loss on the differentiable binary map
        + 10 x masked L1 on the threshold map,
one step of forward (BatchNorm in flax's train mode), loss, autograd,
clip-by-global-norm and Adam, updating the model and optimizer in place.
eval_detection scores extract_boxes (K1 on the card) against the
synthetic ground truth.

Differences from ocrjax, by design: a model without init_variables starts
from weights.init_random_, not from flax's initializers. With mesh= the
step runs dp-sharded as train_rec's does (parallel.mesh): BatchNorm's
statistics and db_loss's ratios are taken over the whole batch; the
detector replicates over tp.
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
from ocrjax_torch.models.db import create_db
from ocrjax_torch.train import det_gt
from ocrjax_torch.train.optim import (Adam, Local, halves, step_state,
                                      train_device, trainable,
                                      trainer_schedule)

OHEM_RATIO = 3.0


def quantile_rows(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-row linear-interpolation quantile of (B, N) float32 rows at q
    (B,), as jnp.quantile evaluates it on XLA:CPU: position q * (N - 1) in
    float32, and low * (1 - w) + high * w with the high term fused into
    the sum (one rounding of high * w + round(low * (1 - w))). OHEM
    compares every loss with this cut by >=, so a cut one ulp off moves a
    whole run of tied losses in or out. torch.quantile is not used: it
    caps its input size and rounds the interpolation otherwise."""
    B, N = x.shape
    s, _ = torch.sort(x, dim=1)
    pos = q.float() * float(N - 1)
    lo = torch.floor(pos)
    hw = pos - lo
    lw = 1.0 - hw
    lo_i = lo.long().clamp(0, N - 1)
    hi_i = torch.ceil(pos).long().clamp(0, N - 1)
    lv = torch.gather(s, 1, lo_i[:, None])[:, 0]
    hv = torch.gather(s, 1, hi_i[:, None])[:, 0]
    return (hv.double() * hw.double() + (lv * lw).double()).float()


def ohem_negatives(bce: torch.Tensor, gt_shrink: torch.Tensor
                   ) -> torch.Tensor:
    """(B, H, W) 0/1 mask of the hard negatives: per image, the negatives
    whose BCE is >= the (1 - k/N) quantile of the negative BCE, k =
    min(#negatives, 3 #positives + 64) clipped to [1, N - 1]."""
    neg = 1.0 - gt_shrink
    n_pos = torch.sum(gt_shrink, dim=(1, 2), keepdim=True)
    n_neg_keep = torch.minimum(torch.sum(neg, dim=(1, 2), keepdim=True),
                               n_pos * OHEM_RATIO + 64.0)
    neg_bce = bce * neg
    B = bce.shape[0]
    flat = neg_bce.reshape(B, -1)
    N = flat.shape[1]
    k = torch.clamp(n_neg_keep.reshape(B), 1.0, N - 1.0)
    cut = quantile_rows(flat, 1.0 - k / N)
    return neg * (neg_bce >= cut[:, None, None]).float()


def db_loss(out: Dict[str, torch.Tensor], gt_shrink, gt_thresh, thresh_mask,
            red=Local()):
    """-> (loss, {"prob", "binary", "thresh"}), ocrjax's db_loss: the
    OHEM cut at the (1 - k/N) quantile of the negative BCE (k the hard
    negatives kept), negatives with loss >= cut selected; eps 1e-6 in the
    logs, the dice and the masked L1. Each ratio divides batch-wide sums:
    `red` (train.optim.Local, or a sharded step's MeshSync) sums numerator
    and denominator over the batch; the OHEM cut stays per image."""
    prob, thresh, binary = out["prob"], out["thresh"], out["binary"]
    eps = 1e-6

    # --- OHEM-balanced BCE on prob -----------------------------------------
    bce = -(gt_shrink * torch.log(prob + eps)
            + (1 - gt_shrink) * torch.log(1 - prob + eps))
    pos = gt_shrink
    with torch.no_grad():      # the selection only feeds a comparison
        hard_neg = ohem_negatives(bce, gt_shrink)
    sel = pos + hard_neg
    l_prob = red.sum(torch.sum(bce * sel)) / (red.sum(torch.sum(sel)) + eps)

    # --- dice on binary -----------------------------------------------------
    inter = red.sum(torch.sum(binary * gt_shrink))
    l_bin = 1.0 - 2.0 * inter / (red.sum(torch.sum(binary))
                                 + red.sum(torch.sum(gt_shrink)) + eps)

    # --- masked L1 on thresh ------------------------------------------------
    l_thr = (red.sum(torch.sum(torch.abs(thresh - gt_thresh) * thresh_mask))
             / (red.sum(torch.sum(thresh_mask)) + eps))

    return l_prob + l_bin + 10.0 * l_thr, {
        "prob": l_prob.detach(), "binary": l_bin.detach(),
        "thresh": l_thr.detach()}


def pool_targets(gts, gtt, gtm, hs: int):
    """Full-resolution targets -> the strided head's grid: shrink and
    threshold maps AVERAGE-pooled (soft targets keep thin kernels), the
    mask MAX-pooled, hs x hs windows (ocrjax's reduce_window, VALID)."""
    def windows(m):
        B, H, W = m.shape
        return m[:, :H // hs * hs, :W // hs * hs].reshape(
            B, H // hs, hs, W // hs, hs)
    return (windows(gts).sum(dim=(2, 4)) / float(hs * hs),
            windows(gtt).sum(dim=(2, 4)) / float(hs * hs),
            windows(gtm).amax(dim=(2, 4)))


@dataclasses.dataclass
class DetTrainResult:
    variables: Dict[str, np.ndarray]      # flat flax layout
    history: list
    recall: float
    precision: float


def det_optimizer(model: torch.nn.Module, lr: float, steps: int) -> Adam:
    """ocrjax's det tx: clip_by_global_norm(5.0), then Adam with warmup
    and cosine decay over `steps`."""
    return Adam(trainable(model), trainer_schedule(lr, steps), clip=5.0)


def make_det_train_step(model, opt: Adam, cfg) -> Callable:
    """-> step(images u8 (B, S, S, 3), gt_shrink, gt_thresh, thresh_mask
    (B, S, S) float32) -> (loss, parts), device tensors in; a strided head
    (the model's head stride) is supervised on pooled targets. The device
    work is one graphs.StepProgram, as make_train_step's (rec_trainer);
    loss and parts are its static outputs."""
    hs = model.arch["head_stride"]
    prepare, apply = halves(opt)

    def body(images_u8, gts, gtt, gtm, hs, mean, std):
        opt.zero_grad()
        x = preprocess.det_normalize(images_u8, mean, std)
        out = model(x)
        if hs > 1:
            gts, gtt, gtm = pool_targets(gts, gtt, gtm, hs)
        loss, parts = db_loss(out, gts, gtt, gtm, opt.sync)
        loss.backward()
        apply()
        return loss.detach(), parts

    program = graphs.StepProgram(body, "det_train_step",
                                 lambda: step_state(model, opt))

    def step(images_u8, gts, gtt, gtm):
        model.train()
        prepare()
        return program(images_u8, gts, gtt, gtm, hs, tuple(cfg.det_mean),
                       tuple(cfg.det_std))

    step.program = program
    return step


def eval_detection(model, cfg, charset, rng, n_pages=8, size=None,
                   iou_thresh=0.5):
    """Recall / precision of extract_boxes against synthetic GT quads
    (pages rendered with train.synth: host only). The forward and the box
    extraction (K1 on the card) are one program of the model, captured
    once per page size and config on the card; the thresholds go in as
    a (4,) tensor, as the serving programs take them."""
    from ocrjax_torch import geometry
    from ocrjax_torch.postprocess import db_boxes
    from ocrjax_torch.train import synth

    size = size or cfg.det_max_side
    device = next(model.parameters()).device
    model.eval()

    @torch.inference_mode()
    def forward(img_u8, thr, cfg):
        x = preprocess.det_normalize(img_u8, cfg.det_mean, cfg.det_std)
        return db_boxes.extract_boxes(
            model(x)["prob"], thresholds=thr,
            **db_boxes.static_kwargs_from_config(cfg))

    program = graphs.owned_program(model, "det_eval", forward)
    thr = torch.from_numpy(np.asarray(
        [cfg.det_thresh, cfg.det_box_thresh, cfg.det_unclip_ratio,
         float(cfg.det_min_box_size)], np.float32)).to(device)
    key = graphs.config_key(cfg)
    tp = fp = fn = 0
    for _ in range(n_pages):
        page, gt_quads, _ = synth.render_page(
            rng, charset, size=(size, size))
        img = np.repeat(page[..., None], 3, axis=2)
        cand = program(torch.from_numpy(img[None]).to(device), thr, key)
        valid = cand["valid"][0].cpu().numpy()
        boxes = cand["boxes"][0].cpu().numpy()[valid]
        matched = set()
        for gt in gt_quads:
            best, best_iou = None, 0.0
            for i, bx in enumerate(boxes):
                iou = geometry.quad_iou_aabb(gt, bx)
                if iou > best_iou:
                    best, best_iou = i, iou
            if best is not None and best_iou >= iou_thresh \
                    and best not in matched:
                matched.add(best)
                tp += 1
            else:
                fn += 1
        fp += len(boxes) - len(matched)
    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    return recall, precision


def train_det(
    config: Optional[OcrConfig] = None,
    charset: Optional[Charset] = None,
    steps: int = 1200,
    batch_size: int = 8,
    size: int = 320,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 50,
    log: Callable[[str], None] = print,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 500,
    p_word: float = 0.0,
    init_variables=None,
    degrade: float = 0.0,
    p_dense: float = 0.0,
    arch: Optional[Dict] = None,
    mesh=None,
    device: str = "cuda",
) -> DetTrainResult:
    """ocrjax's train_det: `size`-px synthetic pages (det_gt.make_det_batch
    with p_word, degrade, p_dense); arch builds a variant detector
    (models.db.DB_ARCHS, e.g. the tile detector) whose head stride flows
    into the config; init_variables warm-starts; checkpoints as train_rec.
    Returns the variables in flax's flat layout, the loss history and
    eval_detection's recall and precision. mesh: as train_rec's."""
    if mesh is not None:
        from ocrjax_torch.parallel import mesh as M
        log, device = M.rank0_log(log), str(M.mesh_device(mesh))
    dev = train_device(device)
    config = config or OcrConfig()
    charset = charset or default_charset()
    if arch is not None:
        config = config.replace(
            det_head_stride=int(arch.get("head_stride", 1)))
        model = create_db(config, arch)
    else:
        model = create_db(config)
    if init_variables is not None:
        W.load_model_variables(model, W.flatten(init_variables))
    else:
        W.init_random_(model, seed)
    model.to(dev)
    opt = det_optimizer(model, lr, steps)

    start_step = 0
    if ckpt_dir:
        from ocrjax_torch.train import checkpoint as C
        latest = C.latest_checkpoint(ckpt_dir, "det_")
        if latest:
            start_step = C.load_train_state(latest, model, opt)
            log(f"[det] resumed from {latest} at step {start_step}")
    if mesh is not None:
        M.prepare_training(mesh, model, opt)
    step_fn = make_det_train_step(model, opt, config)
    rng = np.random.RandomState(seed + start_step)

    history = []
    t0 = time.time()
    for step in range(start_step + 1, steps + 1):
        imgs, gts, gtt, gtm = det_gt.make_det_batch(
            rng, charset, batch_size, size, p_word=p_word,
            degrade=degrade, p_dense=p_dense)
        batch = (imgs, gts, gtt, gtm)
        loss, parts = step_fn(*(
            M.shard_batch(mesh, batch) if mesh is not None
            else (torch.from_numpy(a).to(dev) for a in batch)))
        if step % log_every == 0 or step == steps:
            history.append((step, float(loss)))
            log(f"[det {step}/{steps}] loss={float(loss):.4f} "
                f"prob={float(parts['prob']):.3f} "
                f"bin={float(parts['binary']):.3f} "
                f"thr={float(parts['thresh']):.3f} "
                f"({time.time() - t0:.0f}s)")
        if ckpt_dir and (step % ckpt_every == 0 or step == steps):
            from ocrjax_torch.train import checkpoint as C
            os.makedirs(ckpt_dir, exist_ok=True)
            path = os.path.join(ckpt_dir, f"det_{step}.safetensors")
            if mesh is None:
                C.save_train_state(path, step, model, opt)
            else:
                M.save_train_state(mesh, path, step, model, opt)

    eval_rng = np.random.RandomState(seed + 999)
    recall, precision = eval_detection(model, config, charset, eval_rng,
                                       size=size)
    log(f"[det] eval recall={recall:.3f} precision={precision:.3f}")
    variables = W.model_variables(model) if mesh is None \
        else M.model_variables(mesh, model)
    return DetTrainResult(variables, history, recall, precision)
