"""Prob map -> oriented text boxes, batched over pages: a frozen copy of
the plain box extraction and its fixed-sweep labeling (the CCL contract:
8-connected, label = the smallest linear index reached in exactly
`n_iters` sweeps of row run-min, column run-min and 3x3 min; BIG on
background).

Per page: binarize, label components (on an OR-pooled coarse grid when
cc_downsample > 1), take the C smallest component roots (raster order),
accumulate each component's moments, orient its box along the PCA axis
(borrowing the page's dominant angle for near-square components), measure
its extents along that axis, unclip, and filter by score and size.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

import torch.nn.functional as F

BIG = 2 ** 30


def _shift(x: torch.Tensor, k: int, dim: int, fill, reverse: bool):
    """x moved k places along dim (toward higher indices, or lower when
    reverse); the k vacated places take `fill`."""
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = min(k, n)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if reverse:
        return torch.cat([x.narrow(dim, k, n - k), pad], dim) if k < n else pad
    return torch.cat([pad, x.narrow(dim, 0, n - k)], dim) if k < n else pad


def _seg_scan(lab: torch.Tensor, fg: torch.Tensor, dim: int, reverse: bool):
    """Inclusive segmented min-scan along dim (Hillis-Steele doubling);
    background elements are segment boundaries. Out-of-range neighbours
    read (BIG, no boundary), which keeps an element as it is."""
    v = lab
    f = ~fg
    k = 1
    while k < lab.shape[dim]:
        v_n = _shift(v, k, dim, BIG, reverse)
        f_n = _shift(f, k, dim, False, reverse)
        v = torch.where(f, v, torch.minimum(v, v_n))
        f = f | f_n
        k *= 2
    return v


def _run_min(lab, fg, dim: int):
    fwd = _seg_scan(lab, fg, dim, reverse=False)
    bwd = _seg_scan(lab, fg, dim, reverse=True)
    return torch.where(fg, torch.minimum(fwd, bwd), BIG)


def _neighbor_min(lab: torch.Tensor) -> torch.Tensor:
    """3x3 window min, BIG outside the grid."""
    H, W = lab.shape[-2:]
    p = F.pad(lab, (1, 1, 1, 1), value=BIG)
    out = lab
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, p[..., dy:dy + H, dx:dx + W])
    return out


def label_components_torch(bitmap: torch.Tensor, n_iters: int = 4
                           ) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W) -> (B, H, W) int32 labels."""
    fg = bitmap.bool()
    H, W = fg.shape[-2:]
    lin = torch.arange(H * W, dtype=torch.int32,
                       device=fg.device).reshape(H, W)
    lab = torch.where(fg, lin, BIG)
    for _ in range(n_iters):
        lab = _run_min(lab, fg, dim=-1)
        lab = _run_min(lab, fg, dim=-2)
        lab = torch.where(fg, torch.minimum(lab, _neighbor_min(lab)), BIG)
    return lab


_HALF_PI = float(torch.tensor(math.pi / 2.0, dtype=torch.float32))


def _wrap_half(a: torch.Tensor) -> torch.Tensor:
    """Wrap an axis-angle difference to [-pi/2, pi/2) (floor mod)."""
    return torch.remainder(a + _HALF_PI, 2.0 * _HALF_PI) - _HALF_PI


def extract_boxes(prob: torch.Tensor, *, thresh: float = 0.3,
                  box_thresh: float = 0.6, unclip_ratio: float = 1.5,
                  max_candidates: int = 256, min_box_size: float = 3,
                  cc_iters: int = 4, cc_downsample: int = 1,
                  coord_stride: int = 1, angle_aniso_floor: float = 0.30,
                  angle_flip_below: float = 0.75,
                  angle_coherence_min: float = 0.75,
                  thresholds: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """prob (B, H, W) float -> {'boxes' (B, C, 4, 2) float32 TL,TR,BR,BL in
    canvas pixels, 'scores' (B, C) mean prob, 'valid' (B, C) bool}.
    coord_stride: canvas pixels per prob-map pixel. thresholds: a (4,)
    float32 tensor on prob's device, (thresh, box_thresh, unclip_ratio,
    min_box_size), in place of the four floats: the reference's traced
    thresholds, so that a captured program takes new values without a
    new capture; the result is the float call's, bit for bit."""
    traced = thresholds is not None
    if traced:
        thresh, box_thresh, unclip_ratio, min_box_size = thresholds.unbind()
    B, H, W = prob.shape
    C = max_candidates
    dev = prob.device
    prob = prob.float()
    fg = prob > thresh

    d = cc_downsample
    if d > 1:
        if H % d or W % d:
            raise ValueError(f"H, W must be multiples of cc_downsample={d}")
        fg_c = fg.reshape(B, H // d, d, W // d, d).any(dim=4).any(dim=2)
        labels_c = label_components_torch(fg_c, cc_iters)
        # the stats sample one pixel per coarse cell, where the repeated
        # coarse labels are labels_c itself
        labels_s = labels_c
    else:
        labels_s = label_components_torch(fg, cc_iters)
    s_ = d if d > 1 else 1
    fg_s = fg[:, ::s_, ::s_]
    prob_s = prob[:, ::s_, ::s_]
    Hs_, Ws_ = fg_s.shape[-2:]
    roots = labels_s.reshape(B, -1)
    lin = torch.arange(Hs_ * Ws_, dtype=torch.int32, device=dev)
    flat_lab = torch.where(fg_s.reshape(B, -1), roots, BIG)
    root_vals = torch.where(roots == lin, roots, BIG)
    # the C smallest roots == the first C components in raster order
    root_ids = torch.sort(root_vals, dim=1).values[:, :C].contiguous()
    has_comp = root_ids < BIG

    # each pixel's component slot (C = none): the C roots are sorted, so a
    # binary search finds it. Background pixels match every empty slot
    # (root BIG), as in the reference's (pixel, slot) mask; the sums below
    # fill the first empty slot and copy it to the others.
    slot = torch.searchsorted(root_ids, flat_lab)             # (B, P)
    slot_c = torch.clamp(slot, max=C - 1)
    match = (slot < C) & (torch.gather(root_ids, 1, slot_c) == flat_lab)
    slot = torch.where(match, slot_c, C)
    first_empty = torch.clamp(has_comp.sum(dim=1, keepdim=True), max=C - 1)
    src_slot = torch.where(has_comp, torch.arange(C, device=dev),
                           first_empty)

    def per_slot(t):  # (B, C + 1, ...) sums -> (B, C, ...), empty slots
        idx = src_slot.reshape(src_slot.shape + (1,) * (t.dim() - 2))
        return torch.gather(t, 1, idx.expand((B, C) + t.shape[2:]))

    # moments, accumulated in float64: the second moments of a short
    # component far from the canvas centre cancel (var = E[x^2] - E[x]^2)
    # and a float32 sum in another order moves its box by hundredths of a
    # pixel; float64 holds every device to the exact sums
    ys = (lin // Ws_).float() * s_
    xs = (lin % Ws_).float() * s_
    pv = prob_s.reshape(B, -1)
    xc = xs - (W - 1) / 2.0
    yc = ys - (H - 1) / 2.0
    base = torch.stack([torch.ones_like(xs), xc, yc, xc * xc, yc * yc,
                        xc * yc], dim=1)                      # (P, 6)
    vals = torch.cat([base.expand(B, -1, -1), pv[..., None]], dim=2)
    sums = torch.zeros((B, C + 1, 7), dtype=torch.float64, device=dev)
    sums.scatter_add_(1, slot[..., None].expand(-1, -1, 7), vals.double())
    moments = per_slot(sums).float()                          # (B, C, 7)
    cnt, sx, sy, sxx, syy, sxy, sp = moments.unbind(dim=2)

    n = torch.clamp(cnt, min=1.0)
    mx, my = sx / n, sy / n
    # a - b * c rounded once, as XLA contracts it into a fused multiply-add:
    # far from the centre the two terms cancel, and a separately rounded
    # product tilts a long box by tenths of a degree
    def fms(a, b, c):
        return (a.double() - b.double() * c.double()).float()
    cxx = fms(sxx / n, mx, mx)
    cyy = fms(syy / n, my, my)
    cxy = fms(sxy / n, mx, my)
    theta = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)

    # near-square components borrow the page's dominant axis (see
    # ocrjax/postprocess/db_boxes.py for the measurements)
    score = sp / n
    lam_gap = torch.sqrt((cxx - cyy) ** 2 + 4.0 * cxy * cxy)
    aniso = lam_gap / torch.clamp(cxx + cyy, min=1e-6)
    w_page = torch.where(
        has_comp & (score >= box_thresh) & (aniso >= angle_flip_below),
        cnt, 0.0)
    sin_sum = (w_page * torch.sin(2.0 * theta)).sum(dim=1, keepdim=True)
    cos_sum = (w_page * torch.cos(2.0 * theta)).sum(dim=1, keepdim=True)
    theta_page = 0.5 * torch.atan2(sin_sum, cos_sum)
    w_sum = w_page.sum(dim=1, keepdim=True)
    res_len = torch.sqrt(sin_sum ** 2 + cos_sum ** 2) \
        / torch.clamp(w_sum, min=1e-6)
    coherent = (res_len >= angle_coherence_min) | (w_sum <= 1e-6)
    d_own = _wrap_half(theta - theta_page)
    d_flip = _wrap_half(theta + _HALF_PI - theta_page)
    theta_r = torch.where(
        coherent & (aniso < angle_flip_below)
        & (torch.abs(d_flip) < torch.abs(d_own)),
        theta + _HALF_PI, theta)
    theta = torch.where(coherent & (aniso < angle_aniso_floor),
                        theta_page, theta_r)
    theta = _wrap_half(theta)
    ct, st = torch.cos(theta), torch.sin(theta)

    # extents along each component's axis: per-pixel projection onto its own
    # component's axis, reduced with scatter min/max (exact, order-free)
    ct_p = torch.gather(ct, 1, slot_c.long())
    st_p = torch.gather(st, 1, slot_c.long())
    u_p = xs * ct_p + ys * st_p
    v_p = -xs * st_p + ys * ct_p
    inf = float("inf")

    def reduce(vals_p, how, init):
        out = torch.full((B, C + 1), init, device=dev)
        return out.scatter_reduce(1, slot, vals_p, how)

    umin, umax = reduce(u_p, "amin", inf), reduce(u_p, "amax", -inf)
    vmin, vmax = reduce(v_p, "amin", inf), reduce(v_p, "amax", -inf)
    umin, umax, vmin, vmax = (per_slot(t[..., None])[..., 0]
                              for t in (umin, umax, vmin, vmax))
    if s_ > 1:
        # strided sampling biases extents tight by up to s-1 px per side
        pad_ = float(s_ - 1)
        umin, umax = umin - pad_, umax + pad_
        vmin, vmax = vmin - pad_, vmax + pad_
    none_ = cnt < 0.5
    umin = torch.where(none_, 0.0, umin)
    umax = torch.where(none_, 0.0, umax)
    vmin = torch.where(none_, 0.0, vmin)
    vmax = torch.where(none_, 0.0, vmax)

    bw = torch.where(has_comp, umax - umin + 1.0, 0.0)
    bh = torch.where(has_comp, vmax - vmin + 1.0, 0.0)
    valid = has_comp & (cnt > 0) & (score >= box_thresh) \
        & (torch.minimum(bw, bh) * coord_stride >= min_box_size)

    # unclip: classic DB ratio rule, or (ratio <= 0) the exact inversion of
    # the training-time shrink
    area = bw * bh
    perim = 2.0 * (bw + bh)
    def ratio_delta():
        return area * unclip_ratio / torch.clamp(perim, min=1e-6)

    def invert_delta():
        s2 = bw + bh
        disc = (0.32 * s2) ** 2 + 4.0 * 4.64 * 0.84 * area
        return (-0.32 * s2 + torch.sqrt(disc)) / (2.0 * 4.64)

    if traced:      # both computed, each element as the branch gives it
        delta = torch.where(unclip_ratio > 0, ratio_delta(), invert_delta())
    elif unclip_ratio > 0:
        delta = ratio_delta()
    else:
        delta = invert_delta()
    umin, umax = umin - delta, umax + delta
    vmin, vmax = vmin - delta, vmax + delta

    us = torch.stack([umin, umax, umax, umin], dim=2)         # (B, C, 4)
    vs = torch.stack([vmin, vmin, vmax, vmax], dim=2)
    bx = us * ct[..., None] - vs * st[..., None]
    by = us * st[..., None] + vs * ct[..., None]
    boxes = torch.stack([bx, by], dim=-1)                     # (B, C, 4, 2)
    if coord_stride > 1:
        boxes = boxes * coord_stride + 0.5 * (coord_stride - 1)
    # each axis clamped with Python bounds (integers float32 holds
    # exactly): a bound tensor made from a list would be a blocking copy
    boxes = torch.stack([
        boxes[..., 0].clamp(0.0, float(W * coord_stride - 1)),
        boxes[..., 1].clamp(0.0, float(H * coord_stride - 1))], dim=-1)
    return {"boxes": boxes, "scores": score, "valid": valid}


def static_kwargs_from_config(cfg) -> Dict:
    """The structural extract_boxes params implied by a config: with a
    strided det head the residual CCL downsample is det_cc_downsample /
    det_head_stride."""
    hs = getattr(cfg, "det_head_stride", 1)
    return dict(max_candidates=cfg.det_max_candidates,
                cc_iters=cfg.det_cc_iters,
                cc_downsample=max(1, cfg.det_cc_downsample // hs),
                coord_stride=hs)

