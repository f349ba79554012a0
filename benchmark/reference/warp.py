"""Line-crop warps, a frozen copy of the plain torch warps: quad expansion, the
separable AABB crop+resize as two batched matmuls (per page for the fused
lane, pooled over pages with a row tile for the bucketed lane), the exact
homography warp as a written-out bilinear gather (staged lane, tilted
quads, and grouped per page for the fused program with separable_warp
off), the ink-band probe, the two ink refinements (AABB and homography)
with their two-pass warps, and the strip-space ink snap.

The matmuls must run in float32 without TF32 to agree with the reference;
the reference turns TF32 off.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import flatband


def expand_quads(quads: torch.Tensor, frac_y: float, frac_x: float,
                 bounds=None) -> torch.Tensor:
    """Grow each (..., 4, 2) TL,TR,BR,BL quad outward by a fraction of its
    own height on both axes; clip to [0, bounds] when given (bounds
    broadcasts against the result, e.g. (B, 1, 1, 2) per page)."""
    down = (quads[..., 3, :] + quads[..., 2, :]) \
        - (quads[..., 0, :] + quads[..., 1, :])              # 2 (bottom-top)
    h = torch.sqrt(torch.clamp((down * down).sum(-1), min=1e-12)) * 0.5
    ey = down / (2.0 * h[..., None])
    right = (quads[..., 1, :] + quads[..., 2, :]) \
        - (quads[..., 0, :] + quads[..., 3, :])
    wlen = torch.sqrt(torch.clamp((right * right).sum(-1), min=1e-12)) * 0.5
    ex = right / (2.0 * wlen[..., None])
    my = (frac_y * h)[..., None, None] * ey[..., None, :]     # (..., 1, 2)
    mx = (frac_x * h)[..., None, None] * ex[..., None, :]
    lead = (1,) * (quads.dim() - 2)
    # the corners' signs made on the device: a tensor made from a list is
    # a blocking copy
    c = torch.arange(4, device=quads.device)
    sy = torch.where(c >= 2, 1.0, -1.0).to(quads.dtype).reshape(
        lead + (4, 1))
    sx = torch.where((c == 1) | (c == 2), 1.0, -1.0).to(quads.dtype).reshape(
        lead + (4, 1))
    out = quads + sy * my + sx * mx
    if bounds is not None:
        out = torch.minimum(torch.clamp(out, min=0.0),
                            torch.as_tensor(bounds, dtype=out.dtype,
                                            device=out.device))
    return out


def expand_quads_host(quads: np.ndarray, frac_y: float, frac_x: float,
                      bounds=None) -> np.ndarray:
    """expand_quads for host arrays, with the reference's numpy arithmetic:
    the margins in the quads' dtype (float32), the final sum and the clip in
    float64. The staged and bucketed lanes expand on the host and round to
    float32 at the upload."""
    down = (quads[..., 3, :] + quads[..., 2, :]) \
        - (quads[..., 0, :] + quads[..., 1, :])
    h = np.sqrt(np.maximum((down * down).sum(-1), 1e-12)) * 0.5
    ey = down / (2.0 * h[..., None])
    right = (quads[..., 1, :] + quads[..., 2, :]) \
        - (quads[..., 0, :] + quads[..., 3, :])
    wlen = np.sqrt(np.maximum((right * right).sum(-1), 1e-12)) * 0.5
    ex = right / (2.0 * wlen[..., None])
    my = (frac_y * h)[..., None, None] * ey[..., None, :]
    mx = (frac_x * h)[..., None, None] * ex[..., None, :]
    lead = (1,) * (quads.ndim - 2)
    sy = np.asarray([-1.0, -1.0, 1.0, 1.0]).reshape(lead + (4, 1))
    sx = np.asarray([-1.0, 1.0, 1.0, -1.0]).reshape(lead + (4, 1))
    out = quads + sy * my + sx * mx
    if bounds is not None:
        out = np.clip(out, 0.0, np.asarray(bounds, out.dtype))
    return out


def warp_quads_separable(pages: torch.Tensor, quads: torch.Tensor, *,
                         rec_height: int = 32, bucket_width: int = 320,
                         pad_value: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop+resize each quad's axis-aligned hull: out = Wy @ page @ Wx^T
    with per-strip bilinear (hat) weight matrices. Exact for axis-aligned
    quads; rotated quads are cropped by their AABB.

    pages (B, S, S) float32, quads (B, K, 4, 2) ->
    (strips (B, K, rec_height, bucket_width), widths (B, K) int32).
    """
    S = pages.shape[-1]
    Hh, W = rec_height, bucket_width
    dev = pages.device
    x0 = quads[..., 0].amin(-1)
    x1 = quads[..., 0].amax(-1)
    y0 = quads[..., 1].amin(-1)
    y1 = quads[..., 1].amax(-1)
    widths = torch.clamp(torch.round(
        (x1 - x0 + 1.0) * Hh / torch.clamp(y1 - y0 + 1.0, min=1.0)),
        1, W).to(torch.int32)
    vout = torch.arange(Hh, dtype=torch.float32, device=dev)[:, None]
    uout = torch.arange(W, dtype=torch.float32, device=dev)[:, None]
    src = torch.arange(S, dtype=torch.float32, device=dev)[None, :]

    def col(t):  # (B, K) -> (B, K, 1, 1)
        return t[..., None, None]

    ys = col(y0) + vout * (col(y1) - col(y0)) / (Hh - 1.0)   # (B, K, Hh, 1)
    wy = torch.clamp(1.0 - torch.abs(ys - src), min=0.0)     # (B, K, Hh, S)
    xs = col(x0) + uout * (col(x1) - col(x0)) / torch.clamp(
        col(widths.float()) - 1.0, min=1.0)                  # (B, K, W, 1)
    wx = torch.clamp(1.0 - torch.abs(xs - src), min=0.0)     # (B, K, W, S)
    B, K = quads.shape[:2]
    rows = torch.bmm(wy.reshape(B, K * Hh, S), pages)        # (B, K*Hh, S)
    out = torch.matmul(rows.reshape(B, K, Hh, S),
                       wx.transpose(-1, -2))                 # (B, K, Hh, W)
    mask = torch.arange(W, device=dev)[None, None, None, :] < col(widths)
    return torch.where(mask, out, pad_value), widths


def _argmax_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along dim (0 when none), like jnp.argmax
    on booleans."""
    return torch.argmax(x.to(torch.int32), dim=dim)


def ink_boxes(strips: torch.Tensor, widths: torch.Tensor, *,
              ink_thresh: float = 0.0, min_count: int = 2,
              pad_y: float = 2.0, pad_x: float = 3.0,
              x_lo=None, x_hi=None, gap_fill: float = 0.10,
              flat_frac: float = 0.0, line_h=None):
    """Per-strip padded bbox of the ink band through the vertical centre,
    with blank row gaps of <= max(2, gap_fill H) rows between ink rows
    closed, optional column window [x_lo, x_hi], and the flat-band rescale
    (see ocrjax/ops/warp.py::ink_boxes for the measurements behind it).

    strips (N, H, W) normalized (ink below ink_thresh) ->
    (x0, y0, x1, y1, ok, flat), float strip coords and (N,) bool masks.
    """
    N, H, W = strips.shape
    dev = strips.device
    col_idx = torch.arange(W, device=dev)[None, :]
    col_in = col_idx < widths[:, None]
    if x_lo is not None:
        col_in = col_in & (col_idx.float() >= x_lo[:, None])
    if x_hi is not None:
        col_in = col_in & (col_idx.float() <= x_hi[:, None])
    ink = (strips < ink_thresh) & col_in[:, None, :]          # (N, H, W)

    rows = ink.sum(dim=2) >= min_count                        # (N, H)
    r = torch.arange(H, device=dev)[None, :]
    if gap_fill > 0:
        G = max(int(round(gap_fill * H)), 2)
        la = torch.cummax(torch.where(rows, r, -4 * H), dim=1).values
        fb = torch.cummin(torch.where(rows, r, 4 * H).flip(1),
                          dim=1).values.flip(1)
        rows = rows | ((r - la) + (fb - r) <= G + 1)
    center = H // 2
    empty = ~rows
    last_empty_above = torch.cummax(torch.where(empty, r, -1), dim=1).values
    first_empty_below = torch.cummin(torch.where(empty, r, H).flip(1),
                                     dim=1).values.flip(1)
    band_y0 = last_empty_above[:, center] + 1
    band_y1 = first_empty_below[:, center] - 1
    band_ok = band_y1 >= band_y0
    any_row = rows.any(dim=1)
    g_y0 = _argmax_first(rows, 1)
    g_y1 = H - 1 - _argmax_first(rows.flip(1), 1)
    y0 = torch.where(band_ok, band_y0, g_y0).float()
    y1 = torch.where(band_ok, band_y1, g_y1).float()

    band = (r >= y0[:, None]) & (r <= y1[:, None])
    ink_band = ink & band[:, :, None]
    cols = ink_band.sum(dim=1) >= 1                           # (N, W)
    any_col = cols.any(dim=1)
    x0 = _argmax_first(cols, 1).float()
    x1 = (W - 1 - _argmax_first(cols.flip(1), 1)).float()
    ok = (band_ok | any_row) & any_col

    if flat_frac > 0.0:
        inf = float("inf")
        top = torch.where(cols, _argmax_first(ink_band, 1), H).float()
        bot = torch.where(cols, H - 1 - _argmax_first(ink_band.flip(1), 1),
                          -1).float()
        prev = torch.cat([torch.zeros_like(cols[:, :1]), cols[:, :-1]], 1)
        seg = torch.clamp(torch.cumsum((cols & ~prev).long(), dim=1) - 1,
                          0, W - 1)
        gtop = torch.full((N, W), inf, device=dev).scatter_reduce(
            1, seg, torch.where(cols, top, inf), "amin")
        gbot = torch.full((N, W), -inf, device=dev).scatter_reduce(
            1, seg, torch.where(cols, bot, -inf), "amax")
        gv = torch.isfinite(gtop)
        t_spread = (torch.where(gv, gtop, -inf).amax(1)
                    - torch.where(gv, gtop, inf).amin(1))
        b_spread = (torch.where(gv, gbot, -inf).amax(1)
                    - torch.where(gv, gbot, inf).amin(1))
        ih = y1 - y0 + 1.0
        tol = torch.clamp(flatband.FLAT_TOL_FRAC * ih, min=2.0)
        n_glyphs = gv.sum(dim=1)
        flat = (ok & (t_spread <= tol) & (b_spread <= tol)
                & (n_glyphs <= flatband.FLAT_MAX_GLYPHS))
        if line_h is not None:
            flat = flat & (ih <= flatband.FLAT_CASE_MAX_FRAC * line_h)
        yc = (y0 + y1) * 0.5
        half = ih / (2.0 * flat_frac)
        y0 = torch.where(flat, yc - half, y0)
        y1 = torch.where(flat, yc + half, y1)
    else:
        flat = torch.zeros((N,), dtype=torch.bool, device=dev)
    return x0 - pad_x, y0 - pad_y, x1 + pad_x, y1 + pad_y, ok, flat


def _ink_x_window(widths, m_left, m_right, keep: float):
    """Allowed ink-column window: ink may reach keep * margin into each
    side's expansion margin (margins are per side)."""
    return (m_left * (1.0 - keep),
            widths.float() - 1.0 - m_right * (1.0 - keep))


def _shift_into_bounds(quads: torch.Tensor, bounds: torch.Tensor
                       ) -> torch.Tensor:
    """Translate each quad to fit [0, bounds] before the clip, keeping its
    size (flat-band expansions may poke past the page edge)."""
    lo = torch.clamp(-quads.amin(dim=-2, keepdim=True), min=0.0)
    hi = torch.clamp(quads.amax(dim=-2, keepdim=True) - bounds, min=0.0)
    return quads + lo - hi


def refine_aabb_to_ink(strips: torch.Tensor, widths: torch.Tensor,
                       quads: torch.Tensor, *, rec_height: int,
                       ink_thresh: float = 0.0, min_count: int = 2,
                       pad_y: float = 2.0, pad_x: float = 3.0,
                       bounds=None, margin_fracs=None,
                       x_margin_keep: float = 1.0, orig_quads=None,
                       flat_frac: float = 0.0, case_gate: bool = False
                       ) -> torch.Tensor:
    """Two-pass refinement matching warp_quads_separable's linear
    strip<->page map: the probe strip's ink band mapped back to the page as
    a rectangle. strips (N, H, W), widths (N,), quads (N, 4, 2) (the probe
    quads), bounds (N, 1, 2) -> refined (N, 4, 2). Strips with no ink keep
    their quad."""
    N, H, W = strips.shape
    xa = quads[..., 0].amin(-1)
    xb = quads[..., 0].amax(-1)
    ya = quads[..., 1].amin(-1)
    yb = quads[..., 1].amax(-1)
    sy = (yb - ya) / (rec_height - 1.0)
    sx = (xb - xa) / torch.clamp(widths.float() - 1.0, min=1.0)
    x_lo = x_hi = None
    if margin_fracs is not None and x_margin_keep < 1.0:
        fy, fx = margin_fracs
        if orig_quads is not None:
            m_l = torch.clamp(orig_quads[..., 0].amin(-1) - xa, min=0.0) \
                / torch.clamp(sx, min=1e-6)
            m_r = torch.clamp(xb - orig_quads[..., 0].amax(-1), min=0.0) \
                / torch.clamp(sx, min=1e-6)
        else:
            h_orig = (yb - ya) / (1.0 + 2.0 * fy)
            m_l = m_r = fx * h_orig / torch.clamp(sx, min=1e-6)
        x_lo, x_hi = _ink_x_window(widths, m_l, m_r, x_margin_keep)
    line_h = None
    if flat_frac > 0.0 and case_gate:
        if orig_quads is not None:
            o_h = orig_quads[..., 1].amax(-1) - orig_quads[..., 1].amin(-1)
            line_h = o_h / torch.clamp(sy, min=1e-6)
        elif margin_fracs is not None:
            line_h = torch.full((N,), H / (1.0 + 2.0 * margin_fracs[0]),
                                device=strips.device)
    xs0, ys0, xs1, ys1, ok, flat = ink_boxes(
        strips, widths, ink_thresh=ink_thresh, min_count=min_count,
        pad_y=pad_y, pad_x=pad_x, x_lo=x_lo, x_hi=x_hi,
        flat_frac=flat_frac, line_h=line_h)
    ya2 = ya + ys0 * sy
    yb2 = ya + ys1 * sy
    xa2 = xa + xs0 * sx
    xb2 = xa + xs1 * sx
    refined = torch.stack([
        torch.stack([xa2, ya2], -1), torch.stack([xb2, ya2], -1),
        torch.stack([xb2, yb2], -1), torch.stack([xa2, yb2], -1)], dim=-2)
    refined = torch.where(ok[:, None, None], refined, quads)
    if bounds is not None:
        b = torch.as_tensor(bounds, dtype=refined.dtype,
                            device=refined.device)
        if flat_frac > 0.0:
            refined = torch.where(flat[:, None, None],
                                  _shift_into_bounds(refined, b), refined)
        refined = torch.minimum(torch.clamp(refined, min=0.0), b)
    return refined


def solve_homographies(quads: torch.Tensor, heights: torch.Tensor,
                       widths: torch.Tensor) -> torch.Tensor:
    """DLT homographies strip -> page: quads (N, 4, 2) TL,TR,BR,BL page
    coords, heights/widths (N,) strip sizes -> (N, 3, 3) with
    H @ [u, v, 1]^T ~ [x, y, 1]^T. One batched 8x8 float32 solve with the
    reference's 1e-6 ridge (degenerate quads stay solvable)."""
    w = torch.clamp(widths.float(), min=1.0)
    h = torch.clamp(heights.float(), min=1.0)
    z = torch.zeros_like(w)
    one = torch.ones_like(w)
    dst = [(z, z), (w - 1, z), (w - 1, h - 1), (z, h - 1)]
    src = quads.float()
    rows, rhs = [], []
    for i, (u, v) in enumerate(dst):
        x, y = src[:, i, 0], src[:, i, 1]
        rows.append(torch.stack([u, v, one, z, z, z, -u * x, -v * x], -1))
        rows.append(torch.stack([z, z, z, u, v, one, -u * y, -v * y], -1))
        rhs += [x, y]
    A = torch.stack(rows, dim=1)                              # (N, 8, 8)
    b = torch.stack(rhs, dim=1)                               # (N, 8)
    A = A + 1e-6 * torch.eye(8, dtype=A.dtype, device=A.device)
    # solve_ex: the same solve without its check for a singular A, which
    # reads the status back to the host (the ridge keeps A regular)
    sol = torch.linalg.solve_ex(A, b)[0]
    return torch.cat([sol, one[:, None]], dim=1).reshape(-1, 3, 3)


def _bilinear_sample(pages: torch.Tensor, page_ids: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """pages (B, H, W) float; page_ids (N,); x, y (N, ...) sample coords ->
    samples. Clamp to the edge BEFORE flooring (a coordinate of -1e-6 would
    otherwise floor to -1 with a weight near 1), pixel centres at integers:
    neither is what F.grid_sample does, so the gather is written out."""
    B, H, W = pages.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    dx, dy = x - x0f, y - y0f
    x0 = torch.clamp(x0f.long(), 0, W - 1)
    y0 = torch.clamp(y0f.long(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    base = page_ids.long().reshape((-1,) + (1,) * (x.dim() - 1)) * (H * W)
    flat = pages.reshape(-1)
    v00 = flat[base + y0 * W + x0]
    v01 = flat[base + y0 * W + x1]
    v10 = flat[base + y1 * W + x0]
    v11 = flat[base + y1 * W + x1]
    return ((1 - dy) * ((1 - dx) * v00 + dx * v01)
            + dy * ((1 - dx) * v10 + dx * v11))


def quad_strip_widths(quads: torch.Tensor, rec_height: int,
                      max_width: int) -> torch.Tensor:
    """Aspect-preserving strip width of each (N, 4, 2) quad, clipped to the
    bucket (corners sit at pixel centres: edge length + 1 is the size)."""
    def norm(d):
        return torch.sqrt((d * d).sum(-1))
    e_top = norm(quads[:, 1] - quads[:, 0])
    e_bot = norm(quads[:, 2] - quads[:, 3])
    e_left = norm(quads[:, 3] - quads[:, 0])
    e_right = norm(quads[:, 2] - quads[:, 1])
    qw = torch.maximum(e_top, e_bot) + 1.0
    qh = torch.clamp(torch.maximum(e_left, e_right) + 1.0, min=1.0)
    return torch.clamp(torch.round(qw * rec_height / qh), 1,
                       max_width).to(torch.int32)


def warp_quads_multi(pages: torch.Tensor, page_ids: torch.Tensor,
                     quads: torch.Tensor, *, rec_height: int = 32,
                     bucket_width: int = 320, pad_value: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact homography crop+rectify of quads pooled over pages: pages
    (B, H, W) float32 normalized, page_ids (N,), quads (N, 4, 2) ->
    (strips (N, rec_height, bucket_width), pad_value beyond each width;
    widths (N,) int32)."""
    N = quads.shape[0]
    dev = pages.device
    widths = quad_strip_widths(quads, rec_height, bucket_width)
    heights = torch.full((N,), rec_height, dtype=torch.int32, device=dev)
    Hs = solve_homographies(quads, heights, widths)           # (N, 3, 3)
    u = torch.arange(bucket_width, dtype=torch.float32, device=dev)
    v = torch.arange(rec_height, dtype=torch.float32, device=dev)
    grid = torch.stack([u[None, :].expand(rec_height, -1),
                        v[:, None].expand(-1, bucket_width),
                        torch.ones((rec_height, bucket_width), device=dev)],
                       dim=-1).reshape(-1, 3)                 # (h * W, 3)
    s = torch.matmul(grid[None], Hs.transpose(1, 2)).reshape(
        N, rec_height, bucket_width, 3)
    denom = s[..., 2]
    denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
    samp = _bilinear_sample(pages, page_ids, s[..., 0] / denom,
                            s[..., 1] / denom)
    mask = torch.arange(bucket_width, device=dev)[None, None, :] \
        < widths[:, None, None]
    return torch.where(mask, samp, pad_value), widths


def warp_quads(page: torch.Tensor, quads: torch.Tensor, *,
               rec_height: int = 32, bucket_width: int = 320,
               pad_value: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """warp_quads_multi for the quads of one (H, W) page. Recognition
    callers pass pad_value = (0 - rec_mean) / rec_std: the recognizer was
    trained on black-padded strips."""
    ids = torch.zeros((quads.shape[0],), dtype=torch.int64,
                      device=page.device)
    return warp_quads_multi(page[None], ids, quads, rec_height=rec_height,
                            bucket_width=bucket_width, pad_value=pad_value)


def warp_quads_grouped(pages: torch.Tensor, quads: torch.Tensor, *,
                       rec_height: int = 32, bucket_width: int = 320,
                       pad_value: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """warp_quads_multi for quads grouped by page: pages (B, H, W), quads
    (B, K, 4, 2) -> (strips (B, K, rec_height, bucket_width), widths
    (B, K)). The fused program's exact-homography warp."""
    B, K = quads.shape[:2]
    ids = torch.arange(B, device=pages.device)[:, None].expand(
        B, K).reshape(-1)
    strips, widths = warp_quads_multi(
        pages, ids, quads.reshape(B * K, 4, 2), rec_height=rec_height,
        bucket_width=bucket_width, pad_value=pad_value)
    return (strips.reshape(B, K, rec_height, bucket_width),
            widths.reshape(B, K))


def warp_quads_multi_separable(pages: torch.Tensor, page_ids: torch.Tensor,
                               quads: torch.Tensor, *, rec_height: int = 32,
                               bucket_width: int = 320, tile_h: int = 128,
                               pad_value: float = 0.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pooled separable AABB crop+resize: each strip takes a (tile_h, Wp)
    row band around its quad (origin one row above the quad, clamped inside
    the page) and resamples it with two bilinear-weight matmuls. Exact for
    axis-aligned quads; callers route quads that are tilted or taller than
    tile_h - 4 to warp_quads_multi (bucketing.sep_warp_mask).

    pages (B, Hp, Wp), page_ids (N,), quads (N, 4, 2) ->
    (strips (N, rec_height, bucket_width), widths (N,) int32)."""
    Hp, Wp = pages.shape[1], pages.shape[2]
    Hh, W, TH = rec_height, bucket_width, min(tile_h, Hp)
    dev = pages.device
    x0 = quads[..., 0].amin(-1)
    x1 = quads[..., 0].amax(-1)
    y0 = quads[..., 1].amin(-1)
    y1 = quads[..., 1].amax(-1)
    widths = torch.clamp(torch.round(
        (x1 - x0 + 1.0) * Hh / torch.clamp(y1 - y0 + 1.0, min=1.0)),
        1, W).to(torch.int32)
    ty = torch.clamp(torch.floor(y0) - 1.0, 0.0, float(max(Hp - TH, 0)))
    rows = ty.long()[:, None] + torch.arange(TH, device=dev)[None, :]
    tiles = pages[page_ids.long()[:, None], rows]             # (N, TH, Wp)
    vout = torch.arange(Hh, dtype=torch.float32, device=dev)[None, :, None]
    uout = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    src_y = torch.arange(TH, dtype=torch.float32, device=dev)[None, None, :]
    src_x = torch.arange(Wp, dtype=torch.float32, device=dev)[None, None, :]

    def col(t):  # (N,) -> (N, 1, 1)
        return t[:, None, None]

    ys = (col(y0) - col(ty)) + vout * (col(y1) - col(y0)) / (Hh - 1.0)
    wy = torch.clamp(1.0 - torch.abs(ys - src_y), min=0.0)    # (N, Hh, TH)
    xs = col(x0) + uout * (col(x1) - col(x0)) / torch.clamp(
        col(widths.float()) - 1.0, min=1.0)
    wx = torch.clamp(1.0 - torch.abs(xs - src_x), min=0.0)    # (N, W, Wp)
    out = torch.bmm(torch.bmm(wy, tiles), wx.transpose(1, 2))  # (N, Hh, W)
    mask = torch.arange(W, device=dev)[None, None, :] < col(widths)
    return torch.where(mask, out, pad_value), widths


def warp_quads_multi_sep_refined(pages, page_ids, quads, bounds, *,
                                 rec_height: int = 32,
                                 bucket_width: int = 320, tile_h: int = 128,
                                 ink_thresh: float = 0.0, margin_fracs=None,
                                 x_margin_keep: float = 1.0,
                                 pad_value: float = 0.0, orig_quads=None,
                                 flat_frac: float = 0.0,
                                 case_gate: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass warp_quads_multi_separable: probe, AABB ink refine,
    re-warp. The refined quad lies inside the probe quad, so the second
    pass inherits the first one's row-tile routing."""
    kw = dict(rec_height=rec_height, bucket_width=bucket_width,
              tile_h=tile_h, pad_value=pad_value)
    strips, widths = warp_quads_multi_separable(pages, page_ids, quads, **kw)
    refined = refine_aabb_to_ink(
        strips, widths, quads, rec_height=rec_height, bounds=bounds,
        ink_thresh=ink_thresh, margin_fracs=margin_fracs,
        x_margin_keep=x_margin_keep, orig_quads=orig_quads,
        flat_frac=flat_frac, case_gate=case_gate)
    return warp_quads_multi_separable(pages, page_ids, refined, **kw)


def _applied_x_margins(exp_quads: torch.Tensor, orig_quads: torch.Tensor):
    """Per-side expansion margins actually applied, in page px: the
    original quad's left/right edge midpoints projected on the expanded
    quad's x direction (a clamped expansion shows as a smaller margin)."""
    right = (exp_quads[:, 1] + exp_quads[:, 2]) \
        - (exp_quads[:, 0] + exp_quads[:, 3])
    wlen = torch.sqrt(torch.clamp((right * right).sum(-1), min=1e-12))
    ex = right / wlen[:, None]
    ml_o = (orig_quads[:, 0] + orig_quads[:, 3]) * 0.5
    ml_e = (exp_quads[:, 0] + exp_quads[:, 3]) * 0.5
    mr_o = (orig_quads[:, 1] + orig_quads[:, 2]) * 0.5
    mr_e = (exp_quads[:, 1] + exp_quads[:, 2]) * 0.5
    m_left = torch.clamp(((ml_o - ml_e) * ex).sum(-1), min=0.0)
    m_right = torch.clamp(((mr_e - mr_o) * ex).sum(-1), min=0.0)
    return m_left, m_right


def refine_quads_to_ink(strips: torch.Tensor, widths: torch.Tensor,
                        quads: torch.Tensor, *, rec_height: int,
                        ink_thresh: float = 0.0, min_count: int = 2,
                        pad_y: float = 2.0, pad_x: float = 3.0,
                        bounds=None, margin_fracs=None,
                        x_margin_keep: float = 1.0, orig_quads=None,
                        flat_frac: float = 0.0, case_gate: bool = False
                        ) -> torch.Tensor:
    """Two-pass refinement, homography variant: the probe strip's ink band
    mapped back to the page through the SAME homography that warped the
    probe. strips (N, H, W), widths (N,), quads (N, 4, 2) (the expanded
    probe quads), bounds (2,) or (N, 1, 2) -> refined (N, 4, 2); strips
    with no ink keep their quad. See refine_aabb_to_ink for the margin and
    flat-band arguments."""
    N, H, W = strips.shape

    def edge(a, b):
        d = quads[:, a] - quads[:, b]
        return torch.sqrt((d * d).sum(-1))

    x_lo = x_hi = None
    if margin_fracs is not None and x_margin_keep < 1.0:
        fy, fx = margin_fracs
        to_strip = (widths.float() - 1.0) / torch.clamp(edge(1, 0), min=1.0)
        if orig_quads is not None:
            m_l, m_r = _applied_x_margins(quads, orig_quads)
            m_l, m_r = m_l * to_strip, m_r * to_strip
        else:
            h_orig = edge(3, 0) / (1.0 + 2.0 * fy)
            m_l = m_r = fx * h_orig * to_strip
        x_lo, x_hi = _ink_x_window(widths, m_l, m_r, x_margin_keep)
    line_h = None
    if flat_frac > 0.0 and case_gate:
        h_exp = edge(3, 0)
        if orig_quads is not None:
            d = orig_quads[:, 3] - orig_quads[:, 0]
            line_h = H * torch.sqrt((d * d).sum(-1)) \
                / torch.clamp(h_exp, min=1e-6)
        elif margin_fracs is not None:
            line_h = torch.full((N,), H / (1.0 + 2.0 * margin_fracs[0]),
                                device=strips.device)
    x0, y0, x1, y1, ok, flat = ink_boxes(
        strips, widths, ink_thresh=ink_thresh, min_count=min_count,
        pad_y=pad_y, pad_x=pad_x, x_lo=x_lo, x_hi=x_hi,
        flat_frac=flat_frac, line_h=line_h)
    heights = torch.full((N,), rec_height, dtype=torch.int32,
                         device=strips.device)
    Hs = solve_homographies(quads, heights, widths)           # strip -> page
    us = torch.stack([x0, x1, x1, x0], dim=1)                 # (N, 4)
    vs = torch.stack([y0, y0, y1, y1], dim=1)
    pts = torch.stack([us, vs, torch.ones_like(us)], dim=-1)  # (N, 4, 3)
    proj = torch.matmul(pts, Hs.transpose(1, 2))              # (N, 4, 3)
    denom = proj[..., 2:]
    denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
    refined = proj[..., :2] / denom
    refined = torch.where(ok[:, None, None], refined, quads)
    if bounds is not None:
        b = torch.as_tensor(bounds, dtype=refined.dtype,
                            device=refined.device)
        if flat_frac > 0.0:
            refined = torch.where(flat[:, None, None],
                                  _shift_into_bounds(refined, b), refined)
        refined = torch.minimum(torch.clamp(refined, min=0.0), b)
    return refined


def snap_strips_to_ink(strips: torch.Tensor, widths: torch.Tensor, *,
                       ink_thresh: float = 0.0, min_count: int = 2,
                       pad_y: float = 2.0, pad_x: float = 3.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-crop each strip to the ink band through its vertical centre by an
    aspect-preserving bilinear resample in strip space (the two-pass
    refine + re-warp is better where the page is at hand). strips (N, H, W)
    normalized, widths (N,) -> (strips zero outside the new extent, new
    widths); strips with no ink pass through unchanged."""
    N, H, W = strips.shape
    dev = strips.device
    x0, y0, x1, y1, ok, _ = ink_boxes(
        strips, widths, ink_thresh=ink_thresh, min_count=min_count,
        pad_y=pad_y, pad_x=pad_x)
    src_h = y1 - y0 + 1.0
    src_w = x1 - x0 + 1.0
    s = torch.minimum(H / src_h, W / src_w)   # never overflow the bucket
    new_w = torch.clamp(torch.round(src_w * s), 1, W).to(torch.int32)
    new_h = torch.clamp(torch.round(src_h * s), 1, H).to(torch.int32)
    oy = (torch.arange(H, device=dev)[None, :] + 0.5) / s[:, None] \
        + y0[:, None] - 0.5                                   # (N, H)
    ox = (torch.arange(W, device=dev)[None, :] + 0.5) / s[:, None] \
        + x0[:, None] - 0.5                                   # (N, W)
    out = _bilinear_sample(strips, torch.arange(N, device=dev),
                           ox[:, None, :].expand(N, H, W),
                           oy[:, :, None].expand(N, H, W))
    keep = ((torch.arange(W, device=dev)[None, None, :]
             < new_w[:, None, None])
            & (torch.arange(H, device=dev)[None, :, None]
               < new_h[:, None, None]))
    out = torch.where(keep, out, 0.0)
    return (torch.where(ok[:, None, None], out, strips),
            torch.where(ok, new_w, widths.to(torch.int32)))


def warp_quads_multi_refined(pages, page_ids, quads, bounds, *,
                             rec_height: int = 32, bucket_width: int = 320,
                             ink_thresh: float = 0.0, margin_fracs=None,
                             x_margin_keep: float = 1.0,
                             pad_value: float = 0.0, orig_quads=None,
                             flat_frac: float = 0.0, case_gate: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass warp_quads_multi: probe, homography ink refine, re-warp at
    full resolution. quads should already be expanded (expand_quads)."""
    kw = dict(rec_height=rec_height, bucket_width=bucket_width,
              pad_value=pad_value)
    strips, widths = warp_quads_multi(pages, page_ids, quads, **kw)
    refined = refine_quads_to_ink(
        strips, widths, quads, rec_height=rec_height, bounds=bounds,
        ink_thresh=ink_thresh, margin_fracs=margin_fracs,
        x_margin_keep=x_margin_keep, orig_quads=orig_quads,
        flat_frac=flat_frac, case_gate=case_gate)
    return warp_quads_multi(pages, page_ids, refined, **kw)


def warp_quads_refined(page, quads, bounds, **kw
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """warp_quads_multi_refined for the quads of one (H, W) page."""
    ids = torch.zeros((quads.shape[0],), dtype=torch.int64,
                      device=page.device)
    return warp_quads_multi_refined(page[None], ids, quads, bounds, **kw)
