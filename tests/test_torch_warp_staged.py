"""The warps of the staged and bucketed lanes: each function of
ocrjax_torch.ops.warp against its ocrjax counterpart on seeded numpy inputs
(CPU, float32).

Tolerances: the homography solve is an 8x8 float32 LU in two LAPACK
builds, held to rtol 1e-4 / atol 1e-4 (its entries reach page coordinates
of several hundred); sample coordinates then agree to about 1e-4 px, and a
normalized strip value to 2e-3 where the page has an edge under the sample
(|gradient| <= 2 per px), 1e-5 for the matmul warps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrjax.ops import warp as jw
from ocrjax_torch.ops import warp as tw

H, W = 96, 160
PAD = -1.0


def _page(seed, n=2):
    """Normalized pages with dark 'ink' bars on a light background."""
    rng = np.random.RandomState(seed)
    pages = np.full((n, H, W), 1.0, np.float32)
    for p in range(n):
        for k in range(4):
            y = 10 + 20 * k + rng.randint(0, 4)
            x0, x1 = rng.randint(5, 30), rng.randint(90, 150)
            pages[p, y:y + 9, x0:x1] = rng.uniform(-1.0, -0.6)
            # glyph-like gaps
            for g in range(x0 + 6, x1, 11):
                pages[p, y:y + 9, g:g + 2] = 1.0
    return pages + rng.uniform(-0.02, 0.02, pages.shape).astype(np.float32)


def _quads(seed, n=6, max_deg=10.0):
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        cy = 14 + 20 * (k % 4) + rng.uniform(-1, 1)
        cx = rng.uniform(60, 100)
        hw, hh = rng.uniform(30, 55), rng.uniform(5, 8)
        a = np.radians(rng.uniform(-max_deg, max_deg))
        c = np.array([[-hw, -hh], [hw, -hh], [hw, hh], [-hw, hh]])
        r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        out.append(c @ r.T + [cx, cy])
    return np.asarray(out, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_solve_homographies():
    quads = _quads(0, 8)
    widths = np.array([40, 64, 17, 128, 1, 90, 33, 200], np.int32)
    heights = np.full(8, 32, np.int32)
    want = np.asarray(jw.solve_homographies(
        jnp.asarray(quads), jnp.asarray(heights), jnp.asarray(widths)))
    got = tw.solve_homographies(_t(quads), _t(heights), _t(widths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the corners of the strip land on the quad
    k = 3
    corner = got[k] @ np.array([widths[k] - 1.0, 31.0, 1.0], np.float32)
    np.testing.assert_allclose(corner[:2] / corner[2], quads[k, 2], atol=1e-2)


def test_bilinear_sample_clamps_before_flooring():
    page = _page(1, 1)
    rng = np.random.RandomState(2)
    x = rng.uniform(-3, W + 2, (5, 7)).astype(np.float32)
    y = rng.uniform(-3, H + 2, (5, 7)).astype(np.float32)
    x[0, 0], y[0, 0] = -1e-6, -1e-6
    want = np.asarray(jw._bilinear_sample(jnp.asarray(page[0]),
                                          jnp.asarray(x), jnp.asarray(y)))
    got = tw._bilinear_sample(_t(page), torch.zeros(1, dtype=torch.int64),
                              _t(x)[None], _t(y)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0, 0] == page[0, 0, 0]


def test_quad_strip_widths():
    quads = _quads(3, 12, max_deg=30.0)
    want = np.asarray(jw.quad_strip_widths(jnp.asarray(quads), 32, 128))
    got = tw.quad_strip_widths(_t(quads), 32, 128).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_warp_quads_and_multi():
    pages, quads = _page(4), _quads(5)
    ids = np.array([0, 1, 1, 0, 1, 0], np.int32)
    want_s, want_w = jw.warp_quads_multi(
        jnp.asarray(pages), jnp.asarray(ids), jnp.asarray(quads),
        rec_height=32, bucket_width=192, pad_value=PAD)
    got_s, got_w = tw.warp_quads_multi(
        _t(pages), _t(ids), _t(quads), rec_height=32, bucket_width=192,
        pad_value=PAD)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=2e-3)
    one_s, one_w = jw.warp_quads(jnp.asarray(pages[1]), jnp.asarray(quads),
                                 rec_height=32, bucket_width=192,
                                 pad_value=PAD)
    g1_s, g1_w = tw.warp_quads(_t(pages[1]), _t(quads), rec_height=32,
                               bucket_width=192, pad_value=PAD)
    np.testing.assert_array_equal(g1_w.numpy(), np.asarray(one_w))
    np.testing.assert_allclose(g1_s.numpy(), np.asarray(one_s), atol=2e-3)
    # beyond each width the strip holds the pad value
    assert (g1_s.numpy()[0, :, int(g1_w[0]):] == PAD).all()


@pytest.mark.parametrize("tile_h", [128, 40])
def test_warp_quads_multi_separable(tile_h):
    pages, quads = _page(6), _quads(7, max_deg=0.0)
    quads[2, :, 1] += 60.0          # near the bottom: the tile origin clamps
    ids = np.array([1, 0, 1, 0, 0, 1], np.int32)
    want_s, want_w = jw.warp_quads_multi_separable(
        jnp.asarray(pages), jnp.asarray(ids), jnp.asarray(quads),
        rec_height=32, bucket_width=192, tile_h=tile_h, pad_value=PAD)
    got_s, got_w = tw.warp_quads_multi_separable(
        _t(pages), _t(ids), _t(quads), rec_height=32, bucket_width=192,
        tile_h=tile_h, pad_value=PAD)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)


def _refine_kw(orig):
    return dict(rec_height=32, ink_thresh=0.0, margin_fracs=(0.15, 0.15),
                x_margin_keep=0.5, orig_quads=orig, flat_frac=0.46,
                case_gate=False)


def _expanded(quads, bounds):
    """Expanded on the host as the lanes do it, rounded to float32 as the
    upload rounds it; the port's host expansion gives the same bits."""
    want = np.asarray(jw.expand_quads(quads, 0.15, 0.15, bounds=bounds))
    got = tw.expand_quads_host(quads, 0.15, 0.15, bounds=bounds)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return want.astype(np.float32)


def test_applied_x_margins_and_refine_quads_to_ink():
    pages, quads = _page(8, 1), _quads(9)
    bounds = np.array([W - 1.0, H - 1.0], np.float32)
    exp = _expanded(quads, bounds)
    for g, w in zip(tw._applied_x_margins(_t(exp), _t(quads)),
                    jw._applied_x_margins(jnp.asarray(exp),
                                          jnp.asarray(quads))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    strips, widths = jw.warp_quads(jnp.asarray(pages[0]), jnp.asarray(exp),
                                   rec_height=32, bucket_width=192,
                                   pad_value=PAD)
    for orig in (quads, None):
        want = np.asarray(jw.refine_quads_to_ink(
            strips, widths, jnp.asarray(exp), bounds=jnp.asarray(bounds),
            **_refine_kw(None if orig is None else jnp.asarray(orig))))
        got = tw.refine_quads_to_ink(
            _t(strips), _t(widths), _t(exp), bounds=_t(bounds),
            **_refine_kw(None if orig is None else _t(orig))).numpy()
        # refined corners, page px: the same ink rows and columns mapped
        # through homographies that agree to 1e-4 relative
        np.testing.assert_allclose(got, want, atol=5e-3)
    assert np.abs(want - exp).max() > 1.0       # the refinement moved them


def test_two_pass_warps_match():
    pages, quads = _page(10), _quads(11, max_deg=6.0)
    ids = np.array([0, 1, 0, 1, 1, 0], np.int32)
    b_all = np.tile(np.array([W - 1.0, H - 1.0], np.float32), (6, 1, 1))
    exp = _expanded(quads, b_all)
    kw = dict(bucket_width=192, pad_value=PAD, **_refine_kw(None))
    del kw["orig_quads"]
    want_s, want_w = jw.warp_quads_multi_refined(
        jnp.asarray(pages), jnp.asarray(ids), jnp.asarray(exp),
        jnp.asarray(b_all), orig_quads=jnp.asarray(quads), **kw)
    got_s, got_w = tw.warp_quads_multi_refined(
        _t(pages), _t(ids), _t(exp), _t(b_all), orig_quads=_t(quads), **kw)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=5e-3)

    one_s, one_w = jw.warp_quads_refined(
        jnp.asarray(pages[0]), jnp.asarray(exp),
        jnp.asarray(b_all[0, 0]), orig_quads=jnp.asarray(quads), **kw)
    g1_s, g1_w = tw.warp_quads_refined(
        _t(pages[0]), _t(exp), _t(b_all[0, 0]), orig_quads=_t(quads), **kw)
    np.testing.assert_array_equal(g1_w.numpy(), np.asarray(one_w))
    np.testing.assert_allclose(g1_s.numpy(), np.asarray(one_s), atol=5e-3)


def test_warp_quads_multi_sep_refined():
    pages, quads = _page(12), _quads(13, max_deg=0.0)
    ids = np.array([0, 1, 0, 1, 1, 0], np.int32)
    b_all = np.tile(np.array([W - 1.0, H - 1.0], np.float32), (6, 1, 1))
    exp = _expanded(quads, b_all)
    kw = dict(bucket_width=192, tile_h=64, pad_value=PAD, **_refine_kw(None))
    del kw["orig_quads"]
    want_s, want_w = jw.warp_quads_multi_sep_refined(
        jnp.asarray(pages), jnp.asarray(ids), jnp.asarray(exp),
        jnp.asarray(b_all), orig_quads=jnp.asarray(quads), **kw)
    got_s, got_w = tw.warp_quads_multi_sep_refined(
        _t(pages), _t(ids), _t(exp), _t(b_all), orig_quads=_t(quads), **kw)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
