"""CCL: the port's plain labeling is bit-exact to ocrjax's (XLA scans and
the Pallas kernel in interpret mode). The CUDA kernel's own cases, which
need the card, are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ocrjax.ops.pallas.cc_label import label_components_pallas
from ocrjax.postprocess.db_boxes import label_components as jax_label
from ocrjax_torch.ops import cc_label


def _jax(bm: np.ndarray, n_iters: int) -> np.ndarray:
    if bm.ndim == 2:
        return np.asarray(jax_label(jnp.asarray(bm), n_iters))
    return np.stack([_jax(b, n_iters) for b in bm])


def _torch(bm: np.ndarray, n_iters: int) -> np.ndarray:
    return cc_label.label_components_torch(torch.from_numpy(bm),
                                           n_iters).numpy()


def _snake_and_rect() -> np.ndarray:
    bm = np.zeros((64, 64), bool)
    bm[2, 2:60] = True
    bm[2:40, 59] = True
    bm[39, 4:60] = True          # S-snake: one component
    bm[50:60, 5:25] = True       # separate rect
    return bm


def _long_snake() -> np.ndarray:
    bm = np.zeros((64, 64), bool)
    bm[2, 2:60] = True
    bm[2:40, 59] = True
    bm[39, 4:60] = True
    return bm


@pytest.mark.parametrize("n_iters", [4, 6])
@pytest.mark.parametrize("seed,density", [(0, 0.3), (1, 0.5), (2, 0.72)])
def test_random_bitmaps_bit_exact(seed, density, n_iters):
    bm = np.random.RandomState(seed).rand(48, 64) > density
    np.testing.assert_array_equal(_torch(bm, n_iters), _jax(bm, n_iters))


@pytest.mark.parametrize("n_iters", [4, 6, 24])
@pytest.mark.parametrize("case", ["snake_and_rect", "long_snake"])
def test_snakes_bit_exact(case, n_iters):
    bm = _snake_and_rect() if case == "snake_and_rect" else _long_snake()
    got = _torch(bm, n_iters)
    np.testing.assert_array_equal(got, _jax(bm, n_iters))
    assert (got[~bm] == cc_label.BIG).all()


def test_batched_bit_exact():
    bm = np.random.RandomState(7).rand(2, 32, 32) > 0.7
    np.testing.assert_array_equal(_torch(bm, 6), _jax(bm, 6))


def test_matches_pallas_interpret():
    bm = np.random.RandomState(3).rand(2, 24, 40) > 0.6
    want = np.asarray(label_components_pallas(jnp.asarray(bm), n_iters=4,
                                              interpret=True))
    np.testing.assert_array_equal(_torch(bm, 4), want)


def test_wrapper_takes_plain_version_on_cpu():
    bm = torch.from_numpy(_snake_and_rect()[None])
    before = cc_label.label_components_cuda.launches
    out = cc_label.label_components(bm, 4)
    assert out.dtype == torch.int32
    assert cc_label.label_components_cuda.launches == before
    with pytest.raises(ValueError):
        cc_label.label_components_cuda(bm, 4)



@pytest.mark.parametrize("H,W,path", [
    (240, 240, "shared"), (128, 128, "shared"), (255, 257, "shared"),
    (256, 256, "cluster"), (512, 512, "cluster"), (1, 1, "shared"),
    (37, 70, "shared"), (1, 65535, "shared"), (65535, 1, "global"),
    (3, 21845, "shared"), (9216, 7, "shared"), (9217, 7, "global"),
    (512, 192, "cluster"), (448, 512, "cluster"), (448, 192, "cluster"),
    (192, 512, "cluster"), (320, 512, "cluster"),
    (768, 512, "cluster"), (769, 512, "global"),
    (360, 1024, "cluster"), (361, 1024, "global"),
    (64, 1024, "cluster"), (64, 1025, "global"), (1, 65536, "global"),
    (4096, 17, "cluster"), (23208, 3, "cluster"), (23209, 3, "global")])
def test_path_choice_is_a_pure_function_of_the_grid(H, W, path):
    """The shared-memory kernel takes H * W <= 65,535 pixels (uint16 labels,
    0xFFFF is background) in at most 9,216 chunks of 8 pixels (rows padded
    to 8, 9 chunks a thread). The cluster kernel takes the larger grids
    whose rows are at most 1,024 wide (2 rounds of 512 pixels in a warp's
    registers) and whose band of ceil(H / 8) rows with two halo rows (Ws
    padded to 16, 4 words more every 32) and three summary rows fits a
    CTA's 232,448 B; everything else goes to the general kernel."""
    assert cc_label.ccl_path(H, W) == path
    if path == "shared":
        assert cc_label.shared_bytes(H, W) <= cc_label.SHARED_MEMORY_LIMIT
        assert cc_label.shared_bytes(H, W) == H * ((W + 7) // 8) * 16
    if path == "cluster":
        assert H * W > cc_label.SHARED_MAX_PIXELS
        assert cc_label.cluster_bytes(H, W) <= cc_label.SHARED_MEMORY_LIMIT
        ws = (W + 15) // 16 * 16
        assert cc_label.cluster_bytes(H, W) == \
            (((H + 7) // 8 + 2) * (ws + (ws + 31) // 32 * 4) + 3 * ws) * 4
        assert W <= cc_label.CLUSTER_MAX_WIDTH
    if path == "global" and H * W > cc_label.SHARED_MAX_PIXELS:
        assert not cc_label.fits_cluster(H, W)


def test_the_lanes_grids_take_the_shared_path():
    from ocrjax_torch import tiling
    from ocrjax_torch.config import OcrConfig
    cfg = OcrConfig()
    side = cfg.det_max_side // cfg.det_cc_downsample
    assert cc_label.ccl_path(side, side) == "shared"
    assert cc_label.shared_bytes(240, 240) == 115200
    # every C5 grid at the shipped tile settings: the tiles of an A4 page
    # at 300 dpi, upright and landscape, and of the bench's dense page,
    # OR-pooled det_cc_downsample times
    grids = {(th // cfg.det_cc_downsample, tw // cfg.det_cc_downsample)
             for h, w in ((3508, 2480), (2480, 3508), (3072, 2048))
             for (_, _, th, tw) in tiling.tile_plan(h, w, cfg)}
    assert {(512, 512), (512, 192), (448, 512), (448, 192)} <= grids
    assert {g: cc_label.ccl_path(*g) for g in grids} == \
        {g: "cluster" for g in grids}
    assert cc_label.cluster_bytes(512, 512) == 158208


def test_cuda_wrapper_checks_its_arguments_before_any_launch():
    bm = torch.zeros((1, 8, 8), dtype=torch.bool)
    for kwargs in ({}, {"path": "shared"}, {"path": "cluster"},
                   {"path": "global"}):
        with pytest.raises(ValueError):                    # a CPU tensor
            cc_label.label_components_cuda(bm, 4, **kwargs)
    # grids that the forced path cannot take, refused before the device is
    # looked at: a band past a CTA's shared memory, a row past the
    # registers, and the shared path on a C5 grid
    for shape, path in (((1, 769, 512), "cluster"), ((1, 64, 1025), "cluster"),
                        ((1, 512, 512), "shared")):
        with pytest.raises(ValueError, match=f"does not fit the {path}"):
            cc_label.label_components_cuda(torch.zeros(shape, dtype=torch.bool),
                                           4, path=path)
    with pytest.raises(ValueError, match="path must be one of"):
        cc_label.label_components_cuda(bm, 4, path="union-find")
    assert cc_label.label_components_cuda.launches_by_path.keys() \
        == set(cc_label.PATHS) == {"shared", "cluster", "global"}
    assert sum(cc_label.label_components_cuda.launches_by_path.values()) \
        == cc_label.label_components_cuda.launches


# ---------------------------------------------------------------------------
# The cluster kernel's decomposition, modelled on the CPU: the grid's rows
# split into bands; rows run-min inside a band; columns run-min inside a
# band, then the carries from the neighbouring bands' summaries (min of the
# bottom / top run where it touches the boundary, band column all
# foreground) applied to the band's own top and bottom runs; the 3x3 min as
# a horizontal 3-min and a vertical 3-min with the neighbours' boundary
# rows as halos.
# ---------------------------------------------------------------------------

def _min3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Min of each element and its two neighbours along dim, BIG outside."""
    n = x.shape[dim]
    big = torch.full_like(x.narrow(dim, 0, 1), cc_label.BIG)
    p = torch.cat([big, x, big], dim)
    return torch.minimum(torch.minimum(p.narrow(dim, 0, n),
                                       p.narrow(dim, 1, n)),
                         p.narrow(dim, 2, n))


def _banded(bm: np.ndarray, n_iters: int, bands: int) -> np.ndarray:
    big = cc_label.BIG
    fg = torch.from_numpy(bm).bool()
    H, W = fg.shape[-2:]
    R = -(-H // bands)
    cuts = [(a, min(a + R, H)) for a in range(0, H, R)]
    lab = torch.where(fg, torch.arange(H * W, dtype=torch.int32)
                      .reshape(H, W), big)
    for _ in range(n_iters):
        lab = cc_label._run_min(lab, fg, -1)
        local = [cc_label._run_min(lab[..., a:b, :], fg[..., a:b, :], -2)
                 for a, b in cuts]
        full = [fg[..., a:b, :].all(-2) for a, b in cuts]
        out = []
        for k, (a, b) in enumerate(cuts):
            carry = {}
            for name, js, edge in (("up", range(k - 1, -1, -1), -1),
                                   ("down", range(k + 1, len(cuts)), 0)):
                c = torch.full_like(lab[..., 0, :], big)
                alive = torch.ones_like(c, dtype=torch.bool)
                for j in js:
                    c = torch.where(alive, torch.minimum(c, local[j][..., edge, :]),
                                    c)
                    alive &= full[j]
                carry[name] = c[..., None, :]
            f = fg[..., a:b, :].int()
            top = torch.cumprod(f, -2).bool()
            bot = torch.cumprod(f.flip(-2), -2).flip(-2).bool()
            p = torch.where(top, torch.minimum(local[k], carry["up"]), local[k])
            out.append(torch.where(bot, torch.minimum(p, carry["down"]), p))
        h = _min3(torch.cat(out, -2), -1)
        rows = []
        for a, b in cuts:
            above = h[..., a - 1:a, :] if a > 0 else \
                torch.full_like(h[..., :1, :], big)
            below = h[..., b:b + 1, :] if b < H else \
                torch.full_like(h[..., :1, :], big)
            v = _min3(torch.cat([above, h[..., a:b, :], below], -2), -2)
            rows.append(v[..., 1:-1, :])
        lab = torch.where(fg, torch.cat(rows, -2), big)
    return lab.numpy()


@settings(max_examples=60, deadline=None, database=None)
@given(H=st.integers(1, 24), W=st.integers(1, 24), bands=st.integers(2, 8),
       n_iters=st.integers(1, 6), density=st.sampled_from([0.2, 0.4, 0.6]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_band_decomposition_is_bit_exact(H, W, bands, n_iters, density,
                                         seed):
    bm = np.random.RandomState(seed).rand(H, W) > density
    np.testing.assert_array_equal(_banded(bm, n_iters, bands),
                                  _torch(bm, n_iters))


@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("bands", [2, 5, 8, 24])
def test_band_decomposition_matches_pallas_interpret(bands, n_iters):
    """2-8 bands, and 24 bands of one row each, against the Pallas kernel
    in interpret mode and the plain version (the shape of
    test_matches_pallas_interpret, so the interpreter's compile is shared)."""
    bm = np.random.RandomState(bands).rand(2, 24, 40) > 0.45
    want = np.asarray(label_components_pallas(jnp.asarray(bm),
                                              n_iters=n_iters,
                                              interpret=True))
    np.testing.assert_array_equal(_banded(bm, n_iters, bands), want)
    np.testing.assert_array_equal(_torch(bm, n_iters), want)


@pytest.mark.parametrize("case", ["snake", "band_edges", "all_fg"])
def test_band_decomposition_on_runs_across_bands(case):
    """Vertical runs that cross every band boundary, runs that begin and
    end on band-boundary rows, and an all-foreground grid, at 8 bands of 8
    rows (the kernel's 8 CTAs)."""
    bm = np.zeros((64, 48), bool)
    if case == "snake":
        for x in range(2, 46, 4):
            bm[1:63, x] = True
            bm[1 if (x // 4) % 2 else 62, x:x + 5] = True
    elif case == "band_edges":
        for k in range(1, 8):
            bm[8 * k - 1:8 * k + 1, 2 * k:2 * k + 9] = True
            bm[8 * k:8 * k + 3, 30 + k] = True
            bm[8 * k - 3:8 * k, 40 + k] = True
    else:
        bm[:] = True
    for n_iters in (4, 5, 24):
        np.testing.assert_array_equal(_banded(bm, n_iters, 8),
                                      _torch(bm, n_iters))
