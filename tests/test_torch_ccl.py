"""CCL: the port's plain labeling is bit-exact to ocrjax's (XLA scans and
the Pallas kernel in interpret mode). The CUDA kernel's own cases, which
need the card, are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    (256, 256, "global"), (512, 512, "global"), (1, 1, "shared"),
    (37, 70, "shared"), (1, 65535, "shared"), (65535, 1, "global"),
    (3, 21845, "shared"), (9216, 7, "shared"), (9217, 7, "global")])
def test_path_choice_is_a_pure_function_of_the_grid(H, W, path):
    """The shared-memory kernel takes H * W <= 65,535 pixels (uint16 labels,
    0xFFFF is background) in at most 9,216 chunks of 8 pixels (rows padded
    to 8, 9 chunks a thread); everything else goes to the general kernel."""
    assert cc_label.ccl_path(H, W) == path
    if path == "shared":
        assert cc_label.shared_bytes(H, W) <= cc_label.SHARED_MEMORY_LIMIT
        assert cc_label.shared_bytes(H, W) == H * ((W + 7) // 8) * 16


def test_the_lanes_grids_take_the_shared_path():
    from ocrjax_torch.config import OcrConfig
    cfg = OcrConfig()
    side = cfg.det_max_side // cfg.det_cc_downsample
    assert cc_label.ccl_path(side, side) == "shared"
    assert cc_label.shared_bytes(240, 240) == 115200


def test_cuda_wrapper_checks_its_arguments_before_any_launch():
    bm = torch.zeros((1, 8, 8), dtype=torch.bool)
    for kwargs in ({}, {"path": "shared"}, {"path": "global"}):
        with pytest.raises(ValueError):                    # a CPU tensor
            cc_label.label_components_cuda(bm, 4, **kwargs)
    assert cc_label.label_components_cuda.launches_by_path.keys() \
        == set(cc_label.PATHS)
    assert sum(cc_label.label_components_cuda.launches_by_path.values()) \
        == cc_label.label_components_cuda.launches
