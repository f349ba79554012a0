"""Tests that need an NVIDIA GPU: the cc_label and conv_fused CUDA kernels
against their plain versions, the homography solve against committed JAX
values, and the engine's device settings. They skip without CUDA.
This file imports neither JAX nor ocrjax, so on the GPU machine (which has
no JAX) it runs without the suite's conftest:
    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

from ocrjax_torch.ops import cc_label, conv_fused, warp

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ocrjax_torch", "testdata")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,density,n_iters", [
    ((16, 240, 240), 0.5, 4), ((16, 240, 240), 0.72, 6),
    ((4, 512, 512), 0.5, 4), ((3, 37, 70), 0.3, 5), ((1, 1, 1), 0.0, 4)])
def test_kernel_bit_exact(cuda, shape, density, n_iters):
    g = torch.Generator(device=cuda).manual_seed(0)
    bm = torch.rand(shape, generator=g, device=cuda) > density
    before = cc_label.label_components_cuda.launches
    got = cc_label.label_components(bm, n_iters)
    torch.cuda.synchronize()
    assert cc_label.label_components_cuda.launches == before + 1
    assert torch.equal(got, cc_label.label_components_torch(bm, n_iters))


def test_kernel_rejects_unbatched_input(cuda):
    with pytest.raises(ValueError):
        cc_label.label_components_cuda(torch.ones((8, 8), device=cuda), 4)


def test_engine_turns_tf32_off(cuda):
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.config import TINY
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    OcrEngine(config=TINY)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# B, H, W, Cin, Cout: ragged channel tiles (Cin 1, Cout 24), odd sizes, a
# single pixel, more than one Cout tile, and one production shape
CONV_SHAPES = [(2, 8, 16, 1, 64), (1, 12, 20, 96, 24), (1, 7, 13, 3, 5),
               (1, 1, 1, 3, 5), (2, 9, 33, 17, 70), (16, 30, 30, 512, 512)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_matches_plain_version(cuda, shape, dtype):
    """float32 outputs within rtol 5e-5 / atol 5e-4 of the plain version
    (the same exact products summed in float32 in another order), bf16
    outputs within one bf16 step."""
    B, H, W, cin, cout = shape
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(B, H, W, cin).astype(np.float32)).to(
        device=cuda, dtype=dtype)
    w = torch.from_numpy(
        rng.randn(3, 3, cin, cout).astype(np.float32) * 0.05).to(cuda)
    scale = torch.from_numpy(rng.rand(cout).astype(np.float32) + 0.5).to(cuda)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.1).to(cuda)
    before = conv_fused.conv3x3_bn_relu_cuda.launches
    got = conv_fused.conv3x3_bn_relu(x, w, scale, bias)
    torch.cuda.synchronize()
    assert conv_fused.conv3x3_bn_relu_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, W, cout)
    want = conv_fused.conv_bn_relu_torch(x, w, scale, bias)
    rtol, atol = (5e-5, 5e-4) if dtype == torch.float32 else (2 ** -7, 5e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_conv_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((1, 4, 4, 8), device=cuda)
    w = torch.zeros((3, 3, 8, 8), device=cuda)
    s = torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        conv_fused.conv3x3_bn_relu_cuda(x.permute(0, 2, 1, 3)[:, :, :2], w,
                                        s, s)                # not contiguous
    with pytest.raises(ValueError):
        conv_fused.conv3x3_bn_relu_cuda(x.half(), w, s, s)
    with pytest.raises(ValueError):
        conv_fused.conv3x3_bn_relu_cuda(x, w.cpu(), s, s)


def test_solve_homographies_matches_committed_jax_values(cuda):
    """The 8x8 float32 solve on the card's solver against the JAX values
    of the lane fixture: entries reach page coordinates of several hundred,
    held to rtol 1e-4 / atol 1e-4; a strip corner mapped through them moves
    by less than 0.01 px."""
    lanes = np.load(os.path.join(TESTDATA, "lanes_960.npz"))
    with open(os.path.join(TESTDATA,
                           "expected_jax_lanes_fp32_960.json")) as f:
        want = np.asarray(json.load(f)["homographies"], np.float32)
    quads = torch.from_numpy(lanes["hquads"]).to(cuda)
    widths = torch.from_numpy(lanes["hwidths"]).to(cuda)
    heights = torch.full((16,), 32, dtype=torch.int32, device=cuda)
    got = warp.solve_homographies(quads, heights, widths).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    corner = np.stack([lanes["hwidths"] - 1.0, np.full(16, 31.0),
                       np.ones(16)], -1).astype(np.float32)
    for Hs in (got, want):
        p = np.einsum("nij,nj->ni", Hs, corner)
        np.testing.assert_allclose(p[:, :2] / p[:, 2:], lanes["hquads"][:, 2],
                                   atol=1e-2)
