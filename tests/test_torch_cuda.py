"""Tests that need an NVIDIA GPU: the cc_label and conv_fused CUDA kernels
against their plain versions, the homography solve against committed JAX
values, the engine's device settings, and the device-agnostic beam search
and 180-degree flip giving the card the CPU's answers (tie order of the
stable sort included). They skip without CUDA.
This file imports neither JAX nor ocrjax, so on the GPU machine (which has
no JAX) it runs without the suite's conftest:
    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

from ocrjax_torch.models import cls
from ocrjax_torch.ops import cc_label, conv_fused, ctc, warp

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
    ((4, 512, 512), 0.5, 4), ((3, 37, 70), 0.3, 5), ((1, 1, 1), 0.0, 4),
    ((2, 448, 192), 0.5, 4)])
def test_kernel_bit_exact(cuda, shape, density, n_iters):
    g = torch.Generator(device=cuda).manual_seed(0)
    bm = torch.rand(shape, generator=g, device=cuda) > density
    before = cc_label.label_components_cuda.launches
    got = cc_label.label_components(bm, n_iters)
    torch.cuda.synchronize()
    assert cc_label.label_components_cuda.launches == before + 1
    assert torch.equal(got, cc_label.label_components_torch(bm, n_iters))


# the edges of the shared-memory path: the lanes' grids, the most pixels a
# uint16 label can index (255 x 257 = 65,535), one pixel more than that
# (256 x 256, the cluster path's), a width that is no multiple of 8, rows
# wider than a warp's 256 pixels, one pixel, no sweep at all; the cluster
# path on the C5 grids, an odd number of sweeps, a height that is no
# multiple of 8 and a width that is no multiple of 4; the general path past
# the cluster path's widest row
@pytest.mark.parametrize("shape,density,n_iters,path", [
    ((16, 240, 240), 0.5, 4, "shared"), ((2, 128, 128), 0.5, 4, "shared"),
    ((1, 255, 257), 0.5, 4, "shared"), ((1, 256, 256), 0.5, 4, "cluster"),
    ((3, 37, 70), 0.3, 5, "shared"), ((1, 3, 1000), 0.2, 6, "shared"),
    ((1, 1, 1), 0.0, 4, "shared"), ((2, 64, 64), 0.6, 0, "shared"),
    ((4, 512, 512), 0.5, 4, "cluster"), ((2, 512, 192), 0.72, 5, "cluster"),
    ((3, 448, 512), 0.3, 6, "cluster"), ((2, 448, 192), 0.5, 4, "cluster"),
    ((2, 301, 258), 0.4, 4, "cluster"), ((1, 70, 1100), 0.5, 4, "global")])
def test_kernel_bit_exact_on_the_path_it_picks(cuda, shape, density, n_iters,
                                               path):
    g = torch.Generator(device=cuda).manual_seed(1)
    bm = torch.rand(shape, generator=g, device=cuda) > density
    want = cc_label.label_components_torch(bm, n_iters)
    counter = cc_label.label_components_cuda
    before = dict(counter.launches_by_path)
    got = cc_label.label_components(bm, n_iters)
    torch.cuda.synchronize()
    assert counter.launches_by_path == {
        p: before[p] + (p == path) for p in cc_label.PATHS}
    assert torch.equal(got, want)
    # the general path takes every grid; the cluster path every grid whose
    # band fits; the shared path only what fits it
    forced = counter(bm, n_iters, path="global")
    torch.cuda.synchronize()
    assert counter.launches_by_path["global"] == before["global"] + 1 \
        + (path == "global")
    assert torch.equal(forced, want)
    if cc_label.fits_cluster(*shape[1:]):
        assert torch.equal(counter(bm, n_iters, path="cluster"), want)
    else:
        with pytest.raises(ValueError):
            counter(bm, n_iters, path="cluster")
    if path != "shared":
        with pytest.raises(ValueError):
            counter(bm, n_iters, path="shared")


def test_kernel_takes_uint8_and_bool_bitmaps_alike(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    bm = torch.rand((2, 40, 48), generator=g, device=cuda) > 0.5
    want = cc_label.label_components_torch(bm, 4)
    for same in (bm, bm.to(torch.uint8) * 7, bm.transpose(1, 2).contiguous()
                 .transpose(1, 2)):
        for path in cc_label.PATHS:
            assert torch.equal(
                cc_label.label_components_cuda(same, 4, path=path), want)


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


def _conv_inputs(shape, dtype, device):
    B, H, W, cin, cout = shape
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(B, H, W, cin).astype(np.float32)).to(
        device=device, dtype=dtype)
    w = torch.from_numpy(
        rng.randn(3, 3, cin, cout).astype(np.float32) * 0.05).to(device)
    scale = torch.from_numpy(
        rng.rand(cout).astype(np.float32) + 0.5).to(device)
    bias = torch.from_numpy(
        rng.randn(cout).astype(np.float32) * 0.1).to(device)
    return x, w, scale, bias


def _assert_conv_close(got, want, dtype):
    rtol, atol = (5e-5, 5e-4) if dtype == torch.float32 else (2 ** -7, 5e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_matches_plain_version(cuda, shape, dtype):
    """float32 outputs within rtol 5e-5 / atol 5e-4 of the plain version
    (the same exact products summed in float32 in another order), bf16
    outputs within one bf16 step."""
    B, H, W, cin, cout = shape
    x, w, scale, bias = _conv_inputs(shape, dtype, cuda)
    before = conv_fused.conv3x3_bn_relu_cuda.launches
    got = conv_fused.conv3x3_bn_relu(x, w, scale, bias)
    torch.cuda.synchronize()
    assert conv_fused.conv3x3_bn_relu_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, W, cout)
    want = conv_fused.conv_bn_relu_torch(x, w, scale, bias)
    _assert_conv_close(got, want, dtype)


# B, H, W, Cin, Cout and the path the wrapper must pick: wgmma with an n24
# Cout tile and a ragged second Cin chunk (96), on a short 4 x 80 map with
# two Cout tiles (4 x 16 patches of four images, the batch of 3 leaving one
# idle), with one half-filled k16 step (Cin 8), with float32 x, on a 2 x 64
# patch, on 4 x 16 patches of two images at the 64-wide Cout tile and of
# four at the 128-wide one with float32 x; Cin 1 and Cin 4 on the small-Cin
# path; ragged channels on the general path
CONV_PATH_CASES = [
    ((1, 12, 20, 96, 24), torch.bfloat16, "wgmma"),
    ((3, 4, 80, 128, 256), torch.bfloat16, "wgmma"),
    ((2, 9, 33, 8, 8), torch.bfloat16, "wgmma"),
    ((2, 30, 30, 64, 64), torch.float32, "wgmma"),
    ((1, 2, 100, 64, 136), torch.bfloat16, "wgmma"),
    ((2, 4, 80, 64, 64), torch.bfloat16, "wgmma"),
    ((7, 4, 80, 128, 136), torch.float32, "wgmma"),
    ((2, 8, 16, 1, 64), torch.bfloat16, "small_cin"),
    ((2, 7, 13, 4, 16), torch.float32, "small_cin"),
    ((1, 7, 13, 3, 5), torch.bfloat16, "generic"),
    ((2, 9, 33, 17, 70), torch.float32, "generic"),
    ((1, 8, 8, 8, 12), torch.bfloat16, "generic")]


@pytest.mark.parametrize("shape,dtype,path", CONV_PATH_CASES)
def test_conv_kernel_path_and_forced_general_path(cuda, shape, dtype, path):
    x, w, scale, bias = _conv_inputs(shape, dtype, cuda)
    counter = conv_fused.conv3x3_bn_relu_cuda
    before = dict(counter.launches_by_path)
    got = conv_fused.conv3x3_bn_relu(x, w, scale, bias)
    torch.cuda.synchronize()
    after = dict(counter.launches_by_path)
    assert {k: after[k] - before[k] for k in after} \
        == {k: int(k == path) for k in after}
    want = conv_fused.conv_bn_relu_torch(x, w, scale, bias)
    _assert_conv_close(got, want, dtype)
    forced = counter(x, w, scale, bias, path="generic")
    torch.cuda.synchronize()
    assert counter.launches_by_path["generic"] == after["generic"] + 1
    _assert_conv_close(forced, want, dtype)
    for other in ("wgmma", "small_cin"):
        if other != path:
            with pytest.raises(ValueError):
                counter(x, w, scale, bias, path=other)


def test_unaligned_x_goes_to_the_general_path(cuda):
    x, w, scale, bias = _conv_inputs((1, 8, 16, 64, 64), torch.bfloat16,
                                     cuda)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda)
    flat[1:] = x.reshape(-1)
    shifted = flat[1:].view(x.shape)          # 2 bytes off a 16-byte boundary
    counter = conv_fused.conv3x3_bn_relu_cuda
    before = dict(counter.launches_by_path)
    got = counter(shifted, w, scale, bias)
    torch.cuda.synchronize()
    assert counter.launches_by_path["generic"] == before["generic"] + 1
    assert torch.equal(got, counter(x, w, scale, bias, path="generic"))


@pytest.mark.parametrize("cin,cout", [(64, 64), (96, 24), (8, 8), (40, 136)])
def test_pack_weights_kernel_bit_equal_to_plain_version(cuda, cin, cout):
    plan = conv_fused.conv_plan(1, 8, 16, cin, cout)
    w = torch.from_numpy(np.random.RandomState(3).randn(
        3, 3, cin, cout).astype(np.float32)).to(cuda)
    got = conv_fused.pack_weights_cuda(w, plan["cin_pad"], plan["cout_pad"])
    want = conv_fused.pack_weights_torch(w, plan["cin_pad"],
                                         plan["cout_pad"])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


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


@pytest.mark.parametrize("case", ["uniform", "random"])
def test_beam_decode_on_the_card_equals_the_cpu(cuda, case):
    """Uniform logits tie everywhere: the stable sort must keep index
    order on the card as on the CPU."""
    rng = np.random.RandomState(4)
    logits = np.zeros((8, 80, 96), np.float32) if case == "uniform" \
        else (rng.randn(8, 80, 96) * 3).astype(np.float32)
    lengths = torch.from_numpy(np.asarray([80, 0, 1, 17, 80, 40, 63, 5]))
    want = ctc.ctc_beam_decode(torch.from_numpy(logits), lengths,
                               max_tokens=16)
    got = ctc.ctc_beam_decode(torch.from_numpy(logits).to(cuda),
                              lengths.to(cuda), max_tokens=16)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-5, atol=0)


def test_flip_strips_on_the_card_is_bit_exact(cuda):
    rng = np.random.RandomState(5)
    strips = torch.from_numpy(rng.randn(6, 32, 96).astype(np.float32))
    widths = torch.tensor([96, 1, 0, 40, 95, 7])
    flip = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.bool)
    want = cls.flip_strips_by_width(strips, widths, flip, -1.0)
    got = cls.flip_strips_by_width(strips.to(cuda), widths.to(cuda),
                                   flip.to(cuda), -1.0)
    assert torch.equal(got.cpu(), want)


def test_stage_timer_records_device_time_on_the_card(cuda):
    """On the card a stage has CUDA-event device time beside its host time
    and its call count."""
    from ocrjax_torch.utils import profiling as P
    timer = P.StageTimer("cuda")
    x = torch.randn(2048, 2048, device=cuda)
    with timer.active():
        for _ in range(2):
            with P.stage("matmul"):
                x @ x
    assert timer.report()["matmul"] > 0
    assert timer.host_report(calls=True)["matmul"]["calls"] == 2
