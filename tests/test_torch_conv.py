"""The fused conv: the port's plain version against ocrjax's Pallas kernel
(interpret mode) and its XLA path, on seeded numpy inputs.

Tolerances: against the Pallas kernel both sides round the operands to
bf16 and sum the same products in float32 in another order, so float32
results are held to rtol/atol 1e-4; against the XLA path (unrounded
float32 operands) to the reference test's own atol 0.15, rtol 0.05.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrjax.ops.pallas import conv_fused as jax_conv
from ocrjax_torch import bench_conv, weights as W
from ocrjax_torch.ops import conv_fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# B, H, W, Cin, Cout: the reference test's shapes, then the ragged channel
# tiles of production (crnn.conv0 has Cin 1, the DB head has Cout 24)
SHAPES = [(1, 16, 16, 8, 16), (2, 8, 24, 16, 8), (2, 8, 16, 1, 16),
          (1, 8, 8, 16, 24)]


def _inputs(shape, seed=0):
    B, H, Wd, cin, cout = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Wd, cin).astype(np.float32),
            rng.randn(3, 3, cin, cout).astype(np.float32) * 0.1,
            rng.rand(cout).astype(np.float32) + 0.5,
            rng.randn(cout).astype(np.float32) * 0.1)


def _port(fn, arrays, dtype=torch.float32):
    x, *rest = (torch.from_numpy(a) for a in arrays)
    return fn(x.to(dtype), *rest).float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_interpret(shape):
    arrays = _inputs(shape)
    want = np.asarray(jax_conv.conv3x3_bn_relu(
        *map(jnp.asarray, arrays), interpret=True, force_pallas=True))
    got = _port(conv_fused.conv_bn_relu_torch, arrays)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got.min() >= 0.0 and got.shape == want.shape


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_matches_xla_path(shape):
    arrays = _inputs(shape, seed=1)
    want = np.asarray(jax_conv.conv_bn_relu_xla(*map(jnp.asarray, arrays)))
    got = _port(conv_fused.conv3x3_bn_relu, arrays)
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)


def test_bf16_input_gives_bf16_output_within_one_step():
    arrays = _inputs(SHAPES[0], seed=2)
    x = jnp.asarray(arrays[0], jnp.bfloat16)
    want = np.asarray(jax_conv.conv3x3_bn_relu(
        x, *map(jnp.asarray, arrays[1:]), interpret=True,
        force_pallas=True).astype(jnp.float32))
    x_t = torch.from_numpy(arrays[0]).to(torch.bfloat16)
    got_t = conv_fused.conv3x3_bn_relu(
        x_t, *(torch.from_numpy(a) for a in arrays[1:]))
    assert got_t.dtype == torch.bfloat16
    # one bf16 step: the float32 sums differ in order before the cast
    np.testing.assert_allclose(got_t.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)


def test_library_call_agrees_with_plain_version():
    arrays = _inputs(SHAPES[1], seed=3)
    # cuDNN's counterpart on the CPU: bf16 conv output before the epilogue
    np.testing.assert_allclose(
        _port(conv_fused.conv_bn_relu_cudnn, arrays),
        _port(conv_fused.conv_bn_relu_torch, arrays), rtol=2 ** -6, atol=2e-2)


def test_fuse_bn_matches_ocrjax_and_batchnorm():
    rng = np.random.RandomState(1)
    gamma, var = rng.rand(8).astype(np.float32) + 0.5, \
        rng.rand(8).astype(np.float32) + 0.1
    beta, mean = rng.randn(8).astype(np.float32), \
        rng.randn(8).astype(np.float32)
    want = jax_conv.fuse_bn(*map(jnp.asarray, (gamma, beta, mean, var)))
    got = conv_fused.fuse_bn(*map(torch.from_numpy,
                                  (gamma, beta, mean, var)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=2e-6)
    x = rng.randn(4, 8).astype(np.float32)
    np.testing.assert_allclose(
        x * got[0].numpy() + got[1].numpy(),
        gamma * (x - mean) / np.sqrt(var + 1e-5) + beta, rtol=2e-5, atol=2e-5)


def test_conv_bn_from_flax_on_a_real_resblock_conv():
    """ResBlock_0's first conv of the shipped detector (64 -> 64): the
    carried (w, scale, bias) through the port equals ocrjax's kernel on the
    flax arrays, and equals conv + BatchNorm + ReLU computed directly."""
    flat, _ = W.read_safetensors(os.path.join(ROOT, "assets",
                                              "det.safetensors"))
    mod = "Backbone_0/ResBlock_0/ConvBNRelu_0"
    w, scale, bias = W.conv_bn_from_flax(flat, mod)
    assert tuple(w.shape) == (3, 3, 64, 64) and tuple(scale.shape) == (64,)
    x = np.random.RandomState(4).randn(1, 12, 20, 64).astype(np.float32)
    bn = f"{mod}/BatchNorm_0"
    j_scale, j_bias = jax_conv.fuse_bn(*(jnp.asarray(flat[k]) for k in (
        f"params/{bn}/scale", f"params/{bn}/bias",
        f"batch_stats/{bn}/mean", f"batch_stats/{bn}/var")))
    want = np.asarray(jax_conv.conv3x3_bn_relu(
        jnp.asarray(x), jnp.asarray(flat[f"params/{mod}/Conv_0/kernel"]),
        j_scale, j_bias, interpret=True, force_pallas=True))
    got = conv_fused.conv3x3_bn_relu(torch.from_numpy(x), w, scale,
                                     bias).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the same layer as the port's detector computes it, in float32
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
        padding=1)
    ref = torch.relu(torch.nn.functional.batch_norm(
        conv, *(torch.from_numpy(flat[k]) for k in (
            f"batch_stats/{bn}/mean", f"batch_stats/{bn}/var",
            f"params/{bn}/scale", f"params/{bn}/bias")), eps=1e-5))
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(),
                               atol=0.15, rtol=0.05)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, s, b = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    with pytest.raises(ValueError):
        conv_fused.conv3x3_bn_relu(x.double(), w, s, b)
    with pytest.raises(ValueError):
        conv_fused.conv3x3_bn_relu(x, w[:, :, :4], s, b)
    with pytest.raises(ValueError):
        conv_fused.conv3x3_bn_relu(x, w, s[:3], b)
    with pytest.raises(ValueError):
        conv_fused.conv3x3_bn_relu_cuda(x, w, s, b)        # CPU tensors
    assert conv_fused.cout_tile(24) == 32 and conv_fused.cout_tile(512) == 64


def test_bench_runs_on_the_cpu_and_needs_cuda_otherwise():
    shapes = [("tiny a", 1, 8, 16, 4, 8), ("tiny b", 2, 4, 8, 1, 24)]
    rows = bench_conv.run(device="cpu", shapes=shapes, reps=2)
    assert [r["label"] for r in rows] == ["tiny a", "tiny b"]
    for r in rows:
        assert r["device"] == "cpu" and r["max_abs_err"] == 0.0
        assert min(r["kernel_ms"], r["cudnn_ms"], r["conv_only_ms"],
                   r["plain_ms"]) > 0.0
    assert "tiny b" in bench_conv.format_table(rows)
    assert len(bench_conv.SHAPES) == 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_conv.run(shapes=shapes, reps=1)


@pytest.mark.parametrize("shape", bench_conv.SHAPES, ids=lambda s: s[0])
def test_every_production_shape_takes_its_fast_path(shape):
    _, B, H, W, cin, cout = shape
    path = conv_fused.conv_path(B, H, W, cin, cout)
    assert path == ("wgmma" if cin >= 64 else "small_cin")
    # a pointer off a 16-byte boundary sends any shape to the general kernel
    assert conv_fused.conv_path(B, H, W, cin, cout, aligned=False) \
        == "generic"


@pytest.mark.parametrize("shape,path", [
    ((1, 7, 13, 3, 5), "generic"), ((1, 1, 1, 3, 5), "generic"),
    ((2, 9, 33, 17, 70), "generic"), ((1, 8, 8, 8, 12), "generic"),
    ((1, 8, 8, 12, 8), "generic"), ((2, 9, 33, 8, 8), "wgmma"),
    ((1, 8, 8, 4, 8), "small_cin"), ((1, 8, 8, 1, 64), "small_cin"),
    ((1, 8, 8, 4, 512), "generic"), ((1, 8, 8, 5, 8), "generic")])
def test_path_choice_on_edge_shapes(shape, path):
    """Cin <= 4 with Cout % 8 == 0 and its weights within 48 KB of shared
    memory is the small-Cin path; Cin % 8 == 0 and Cout % 8 == 0 is wgmma;
    ragged channels are the general kernel's."""
    assert conv_fused.conv_path(*shape) == path


# label -> (th, tw, bn, images a block, padded pixels of one image)
PLANS = {"db.res1 960/4": (8, 16, 64, 1, 57600),
         "db.res2 960/8": (8, 16, 128, 2, 15360),
         "db.res3 960/16": (4, 32, 128, 2, 3840),
         "db.res4 960/32": (8, 16, 128, 2, 1024),
         "db.fpn.smooth": (8, 16, 24, 1, 57600),
         "db.head.conv": (8, 16, 24, 1, 57600),
         "crnn.conv1": (8, 16, 128, 2, 2560),
         "crnn.conv2": (8, 16, 128, 2, 640),
         "crnn.conv3": (8, 16, 128, 2, 640),
         "crnn.conv4": (4, 16, 128, 4, 320),
         "crnn.conv5": (4, 16, 128, 4, 320)}


@pytest.mark.parametrize("shape", [s for s in bench_conv.SHAPES
                                   if s[0] in PLANS], ids=lambda s: s[0])
def test_tile_plan_of_every_wgmma_production_shape(shape):
    label, B, H, W, cin, cout = shape
    for itemsize in (2, 4):
        plan = conv_fused.conv_plan(B, H, W, cin, cout, itemsize)
        assert (plan["th"], plan["tw"], plan["bn"], plan["images"],
                plan["padded_pixels"]) == PLANS[label]
        # a block takes 128 pixels, or 256 at the wide Cout tile
        assert plan["images"] * plan["th"] * plan["tw"] \
            == (256 if plan["bn"] == 128 else 128)
        # a short map fills its tiles: the CRNN's 4 x 80 maps take 4 x 16
        # patches of four images and pad nothing; 30 x 30 pads the most
        assert plan["padded_pixels"] <= 1.14 * H * W
        assert 2 <= plan["stages"] <= conv_fused.WGMMA_MAX_STAGES
        assert plan["smem_bytes"] <= conv_fused.SHARED_MEMORY_LIMIT
        assert plan["stage_bytes"] % 512 == 0      # the swizzle's period
        # narrow Cout tiles leave room for a second block on the SM
        assert plan["blocks_per_sm"] == (2 if plan["bn"] <= 64 else 1)
        assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) \
            <= conv_fused.SHARED_MEMORY_LIMIT
        # 8 consumer warps stage 16 pixel rows x up to 64 channels each
        assert plan["staging_bytes"] \
            == 128 * (min(plan["bn"], 64) * itemsize + 16)
        assert plan["smem_bytes"] == 1024 + 16 * conv_fused.WGMMA_MAX_STAGES \
            + plan["staging_bytes"] + plan["stages"] * plan["stage_bytes"]
        assert plan["cin_pad"] % conv_fused.WGMMA_CHUNK == 0 \
            and 0 <= plan["cin_pad"] - cin < conv_fused.WGMMA_CHUNK
        assert plan["cout_pad"] % plan["bn"] == 0 \
            and 0 <= plan["cout_pad"] - cout < plan["bn"]
        assert plan["tiles"] == -(-B // plan["images"]) \
            * (plan["padded_pixels"] // (plan["th"] * plan["tw"])) \
            * (plan["cout_pad"] // plan["bn"])


@pytest.mark.parametrize("B,H,W,cout,tile,images", [
    (1, 2, 200, 64, (2, 64), 1), (1, 4, 80, 64, (4, 32), 1),
    (2, 4, 80, 64, (4, 16), 2), (1, 8, 80, 64, (8, 16), 1),
    (1, 1, 1, 64, (8, 16), 1), (1, 3, 64, 64, (4, 32), 1),
    (16, 240, 240, 64, (8, 16), 1), (256, 4, 80, 512, (4, 16), 4),
    (3, 4, 80, 256, (4, 16), 4), (2, 4, 80, 256, (4, 32), 2),
    (1, 4, 80, 256, (4, 32), 1)])
def test_tile_plan_picks_the_patch_that_computes_least(B, H, W, cout, tile,
                                                       images):
    """Padded pixels times the images a block takes, idle ones included: a
    4 x 16 patch pads a 4 x 80 map least, but it spreads a block over twice
    as many images, which a batch of one or two does not fill."""
    plan = conv_fused.conv_plan(B, H, W, 64, cout)
    assert (plan["th"], plan["tw"]) == tile and plan["images"] == images
    pixels = plan["images"] * plan["th"] * plan["tw"]

    def work(th, tw):
        per_block = pixels // (th * tw)
        return -(-B // per_block) * per_block \
            * (-(-H // th) * th) * (-(-W // tw) * tw)
    assert work(*tile) == min(work(*t) for t in conv_fused.WGMMA_TILES)


@pytest.mark.parametrize("B,cout,images", [
    (16, 512, 2), (1, 512, 1), (16, 64, 1), (3, 128, 2), (2, 136, 2),
    (16, 24, 1)])
def test_tile_plan_takes_two_images_a_block_only_at_the_wide_cout_tile(
        B, cout, images):
    plan = conv_fused.conv_plan(B, 8, 80, 256, cout, 2)
    assert plan["images"] == images
    assert plan["smem_bytes"] <= conv_fused.SHARED_MEMORY_LIMIT
    assert plan["stages"] >= 2


@pytest.mark.parametrize("cin,cout,cin_pad,cout_pad", [
    (64, 64, 64, 64), (96, 24, 96, 24), (8, 8, 32, 24), (5, 7, 32, 64)])
def test_pack_weights_torch_against_the_index_formula(cin, cout, cin_pad,
                                                      cout_pad):
    w = np.random.RandomState(5).randn(3, 3, cin, cout).astype(np.float32)
    got = conv_fused.pack_weights_torch(torch.from_numpy(w), cin_pad,
                                        cout_pad)
    assert got.dtype == torch.bfloat16 \
        and tuple(got.shape) == (9, cout_pad, cin_pad)
    want = np.zeros((9, cout_pad, cin_pad), np.float32)
    rounded = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    for tap in range(9):
        for n in range(cout):
            for c in range(cin):
                want[tap, n, c] = rounded[tap // 3, tap % 3, c, n]
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_cuda_wrapper_refuses_an_unknown_path_and_cpu_tensors():
    x, w, s, b = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    for path in (None, "wgmma", "generic", "cudnn"):
        with pytest.raises(ValueError):
            conv_fused.conv3x3_bn_relu_cuda(x, w, s, b, path=path)
    counter = conv_fused.conv3x3_bn_relu_cuda
    assert set(counter.launches_by_path) == set(conv_fused.PATHS)
    assert sum(counter.launches_by_path.values()) == counter.launches
