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
