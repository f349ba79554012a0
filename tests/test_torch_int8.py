"""The int8 detection path (ocrjax_torch/models/db_int8.py) against
ocrjax.models.db_int8, and det_int8 on the engine's lanes against ocrjax.

Layer level: the quantized conv is bit-exact to the reference's jitted
_qconv (same int8 codes, exact int32 sums, the dequantization as one fused
multiply-add); the BN fold takes the correctly rounded rsqrt where XLA uses
its own, so a folded weight may sit one ulp off (measured on 89% equal
channels). The prob maps of the whole int8 forward are held to 2e-3 at
small and flagship widths, float32 on both sides. Lanes: the goldens bar
(identical strings and order, boxes within 0.011 px, scores within 2e-3)
on the shipped assets at 512 with the reference's BN fold; with the port's
own fold, strings, order and boxes at the bar and the scores within 0.05 on
the page held here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.models import db_int8 as jq
from ocrjax.models.db import DBDetector as JaxDB
from ocrjax_torch import weights as W
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.models import db_int8 as tq
from ocrjax_torch.models.crnn import BatchNorm
from ocrjax_torch.models.db import DBDetector
from test_torch_db import _random_state, _to_flax
from test_torch_fixture import few_torch_threads  # noqa: F401
from test_torch_fixture import jax_int8_fold
from test_torch_slice import _page

TINY_ARCH = dict(channels=(8, 16, 24, 32), blocks_per_stage=1, inner=16)
FLAGSHIP_ARCH = dict(channels=(64, 128, 256, 512), blocks_per_stage=2,
                     inner=96)


def _jax_qconv(x, w, b, stride, relu=False):
    """The reference's _qconv under jit (as its callers run it), NHWC."""
    f = jax.jit(lambda x, w, b: jq._qconv(x, w, b, (stride, stride), relu,
                                          jnp.float32))
    return np.asarray(f(x, w, b))


def _port_qconv(x, w, b, stride, relu=False):
    return tq.qconv(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w).permute(3, 2, 0, 1),
                    None if b is None else torch.from_numpy(b), stride,
                    relu, torch.float32).permute(0, 2, 3, 1).numpy()


# (cin, cout, kernel, stride, bias): the stem, a block conv, a projection,
# an FPN lateral and smooth (no bias), a wide input (sums past 2^24)
LAYERS = [(3, 32, 3, 2, True), (64, 64, 3, 1, True), (64, 128, 1, 2, True),
          (256, 96, 1, 1, False), (96, 24, 3, 1, False),
          (512, 512, 3, 1, True), (8, 16, 3, 2, True)]


@pytest.mark.parametrize("layer", LAYERS, ids=lambda c: "x".join(map(str, c)))
def test_qconv_is_bit_exact_to_ocrjax(layer):
    cin, cout, k, s, with_bias = layer
    rng = np.random.RandomState(cin + cout)
    # channels of very different magnitude, as a trained net has them
    x = (rng.randn(2, 11, 13, cin)
         * rng.uniform(0.05, 8.0, cin)).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32) if with_bias else None
    want = _jax_qconv(x, w, b, s, relu=True)
    got = _port_qconv(x, w, b, s, relu=True)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_dequant_epilogue_is_one_fused_multiply_add():
    """XLA evaluates y * ws + bias as one FMA; two float32 roundings differ
    from it, and the port's single float64 evaluation does not."""
    rng = np.random.RandomState(3)
    cin, cout = 64, 64
    x = (rng.randn(4, 16, 16, cin) * rng.uniform(0.1, 4, cin)
         ).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) / 24.0).astype(np.float32)
    b = (rng.randn(cout) * 0.3).astype(np.float32)
    want = _jax_qconv(x, w, b, 1)
    np.testing.assert_array_equal(_port_qconv(x, w, b, 1), want)

    # the same layer with the epilogue rounded twice
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    sx = torch.clamp(xt.abs().amax(dim=(0, 2, 3)), min=1e-8) * tq._INV_QMAX
    xq = torch.clamp(torch.round(xt / sx[None, :, None, None]), -127, 127
                     ).to(torch.int8)
    w_eff = wt * sx[None, :, None, None]
    ws = torch.clamp(w_eff.abs().amax(dim=(1, 2, 3)), min=1e-8) * tq._INV_QMAX
    wq = torch.clamp(torch.round(w_eff / ws[:, None, None, None]), -127, 127
                     ).to(torch.int8)
    y = tq.int8_conv(xq, wq, 1).float()
    twice = (y * ws[None, :, None, None]
             + torch.from_numpy(b)[None, :, None, None])
    assert (twice.permute(0, 2, 3, 1).numpy() != want).sum() > 0


@pytest.mark.parametrize("shape", [(2, 3, 9, 11, 16, 3, 2),
                                   (1, 24, 5, 7, 4, 3, 1),
                                   (1, 130, 4, 4, 40, 3, 1),
                                   (3, 64, 6, 6, 128, 1, 2),
                                   (1, 8, 2, 2, 8, 3, 1)])
def test_int_mm_route_is_the_exact_convolution(shape):
    """The card's route (im2col + torch._int_mm, K and N zero-padded to
    multiples of 8, short row counts padded) equals the plain float64
    convolution and an int64 reference bit for bit, in int32."""
    B, ci, H, Wd, co, k, s = shape
    g = torch.Generator().manual_seed(sum(shape))
    xq = torch.randint(-127, 128, (B, ci, H, Wd), dtype=torch.int8,
                       generator=g)
    wq = torch.randint(-127, 128, (co, ci, k, k), dtype=torch.int8,
                       generator=g)
    got = tq.int8_conv_int_mm(xq, wq, s)
    plain = tq.int8_conv_plain(xq, wq, s)
    assert got.dtype == plain.dtype == torch.int32
    assert torch.equal(got, plain)
    # int64 reference: the same SAME padding, every tap summed exactly
    from ocrjax_torch.models.crnn import same_pads
    xp = torch.nn.functional.pad(xq.long(), same_pads((H, Wd), (k, k),
                                                      (s, s)))
    Ho, Wo = -(-H // s), -(-Wd // s)
    ref = torch.zeros((B, co, Ho, Wo), dtype=torch.long)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, :, dy:dy + s * (Ho - 1) + 1:s,
                     dx:dx + s * (Wo - 1) + 1:s]
            ref += torch.einsum("bihw,oi->bohw", tap, wq[:, :, dy, dx].long())
    assert torch.equal(plain.long(), ref)


def test_fold_bn_agrees_with_ocrjax_to_one_ulp():
    """g = scale * rsqrt(var + eps) one ulp off at most, so w' = k * g
    within two float32 ulps (2^-21 relative)."""
    rng = np.random.RandomState(4)
    n = 2048
    bn = BatchNorm(n)
    for name, v in (("weight", rng.uniform(0.5, 1.5, n)),
                    ("bias", rng.randn(n) * 0.1),
                    ("running_mean", rng.randn(n)),
                    ("running_var", rng.uniform(0.01, 3.0, n))):
        getattr(bn, name).data = torch.from_numpy(v.astype(np.float32))
    k = rng.randn(3, 3, 2, n).astype(np.float32)
    f = jax.jit(lambda k, s, b, m, v: jq._fold_bn(
        k, {"scale": s, "bias": b}, {"mean": m, "var": v}))
    jw, jb = (np.asarray(a) for a in f(
        k, *(getattr(bn, a).detach().numpy()
             for a in ("weight", "bias", "running_mean", "running_var"))))
    tw, tb = tq.fold_bn(torch.from_numpy(k).permute(3, 2, 0, 1), bn)
    tw = tw.permute(2, 3, 1, 0).detach().numpy()
    tb = tb.detach().numpy()
    assert (tw == jw).all(axis=(0, 1, 2)).mean() > 0.85
    assert (tb == jb).mean() > 0.85
    np.testing.assert_allclose(tw, jw, rtol=2.0 ** -21, atol=0)
    # bias - mean * g: one ulp of mean * g (|mean * g| < 8) when g is off
    np.testing.assert_allclose(tb, jb, rtol=2.0 ** -21, atol=2.0 ** -21 * 8)


def _carried(arch, seed):
    """A port DBDetector with random weights and the same weights as a
    flax variable tree."""
    rng = np.random.RandomState(seed)
    arch = dict(arch, head_stride=1)
    tm = DBDetector(**arch, dtype=torch.float32)
    sd = _random_state(tm, rng)
    table = W._db_key_table(arch["channels"], arch["blocks_per_stage"], 1)
    flat = {fk: np.ascontiguousarray(_to_flax(sd[tk], kind))
            for fk, tk, kind in table}
    W.load_into(tm, W.db_state_dict(flat, arch)[0])
    nested = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return tm.eval(), JaxDB(**arch, dtype=jnp.float32), nested


def _jax_fold(weight, bn):
    """The reference's jitted BN fold, on port tensors."""
    f = jax.jit(lambda k, s, b, m, v: jq._fold_bn(
        k, {"scale": s, "bias": b}, {"mean": m, "var": v}))
    w, b = f(weight.detach().permute(2, 3, 1, 0).numpy(),
             *(getattr(bn, a).detach().numpy()
               for a in ("weight", "bias", "running_mean", "running_var")))
    return (torch.tensor(np.asarray(w)).permute(3, 2, 0, 1),
            torch.tensor(np.asarray(b)))


def _reference_fold(model):
    """fold_bn with the reference's folded values of every BatchNorm of
    `model` (jax_int8_fold), looked up by module."""
    modules = dict(model.named_modules())
    table = {id(modules[name]): (torch.tensor(g), torch.tensor(b))
             for name, (g, b) in jax_int8_fold(model).items()}

    def fold(weight, bn):
        g, b = table[id(bn)]
        return weight.float() * g[:, None, None, None], b
    return fold


# arch, the bar with the reference's folded weights, the bar with the
# port's own fold (an int8 code one step off where a weight sits at a .5
# moves a random-weight net's prob map by up to ~0.04)
@pytest.mark.parametrize("arch,same_fold_tol,own_fold_tol",
                         [(TINY_ARCH, 1e-6, 0.02),
                          (FLAGSHIP_ARCH, 1e-3, 0.06)],
                         ids=["tiny", "flagship"])
def test_prob_int8_matches_ocrjax(arch, same_fold_tol, own_fold_tol,
                                  monkeypatch):
    """Whole int8 forward, 2 canvases of 256^2, random weights: with the
    reference's folded weights the port's forward agrees to float32
    rounding (the float head); with its own fold, within one-code flips,
    and its thresholded bitmap almost everywhere."""
    tm, jm, variables = _carried(arch, 11)
    rng = np.random.RandomState(12)
    x = rng.randn(2, 256, 256, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jq.prob_int8(jm, v, x))(
        variables, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        own = tq.apply_prob(tm, xt, True).numpy()
        monkeypatch.setattr(tq, "fold_bn", _jax_fold)
        same = tq.apply_prob(tm, xt, True).numpy()
    assert own.shape == same.shape == want.shape == (2, 256, 256)
    assert want.std() > 1e-3
    assert np.abs(same - want).max() <= same_fold_tol
    assert np.abs(own - want).max() <= own_fold_tol
    thr = float(np.median(want))
    assert ((own > thr) == (want > thr)).mean() > 0.99


def test_the_activation_scale_spans_the_batch():
    """A page's int8 prob map depends on the other pages of its call, in
    both packages alike, and not on repeats of them."""
    tm, jm, variables = _carried(TINY_ARCH, 13)
    rng = np.random.RandomState(14)
    a = rng.randn(1, 64, 64, 3).astype(np.float32)
    b = (rng.randn(1, 64, 64, 3) * 3.0).astype(np.float32)
    f = jax.jit(lambda v, x: jq.prob_int8(jm, v, x))
    alone, together = (np.asarray(f(variables, jnp.asarray(x)))[0]
                       for x in (a, np.concatenate([a, b])))
    with torch.no_grad():
        t_alone, t_together = (
            tq.prob_int8(tm, torch.from_numpy(x).permute(0, 3, 1, 2))[0]
            .numpy() for x in (a, np.concatenate([a, b])))
    assert np.abs(alone - together).max() > 1e-3
    assert np.abs(t_alone - t_together).max() > 1e-3
    assert np.abs(t_alone - alone).max() <= 2e-3
    assert np.abs(t_together - together).max() <= 2e-3
    # a batch repeated has the batch's per-channel maxima: the same codes,
    # so chip_smoke's 16-page chunk (4 pages x 4) reads as the 4 pages do
    ab = np.concatenate([a, b])
    with torch.no_grad():
        rep = tq.prob_int8(tm, torch.from_numpy(np.concatenate([ab, ab, ab])
                                                ).permute(0, 3, 1, 2))
    for k in range(3):
        np.testing.assert_array_equal(rep[2 * k].numpy(), t_together)


@pytest.fixture(scope="module")
def engines():
    cfg = asset_config(det_max_side=512, compute_dtype="float32",
                       det_int8=True)
    return (JaxEngine.from_pretrained(config=JaxConfig(
        **dataclasses.asdict(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


@pytest.fixture(scope="module")
def lane_outputs(engines):
    """ocrjax's det_int8 outputs on one page at 512: the fused lane
    (ocr_batch and ocr(), one program), the bucketed lane and detect()
    (one detection program)."""
    jax_engine, _ = engines
    page = _page(101, n_lines=(3, 6), text_height=(20, 40))
    return page, _lanes(jax_engine, page)


def _lanes(engine, page):
    return (engine.ocr_batch([page], fused=True) + [engine.ocr(page)]
            + engine.ocr_batch([page], fused=False), engine.detect(page))


def _assert_boxes(got, want, score_tol, min_boxes=3):
    assert len(got) == len(want) >= min_boxes
    assert np.abs(np.stack([b.quad for b in got])
                  - np.stack([b.quad for b in want])).max() <= 0.011
    assert np.abs(np.asarray([b.score for b in got])
                  - np.asarray([b.score for b in want])).max() <= score_tol


@pytest.mark.parametrize("fold", ["reference", "own"])
def test_int8_lanes_match_ocrjax(engines, lane_outputs, fold, monkeypatch):
    """det_int8 on the fused lane, the bucketed lane and detect at 512.

    With the reference's BN fold (XLA:CPU's rsqrt) the port meets the
    goldens bar: everything after the fold is exact. With its own, the
    correctly rounded rsqrt, one ulp of a folded weight flips an int8
    code now and then, and the flip moves the next layers' activation
    scales: on this page strings, order and boxes still meet the bar and
    the mean-prob box scores move (by up to 0.028 over 8 such pages at
    512; at 960 a line of 1 page in 12 reads otherwise and boxes move by
    up to 0.54 px, chip_smoke.py phase 10)."""
    _, port = engines
    page, (want, want_det) = lane_outputs
    score_tol = 2e-3
    if fold == "reference":
        monkeypatch.setattr(tq, "fold_bn", _reference_fold(port.det_model))
    else:
        score_tol = 0.05
    got, got_det = _lanes(port, page)
    for g, w in zip(got, want):
        assert [line.text for line in g.lines] == \
            [line.text for line in w.lines]
        _assert_boxes([line.box for line in g.lines],
                      [line.box for line in w.lines], score_tol)
    _assert_boxes(got_det, want_det, score_tol)


def test_int8_tiled_detection_matches_ocrjax(monkeypatch):
    """detect_tiled with det_int8 and the tile detector off: the flagship
    DB in int8 on 256-pixel tiles (one call of 4 tiles), against ocrjax
    with its own BN fold."""
    cfg = asset_config(det_max_side=256, compute_dtype="float32",
                       det_int8=True, tile_det_enable=False, tile_size=256,
                       tile_overlap=32, tile_max_candidates=64)
    jax_engine = JaxEngine.from_pretrained(config=JaxConfig(
        **dataclasses.asdict(cfg)))
    port = OcrEngine.from_pretrained(config=cfg, device="cpu")
    monkeypatch.setattr(tq, "fold_bn", _reference_fold(port.det_model))
    from ocrjax.train import synth
    page = synth.render_page(np.random.RandomState(105), port.charset,
                             size=(256, 448), n_lines=(4, 6),
                             text_height=(18, 28))[0]
    from ocrjax_torch import tiling
    assert tiling._tile_forward(port).int8
    _assert_boxes(port.detect_tiled(page), jax_engine.detect_tiled(page),
                  2e-3, min_boxes=2)
    # with the tile detector loaded and enabled, tiles stay in float
    assert not tiling._tile_forward(OcrEngine.from_pretrained(
        config=cfg.replace(tile_det_enable=True), device="cpu")).int8
