"""The port's det trainer (ocrjax_torch/train/det_trainer.py), det_gt and
det_crops against ocrjax on the CPU.

Bars (the rec trainer's, tests/test_torch_train_rec.py):
  * 3 steps of make_det_train_step from one flax init carried to the port,
    the tile preset (32/64/128/256, FPN 64) at 96 px on 2-page batches,
    head stride 1 and 4 (pooled targets): losses within 1e-4 relative,
    update norms per leaf within 2e-2 relative, BN running statistics
    within 1e-5. The bias of each head's first ConvTranspose feeds a
    train-mode BatchNorm, which removes any per-channel constant: its
    exact gradient is 0, both frameworks train it on rounding noise, and
    Adam scales noise up to a full step, so its update is not compared.
  * db_loss on maps with ties (prob on a few levels, so the OHEM cut
    lands in a run of equal losses): loss and parts within 1e-6 relative;
    quantile_rows equals jnp.quantile bit for bit.
  * det_gt.db_gt_maps and make_det_batch equal exactly, rotated quads too.
  * eval_detection and generate_det_crops on the shipped assets give
    ocrjax's numbers and crops (images within one level on 0.5% of
    pixels: the u8 rounding of float strips).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.charset import Charset as JaxCharset
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.config import TINY as JAX_TINY
from ocrjax.models.db import DB_ARCHS, create_db_arch
from ocrjax.train import det_crops as jcrops
from ocrjax.train import det_gt as jgt
from ocrjax.train import det_trainer as JD
from ocrjax.train import synth as jsynth
from ocrjax_torch import weights as W
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.config import TINY
from ocrjax_torch.models.db import create_db
from ocrjax_torch.train import det_crops, det_gt
from ocrjax_torch.train import det_trainer as D
from test_torch_fixture import (  # noqa: F401
    few_torch_threads, jax_fields, one_rank_mesh)
from test_torch_train_rec import LOSS_RTOL, compare_steps, flat_of

NOISE_LEAVES = ("params/DBHead_0/ConvTranspose_0/bias",
                "params/DBHead_1/ConvTranspose_0/bias")


@pytest.mark.parametrize("hs", [1, 4])
def test_three_det_steps_match_ocrjax(hs):
    arch = dict(DB_ARCHS["tile"], head_stride=hs)
    cs = JaxCharset("abcdefghij")
    model = create_db_arch(JAX_TINY.replace(det_head_stride=hs), arch)
    S = 96
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    steps, lr = 20, 3e-4
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(
        optax.warmup_cosine_decay_schedule(0.0, lr, 3, steps)))
    cfg_j = JAX_TINY.replace(det_head_stride=hs)
    jstep = JD.make_det_train_step(model, tx, cfg_j)
    rng = np.random.RandomState(0)
    batches = [jgt.make_det_batch(rng, cs, 2, S, n_lines=(2, 4))
               for _ in range(3)]
    p, bs, st = v["params"], v["batch_stats"], tx.init(v["params"])
    jl = []
    for b in batches:
        p, bs, st, loss, _ = jstep(p, bs, st, *map(jnp.asarray, b))
        jl.append(float(loss))

    port = create_db(TINY.replace(det_head_stride=hs), arch)
    W.load_model_variables(port, flat_of(v))
    opt = D.det_optimizer(port, lr, steps)
    step = D.make_det_train_step(port, opt, TINY)
    tl = [float(step(*(torch.from_numpy(a) for a in b))[0]) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    compare_steps(flat_of(v), flat_of({"params": p, "batch_stats": bs}),
                  W.model_variables(port), skip=NOISE_LEAVES)


def _tied_maps(seed=3, B=2, S=48):
    rng = np.random.RandomState(seed)
    levels = np.array([0.02, 0.1, 0.3, 0.5, 0.7, 0.9], np.float32)
    prob = levels[rng.randint(0, len(levels), size=(B, S, S))]
    thresh = levels[rng.randint(0, len(levels), size=(B, S, S))]
    binary = (1 / (1 + np.exp(-50 * (prob - thresh)))).astype(np.float32)
    gts = np.zeros((B, S, S), np.float32)
    gts[:, 10:20, 5:40] = 1.0
    gtt = np.where(gts > 0, 0.7, 0.3).astype(np.float32)
    gtm = np.zeros((B, S, S), np.float32)
    gtm[:, 8:22, 3:42] = 1.0
    return prob, thresh, binary, gts, gtt, gtm


def test_db_loss_matches_ocrjax_on_maps_with_ties():
    prob, thresh, binary, gts, gtt, gtm = _tied_maps()
    want, wparts = JD.db_loss(
        {"prob": jnp.asarray(prob), "thresh": jnp.asarray(thresh),
         "binary": jnp.asarray(binary)}, *map(jnp.asarray, (gts, gtt, gtm)))
    got, gparts = D.db_loss(
        {"prob": torch.from_numpy(prob), "thresh": torch.from_numpy(thresh),
         "binary": torch.from_numpy(binary)},
        *map(torch.from_numpy, (gts, gtt, gtm)))
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for k in ("prob", "binary", "thresh"):
        assert float(gparts[k]) == pytest.approx(float(wparts[k]), rel=1e-5)
    # the hard negatives: ocrjax's selection (det_trainer.py:40-52) on the
    # same BCE values, which the quantile cut must land on exactly
    bce = -(gts * np.log(prob + 1e-6) + (1 - gts) * np.log(1 - prob + 1e-6))
    bce = bce.astype(np.float32)
    neg = 1.0 - gts
    n_pos = gts.sum(axis=(1, 2), keepdims=True)
    keep = np.minimum(neg.sum(axis=(1, 2), keepdims=True), n_pos * 3 + 64)
    flat = jnp.asarray((bce * neg).reshape(len(bce), -1))
    k = jnp.clip(jnp.asarray(keep.reshape(-1)), 1.0, flat.shape[1] - 1.0)
    cut = jax.vmap(lambda f, qq: jnp.quantile(f, qq))(
        flat, 1.0 - k / flat.shape[1])
    want_sel = neg * (bce * neg >= np.asarray(cut)[:, None, None])
    got_sel = D.ohem_negatives(torch.from_numpy(bce), torch.from_numpy(gts))
    np.testing.assert_array_equal(got_sel.numpy(), want_sel)
    # the cut lands inside a run of ties: more than k negatives selected
    assert (want_sel.sum(axis=(1, 2)) > keep.reshape(-1)).all()


def test_quantile_rows_is_jnp_quantile_bit_for_bit():
    rng = np.random.RandomState(0)
    B, N = 64, 1000
    a = rng.rand(B, N).astype(np.float32)
    a[:, :300] = np.float32(0.3)                          # ties
    a *= rng.choice([1e-3, 1.0, 7.3], size=(B, 1)).astype(np.float32)
    q = rng.rand(B).astype(np.float32)
    q[:4] = [0.0, 1.0, 0.5, 299 / 999]
    want = np.asarray(jax.jit(jax.vmap(lambda f, qq: jnp.quantile(f, qq)))(
        a, q))
    got = D.quantile_rows(torch.from_numpy(a), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)


def test_det_gt_maps_equal_ocrjax():
    cs = JaxCharset.from_file("assets/rec.charset.txt")
    for seed, rot in ((0, 0.0), (1, 12.0)):
        _, quads, _ = jsynth.render_page(np.random.RandomState(seed), cs,
                                         size=(200, 160), max_rotation=rot)
        quads = quads + [np.array([[2, 2], [3, 2], [3, 3], [2, 3]],
                                  np.float32)]            # too small
        for g, w in zip(det_gt.db_gt_maps(quads, (200, 160)),
                        jgt.db_gt_maps(quads, (200, 160))):
            np.testing.assert_array_equal(g, w)
    got = det_gt.make_det_batch(np.random.RandomState(5), cs, 3, 128,
                                p_word=0.5, degrade=0.5, p_dense=0.5)
    want = jgt.make_det_batch(np.random.RandomState(5), cs, 3, 128,
                              p_word=0.5, degrade=0.5, p_dense=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pool_targets_match_reduce_window():
    rng = np.random.RandomState(4)
    m = rng.rand(2, 16, 16).astype(np.float32)
    avg = np.asarray(jax.lax.reduce_window(
        jnp.asarray(m), 0.0, jax.lax.add, (1, 4, 4), (1, 4, 4), "VALID")) / 16
    mx = np.asarray(jax.lax.reduce_window(
        jnp.asarray(m), 0.0, jax.lax.max, (1, 4, 4), (1, 4, 4), "VALID"))
    a, b, c = D.pool_targets(*(torch.from_numpy(m),) * 3, 4)
    np.testing.assert_allclose(a.numpy(), avg, rtol=1e-6)
    np.testing.assert_array_equal(c.numpy(), mx)


@pytest.fixture(scope="module")
def engines():
    cfg = asset_config(det_max_side=512, compute_dtype="float32")
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**jax_fields(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


def test_eval_detection_matches_ocrjax(engines):
    jax_engine, port = engines
    cfg = port.config
    jmodel = create_db_arch(jax_engine.config, DB_ARCHS["flagship"])
    want = JD.eval_detection(
        jmodel, _jax_det_vars(port), jax_engine.config, jax_engine.charset,
        np.random.RandomState(9), n_pages=2, size=256)
    got = D.eval_detection(port.det_model, cfg, port.charset,
                           np.random.RandomState(9), n_pages=2, size=256)
    assert got == want and want[0] > 0.5


def _jax_det_vars(port):
    from ocrjax.weights import _unflatten
    return jax.tree.map(jnp.asarray, _unflatten(
        W.model_variables(port.det_model)))


def test_det_crops_match_ocrjax(engines):
    jax_engine, port = engines
    a = jcrops.generate_det_crops(jax_engine, n_pages=3, seed=5, width=192,
                                  chunk=2, p_word=0.5)
    b = det_crops.generate_det_crops(port, n_pages=3, seed=5, width=192,
                                     chunk=2, p_word=0.5)
    assert b.texts == a.texts and len(a.texts) >= 4
    np.testing.assert_array_equal(b.widths, a.widths)
    diff = np.abs(b.images.astype(int) - a.images)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    ra, rb = np.random.RandomState(1), np.random.RandomState(1)
    la = jcrops.sample_batch(a, jax_engine.charset, ra, 5)
    lb = det_crops.sample_batch(a, port.charset, rb, 5)
    for field in ("images", "widths", "labels", "label_lengths"):
        np.testing.assert_array_equal(getattr(lb, field), getattr(la, field))
    assert lb.texts == la.texts


def test_train_det_runs_and_refuses_a_mesh(tmp_path):
    res = D.train_det(config=TINY, steps=2, batch_size=1, size=64,
                      log_every=1, log=lambda m: None, device="cpu",
                      arch=dict(DB_ARCHS["tile"], head_stride=4))
    assert [s for s, _ in res.history] == [1, 2]
    assert "params/DBHead_0/Conv_0/kernel" in res.variables
    # mesh= runs the same training on a mesh of one rank
    kw = dict(config=TINY, steps=2, batch_size=2, size=64,
              log=lambda m: None, device="cpu")
    want = D.train_det(**kw)
    with one_rank_mesh(tmp_path) as mesh:
        got = D.train_det(**kw, mesh=mesh)
    np.testing.assert_allclose([v for _, v in got.history],
                               [v for _, v in want.history], rtol=1e-5)
    assert set(got.variables) == set(want.variables)
