"""The port's rec trainer (ocrjax_torch/train/rec_trainer.py) and what it
rests on, against ocrjax on the CPU.

Bars:
  * 3 steps of make_train_step at TINY from one flax init carried to the
    port, on the same synth batches: losses within 1e-4 relative; per
    parameter leaf, the norm of the update (params after 3 steps minus
    before) within 2e-2 relative; BatchNorm running statistics within
    1e-3 relative (the norm of the gap over the leaf's norm). The
    statistics of steps 2 and 3 follow the updated weights, so they carry
    the update gaps below; flax's fast variance mean(x^2) - mean(x)^2
    cancels where a channel's mean is large against its spread (the
    detector's stem on white pages: 4e-5 from two float32 summation
    orders). The statistics' semantics are held at 1e-5 by the direct
    BatchNorm test below. Adam divides each gradient by its own root
    mean square, so a leaf's update follows the sign of its gradient and
    rounding in a near-zero gradient moves it: the update norm is the
    measure, not the raw parameters. (Seen: losses equal to 2e-6, update
    norms to 3e-6.)
  * ctc_loss equals ocrjax.ops.ctc.ctc_loss (optax) to 1e-5 relative per
    sequence, an infeasible sample (more labels than frames) included,
    where optax's log(0) = -1e5 gives a large finite loss; gradients to
    1e-5 on the feasible samples.
  * train-mode BatchNorm: output and new running statistics as flax's
    nn.BatchNorm(momentum=0.9) in float32 and under bf16.
  * clip_by_global_norm and the schedules at their boundaries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ocrjax.charset import Charset as JaxCharset
from ocrjax.config import TINY as JAX_TINY
from ocrjax.models.crnn import create_crnn as jax_crnn
from ocrjax.ops import ctc as jctc
from ocrjax.train import rec_trainer as JR
from ocrjax.train import synth as jsynth
from ocrjax_torch import weights as W
from ocrjax_torch.charset import Charset
from ocrjax_torch.config import TINY
from ocrjax_torch.models.crnn import BatchNorm, create_crnn
from ocrjax_torch.ops import ctc
from ocrjax_torch.train import optim
from ocrjax_torch.train import rec_trainer as R
from test_torch_fixture import few_torch_threads, one_rank_mesh  # noqa: F401

LOSS_RTOL = 1e-4
UPDATE_RTOL = 2e-2
BN_RTOL = 1e-3
CHARS = "abcdefghij"


def flat_of(tree) -> dict:
    return W.flatten(jax.tree.map(np.asarray, dict(tree)))


def compare_steps(flat0: dict, flat_jax: dict, flat_port: dict,
                  skip=()) -> float:
    """Asserts the per-leaf update norms and the BN statistics bars;
    returns the worst relative update-norm gap."""
    assert set(flat_port) == set(flat_jax) == set(flat0)
    worst = 0.0
    for k in flat0:
        if k.startswith("batch_stats/"):
            gap = np.linalg.norm(flat_port[k] - flat_jax[k])
            assert gap <= BN_RTOL * np.linalg.norm(flat_jax[k]), (k, gap)
            continue
        if k in skip:
            continue
        dj = float(np.linalg.norm(flat_jax[k] - flat0[k]))
        dt = float(np.linalg.norm(flat_port[k] - flat0[k]))
        rel = abs(dt - dj) / max(dj, 1e-12)
        assert rel <= UPDATE_RTOL, (k, dj, dt)
        worst = max(worst, rel)
    return worst


def torch_batch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("ent_reg", [0.0, 0.05])
def test_three_rec_steps_match_ocrjax(ent_reg):
    cs = JaxCharset(CHARS)
    model = jax_crnn(JAX_TINY, cs.num_classes)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)))
    steps, lr = 20, 1e-3          # warmup 3: lr 0, lr/3, 2 lr/3
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(
        optax.warmup_cosine_decay_schedule(0.0, lr, 3, steps)))
    jstep = JR.make_train_step(model, tx, ent_reg=ent_reg)
    rng = np.random.RandomState(0)
    batches = [jsynth.make_line_batch(rng, cs, 8, 64, 32, max_len=5)
               for _ in range(3)]
    p, bs, st = v["params"], v["batch_stats"], tx.init(v["params"])
    jl = []
    for b in batches:
        p, bs, st, loss = jstep(p, bs, st, *map(jnp.asarray, (
            b.images, b.widths, b.labels, b.label_lengths)))
        jl.append(float(loss))

    port = create_crnn(TINY, cs.num_classes)
    W.load_model_variables(port, flat_of(v))
    opt = R.rec_optimizer(port, lr, steps)
    step = R.make_train_step(port, opt, ent_reg=ent_reg)
    tl = [float(step(*torch_batch(b.images, b.widths, b.labels,
                                  b.label_lengths))) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    compare_steps(flat_of(v), flat_of({"params": p, "batch_stats": bs}),
                  W.model_variables(port))


def _ctc_case():
    rng = np.random.RandomState(0)
    B, T, C, U = 6, 12, 7, 6
    logits = (rng.randn(B, T, C) * 2).astype(np.float32)
    frames = np.array([12, 10, 3, 12, 8, 12], np.int32)
    labels = rng.randint(1, C, size=(B, U)).astype(np.int32)
    labels[1, 1] = labels[1, 0]              # a repeat needs a blank
    labels[5, :] = 3                         # all repeats: 6 labels, 11 min
    lens = np.array([6, 4, 5, 0, 3, 6], np.int32)   # sample 2: infeasible
    for b in range(B):
        labels[b, lens[b]:] = 0
    return logits, frames, labels, lens


def test_ctc_loss_matches_optax_including_an_infeasible_sample():
    logits, frames, labels, lens = _ctc_case()
    T, U = logits.shape[1], labels.shape[1]
    want = np.asarray(optax.ctc_loss(
        jnp.asarray(logits),
        (np.arange(T)[None] >= frames[:, None]).astype(np.float32),
        jnp.asarray(labels),
        (np.arange(U)[None] >= lens[:, None]).astype(np.float32)))
    got = ctc.ctc_loss_per_seq(*torch_batch(logits, frames, labels,
                                            lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 1e4 < got[2] < 1e6                  # large and finite
    # F.ctc_loss gives inf there, the hazard this port avoids
    f = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
        torch.from_numpy(labels), torch.from_numpy(frames),
        torch.from_numpy(lens), reduction="none")
    assert torch.isinf(f[2])

    x = torch.from_numpy(logits).requires_grad_()
    loss = ctc.ctc_loss(x, *torch_batch(frames, labels, lens))
    loss.backward()
    jl, jg = jax.value_and_grad(lambda z: jctc.ctc_loss(
        z, jnp.asarray(frames), jnp.asarray(labels), jnp.asarray(lens)))(
            jnp.asarray(logits))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    feasible = [0, 1, 3, 4, 5]
    np.testing.assert_allclose(x.grad.numpy()[feasible],
                               np.asarray(jg)[feasible], atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batchnorm_is_flax(dtype):
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 6, 5, 3) * 3 + 1.5).astype(np.float32)   # NHWC
    scale = rng.rand(3).astype(np.float32) + 0.5
    bias = rng.randn(3).astype(np.float32)
    mean0 = rng.randn(3).astype(np.float32)
    var0 = rng.rand(3).astype(np.float32) + 0.5
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       dtype=jnp.dtype(dtype))
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    xj = jnp.asarray(x).astype(dtype)
    yj, upd = bn.apply(variables, xj, mutable=["batch_stats"])
    port = BatchNorm(3).train()
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    yt = port(xt)
    assert yt.dtype == xt.dtype
    np.testing.assert_allclose(
        yt.float().permute(0, 2, 3, 1).detach().numpy(),
        np.asarray(yj.astype(jnp.float32)), rtol=1e-6,
        atol=1e-6 if dtype == "float32" else 2 ** -7 * 8)
    for k, b in (("mean", port.running_mean), ("var", port.running_var)):
        np.testing.assert_allclose(b.numpy(), np.asarray(
            upd["batch_stats"][k]), rtol=1e-5, atol=1e-6)
    # torch.nn.BatchNorm2d would keep the unbiased variance instead
    ref = torch.nn.BatchNorm2d(3, momentum=0.1)
    ref.running_var.copy_(torch.from_numpy(var0))
    ref.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(ref.running_var.numpy(), port.running_var.numpy(),
                           rtol=1e-4)


@pytest.mark.parametrize("norm", [4.9999, 5.0, 7.5])
def test_clip_and_adam_match_optax_at_the_clip_boundary(norm):
    rng = np.random.RandomState(2)
    g = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    s = norm / np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2))
                           for a in g))
    g = [(a * s).astype(np.float32) for a in g]
    p0 = [rng.randn(*a.shape).astype(np.float32) for a in g]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(sched))
    state = tx.init(p0)
    params = {str(i): torch.from_numpy(a.copy()).requires_grad_()
              for i, a in enumerate(p0)}
    opt = optim.Adam(params, optim.warmup_cosine_decay_schedule(
        0.0, 1e-2, 2, 10), clip=5.0)
    pj = p0
    for _ in range(3):          # lr 0, then 5e-3, then the cosine
        upd, state = tx.update(g, state, pj)
        pj = optax.apply_updates(pj, upd)
        for i, t in params.items():
            t.grad = torch.from_numpy(g[int(i)])
        opt.step()
    for i, t in params.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(pj[int(i)]),
                                   rtol=1e-6, atol=1e-7)
    assert opt.count == 3


def test_schedules_match_optax_at_their_boundaries():
    for steps in (3, 20, 1500):
        warm = min(100, steps // 10 + 1)
        want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warm, steps)
        got = optim.trainer_schedule(1e-3, steps)
        for c in sorted({0, 1, warm - 1, warm, warm + 1, steps // 2,
                         steps - 1, steps, steps + 7}):
            assert got(c) == pytest.approx(float(want(c)), rel=1e-6,
                                           abs=1e-12), (steps, c)
        assert got(0) == 0.0       # the first update has lr 0
    want = optax.cosine_decay_schedule(1e-3, 1500, alpha=0.1)
    got = optim.cosine_decay_schedule(1e-3, 1500, alpha=0.1)
    for c in (0, 1, 749, 750, 1499, 1500, 2000):
        assert got(c) == pytest.approx(float(want(c)), rel=1e-6)


def test_lstm_input_bias_is_not_trained():
    """flax's cell has one bias a gate (carried into bias_hh); bias_ih
    stays zero and out of the optimizer."""
    model = create_crnn(TINY, 11)
    names = set(optim.trainable(model))
    assert not any(n.endswith("bias_ih_l0") for n in names)
    assert "lstm0.fwd.bias_hh_l0" in names
    n_flax = sum(v.size for k, v in W.model_variables(model).items()
                 if k.startswith("params/"))
    assert n_flax == sum(p.numel() for p in
                         optim.trainable(model).values())


def test_train_rec_runs_resumes_and_refuses_a_mesh(tmp_path):
    logs = []
    kw = dict(config=TINY, charset=Charset("ab"), steps=2, batch_size=2,
              width=64, log_every=1, ckpt_dir=str(tmp_path), ckpt_every=1,
              max_len=2, log=logs.append, device="cpu")
    res = R.train_rec(**kw)
    assert [s for s, _ in res.history] == [1, 2]
    assert all(np.isfinite(loss) for _, loss in res.history)
    logs2 = []
    R.train_rec(**{**kw, "steps": 3, "log": logs2.append})
    assert any("resumed" in m and "step 2" in m for m in logs2), logs2
    assert any("[rec 3/3]" in m for m in logs2)
    assert not any("[rec 1/3]" in m for m in logs2)
    # mesh= runs the same training on a mesh of one rank
    (tmp_path / "m").mkdir()
    with one_rank_mesh(tmp_path / "m") as mesh:
        res_m = R.train_rec(**{**kw, "mesh": mesh, "log": lambda m: None,
                               "ckpt_dir": str(tmp_path / "m")})
    np.testing.assert_allclose([v for _, v in res_m.history],
                               [v for _, v in res.history], rtol=1e-5)
    assert set(res_m.variables) == set(res.variables)
    assert (tmp_path / "m" / "rec_2.safetensors").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            R.train_rec(**{**kw, "device": "cuda"})
