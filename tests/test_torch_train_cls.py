"""The port's cls trainer (ocrjax_torch/train/cls_trainer.py) against
ocrjax on the CPU.

Bars (tests/test_torch_train_rec.py): 3 steps of make_cls_train_step from
one flax init carried to the port, at widths 64, 128, 64 with and without
the antisymmetry term: losses within 1e-4 relative, update norms per leaf
within 2e-2 relative (seen: equal to 7e-8). The batch transforms
(snap_rows_to_ink, flip_half) equal ocrjax's bit for bit, and the loss is
optax.sigmoid_binary_cross_entropy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocrjax.charset import Charset as JaxCharset
from ocrjax.config import TINY as JAX_TINY
from ocrjax.models.cls import create_cls as jax_cls
from ocrjax.train import cls_trainer as JC
from ocrjax.train import synth as jsynth
from ocrjax_torch import weights as W
from ocrjax_torch.config import TINY
from ocrjax_torch.models.cls import create_cls
from ocrjax_torch.train import cls_trainer as C
from ocrjax_torch.train import synth
from test_torch_fixture import few_torch_threads, one_rank_mesh  # noqa: F401
from test_torch_train_rec import LOSS_RTOL, compare_steps, flat_of

CHARSET = "assets/rec.charset.txt"


def _batches(n=3):
    cs = JaxCharset("abcdefghij")
    rng = np.random.RandomState(0)
    out = []
    for w in (64, 128, 64)[:n]:
        lb = jsynth.make_line_batch(rng, cs, 8, w, 32, max_len=5)
        JC.snap_rows_to_ink(rng, lb)
        out.append((lb.images, lb.widths, JC.flip_half(rng, lb)))
    return out


@pytest.mark.parametrize("antisym", [0.0, 0.5])
def test_three_cls_steps_match_ocrjax(antisym):
    model = jax_cls(JAX_TINY)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)),
                   jnp.full((1,), 64, jnp.int32))
    steps, lr = 1500, 1e-3
    tx = optax.adam(optax.schedules.cosine_decay_schedule(lr, steps,
                                                          alpha=0.1))
    jstep = JC.make_cls_train_step(model, tx, 0.5, 0.5, antisym=antisym)
    batches = _batches()
    p, st = v["params"], tx.init(v["params"])
    jl = []
    for b in batches:
        p, st, loss = jstep(p, st, *map(jnp.asarray, b))
        jl.append(float(loss))

    port = create_cls(TINY)
    W.load_model_variables(port, flat_of(v))
    opt = C.cls_optimizer(port, lr, steps)
    step = C.make_cls_train_step(port, opt, 0.5, 0.5, antisym=antisym)
    tl = [float(step(*(torch.from_numpy(np.asarray(a)) for a in b)))
          for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    compare_steps(flat_of(v), flat_of({"params": p}),
                  W.model_variables(port))


@pytest.mark.parametrize("seed", [0, 3])
def test_batch_transforms_equal_ocrjax(seed):
    cs = JaxCharset.from_file(CHARSET)
    lb_j = jsynth.make_line_batch(np.random.RandomState(seed), cs, 16, 192,
                                  32, p_word=0.5, max_rotation=3.0)
    lb_t = synth.make_line_batch(np.random.RandomState(seed), cs, 16, 192,
                                 32, p_word=0.5, max_rotation=3.0)
    rj, rt = np.random.RandomState(seed + 1), np.random.RandomState(seed + 1)
    JC.snap_rows_to_ink(rj, lb_j)
    C.snap_rows_to_ink(rt, lb_t)
    np.testing.assert_array_equal(C.flip_half(rt, lb_t),
                                  JC.flip_half(rj, lb_j))
    np.testing.assert_array_equal(lb_t.images, lb_j.images)
    np.testing.assert_array_equal(lb_t.widths, lb_j.widths)


def test_sigmoid_bce_is_optax():
    x = np.linspace(-30, 30, 41).astype(np.float32)
    y = (np.arange(41) % 2).astype(np.float32)
    np.testing.assert_allclose(
        C.sigmoid_bce(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(optax.sigmoid_binary_cross_entropy(x, y)), rtol=1e-6,
        atol=1e-7)


def test_train_cls_runs_and_refuses_a_mesh(tmp_path):
    res = C.train_cls(config=TINY, charset=None, steps=2, batch_size=4,
                      widths=(64, 128), eval_batches=1, log_every=1,
                      device="cpu")
    assert len(res.history) == 2 and 0.0 <= res.accuracy <= 1.0
    assert set(res.variables) == set(W.model_variables(create_cls(TINY)))
    # mesh= runs the same training on a mesh of one rank
    kw = dict(config=TINY, charset=None, steps=2, batch_size=4,
              widths=(64,), eval_batches=1, log_every=1, device="cpu")
    want = C.train_cls(**kw)
    with one_rank_mesh(tmp_path) as mesh:
        got = C.train_cls(**kw, mesh=mesh)
    np.testing.assert_allclose([v for _, v in got.history],
                               [v for _, v in want.history], rtol=1e-5)
    assert got.accuracy == want.accuracy
