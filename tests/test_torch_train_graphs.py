"""The trainers' compiled programs (graphs.StepProgram: ocrjax's jitted
train steps; the evaluation forwards as graphs.Program) on the CPU.

(i) No host read inside a program: every train step (rec with and
without ent_reg, det at head stride 1 and 4, cls plain and antisym) and
every evaluation forward runs under a TorchDispatchMode that fails on
aten._local_scalar_dense and aten.item.
(ii) Through the stand-in graph of tests/test_torch_graphs.py, extended
here to hold a training step (its replay runs below autograd with grad
mode on, as a CUDA graph's kernels run without autograd; a collective is
run again and waited on; `hold` restores the state around a capture that
runs the body): N steps captured and replayed equal N steps under
graphs.eager() bit for bit (losses, every parameter, the BatchNorm
statistics, mu, nu, the count), over the rec and det schedules' warmup,
where a learning rate frozen at its capture would be 0 for good.
(iii) A resume into a captured step, and a checkpoint under a gloo
2-rank tp mesh followed by replays, equal their op-by-op runs, and
nothing is captured again.
(iv) The graphed steps at TINY against ocrjax's jitted steps from the
same flax initial variables over 3 steps, at the bars of
test_torch_train_{rec,det,cls}.py: losses within LOSS_RTOL = 1e-4
relative, per-leaf update norms within 2e-2 relative, BatchNorm
statistics within 1e-3 relative.
(v) A replaced state tensor makes the program drop its graphs and
capture anew (StepProgram's documented choice), and the result is the
op-by-op route's.
On the card (marked cuda; they skip without one):
python -m pytest --noconftest -q -m cuda tests/test_torch_train_graphs.py
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ocrjax_torch import graphs
from ocrjax_torch import weights as W
from ocrjax_torch.charset import Charset
from ocrjax_torch.config import TINY
from ocrjax_torch.models.cls import create_cls
from ocrjax_torch.models.crnn import create_crnn
from ocrjax_torch.models.db import DB_ARCHS, create_db
from ocrjax_torch.train import checkpoint as C
from ocrjax_torch.train import cls_trainer, det_gt, det_trainer
from ocrjax_torch.train import optim, rec_trainer, synth
from test_torch_fixture import few_torch_threads  # noqa: F401
from test_torch_graphs import (_UNINITIALIZED, StandInBackend, StandInGraph,
                               _writes)

CHARS = "abcdefghij"
STEPS = 5                    # the rec and det warmups are 3 updates long


# ------------------------------------------------------------ stand-in --

class TrainStandInGraph(StandInGraph):
    """StandInGraph for a training step: the replay runs below autograd
    (grad mode on, so operations that keep a workspace for their backward
    still make it) and waits on every collective it runs again."""

    def replay(self):
        with torch._C._AutoDispatchBelowAutograd():
            for func, args, kwargs, out, view in self.ops:
                if func in _UNINITIALIZED:
                    continue
                if func.namespace == "c10d":     # in place on its inputs
                    res = func(*args, **kwargs)
                    for w in pytree.tree_leaves(res):
                        if isinstance(w, torch.ScriptObject):
                            dist.distributed_c10d.Work.unbox(w).wait()
                    continue
                if view:
                    continue
                res = func(*args, **kwargs)
                if _writes(func):
                    continue
                for o, r in zip(pytree.tree_leaves(out),
                                pytree.tree_leaves(res)):
                    if isinstance(o, torch.Tensor):
                        o.copy_(r)


class TrainStandIn(StandInBackend):
    def graph(self):
        return TrainStandInGraph()

    @contextlib.contextmanager
    def hold(self, tensors):
        """The stand-in's capture runs the body: the state is put back."""
        saved = [t.detach().clone() for t in tensors]
        try:
            yield
        finally:
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setitem(graphs.BACKENDS, "cpu", TrainStandIn())


# -------------------------------------------------------------- trainers --

def _rec(ent_reg=0.0, seed=0, device="cpu"):
    cs = Charset(CHARS)
    model = create_crnn(TINY, cs.num_classes)
    W.init_random_(model, seed)
    model.to(device)
    opt = rec_trainer.rec_optimizer(model, 1e-3, 20)
    return model, opt, rec_trainer.make_train_step(model, opt, ent_reg)


def _rec_batches(n=STEPS, B=4):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        b = synth.make_line_batch(rng, Charset(CHARS), B, 64, 32, max_len=5)
        out.append((b.images, b.widths, b.labels, b.label_lengths))
    return out


def _det(hs=1, device="cpu"):
    arch = dict(DB_ARCHS["tile"], head_stride=hs)
    model = create_db(TINY.replace(det_head_stride=hs), arch)
    W.init_random_(model, 0)
    model.to(device)
    opt = det_trainer.det_optimizer(model, 3e-4, 20)
    return model, opt, det_trainer.make_det_train_step(model, opt, TINY)


def _det_batches(n=STEPS):
    rng = np.random.RandomState(0)
    return [det_gt.make_det_batch(rng, Charset(CHARS), 2, 64, n_lines=(2, 4))
            for _ in range(n)]


def _cls(antisym=0.0, device="cpu"):
    model = create_cls(TINY)
    W.init_random_(model, 0)
    model.to(device)
    opt = cls_trainer.cls_optimizer(model, 1e-3, 100)
    return model, opt, cls_trainer.make_cls_train_step(
        model, opt, 0.5, 0.5, antisym=antisym)


def _cls_batches(n=STEPS):
    rng = np.random.RandomState(0)
    out = []
    for w in (64, 128, 64, 128, 64)[:n]:      # one key a width
        lb = synth.make_line_batch(rng, Charset(CHARS), 4, w, 32, max_len=5)
        out.append((lb.images, lb.widths, cls_trainer.flip_half(rng, lb)))
    return out


TRAINERS = {
    "rec": (lambda d: _rec(0.0, device=d), _rec_batches),
    "rec_ent_reg": (lambda d: _rec(0.05, device=d), _rec_batches),
    "det_hs1": (lambda d: _det(1, d), _det_batches),
    "det_hs4": (lambda d: _det(4, d), _det_batches),
    "cls": (lambda d: _cls(0.0, d), _cls_batches),
    "cls_antisym": (lambda d: _cls(0.5, d), _cls_batches),
}


def _tensors(batch, device="cpu"):
    return tuple(torch.from_numpy(np.asarray(a)).to(device) for a in batch)


def _losses(out):
    """The step's outputs as a list of cloned tensors."""
    if isinstance(out, tuple):
        return [out[0].clone()] + [v.clone() for v in out[1].values()]
    return [out.clone()]


def _state(model, opt) -> dict:
    out = {k: t.detach().clone()
           for k, t in optim.step_state(model, opt).items()}
    out["count"] = opt.count
    return out


def _assert_same_state(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _run(name, graphed, n=STEPS, device="cpu"):
    """n steps of a trainer, graphed (under graphs.sync_checked(), which
    holds the card's replays to no host sync) or op by op."""
    make, batches = TRAINERS[name]
    model, opt, step = make(device)
    ctx = graphs.sync_checked() if graphed else graphs.eager()
    with ctx:
        losses = [_losses(step(*_tensors(b, device))) for b in batches(n)]
    return losses, _state(model, opt), step


# ------------------------------------------------ (i) no host read --

class _NoHostRead(TorchDispatchMode):
    READS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.item.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"{func} reads the device inside a program")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_host_read(monkeypatch):
    """Every program body (train steps and evaluation forwards) runs under
    _NoHostRead."""
    for cls in (graphs.Program, graphs.StepProgram):
        orig = cls.__call__

        def call(self, *a, _orig=orig, **kw):
            with _NoHostRead():
                return _orig(self, *a, **kw)
        monkeypatch.setattr(cls, "__call__", call)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_no_host_read_inside_a_train_step(no_host_read, name):
    losses, _, step = _run(name, graphed=False, n=2)
    assert all(torch.isfinite(t).all() for s in losses for t in s)


def test_adam_apply_reads_nothing_back():
    """The clip is a select: Adam's device half reads no value of the
    card on either side of the clip norm."""
    for scale in (1e-3, 1e3):
        p = torch.ones(6, requires_grad=True)
        opt = optim.Adam({"p": p}, lambda c: 1e-2, clip=5.0)
        p.grad = torch.full((6,), scale)
        opt.prepare()
        with _NoHostRead():
            opt.apply()
        assert not torch.equal(p.detach(), torch.ones(6))


def test_no_host_read_inside_the_evaluation_forwards(no_host_read):
    cs = Charset(CHARS)
    model, _, _ = _rec()
    rng = np.random.RandomState(1)
    lines = [synth.make_line_batch(rng, cs, 4, 64, 32, max_len=5)]
    assert 0.0 <= rec_trainer.evaluate_exact_match(model, cs, lines) <= 1.0
    det, _, _ = _det(1)
    cfg = TINY.replace(det_max_side=64)
    r, p = det_trainer.eval_detection(det, cfg, cs, rng, n_pages=1, size=64)
    assert 0.0 <= r <= 1.0 and 0.0 <= p <= 1.0
    cls, _, _ = _cls()
    lb = lines[0]
    logits = cls_trainer.cls_logits(cls, *_tensors((lb.images, lb.widths)))
    assert logits.shape == (4,)


# --------------------------------------- (ii) graphed equals op by op --

@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_captured_steps_equal_eager_steps(stand_in, name):
    want_losses, want_state, _ = _run(name, graphed=False)
    got_losses, got_state, step = _run(name, graphed=True)
    stats = list(step.program.stats().values())
    keys = 2 if name.startswith("cls") else 1     # cls: two widths
    assert len(stats) == keys
    assert sum(s["replays"] for s in stats) == STEPS - keys
    assert step.program.recaptures == 0
    for a, b in zip(want_losses, got_losses):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_same_state(want_state, got_state)
    # the warmup moved the learning rate: steps after the capture moved
    # the parameters (a frozen rate would be 0 for the rec and det steps)
    assert want_state["opt/hyper"][0] != 0


def test_replays_follow_the_schedule(stand_in):
    """A program captured at count 0 (learning rate 0 under the warmup)
    still steps the parameters at its replays."""
    model, opt, step = _rec()
    b = _tensors(_rec_batches(1)[0])
    step(*b)                                  # the capture, lr 0
    before = {k: p.detach().clone() for k, p in opt.params.items()}
    step(*b)                                  # a replay, lr 1e-3 / 3
    assert step.program.stats() and next(
        iter(step.program.stats().values()))["replays"] == 1
    moved = [k for k, p in opt.params.items()
             if not torch.equal(p.detach(), before[k])]
    assert len(moved) > len(before) // 2
    assert opt.count == 2


def _eval_runs(graphed):
    cs = Charset(CHARS)
    ctx = contextlib.nullcontext() if graphed else graphs.eager()
    rng = np.random.RandomState(3)
    rec_model = _rec()[0]
    det_model = _det(4)[0]
    cls_model = _cls()[0]
    lines = [synth.make_line_batch(rng, cs, 4, 64, 32, max_len=5)
             for _ in range(3)]
    cfg = TINY.replace(det_max_side=96, det_head_stride=4)
    with ctx:
        out = {"rec": rec_trainer.evaluate_exact_match(rec_model, cs, lines),
               "det": det_trainer.eval_detection(det_model, cfg, cs, rng,
                                                 n_pages=3, size=96),
               "cls": [cls_trainer.cls_logits(
                   cls_model, *_tensors((lb.images, lb.widths))).clone()
                   for lb in lines]}
    progs = {n: m.__dict__.get("_programs", {}) for n, m in
             (("rec", rec_model), ("det", det_model), ("cls", cls_model))}
    return out, progs


def test_evaluation_forwards_graphed_equal_eager(stand_in):
    want, _ = _eval_runs(graphed=False)
    got, progs = _eval_runs(graphed=True)
    assert got["rec"] == want["rec"] and got["det"] == want["det"]
    assert all(torch.equal(a, b) for a, b in zip(got["cls"], want["cls"]))
    for name in ("rec", "det", "cls"):
        stats = list(progs[name][f"{name}_eval"].stats().values())
        assert len(stats) == 1 and stats[0]["replays"] == 2, (name, stats)


def test_det_evaluation_counts_k1_at_every_replay(stand_in, monkeypatch):
    from ocrjax_torch.ops import cc_label
    calls = []
    real = cc_label.label_components

    def counted(*a, **k):
        graphs.launched(calls.append, 1)
        return real(*a, **k)
    monkeypatch.setattr(cc_label, "label_components", counted)
    cs = Charset(CHARS)
    det_model = _det(1)[0]
    cfg = TINY.replace(det_max_side=64)
    det_trainer.eval_detection(det_model, cfg, cs, np.random.RandomState(2),
                               n_pages=3, size=64)
    assert len(calls) == 3


# ----------------------------------------------------- (iii) resumes --

def test_resume_into_a_captured_step(stand_in, tmp_path):
    batches = [_tensors(b) for b in _rec_batches(6)]
    path = str(tmp_path / "rec_3.safetensors")

    def run(graphed):
        ctx = contextlib.nullcontext() if graphed else graphs.eager()
        with ctx:
            model, opt, step = _rec()
            for b in batches[:3]:
                step(*b)
            C.save_train_state(path, 3, model, opt)
            want = [step(*b).clone() for b in batches[3:]]
            # a fresh step captured on another batch, then resumed: the
            # checkpoint is copied into the storage its graphs update
            model2, opt2, step2 = _rec(seed=1)
            step2(*batches[5])
            assert C.load_train_state(path, model2, opt2) == 3
            got = [step2(*b).clone() for b in batches[3:]]
        return want, got, _state(model, opt), _state(model2, opt2), step2

    want_e, got_e, st_e, st2_e, _ = run(False)
    want_g, got_g, st_g, st2_g, step2 = run(True)
    assert all(torch.equal(a, b) for a, b in zip(want_e, got_e))
    assert all(torch.equal(a, b) for a, b in zip(want_g, got_g))
    assert all(torch.equal(a, b) for a, b in zip(want_e, want_g))
    _assert_same_state(st_e, st_g)
    _assert_same_state(st2_g, st_g)
    assert step2.program.recaptures == 0
    assert next(iter(step2.program.stats().values()))["replays"] == 3


def _tp_rank(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        from ocrjax_torch.parallel import mesh as M
        graphs.BACKENDS["cpu"] = TrainStandIn()
        mesh = M.make_mesh(n_dp=1, n_tp=world)
        batches = _rec_batches(5)
        res = {}
        for route in ("eager", "graphed"):
            ctx = graphs.eager() if route == "eager" \
                else contextlib.nullcontext()
            with ctx:
                model, opt, _ = _rec()
                M.prepare_training(mesh, model, opt)
                step = rec_trainer.make_train_step(model, opt)
                local = [t.data_ptr() for t in
                         optim.step_state(model, opt).values()]
                losses = [float(step(*M.shard_batch(mesh, b)))
                          for b in batches[:3]]
                M.save_train_state(mesh, os.path.join(
                    os.path.dirname(out), f"{route}.safetensors"), 3,
                    model, opt)
                assert [t.data_ptr() for t in optim.step_state(
                    model, opt).values()] == local
                losses += [float(step(*M.shard_batch(mesh, b)))
                           for b in batches[3:]]
                flat = M.model_variables(mesh, model)
            stats = list(step.program.stats().values())
            res[route] = (losses, flat, stats, step.program.recaptures)
        if rank == 0:
            (le, fe, _, _), (lg, fg, sg, rg) = res["eager"], res["graphed"]
            np.savez(out, losses_e=np.array(le), losses_g=np.array(lg),
                     replays=sum(s["replays"] for s in sg), recaptures=rg,
                     **{f"e/{k}": v for k, v in fe.items()},
                     **{f"g/{k}": v for k, v in fg.items()})
    finally:
        dist.destroy_process_group()


def test_tp_checkpoint_then_replays_equal_eager(tmp_path):
    out = str(tmp_path / "tp.npz")
    mp.spawn(_tp_rank, args=(2, str(tmp_path / "pg"), out), nprocs=2,
             join=True)
    got = np.load(out)
    assert np.array_equal(got["losses_e"], got["losses_g"])
    assert int(got["replays"]) == 4 and int(got["recaptures"]) == 0
    names = [k[2:] for k in got.files if k.startswith("e/")]
    assert names
    for k in names:
        assert np.array_equal(got[f"e/{k}"], got[f"g/{k}"]), k
    # the checkpoint holds the full tensors the live model held then
    flat, _ = W.read_safetensors(str(tmp_path / "graphed.safetensors"))
    ref, _ = W.read_safetensors(str(tmp_path / "eager.safetensors"))
    assert set(flat) == set(ref)
    assert all(np.array_equal(flat[k], ref[k]) for k in ref)


# ----------------------------------------- (iv) against ocrjax's steps --

def test_graphed_rec_steps_match_ocrjax(stand_in):
    import test_torch_train_rec as T
    T.test_three_rec_steps_match_ocrjax(0.05)


def test_graphed_det_steps_match_ocrjax(stand_in):
    """At head stride 4 (pooled targets); (ii) holds stride 1 to eager."""
    import test_torch_train_det as T
    T.test_three_det_steps_match_ocrjax(4)


def test_graphed_cls_steps_match_ocrjax(stand_in):
    import test_torch_train_cls as T
    T.test_three_cls_steps_match_ocrjax(0.5)


# ------------------------------------------ (v) replaced state tensors --

def _replaced_state_recaptures(how, device):
    batches = [_tensors(b, device) for b in _rec_batches(4)]

    def run(graphed):
        ctx = contextlib.nullcontext() if graphed else graphs.eager()
        with ctx:
            model, opt, step = _rec(device=device)
            losses = [step(*b).clone() for b in batches[:2]]
            name = next(iter(opt.params))
            if how == "parameter_data":
                p = opt.params[name]
                p.data = p.data.clone()
            else:
                opt.mu[name] = opt.mu[name].clone()
            losses += [step(*b).clone() for b in batches[2:]]
        return losses, _state(model, opt), step

    want, want_state, _ = run(False)
    got, got_state, step = run(True)
    assert step.program.recaptures == 1
    assert next(iter(step.program.stats().values()))["replays"] == 1
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    _assert_same_state(want_state, got_state)


@pytest.mark.parametrize("how", ["parameter_data", "moment"])
def test_a_replaced_state_tensor_recaptures(stand_in, how):
    _replaced_state_recaptures(how, "cpu")


def test_step_program_keeps_what_it_captured(stand_in):
    """The state a capture saw stays referenced while its graphs live, so
    its storage is not handed to another tensor."""
    model, opt, step = _rec()
    step(*_tensors(_rec_batches(1)[0]))
    name = next(iter(opt.mu))
    old = opt.mu[name]
    opt.mu[name] = old.clone()
    assert any(t is old for t in step.program._held.values())


# ------------------------------------------------------------ the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_cuda_captured_steps_equal_eager_steps(cuda, name):
    want_losses, want_state, _ = _run(name, False, device="cuda")
    got_losses, got_state, step = _run(name, True, device="cuda")
    assert sum(s["replays"] for s in step.program.stats().values()) >= 3
    for a, b in zip(want_losses, got_losses):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_same_state(want_state, got_state)


@pytest.mark.cuda
def test_cuda_a_replaced_state_tensor_recaptures(cuda):
    _replaced_state_recaptures("moment", "cuda")
