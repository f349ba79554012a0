"""The port's (dp, tp) parallelism (ocrjax_torch/parallel/mesh.py) on CPU
ranks: torch.multiprocessing, gloo, a file-based rendezvous in tmp_path,
one torch thread a rank.

Bars (tests/test_mesh.py's): sharded rec steps against the port's
unsharded step, losses within 1e-4 relative over 3 Adam steps, and one SGD
step's parameters and BatchNorm statistics within rtol 1e-4 / atol 1e-6;
the same bars for two dp steps of the det and cls step functions; the tp
placements equal ocrjax's _param_spec element for element; sharded fused
and tiled serving equal unsharded at the goldens' bar (identical strings,
boxes within 0.011 px, scores within 2e-3).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ocrjax_torch import weights as W
from ocrjax_torch.charset import Charset
from ocrjax_torch.config import TINY
from ocrjax_torch.models.crnn import create_crnn
from ocrjax_torch.parallel import mesh as M
from ocrjax_torch.train import optim
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
BOX_TOL = 0.011
SCORE_TOL = 2e-3


def _entry(rank, fn, world, init, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args) -> None:
    """fn(rank, *args) on `world` gloo ranks."""
    mp.spawn(_entry, args=(fn, world, str(tmp_path / "pg"), args),
             nprocs=world, join=True)


# ---------------------------------------------------------------------------
# Mesh, batch layout
# ---------------------------------------------------------------------------

def _mesh_layout(rank, out):
    m = M.make_mesh()
    assert m.shape == (4, 1) and m.mesh_dim_names == ("dp", "tp")
    m2 = M.make_mesh(n_dp=2, n_tp=2)
    assert m2.shape == (2, 2)
    # tp peers are consecutive ranks
    assert m2.get_local_rank("dp") == rank // 2
    assert m2.get_local_rank("tp") == rank % 2
    with pytest.raises(ValueError, match="3x2 mesh != 4 devices"):
        M.make_mesh(n_dp=3, n_tp=2)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    got = M.shard_batch(m, (x, {"w": np.arange(16)}))
    assert got[0].shape == (4, 4)
    np.testing.assert_array_equal(got[0].numpy(), x[4 * rank:4 * rank + 4])
    np.testing.assert_array_equal(got[1]["w"].numpy(),
                                  np.arange(4 * rank, 4 * rank + 4))
    # on the 2x2 mesh the two tp ranks of a dp group hold the same rows
    y = M.shard_batch(m2, x)
    np.testing.assert_array_equal(y.numpy(),
                                  x[8 * (rank // 2):8 * (rank // 2) + 8])
    with pytest.raises(ValueError, match="multiple of the dp axis"):
        M.shard_batch(m, np.zeros((6, 2)))
    whole = M.gather_rows(m, got[0])
    np.testing.assert_array_equal(whole.numpy(), x)
    flags = M.gather_rows(m, torch.tensor([rank % 2 == 0]))
    assert flags.dtype == torch.bool and flags.tolist() == [
        True, False, True, False]
    if rank == 0:
        open(out, "w").write("ok")


def test_make_mesh_shapes_and_shard_batch(tmp_path):
    out = str(tmp_path / "ok")
    spawn(_mesh_layout, 4, tmp_path, out)
    assert open(out).read() == "ok"
    from torch.distributed.tensor import Replicate, Shard
    assert M.batch_sharding(None) == [Shard(0), Replicate()]
    assert M.replicated(None) == [Replicate(), Replicate()]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.make_mesh()


# ---------------------------------------------------------------------------
# tp placements against ocrjax's _param_spec
# ---------------------------------------------------------------------------

def _marked_crnn(chars: str):
    """A TINY CRNN whose parameter and buffer elements are 0, 1, 2, ...
    across the model (bias_ih, which flax does not have, stays 0)."""
    model = create_crnn(TINY, Charset(chars).num_classes)
    off = 0
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if name.endswith("bias_ih_l0"):
                t.zero_()
                continue
            t.copy_(torch.arange(off, off + t.numel(),
                                 dtype=torch.float32).view(t.shape))
            off += t.numel()
    return model


def _jax_local_values(flat, n_tp, rank, spec_fn):
    """Per flax leaf, the elements rank `rank` holds under spec_fn's
    specs (element values are unique ids)."""
    import jax
    out = {}
    for key, v in flat.items():
        path = tuple(jax.tree_util.DictKey(p) for p in key.split("/"))
        spec = tuple(spec_fn(path, v, n_tp))
        idx = [slice(None)] * v.ndim
        for ax, name in enumerate(spec):
            if name == "tp":
                k = v.shape[ax] // n_tp
                idx[ax] = slice(rank * k, (rank + 1) * k)
        out[key] = set(np.asarray(v)[tuple(idx)].ravel().tolist())
    return out


def _port_local_values(model, places, n_tp, rank):
    out = {}
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        p = places[name]
        local = t.detach() if p is None else p.local(t.detach(), rank, n_tp)
        out[name] = set(local.ravel().tolist())
    return out


def _holdings_match(chars, n_tp, places_fn) -> bool:
    """Whether every rank holds, per port tensor, exactly the elements of
    the flax leaves it carries under ocrjax's _param_spec."""
    from ocrjax.parallel.mesh import _param_spec
    model = _marked_crnn(chars)
    flat = W.crnn_variables(model.state_dict())
    places = places_fn(model, n_tp)
    for rank in range(n_tp):
        jv = _jax_local_values(flat, n_tp, rank, _param_spec)
        pv = _port_local_values(model, places, n_tp, rank)
        full = {name: set(t.detach().ravel().tolist())
                for name, t in list(model.named_parameters())
                + list(model.named_buffers())}
        for name, vals in pv.items():
            if name.endswith("bias_ih_l0"):
                continue
            leaves = [k for k, v in flat.items()
                      if set(np.asarray(v).ravel().tolist()) <= full[name]]
            assert leaves, name
            if vals != set().union(*(jv[k] for k in leaves)):
                return False
    return True


def test_param_placements_match_param_spec():
    # every axis divides 2 (8 classes); and an odd class axis (7 classes)
    # keeps the projection replicated
    assert _holdings_match("abcdefg", 2, M.param_placements)
    assert _holdings_match("abcdef", 2, M.param_placements)
    places = M.param_placements(_marked_crnn("abcdef"), 2)
    assert places["fc.weight"] is None and places["fc.bias"] is None
    assert places["lstm0.fwd.weight_ih_l0"] == M.Split(4)
    assert places["conv2.bn.running_mean"] == M.Split(1)


def test_plain_shard0_of_the_lstm_fails_the_placement_check():
    """A plain Shard(0) of the stacked (4H, in) gate tensors gives rank 0
    gates i and f whole: another layout than flax's per-gate sharding."""
    def shard0(model, n_tp):
        return {k: (M.Split(1) if p is not None else None)
                for k, p in M.param_placements(model, n_tp).items()}
    assert not _holdings_match("abcdefg", 2, shard0)


# ---------------------------------------------------------------------------
# Sharded training steps against the unsharded step
# ---------------------------------------------------------------------------

CHARS = "abcdefg"
B = 8


def _rec_batches(n):
    rng = np.random.RandomState(0)
    return [((rng.rand(B, 32, 64) * 255).astype(np.uint8),
             rng.randint(40, 65, size=(B,)).astype(np.int32),
             rng.randint(1, 8, size=(B, 6)).astype(np.int32),
             rng.randint(3, 7, size=(B,)).astype(np.int32))
            for _ in range(n)]


class SGD:
    """optax.sgd(lr) with the port optimizer's interface (for the
    one-step gradient check, where the update is -lr * grad)."""

    def __init__(self, params, lr):
        self.params, self.lr = dict(params), lr
        self.sync = optim.Local()
        self.mu, self.nu = {}, {}

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self):
        grads = self.sync.reduce_grads({k: p.grad for k, p in
                                        self.params.items()})
        for k, p in self.params.items():
            p.add_(-self.lr * grads[k])


def _rec_sharded(rank, n_dp, n_tp, out):
    mesh = M.make_mesh(n_dp=n_dp, n_tp=n_tp)
    model, tx = M.init_sharded_rec_state(TINY, Charset(CHARS), mesh)
    step = M.make_sharded_rec_train_step(model, tx, mesh)
    losses = [float(step(*M.shard_batch(mesh, b))) for b in _rec_batches(3)]
    model, _ = M.init_sharded_rec_state(TINY, Charset(CHARS), mesh)
    sgd = SGD(optim.trainable(model), 1e-2)
    M.make_sharded_rec_train_step(model, sgd, mesh)(
        *M.shard_batch(mesh, _rec_batches(1)[0]))
    flat = M.model_variables(mesh, model)
    if rank == 0:
        np.savez(out, losses=np.array(losses), **flat)


def _rec_unsharded():
    from ocrjax_torch.train.rec_trainer import make_train_step
    model = create_crnn(TINY, Charset(CHARS).num_classes)
    W.init_random_(model, 0)
    tx = optim.Adam(optim.trainable(model), lambda _c: 1e-3, clip=None)
    step = make_train_step(model, tx)
    losses = [float(step(*(torch.from_numpy(a) for a in b)))
              for b in _rec_batches(3)]
    model = create_crnn(TINY, Charset(CHARS).num_classes)
    W.init_random_(model, 0)
    make_train_step(model, SGD(optim.trainable(model), 1e-2))(
        *(torch.from_numpy(a) for a in _rec_batches(1)[0]))
    return np.array(losses), W.model_variables(model)


@pytest.fixture(scope="module")
def rec_unsharded():
    return _rec_unsharded()


@pytest.mark.parametrize("n_dp,n_tp", [(2, 1), (2, 2)])
def test_sharded_rec_step_matches_unsharded(tmp_path, rec_unsharded,
                                            n_dp, n_tp):
    out = str(tmp_path / "rec.npz")
    spawn(_rec_sharded, n_dp * n_tp, tmp_path, n_dp, n_tp, out)
    got = np.load(out)
    want_losses, want_flat = rec_unsharded
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert set(got.files) - {"losses"} == set(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _det_cls_batches():
    rng = np.random.RandomState(5)
    S = 64
    gts = np.zeros((4, S, S), np.float32)
    for i in range(4):             # text-like bars of different sizes
        y, x = rng.randint(4, 40, size=2)
        gts[i, y:y + 8 + 2 * i, x:x + 20] = 1.0
    det = ((rng.rand(4, S, S, 3) * 255).astype(np.uint8), gts,
           rng.rand(4, S, S).astype(np.float32) * 0.7,
           (rng.rand(4, S, S) > 0.3).astype(np.float32))
    cls = ((rng.rand(4, 32, 64) * 255).astype(np.uint8),
           np.array([64, 48, 56, 64], np.int32),
           np.array([1, 0, 0, 1], np.float32))
    return det, cls


def _det_cls_run(mesh=None):
    """Two steps of the det and the cls step functions from seed 0 ->
    (det losses, det variables, cls losses, cls variables)."""
    from ocrjax_torch.models.cls import create_cls
    from ocrjax_torch.models.db import create_db
    from ocrjax_torch.train import cls_trainer, det_trainer
    det_b, cls_b = _det_cls_batches()

    def put(b):
        return M.shard_batch(mesh, b) if mesh is not None \
            else tuple(torch.from_numpy(a) for a in b)
    out = []
    for make, opt_of, step_of, batch in (
            (lambda: create_db(TINY), lambda m: det_trainer.det_optimizer(
                m, 1e-3, 10), lambda m, o: det_trainer.make_det_train_step(
                m, o, TINY), det_b),
            (lambda: create_cls(TINY), lambda m: cls_trainer.cls_optimizer(
                m, 1e-3, 10), lambda m, o: cls_trainer.make_cls_train_step(
                m, o), cls_b)):
        model = make()
        W.init_random_(model, 0)
        opt = opt_of(model)
        if mesh is not None:
            M.prepare_training(mesh, model, opt)
        step = step_of(model, opt)
        losses = []
        for _ in range(2):
            r = step(*put(batch))
            losses.append(float(r[0] if isinstance(r, tuple) else r))
        flat = W.model_variables(model) if mesh is None \
            else M.model_variables(mesh, model)
        out += [np.array(losses), flat]
    return out


def _det_cls_sharded(rank, out):
    det_l, det_v, cls_l, cls_v = _det_cls_run(M.make_mesh(n_dp=2))
    if rank == 0:
        np.savez(out, det_losses=det_l, cls_losses=cls_l,
                 **{f"det:{k}": v for k, v in det_v.items()},
                 **{f"cls:{k}": v for k, v in cls_v.items()})


def test_sharded_det_and_cls_steps_match_unsharded(tmp_path):
    """Global BatchNorm statistics and db_loss's batch-wide ratios: the
    per-rank versions give other losses from the first step on."""
    out = str(tmp_path / "det_cls.npz")
    spawn(_det_cls_sharded, 2, tmp_path, out)
    got = np.load(out)
    det_l, det_v, cls_l, cls_v = _det_cls_run()
    np.testing.assert_allclose(got["det_losses"], det_l, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["cls_losses"], cls_l, rtol=LOSS_RTOL)
    for pre, want in (("det", det_v), ("cls", cls_v)):
        for k, v in want.items():
            if k.startswith("batch_stats/"):
                np.testing.assert_allclose(got[f"{pre}:{k}"], v, rtol=1e-4,
                                           atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

def _serving_engine():
    from ocrjax_torch.api import OcrEngine, asset_config
    return OcrEngine.from_pretrained(config=asset_config(
        det_max_side=512, compute_dtype="float32", tile_size=256,
        tile_overlap=32, tile_max_candidates=128), device="cpu")


def _serving_inputs(eng):
    from ocrjax_torch import preprocess
    pages = np.load(os.path.join(ROOT, "ocrjax_torch", "testdata",
                                 "pages_960.npz"))["pages"]
    cfg = eng.config
    grays, _, valid_hw, _, _ = preprocess.decode_chunk_to_gray(
        list(pages), range(len(pages)), cfg)
    return (pages, preprocess.pack_for_upload(grays, cfg),
            valid_hw[:, ::-1].astype(np.float32).copy())


def _thr(cfg):
    return (cfg.det_thresh, cfg.det_box_thresh, cfg.det_unclip_ratio,
            float(cfg.det_min_box_size))


def _tiled_records(results):
    return [[(line.text, line.box.quad.tolist(), line.box.score)
             for line in r.lines] for r in results]


def _serving_sharded(rank, out):
    eng = _serving_engine()
    pages, packed, wh = _serving_inputs(eng)
    mesh = M.make_mesh(n_dp=2)
    fn = M.make_sharded_fused_ocr_fn(eng, mesh, 8, 320)
    res = fn(packed, _thr(eng.config), wh).numpy()
    with pytest.raises(ValueError, match="multiple of the dp axis"):
        fn(packed[:3], _thr(eng.config), wh[:3])
    M.shard_tiled_serving(eng, mesh)
    tiled = _tiled_records(eng.ocr_tiled_batch([pages[0], pages[2]]))
    M.shard_tiled_serving(eng, None)
    if rank == 0:
        torch.save({"fused": res, "tiled": tiled}, out)


def _check_lines(got, want):
    assert [t for t, _, _ in got] == [t for t, _, _ in want]
    for (_, qa, sa), (_, qb, sb) in zip(got, want):
        assert np.abs(np.array(qa) - np.array(qb)).max() <= BOX_TOL
        assert abs(sa - sb) <= SCORE_TOL


def test_sharded_serving_matches_unsharded(tmp_path):
    """dp-sharded fused program over 4 pages and sharded tiled serving
    (960 x 960 pages at 256-pixel tiles: 25 tiles in groups of 16, 8 and
    1, each padded to an even count with white tiles) against the
    unsharded engine."""
    from ocrjax_torch import fused
    out = str(tmp_path / "serving.pt")
    spawn(_serving_sharded, 2, tmp_path, out)
    got = torch.load(out, weights_only=False)
    eng = _serving_engine()
    pages, packed, wh = _serving_inputs(eng)
    want = fused.FusedOcr(eng, 8, 320)(torch.from_numpy(packed),
                                       _thr(eng.config),
                                       torch.from_numpy(wh)).numpy()
    # one gathered payload: the port's packed rows, read by unpack_fused
    assert got["fused"].shape == want.shape and \
        got["fused"].dtype == want.dtype
    T, flip = eng.config.rec_max_tokens, eng.config.rec_try_flip
    want = fused.unpack_fused(want, 8, T, flip)
    g = fused.unpack_fused(got["fused"], 8, T, flip)
    assert set(g) == set(want)
    for k in ("tokens", "n_tokens", "valid", "flipped"):
        np.testing.assert_array_equal(g[k], want[k], err_msg=k)
    assert np.abs(g["quads"] - want["quads"]).max() <= BOX_TOL
    assert np.abs(g["scores"] - want["scores"]).max() <= SCORE_TOL
    assert np.abs(g["conf"] - want["conf"]).max() <= SCORE_TOL
    assert want["valid"].sum() > 0
    tiled = _tiled_records(eng.ocr_tiled_batch([pages[0], pages[2]]))
    assert sum(len(r) for r in tiled) > 0
    for a, b in zip(got["tiled"], tiled):
        _check_lines(a, b)
    from ocrjax_torch import tiling
    corners = tiling.tile_plan(960, 960, eng.config)
    assert len(corners) % 2 == 1


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_prints_ok(n, capsys):
    from ocrjax_torch.parallel.dryrun import dryrun_multichip
    line = dryrun_multichip(n)
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    n_tp = 2
    assert line.startswith(
        f"dryrun_multichip OK: mesh={{'dp': {n // n_tp}, 'tp': {n_tp}}} ")
    assert f"fused_ocr_dp={{'dp': {n}, 'tp': 1}}" in line
    assert "det/cls trainers sharded, tiled serving sharded" in line


def _train_rec_sharded(rank, ckpt, out):
    from ocrjax_torch.train.rec_trainer import train_rec
    mesh = M.make_mesh(n_dp=1, n_tp=2)
    kw = dict(config=TINY, charset=Charset(CHARS), steps=2, batch_size=4,
              width=64, max_len=3, log_every=1, ckpt_dir=ckpt,
              ckpt_every=1, log=lambda m: None, mesh=mesh)
    res = train_rec(**kw)
    again = train_rec(**{**kw, "steps": 3})       # resumes at step 2
    if rank == 0:
        np.savez(out, history=np.array(res.history),
                 again=np.array(again.history), **res.variables)


def test_train_rec_on_a_tp_mesh_matches_unsharded(tmp_path):
    """train_rec(mesh=) with the CRNN split over 2 tp ranks: the loss
    history and the final variables (gathered to full tensors) of the
    unsharded run; its checkpoints hold full tensors, and a resume from
    them continues as the unsharded resume does."""
    from ocrjax_torch.train.rec_trainer import train_rec
    out = str(tmp_path / "train.npz")
    (tmp_path / "a").mkdir()
    spawn(_train_rec_sharded, 2, tmp_path, str(tmp_path / "a"), out)
    got = np.load(out)
    kw = dict(config=TINY, charset=Charset(CHARS), steps=2, batch_size=4,
              width=64, max_len=3, log_every=1, ckpt_dir=str(tmp_path / "b"),
              ckpt_every=1, log=lambda m: None, device="cpu")
    want = train_rec(**kw)
    again = train_rec(**{**kw, "steps": 3})
    np.testing.assert_allclose(got["history"], np.array(want.history),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["again"], np.array(again.history),
                               rtol=LOSS_RTOL)
    for k, v in want.variables.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    full = W.read_safetensors(str(tmp_path / "a" / "rec_2.safetensors"))[0]
    assert full["params/Dense_0/kernel"].shape == \
        want.variables["params/Dense_0/kernel"].shape
