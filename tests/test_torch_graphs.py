"""The port's compiled programs (ocrjax_torch.graphs) on the CPU.

(i) No host sync inside a program: a TorchFunctionMode records every
tensor made from host data and every read back to the host inside
FusedOcr's two programs (the host reads the occupied-slot count between
them), DetState.forward, TileForward.forward and rec_strips.
(ii) extract_boxes with its thresholds as a (4,) tensor equals the float
call bit for bit on both unclip branches, and ocrjax's extract_boxes with
traced thresholds at the goldens bar (boxes 1e-3 px, scores 1e-5, as
test_torch_postprocess holds the float call).
(iii) The caches' logic, the engine's program registry among them,
through a stand-in for torch.cuda.CUDAGraph that
lives here only: its capture records every aten operation between
capture_begin and capture_end, and its replay runs them again in order,
writing each result into the tensor the capture returned, as a CUDA
graph's kernels write the same memory at every replay. The graphed route
is held to the op-by-op route bit for bit.
(iv) Capture on the card (marked cuda; they skip without one):
python -m pytest --noconftest -q -m cuda tests/test_torch_graphs.py
"""

import contextlib
import gc
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ocrjax_torch import (api_det, bucketing, fused, graphs, preprocess,
                          tiling)
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.charset import Charset
from ocrjax_torch.ops import bytepack, cc_label
from ocrjax_torch.postprocess import db_boxes
from ocrjax_torch.train import synth
from ocrjax_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads while the module runs (the test workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ stand-in --

_SYNCS = {torch.ops.aten._local_scalar_dense.default,
          torch.ops.aten.item.default, torch.ops.aten.nonzero.default,
          torch.ops.aten.is_nonzero.default}
_UNINITIALIZED = {torch.ops.aten.empty.memory_format,
                  torch.ops.aten.empty_like.default,
                  torch.ops.aten.empty_strided.default}


def _writes(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


def _storages(tree) -> set:
    return {t.untyped_storage().data_ptr() for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.numel()}


class _Recording(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SYNCS:
            raise RuntimeError(f"{func} reads the device inside a capture")
        out = func(*args, **kwargs)
        # an output in an input's storage is a view (aten.to, reshape and
        # the like alias their input only sometimes)
        view = not _writes(func) and bool(
            _storages(out) & _storages((args, kwargs)))
        self.ops.append((func, args, kwargs, out, view))
        return out


class StandInGraph:
    """torch.cuda.CUDAGraph on the CPU: replay reruns the captured aten
    operations into the captured outputs' storage. A view is made once at
    capture (it aliases storage that the replay rewrites); an in-place
    operation runs again in place; any other writes its result into the
    tensor the capture returned."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.ops = []
        self.mode = _Recording(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def replay(self):
        for func, args, kwargs, out, view in self.ops:
            if func in _UNINITIALIZED or view:
                continue
            res = func(*args, **kwargs)
            if _writes(func):
                continue
            for o, r in zip(pytree.tree_leaves(out), pytree.tree_leaves(res)):
                if isinstance(o, torch.Tensor):
                    o.copy_(r)


class StandInBackend:
    def graph(self):
        return StandInGraph()

    def pool(self):
        return None

    def stream(self, device):
        return None

    def current(self, device):
        return None

    def on(self, stream):
        return contextlib.nullcontext()

    def wait(self, stream, other):
        pass

    def keep(self, t, stream):
        pass

    def release_cached(self, always=False):
        pass

    def abandon(self, g):
        pass

    def anchor(self, g):
        return None


@pytest.fixture
def stand_in(monkeypatch):
    """Programs over CPU tensors are captured and replayed by the
    stand-in."""
    monkeypatch.setitem(graphs.BACKENDS, "cpu", StandInBackend())


# --------------------------------------------------------------- inputs --

@pytest.fixture(scope="module")
def pages():
    cs = Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    out = []
    for seed in (11, 12, 13, 14, 15):
        g = synth.render_page(np.random.RandomState(seed), cs,
                              size=(SIZE, SIZE), n_lines=(2, 4),
                              text_height=(18, 26))[0]
        out.append(np.repeat(g[..., None], 3, 2))
    return out


def _engine(**over):
    cfg = asset_config(det_max_side=SIZE, compute_dtype="float32",
                       fused_chunk_pages=2, **over)
    return OcrEngine.from_pretrained(config=cfg, device="cpu")


@pytest.fixture(scope="module")
def eng():
    return _engine()


def _lines(results):
    return [(r.truncated, [(ln.text, np.asarray(ln.box.quad,
                                                np.float32).tobytes(),
                            ln.box.score, ln.confidence) for ln in r.lines])
            for r in results]


def _fused_inputs(eng, pages):
    cfg = eng.config
    grays, _, valid_hw, _, _ = preprocess.decode_chunk_to_gray(
        pages, range(len(pages)), cfg)
    return (torch.from_numpy(preprocess.pack_for_upload(grays, cfg)),
            torch.from_numpy(valid_hw[:, ::-1].astype(np.float32).copy()))


# ------------------------------------------------------ (i) no host sync --

class _HostReads(TorchFunctionMode):
    """Records every tensor made from host data and every read of a
    tensor back to the host."""

    READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.cpu,
             torch.Tensor.nonzero, torch.nonzero, torch.Tensor.__bool__,
             torch.Tensor.__int__, torch.Tensor.__float__,
             torch.Tensor.__index__, torch.Tensor.numpy}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.tensor, torch.as_tensor) and args \
                and not isinstance(args[0], torch.Tensor):
            self.seen.append(func.__name__)
        elif func is torch.Tensor.new_tensor and len(args) > 1 \
                and not isinstance(args[1], torch.Tensor):
            self.seen.append("new_tensor")
        elif func in self.READS:
            self.seen.append(getattr(func, "__name__", str(func)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("program", ["fused", "det", "tile", "rec_strips"])
def test_no_host_sync_inside_a_program(eng, pages, program):
    up, wh = _fused_inputs(eng, pages[:2])
    thr = api_det.upload_thresholds(eng)
    strips = torch.zeros((4, eng.config.rec_height, 64))
    widths = torch.tensor([64, 40, 20, 64], dtype=torch.int32)
    fp, st, tf = (fused._fused_for(eng, 8, 64, False),
                  api_det.det_state(eng), tiling._tile_forward(eng))
    # the count the host reads between the two programs, read here
    n_valid = fp.count(fp.detect(up, thr, wh))
    calls = {
        "fused": lambda: fp.recognize(fp.detect(up, thr, wh), n_valid),
        "det": lambda: st.forward(up),
        "tile": lambda: tf(up),
        "rec_strips": lambda: api_det.rec_strips(eng, strips, widths),
    }
    with _HostReads() as rec:
        calls[program]()
    assert rec.seen == []


# ----------------------------------------------- (ii) traced thresholds --

def _probs(seed, n=3, S=128):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rng.rand(S, S).astype(np.float32) * 0.2
        for _ in range(10):
            x0, y0 = rng.randint(0, S - 40), rng.randint(0, S - 12)
            p[y0:y0 + rng.randint(3, 12), x0:x0 + rng.randint(4, 40)] = \
                0.5 + 0.5 * rng.rand()
        out.append(p)
    return np.stack(out)


@pytest.mark.parametrize("unclip", [1.5, 0.0])
@pytest.mark.parametrize("cc_downsample", [1, 4])
def test_extract_boxes_takes_its_thresholds_as_a_tensor(unclip,
                                                        cc_downsample):
    import jax
    import jax.numpy as jnp
    from ocrjax.postprocess import db_boxes as jboxes
    probs = _probs(7 + cc_downsample)
    thr = (0.3, 0.55, unclip, 4.0)
    kw = dict(max_candidates=64, cc_iters=4, cc_downsample=cc_downsample)
    p = torch.from_numpy(probs)
    floats = db_boxes.extract_boxes(p, thresh=thr[0], box_thresh=thr[1],
                                    unclip_ratio=thr[2],
                                    min_box_size=thr[3], **kw)
    traced = db_boxes.extract_boxes(
        p, thresholds=torch.tensor(thr, dtype=torch.float32), **kw)
    for k in floats:
        assert torch.equal(floats[k], traced[k]), k
    assert int(floats["valid"].sum()) >= 10

    @jax.jit
    def jfn(pp, t):
        return jax.vmap(lambda q: jboxes.extract_boxes(
            q, thresh=t[0], box_thresh=t[1], unclip_ratio=t[2],
            min_box_size=t[3], **kw))(pp)
    want = jfn(jnp.asarray(probs), jnp.asarray(thr, jnp.float32))
    np.testing.assert_array_equal(traced["valid"].numpy(), want["valid"])
    np.testing.assert_allclose(traced["boxes"].numpy(), want["boxes"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(traced["scores"].numpy(), want["scores"],
                               atol=1e-5, rtol=0)


# ------------------------------------------------ (iii) the caches' logic --

def test_program_keys_follow_shape_dtype_and_static_args(stand_in):
    prog = graphs.Program(lambda x, k: (x * k).sum(0) + 1.0, "toy")
    a = torch.arange(6.0).reshape(2, 3)
    first = prog(a, 2.0)
    assert torch.equal(first, (a * 2.0).sum(0) + 1.0)
    out1 = prog(a + 1.0, 2.0)                       # a replay
    assert torch.equal(out1, ((a + 1.0) * 2.0).sum(0) + 1.0)
    out2 = prog(a - 5.0, 2.0)
    assert out2 is out1                             # the static output
    assert torch.equal(out1, ((a - 5.0) * 2.0).sum(0) + 1.0)
    prog(a.double(), 2.0)
    prog(torch.ones(3, 3), 2.0)
    prog(a, 3.0)
    keys = list(prog.stats())
    assert len(keys) == 4
    assert [s["replays"] for s in prog.stats().values()] == [2, 0, 0, 0]
    with graphs.eager():
        prog(a, 5.0)
    assert len(prog.stats()) == 4                   # eager() captures none


def test_no_collection_during_a_capture(stand_in):
    """The collector is off while a capture records (it could free a
    dropped engine's graphs, which invalidates a capture on the card) and
    on again after, also after a failed capture."""
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x + 1.0

    assert gc.isenabled()
    prog = graphs.Program(fn, "toy")
    prog(torch.ones(3))
    assert seen == [True, False] and gc.isenabled()
    bad = graphs.Program(lambda x: x * int(x.sum()), "sync")
    with pytest.raises(RuntimeError):
        bad(torch.ones(3))
    assert gc.isenabled()


def test_a_failed_capture_raises_and_never_runs_eagerly(stand_in):
    prog = graphs.Program(lambda x: x * int(x.sum()), "sync")
    x = torch.ones(3)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="inside a capture"):
            prog(x)
    assert prog.stats() == {}


def test_fused_threshold_change_reuses_the_graphs(stand_in, eng, pages):
    up, wh = _fused_inputs(eng, pages[:2])
    prog = fused._fused_for(eng, 8, 64, False)
    prog.program.clear()
    outs = {}
    for ratio in (1.5, 2.5, 1.5, 0.0):
        e_cfg = eng.config.replace(det_unclip_ratio=ratio)
        thr = torch.tensor([e_cfg.det_thresh, e_cfg.det_box_thresh, ratio,
                            e_cfg.det_min_box_size], dtype=torch.float32)
        got = prog(up, thr, wh).clone()
        with graphs.eager():
            want = prog(up, thr, wh)
        assert torch.equal(got, want), ratio
        outs[ratio] = got
    assert not torch.equal(outs[1.5], outs[2.5])
    st = list(prog.program.stats().values())
    assert len(st) == 1 and st[0]["replays"] == 3
    assert st[0]["graphs"] >= 9     # one a stage and the pieces around them


def test_fused_lane_refetches_chunk_rows_after_later_replays(stand_in, eng,
                                                             pages):
    e = eng
    base = e.config
    e.config = base.replace(fetch_max_tokens=1)
    try:
        _refetch_after_replays(e, pages)
    finally:
        e.config = base


def _refetch_after_replays(e, pages):
    with graphs.eager():
        want = _lines(e.ocr_batch(pages[:4], fused=True))
    before = bytepack.refetches["fused_fetch"]
    got = [_lines(e.ocr_batch(pages[:4], fused=True)) for _ in range(2)]
    assert got == [want, want]
    # 4 pages in chunks of 2, one key: chunk 0's rows are refetched after
    # chunk 1 replayed over the program's output
    assert bytepack.refetches["fused_fetch"] - before == 4
    st = fused._fused_for(e, e.config.fused_lines_per_page,
                          e.config.rec_bucket_for_width(
                              10 * e.config.rec_height), False).program
    assert [s["replays"] for s in st.stats().values()] == [3]


@pytest.mark.parametrize("lane", ["bucketed", "staged", "detect", "strips",
                                  "tiled"])
def test_lanes_graphed_equal_eager(stand_in, pages, lane):
    e = _engine(tile_size=192, tile_overlap=32)
    runs = {
        "bucketed": lambda: _lines(e.ocr_batch(pages, fused=False)),
        "staged": lambda: _lines([api_det.ocr(e, pages[0],
                                              force_staged=True)]),
        "detect": lambda: [(b.quad.tobytes(), b.score)
                           for b in e.detect(pages[1])],
        "strips": lambda: [(r.text, r.confidence) for r in e.recognize_strips(
            [synth.render_line("graph", 32), synth.render_line("cuda", 28)])],
        "tiled": lambda: _lines(e.ocr_tiled_batch(pages[:2])),
    }
    with graphs.eager():
        want = runs[lane]()
    assert any(want) if lane != "detect" else want
    assert runs[lane]() == want            # first call: eager, capture
    assert runs[lane]() == want            # replays
    assert sum(len(p.stats()) for p in graphs.all_programs(e)) >= 1


def test_a_capture_out_of_memory_halves_the_fused_chunk(stand_in,
                                                        monkeypatch, eng,
                                                        pages):
    """A chunk whose capture runs out of device memory, again after the
    cached blocks went back, raises torch.cuda.OutOfMemoryError; the
    fused lane redoes it in halves, each captured as a key of its own."""
    run = fused.FusedOcr._detect

    def tight(self, gray_up, thr, valid_wh):
        if getattr(graphs._state, "tape", None) and gray_up.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("out of memory in a capture")
        return run(self, gray_up, thr, valid_wh)

    monkeypatch.setattr(fused.FusedOcr, "_detect", tight)

    def lane():      # a line capacity of its own: a new FusedOcr
        return _lines(fused.ocr_pages_fused(eng, pages[:2],
                                            lines_per_page=5))
    with graphs.eager():
        want = lane()
    assert lane() == want
    assert lane() == want
    prog = fused._fused_for(eng, 5, eng.config.rec_bucket_for_width(
        10 * eng.config.rec_height), False).program
    assert [k[0][0][0] for k in prog.stats()] == [(1, SIZE, SIZE // 2)]


def test_pages_buffer_is_shared_and_padded(stand_in, eng, pages):
    devs = [api_det.upload(eng, preprocess.pack_for_upload(
        np.stack([g[..., 0] for g in pages[lo:lo + 2]]), eng.config))
        for lo in (0, 2, 4)]
    buf = bucketing.stack_pages(eng, devs)
    assert buf.shape[0] == 16                   # 5 pages, rounded up
    devs17 = devs * 3 + devs[:1]
    assert bucketing.stack_pages(eng, devs17).shape[0] == 32
    assert buf is bucketing.stack_pages(eng, devs)
    with graphs.eager():
        plain = bucketing.stack_pages(eng, devs)
    assert plain.shape[0] == 5
    assert torch.equal(buf[:5], plain)


def test_a_config_change_drops_the_graphs(stand_in, pages):
    e = _engine()
    up, wh = _fused_inputs(e, pages[:2])
    st = api_det.det_state(e)
    st.forward(up)
    st.forward(up)
    assert len(st.program.stats()) == 1
    rec = graphs.program(e, "rec_strips", api_det._rec_strips)
    fp = fused._fused_for(e, 4, 64, False)
    fp(up, api_det.upload_thresholds(e), wh)
    e.config = e.config.replace(det_unclip_ratio=2.0)   # a threshold only
    st.forward(up)
    assert len(st.program.stats()) == 1
    assert graphs.program(e, "rec_strips", api_det._rec_strips) is rec
    assert fused._fused_for(e, 4, 64, False) is fp
    old = list(graphs.all_programs(e))
    assert {p.name for p in old} >= {"det", "rec_strips", "fused",
                                     "fused_rec"}
    e.config = e.config.replace(det_cc_iters=5)
    # no program of the old config is left, the fused lane's included,
    # and their graphs are gone
    assert not [p for p in graphs.all_programs(e) if p in old]
    assert all(p.stats() == {} for p in old)
    st.forward(up)
    assert [s["replays"] for s in st.program.stats().values()] == [0]
    assert graphs.program(e, "rec_strips", api_det._rec_strips) is not rec
    assert fused._fused_for(e, 4, 64, False) is not fp
    fwd = tiling._tile_forward(e)
    fwd(up)
    e.config = e.config.replace(det_cc_iters=4)
    assert tiling._tile_forward(e) is not fwd


def test_the_fused_lane_follows_a_rebuilt_detector(stand_in, pages):
    """After engine._det = None (the CLI's and calibrate_unclip's detector
    reset) and other weights loaded into the rebuilt engine.det_model,
    the fused lane's graphs read the new detector."""
    from ocrjax_torch import weights as W
    e = _engine()
    e.ocr_batch(pages[:2], fused=True)      # captured over the first one
    before = _lines(e.ocr_batch(pages[:2], fused=True))
    flat = W.model_variables(e.det_model)
    rng = np.random.RandomState(3)
    e._det = None
    W.load_model_variables(e.det_model, {
        k: (v * (1 + 0.05 * rng.standard_normal(v.shape))).astype(v.dtype)
        for k, v in flat.items()})
    with graphs.eager():
        want = _lines(e.ocr_batch(pages[:2], fused=True))
    assert want != before and any(lines for _, lines in want)
    assert _lines(e.ocr_batch(pages[:2], fused=True)) == want
    assert _lines(e.ocr_batch(pages[:2], fused=True)) == want


def test_diag_rec_fetch_pools_every_chunk_s_pages(stand_in, monkeypatch,
                                                  capsys):
    """scripts/diag_rec_fetch over three same-shape chunks (a page each):
    the pooled pages its warps read are those of graphs.eager(), though
    every chunk's pages after the first come from a replay of gray_norm,
    whose output the next replay overwrites."""
    from ocrjax_torch.ops import warp
    from ocrjax_torch.scripts import diag_rec_fetch
    load = OcrEngine.from_pretrained
    cfg = asset_config(det_max_side=SIZE, compute_dtype="float32",
                       fused_chunk_pages=1)
    monkeypatch.setattr(OcrEngine, "from_pretrained", classmethod(
        lambda cls, **kw: load(config=cfg, device="cpu")))
    seen = []
    refined = warp.warp_quads_multi_refined

    def spy(gray, *a, **k):
        seen.append(gray[:3].clone())
        return refined(gray, *a, **k)
    monkeypatch.setattr(warp, "warp_quads_multi_refined", spy)
    argv = ["--pages", "3", "--repeats", "1", "--cpu"]
    with graphs.eager():
        diag_rec_fetch.main(argv)
    want, seen[:] = seen[0], []
    diag_rec_fetch.main(argv)
    assert "pages=3" in capsys.readouterr().out
    assert seen and all(torch.equal(g, want) for g in seen)


def test_k1_counts_every_replay(stand_in, monkeypatch, eng, pages):
    """A launch inside a program counts at every replay of its graph and
    not at the capture, as label_components_cuda counts."""
    plain = db_boxes._label_components_fast

    def counted(bitmap, n_iters):
        out = plain(bitmap, n_iters)
        graphs.launched(cc_label._count_launch, "shared")
        return out

    monkeypatch.setattr(db_boxes, "_label_components_fast", counted)
    k1 = cc_label.label_components_cuda
    monkeypatch.setattr(k1, "launches", 0)
    monkeypatch.setattr(k1, "launches_by_path",
                        {p: 0 for p in cc_label.PATHS})
    up, wh = _fused_inputs(eng, pages[:2])
    prog = fused._fused_for(eng, 4, 64, False)
    thr = api_det.upload_thresholds(eng)
    for n in range(1, 5):
        prog(up, thr, wh)
        assert k1.launches == n
    assert k1.launches_by_path["shared"] == 4


def test_stages_replay_between_graphs(stand_in, eng, pages):
    """A replay opens the program's stages as the eager call does, so a
    timer counts them on either route."""
    up, wh = _fused_inputs(eng, pages[:2])
    prog = fused._fused_for(eng, 4, 64, False)
    thr = api_det.upload_thresholds(eng)
    prog(up, thr, wh)
    calls = []
    for route in (graphs.eager(), contextlib.nullcontext()):
        timer = profiling.StageTimer("cpu")
        with route, timer.active():
            prog(up, thr, wh)
        calls.append(dict(timer.calls))
    assert calls[0] == calls[1]
    assert {"det_forward", "extract_boxes", "ccl", "warp_refine", "crnn",
            "ctc"} <= set(calls[0])


# ------------------------------------------------------- (iv) on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_toy_program_replays(cuda):
    prog = graphs.Program(lambda x: torch.sort(x * 2.0).values, "toy")
    x = torch.rand(1000, device=cuda)
    with graphs.eager():
        want = prog(x)
    assert torch.equal(prog(x), want)
    y = torch.rand(1000, device=cuda)
    assert torch.equal(prog(y), torch.sort(y * 2.0).values)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", ["fused", "bucketed", "staged", "strips"])
def test_cuda_lane_graphed_equals_eager(cuda, lane):
    cfg = asset_config(compute_dtype="float32", fused_chunk_pages=2)
    e = OcrEngine.from_pretrained(config=cfg)
    cs = Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    pg = [np.repeat(synth.render_page(np.random.RandomState(s), cs,
                                      size=(640, 640))[0][..., None], 3, 2)
          for s in (1, 2, 3)]
    runs = {
        "fused": lambda: _lines(e.ocr_batch(pg, fused=True)),
        "bucketed": lambda: _lines(e.ocr_batch(pg)),
        "staged": lambda: _lines([api_det.ocr(e, pg[0],
                                              force_staged=True)]),
        "strips": lambda: [(r.text, r.confidence) for r in
                           e.recognize_strips([synth.render_line("x", 32)])],
    }
    with graphs.eager():
        want = runs[lane]()
    assert runs[lane]() == want
    with graphs.sync_checked():
        assert runs[lane]() == want


@pytest.mark.cuda
def test_cuda_a_sync_fails_its_capture_and_later_captures_work(cuda):
    """Last in the file: a capture the card invalidates raises, and the
    captures after it take a new stream and pool."""
    # drawn first: an invalidated capture leaves the random generators
    # unusable in the process
    x, y = torch.rand((2, 1000), device=cuda)
    bad = graphs.Program(lambda t: t * t.sum().item(), "sync")
    with pytest.raises(RuntimeError):
        bad(x)
    assert bad.stats() == {}
    prog = graphs.Program(lambda t: t.cumsum(0), "after")
    prog(x)
    assert torch.equal(prog(y), y.cumsum(0))
    torch.cuda.synchronize()
