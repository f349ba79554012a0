"""SVTR in the recognizer's slot (ocrjax_torch/models/svtr.py) on the CPU,
at a small width, held to the benchmark's plain float32 reference
(benchmark/reference/rec_svtr.py, which shares no code with the port) on
weights drawn by the reference's seeded rules.

Held here: the port's logits against the reference's in float32; the
bf16 port within a tolerance that the reference's fp8 control fails; the
local window (a key 4 rows or 6 columns away changes nothing, one inside
changes the query); a strip's valid frames at two width buckets; the
reference's closed-form FLOPs against models.counting; the weights'
round trip through the flat names; one small page through ocr(), the
pooled and fused ocr_batch and ocr_tiled_batch against the reference's
lanes; a change of rec_arch empties the engine's program registry; and
the CRNN-only entries refuse an SVTR config.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.lib import seeded
from benchmark.reference import models as M
from benchmark.reference import rec_svtr as R
from ocrjax_torch import graphs
from ocrjax_torch import weights as W
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.charset import Charset
from ocrjax_torch.config import OcrConfig
from ocrjax_torch.models import svtr as S
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
DATA = os.path.join(ROOT, "benchmark", "data")
CLASSES = 96
# a small SVTR: every kind of block and merge, local blocks in stages 1
# and 2 (the window covers the 4-row grid there), 7 x 11 window
SMALL = dict(rec_arch="svtr", svtr_dims=(16, 24, 32), svtr_depths=(1, 2, 2),
             svtr_heads=(2, 2, 4), svtr_local_blocks=2, svtr_mlp_ratio=2,
             svtr_out_channels=24, rec_width_buckets=(64, 128))
SEED = 2205


def _ns(cfg: OcrConfig) -> SimpleNamespace:
    return SimpleNamespace(**dataclasses.asdict(cfg))


def _flat(cfg: OcrConfig):
    return dict(seeded.draw(R.init(_ns(cfg), CLASSES), SEED))


@pytest.fixture(scope="module")
def small():
    """(config float32, flat weights, the port's model in float32)."""
    cfg = OcrConfig(compute_dtype="float32", **SMALL)
    flat = _flat(cfg)
    model = S.create_svtr(cfg, CLASSES)
    W.load_into(model, W.svtr_state_dict(flat)[0])
    return cfg, flat, model.eval()


def _strips(n=5, width=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 32, width, generator=g)
    widths = torch.tensor([width, 100, 37, 3, 0][:n])
    return x, widths


def _ref(cfg, flat, x, widths, lowp=None):
    with torch.inference_mode():
        return R.logits(M.Params(flat, "cpu", lowp), _ns(cfg), x, widths)


def _port(model, x, widths):
    with torch.inference_mode():
        return model(x[:, None], widths)


def _valid_gap(a, b, lengths):
    return max((a[i, :n] - b[i, :n]).abs().max().item()
               for i, n in enumerate(lengths.tolist()) if n)


def test_port_matches_reference_in_float32(small):
    cfg, flat, model = small
    x, widths = _strips()
    got, lg = _port(model, x, widths)
    want, lw = _ref(cfg, flat, x, widths)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert lg.tolist() == lw.tolist() == [32, 25, 10, 1, 0]
    # float32 both sides, another order of the sums (SDPA against the
    # gathered window, cuDNN-free convs): measured 1.1e-6 on logits of
    # std ~0.6
    assert _valid_gap(got, want, lg) < 1e-5


def test_bf16_port_within_a_tolerance_the_fp8_control_fails(small):
    cfg, flat, _ = small
    model = S.create_svtr(cfg.replace(compute_dtype="bfloat16"), CLASSES)
    W.load_into(model, W.svtr_state_dict(flat)[0])
    x, widths = _strips(seed=1)
    want, lens = _ref(cfg, flat, x, widths)
    bf16 = _valid_gap(_port(model.eval(), x, widths)[0], want, lens)
    fp8 = _valid_gap(_ref(cfg, flat, x, widths, lowp="fp8")[0], want, lens)
    # bf16 keeps 8 bits of mantissa in every conv, linear and attention
    # operand, e4m3 3; the tolerance lies between the two readings, with
    # room on both sides
    tol = 0.1
    assert bf16 < tol < fp8, (bf16, fp8)


def test_rec_compute_dtype_sets_the_recognizer_alone():
    """rec_compute_dtype is the recognizer's dtype, CRNN or SVTR, and
    leaves the detector at compute_dtype; empty, the recognizer follows
    compute_dtype."""
    from ocrjax_torch.models.crnn import create_crnn
    from ocrjax_torch.models.db import create_db
    cfg = OcrConfig(compute_dtype="float32", rec_compute_dtype="bfloat16",
                    **SMALL)
    assert S.create_svtr(cfg, CLASSES).dtype == torch.bfloat16
    assert create_crnn(cfg.replace(rec_arch="crnn"),
                       CLASSES).conv0.conv.dtype == torch.bfloat16
    assert create_db(cfg).head.dtype == torch.float32
    same = cfg.replace(rec_compute_dtype="")
    assert S.create_svtr(same, CLASSES).dtype == torch.float32
    assert OcrEngine(config=cfg, device="cpu").rec_model.dtype == \
        torch.bfloat16


def test_local_window(small):
    """Block 0 is local: a key 4 rows or 6 columns from the query changes
    nothing at the query, a key 3 rows and 5 columns away changes it; the
    port's block and the reference's gathered window agree."""
    cfg, flat, model = small
    gh, T, D = 8, 16, cfg.svtr_dims[0]
    lengths = torch.tensor([T])
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, gh * T, D, generator=g)
    mask = S.attention_mask(gh, T, lengths, cfg.svtr_window)
    add = torch.zeros(mask.shape).masked_fill_(~mask, float("-inf"))
    p = M.Params(flat, "cpu")
    h, w = 2, 7

    def at(r, c):
        return r * T + c

    def outs(t):
        with torch.inference_mode():
            port = model.blocks[0](t, add)[0, at(h, w)]
            ref = R._block(p, 0, t, cfg.svtr_heads[0], lengths, gh, T,
                           tuple(cfg.svtr_window))[0, at(h, w)]
        return port, ref
    base = outs(x)
    for r, c, moves in ((h + 4, w, False), (h, w + 6, False),
                        (h, w - 6, False), (h + 3, w + 5, True),
                        (h - 2, w - 5, True)):
        y = x.clone()
        y[0, at(r, c)] += 1.0
        for b, o in zip(base, outs(y)):
            assert bool((b - o).abs().max() > 1e-4) == moves, (r, c)
    assert (base[0] - base[1]).abs().max() < 1e-5


def test_mask_closes_padding_but_never_a_whole_row():
    eye = torch.eye(10, dtype=torch.bool)
    cols = torch.arange(5).repeat(2)
    m = S.attention_mask(2, 5, torch.tensor([3, 0]), None)[:, 0]
    assert torch.equal(m[0], (cols[None, :] < 3) | eye)
    assert torch.equal(m[1], eye)           # no valid key: itself alone
    m = S.attention_mask(8, 16, torch.tensor([9]), (7, 11))[0, 0]
    for q in range(0, 128, 5):
        for k in range(128):
            near = abs(q // 16 - k // 16) <= 3 and abs(q % 16 - k % 16) <= 5
            assert bool(m[q, k]) == (q == k or (near and k % 16 < 9))


def test_valid_frames_equal_at_two_width_buckets(small):
    cfg, flat, model = small
    g = torch.Generator().manual_seed(4)
    s = torch.full((1, 32, 128), -1.0)
    s[:, :, :40] = torch.randn(1, 32, 40, generator=g)
    w = torch.tensor([40])
    a, la = _port(model, s[:, :, :64], w)
    b, lb = _port(model, s, w)
    assert la.tolist() == lb.tolist() == [10]
    assert (a[0, :10] - b[0, :10]).abs().max() < 1e-5
    ra, _ = _ref(cfg, flat, s[:, :, :64], w)
    rb, _ = _ref(cfg, flat, s, w)
    assert (ra[0, :10] - rb[0, :10]).abs().max() < 1e-5


@pytest.mark.parametrize("width", [64, 100, 128])
def test_flops_closed_form_equals_counting(small, width):
    cfg, flat, _ = small
    p = M.Params(flat, "cpu")
    with torch.inference_mode(), M.counting() as c:
        R.logits(p, _ns(cfg), torch.zeros(1, 32, -(-width // 4) * 4),
                 torch.tensor([width]))
    assert R.flops(p, _ns(cfg), [width]).tolist() == [float(c.flops)]
    head = 2.0 * -(-width // 4) * cfg.svtr_out_channels * CLASSES
    f, b = R.parts(_ns(cfg), [width])["svtr"]
    assert f.tolist() == [c.flops - head] and b[0] > 0


def test_weights_round_trip_through_the_flat_names(small, tmp_path):
    cfg, flat, model = small
    sd, used = W.svtr_state_dict(flat)
    assert sorted(used) == sorted(flat)
    back = W.model_variables(model)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k
    path = str(tmp_path / "svtr.safetensors")
    W.save_variables(path, back)
    other = S.create_svtr(cfg, CLASSES)
    W.load_model_variables(other, W.read_safetensors(path)[0])
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
    assert sorted(W.rec_state_dict(flat, "svtr")[0]) == sorted(sd)
    with pytest.raises(ValueError, match="rec_arch"):
        W.rec_state_dict(flat, "vit")


# ---------------------------------------------------------------------------
# the lanes, against the reference's
# ---------------------------------------------------------------------------

LANE_CFG = dict(SMALL, det_max_side=480, compute_dtype="float32",
                tile_size=512, tile_overlap=64, line_batch_buckets=(4, 8),
                fused_chunk_pages=2)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """(engine, reference, 480 px pages, an A4 crop) on the CPU, the
    detectors from the shipped assets, SVTR from the seed."""
    from benchmark.reference.pipeline import Reference
    cfg = asset_config(**LANE_CFG)
    flat = _flat(cfg)
    rec = str(tmp_path_factory.mktemp("svtr") / "rec.safetensors")
    W.save_variables(rec, flat)
    assets = {n: os.path.join(ASSETS, f"{n}.safetensors")
              for n in ("det", "cls", "det_tile")}
    assets.update(rec=rec, charset=os.path.join(ASSETS, "rec.charset.txt"))
    tile_flat, meta = W.read_safetensors(assets["det_tile"])
    eng = OcrEngine(config=cfg, charset=Charset.from_file(
        assets["charset"]), rec_weights=flat,
        det_weights=W.read_safetensors(assets["det"])[0],
        cls_weights=W.read_safetensors(assets["cls"])[0], device="cpu",
        tile_det_weights=tile_flat, tile_det_arch=json.loads(meta["arch"]))
    ref = Reference(dataclasses.asdict(cfg), assets, "cpu")
    with np.load(os.path.join(DATA, "bench_traffic.npz")) as z:
        pages = [np.ascontiguousarray(z["pages"][p, y:y + 480, x:x + 480])
                 for p, y, x in ((93, 480, 480), (90, 0, 0))]
    with np.load(os.path.join(DATA, "c5_pages.npz")) as z:
        a4 = np.ascontiguousarray(z["dense"][:400, :1100])
    return eng, ref, pages, a4


def _same(results, ref_pages):
    assert len(results) == len(ref_pages)
    for r, want in zip(results, ref_pages):
        assert [line.text for line in r.lines] == want["texts"]
        got = np.asarray([line.box.quad for line in r.lines],
                         np.float32).reshape(-1, 4, 2)
        assert np.abs(got - want["quads"]).max(initial=0) < 1e-3


def test_every_lane_reads_the_reference_strings(lanes):
    eng, ref, pages, a4 = lanes
    pooled = ref.run("pooled", pages)
    assert sum(len(p["texts"]) for p in pooled) >= 4
    # not degenerate: the seeded SVTR reads varied strings
    chars = {c for p in pooled for t in p["texts"] for c in t}
    assert len(chars) >= 3
    _same(eng.ocr_batch(pages), pooled)
    fused = ref.run("fused", pages)
    _same(eng.ocr_batch(pages, fused=True), fused)
    _same([eng.ocr(pages[0])], fused[:1])
    _same(eng.ocr_tiled_batch([a4]), ref.run("tiled", [a4]))
    from ocrjax_torch.api_det import rec_counts
    assert rec_counts["strips"] > 0 and rec_counts["columns"] > 0


def test_a_bf16_recognizer_keeps_the_float32_detectors_boxes(lanes):
    """rec_compute_dtype bf16 over a float32 detector (the A4 SVTR cell's
    split): the tiled lane's boxes are the float32 reference's, every line
    is read, and the recognizer alone runs in bf16."""
    eng, ref, _, a4 = lanes
    cfg = eng.config.replace(rec_compute_dtype="bfloat16")
    low = OcrEngine(config=cfg, charset=eng.charset,
                    rec_weights=W.model_variables(eng.rec_model),
                    det_weights=W.model_variables(eng.det_model),
                    device="cpu", tile_det_arch=eng.tile_det_arch,
                    tile_det_weights=W.model_variables(eng.tile_det_model))
    assert low.rec_model.dtype == torch.bfloat16
    assert low.tile_det_model.head.dtype == torch.float32
    got = low.ocr_tiled_batch([a4])[0]
    want = ref.run("tiled", [a4])[0]
    quads = np.asarray([line.box.quad for line in got.lines],
                       np.float32).reshape(-1, 4, 2)
    assert quads.shape == want["quads"].shape and len(quads) >= 2
    assert np.abs(quads - want["quads"]).max() < 1e-3
    assert all(line.text for line in got.lines)


def test_rec_arch_empties_the_program_registry(lanes):
    eng, _, pages, _ = lanes
    eng.ocr_batch(pages[:1])
    assert graphs.engine_programs(eng)
    before = eng.config
    try:
        eng.config = before.replace(rec_arch="crnn")
        assert graphs.engine_programs(eng) == {}
        # the engine's recognizer is SVTR: a lane refuses, naming rec_arch
        with pytest.raises(ValueError, match="rec_arch"):
            eng.ocr_batch(pages[:1])
    finally:
        eng.config = before
    assert [line.text for line in eng.ocr_batch(pages[:1])[0].lines]


def test_crnn_only_entries_refuse_svtr(monkeypatch):
    from ocrjax_torch import bench_lib
    from ocrjax_torch.charset import default_charset
    from ocrjax_torch.parallel import mesh
    from ocrjax_torch.train import rec_trainer
    cfg = OcrConfig(compute_dtype="float32", **SMALL)
    with pytest.raises(ValueError, match="rec_arch"):
        rec_trainer.train_rec(config=cfg, steps=1, device="cpu")
    with pytest.raises(ValueError, match="rec_arch"):
        mesh.init_sharded_rec_state(cfg, default_charset(), None)
    with pytest.raises(ValueError, match="rec_arch"):
        mesh.make_sharded_rec_train_step(S.create_svtr(cfg, CLASSES), None,
                                         None)
    eng = OcrEngine(config=cfg, device="cpu")
    assert eng.rec_model.arch == "svtr"
    monkeypatch.setattr(OcrEngine, "from_pretrained",
                        classmethod(lambda cls, **kw: eng))
    with pytest.raises(ValueError, match="rec_arch"):
        bench_lib.run_bench(cpu=True)
