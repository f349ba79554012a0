"""The committed chip fixture: pages and the JAX engine's outputs on them.

chip_smoke.py runs the port on the card over
ocrjax_torch/testdata/pages_960.npz and holds its float32 results against
ocrjax_torch/testdata/expected_jax_fp32_960.json. The machine with the card
has neither JAX nor a text renderer, so both files are made here and
committed; this test re-renders the pages and re-runs the JAX engine, and
fails if either committed file differs from what the code makes now.

The staged and rerouted lanes have a second pair of files,
lanes_960.npz (a tilted, a colour, an inverted, a 40-line, an oversize and
an oversize tilted page, a few line strips, quads for the homography solve)
and expected_jax_lanes_fp32_960.json (the JAX engine's float32 outputs of
ocr_batch fused and bucketed, ocr, detect and recognize_strips on them, and
its solve_homographies values). Re-running all of that on the CPU takes
minutes, so the guard re-renders every input and re-runs the cheap entry
points (recognize_strips, solve_homographies, detect on the tilted page);
--write re-runs everything.

Three more pairs serve the later phases of chip_smoke.py:
  * expected_jax_beam_fp32_960.json: the JAX float32 beam=True outputs of
    the fused lane on pages_960.npz, the bucketed lane on the lane batch
    and recognize_strips on the lane strips;
  * flip_960.npz (an upright, a 180-degree and a 90-degree rotated page)
    and expected_jax_flip_fp32_960.json: the try-flip engine's outputs of
    ocr, ocr_batch(fused=True) and ocr_batch(fused=False);
  * c5_pages.npz (two A4 pages at 300 dpi: a dense one and one with text
    in its top band only) and expected_jax_c5_fp32.json: ocr_tiled_batch
    on [dense, sparse, dense] at the shipped tile settings and
    detect_tiled on the dense page.
The guard re-renders every input and re-runs the beam strips; the page
outputs, minutes of JAX on the CPU, are regenerated only by --write.

The opt-in paths (chip_smoke.py phases 10 and 11) have three more files:
  * expected_jax_optin_fp32_960.json: det_int8 on the fused lane (the 4
    pages), ocr() and the bucketed lane batch; the fused program with the
    exact homography warp on the 4 pages; rec_flat_case_gate on the lane
    batch, fused and bucketed;
  * det_int8_fold_jax.npz: ocrjax's BN fold of the det asset (XLA:CPU's
    rsqrt), with which the card holds the rest of the int8 path exactly;
  * curl_960.npz (three pages under page curl, the third upside down, and
    line crops) and expected_jax_curl_fp32_960.json: rec_dewarp_curl
    through ocr, ocr_batch fused and bucketed and recognize_strips, with
    and without rec_try_flip, and the dewarp's curved masks.
The guard re-renders the curl inputs, re-derives the fold and re-runs the
curved masks; the lane outputs are regenerated only by --write, or alone
by --write-optin.

The bench, e2e_eval and the trainers (chip_smoke.py phases 13-15) read
three more inputs, rendered here because the card's machine has no PIL:
  * bench_traffic.npz: run_bench's traffic in its seeds and order
    (RandomState(0): 256 strips at width 320, then 96 pages at 960, of
    which run_bench's default takes the first 16 and bench_main all; dense
    page s at RandomState(1000 + s), 3072x2048 with 200 lines), with the
    ground-truth texts and quads;
  * e2e_pages.npz (evaluate_e2e's 8 pages, seed 123, 640 px, and their
    texts) and expected_jax_e2e_fp32.json (ocrjax's fp32 line exact match,
    detection recall and CER on them);
  * train_batches.npz (3 rec batches of train_rec, 3 det pages batches of
    train_det with their quads, 3 cls batches of train_cls, each from its
    trainer's RandomState(0)) and expected_jax_train_fp32.json: 3 steps of
    each ocrjax step function from the shipped assets at full width in
    float32: the losses, and per parameter leaf the norm of the update and
    of the new BatchNorm statistics, with the bars the card is held to.
The guard re-renders every input with ocrjax.train.synth; the JAX numbers
are regenerated by --write, or with the other two alone by
--write-bench-train (~3 min of CPU).

Regenerate (after an intended change to the renderer, weights or
pipeline) with:
    JAX_PLATFORMS=cpu python tests/test_torch_fixture.py --write
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "ocrjax_torch", "testdata")
PAGES = os.path.join(TESTDATA, "pages_960.npz")
EXPECTED = os.path.join(TESTDATA, "expected_jax_fp32_960.json")
SEEDS = (1101, 1102, 1103, 1104)
SIZE = 960
# XLA:CPU may round the last bit of a float differently on another host
# CPU; coordinates and scores are held to 1e-4, strings exactly.
FLOAT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """At most two torch threads while a port test module runs: the test
    workers share the host's cores, and torch's default of one thread a
    core oversubscribes them (two of the port's files under two workers:
    178.8 s with 8 threads, 104.5 s with 2, on an 8-core host). Modules
    import it to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A (1, 1) parallel.mesh mesh over a gloo process group of this
    process alone (file rendezvous in tmp_path), torn down after."""
    import torch.distributed as dist
    from ocrjax_torch.parallel import mesh as M
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield M.make_mesh()
    finally:
        dist.destroy_process_group()


def render_pages() -> np.ndarray:
    """(4, 960, 960) uint8 luma pages from ocrjax's synthetic renderer."""
    from ocrjax.charset import Charset
    from ocrjax.train import synth
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))
    pages = []
    for s in SEEDS:
        rng = np.random.RandomState(s)
        page, _, _ = synth.render_page(rng, charset, size=(SIZE, SIZE),
                                       n_lines=(6, 12), text_height=(20, 40))
        pages.append(page)
    return np.stack(pages)


def _port_only() -> tuple:
    import dataclasses

    from ocrjax.config import OcrConfig as JaxConfig
    from ocrjax_torch.config import OcrConfig
    theirs = {f.name for f in dataclasses.fields(JaxConfig)}
    return tuple(f.name for f in dataclasses.fields(OcrConfig)
                 if f.name not in theirs)


# the port's own config fields, which ocrjax's OcrConfig does not have (the
# recognizer's name, its compute dtype and SVTR's widths), in their order
PORT_ONLY = _port_only()


def jax_fields(cfg) -> dict:
    """The port's config as ocrjax's OcrConfig keywords: its fields less
    the port's own (PORT_ONLY)."""
    import dataclasses
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in PORT_ONLY}


def asset_config(**overrides):
    """ocrjax OcrConfig from the assets' `config` metadata (rec, then det),
    plus overrides — what from_pretrained builds when given no config."""
    from ocrjax import weights as W
    from ocrjax.config import OcrConfig
    cfg = {}
    for name in ("rec", "det"):
        meta = W.load_metadata(os.path.join(ROOT, "assets",
                                            f"{name}.safetensors"))
        cfg.update(json.loads(meta["config"]))
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    cfg.update(overrides)
    return OcrConfig(**cfg)


def result_record(res) -> dict:
    return {"strings": [line.text for line in res.lines],
            "boxes": [[[float(v) for v in pt] for pt in line.box.quad]
                      for line in res.lines],
            "scores": [float(line.box.score) for line in res.lines]}


def jax_expected(pages: np.ndarray) -> dict:
    from ocrjax.api import OcrEngine
    eng = OcrEngine.from_pretrained(
        config=asset_config(det_max_side=SIZE, compute_dtype="float32"))
    results = eng.ocr_batch(list(pages), fused=True)
    return {"seeds": list(SEEDS), "det_max_side": SIZE,
            "compute_dtype": "float32",
            "pages": [result_record(r) for r in results]}


LANES = os.path.join(TESTDATA, "lanes_960.npz")
LANES_EXPECTED = os.path.join(TESTDATA, "expected_jax_lanes_fp32_960.json")
# the mixed batch, in order; "straight" is page 0 of pages_960.npz
LANE_BATCH = ("straight", "tilted", "color", "inverted", "dense", "big",
              "bigtilt")
STRIP_SEEDS = (301, 302, 303, 304, 305)


def render_lane_inputs() -> dict:
    """The arrays of lanes_960.npz: one page per reroute of the fused lane,
    line strips of several sizes, and quads for the homography solve."""
    from ocrjax.charset import Charset
    from ocrjax.train import synth
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))

    def page(seed, size=(SIZE, SIZE), **kw):
        return synth.render_page(np.random.RandomState(seed), charset,
                                 size=size, **kw)[0]

    ink = page(1203, n_lines=(8, 11), text_height=(30, 44))
    out = {
        "tilted": page(1201, n_lines=(4, 7), text_height=(24, 40),
                       max_rotation=8.0),
        # saturated yellow ink on white: 601 luma washes it out
        "color": np.stack([np.full_like(ink, 255), np.full_like(ink, 255),
                           ink], axis=-1),
        "inverted": np.asarray(
            255 - page(1204, n_lines=(4, 6), text_height=(24, 40)), np.uint8),
        "dense": synth.render_page_dense(
            np.random.RandomState(1205), charset, size=(SIZE, SIZE),
            n_lines=40, text_height=(18, 26))[0],
        "big": page(1206, size=(1400, 1000), n_lines=(6, 10),
                    text_height=(36, 60)),
        "bigtilt": page(1207, size=(1100, 1280), n_lines=(4, 6),
                        text_height=(40, 60), max_rotation=8.0),
    }
    for k, s in enumerate(STRIP_SEEDS):
        rng = np.random.RandomState(s)
        text = synth.random_text(rng, charset, 4, 14)
        # rendered at several heights, so rec_resize scales up and down
        out[f"strip{k}"] = synth.render_line(text, (32, 48, 24, 64, 20)[k])
    rng = np.random.RandomState(1208)
    ctr = rng.uniform(100, 800, (16, 1, 2))
    half = np.stack([rng.uniform(20, 200, 16), rng.uniform(6, 30, 16)], -1)
    ang = np.radians(rng.uniform(-12, 12, 16))
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                    np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    out["hquads"] = (ctr + np.einsum("nij,nkj->nki", rot,
                                     corners[None] * half[:, None])
                     ).astype(np.float32)
    out["hwidths"] = rng.randint(8, 320, 16).astype(np.int32)
    return out


def lane_batch(lanes, pages) -> list:
    return [pages[0] if k == "straight" else lanes[k] for k in LANE_BATCH]


def lane_strips(lanes) -> list:
    return [lanes[f"strip{k}"] for k in range(len(STRIP_SEEDS))]


def _lane_engine():
    from ocrjax.api import OcrEngine
    return OcrEngine.from_pretrained(
        config=asset_config(det_max_side=SIZE, compute_dtype="float32"))


def det_record(boxes) -> dict:
    return {"boxes": [[[float(v) for v in pt] for pt in b.quad]
                      for b in boxes],
            "scores": [float(b.score) for b in boxes]}


def jax_cheap_expected(lanes, eng=None) -> dict:
    """The entry points the guard re-runs."""
    import jax.numpy as jnp
    from ocrjax.ops.warp import solve_homographies
    eng = eng or _lane_engine()
    recs = eng.recognize_strips(lane_strips(lanes))
    hs = solve_homographies(jnp.asarray(lanes["hquads"]),
                            jnp.full((16,), 32, jnp.int32),
                            jnp.asarray(lanes["hwidths"]))
    return {"strips": {"strings": [r.text for r in recs],
                       "conf": [float(r.confidence) for r in recs]},
            "homographies": np.asarray(hs).tolist(),
            "detect_tilted": det_record(eng.detect(lanes["tilted"]))}


def jax_lane_expected(lanes, pages) -> dict:
    eng = _lane_engine()
    batch = lane_batch(lanes, pages)
    out = {"batch": list(LANE_BATCH), "det_max_side": SIZE,
           "compute_dtype": "float32",
           "fused_batch": [result_record(r)
                           for r in eng.ocr_batch(batch, fused=True)],
           "bucketed_batch": [result_record(r)
                              for r in eng.ocr_batch(batch, fused=False)],
           "ocr_big": result_record(eng.ocr(lanes["big"])),
           "detect_big": det_record(eng.detect(lanes["big"]))}
    out.update(jax_cheap_expected(lanes, eng))
    return out


LOGS_EXPECTED = os.path.join(TESTDATA, "expected_jax_logs.json")


@contextlib.contextmanager
def captured_logs(name: str):
    """The records of logger `name` while the block runs, as (level,
    message, fields); get_logger's loggers do not propagate to the root,
    so the handler sits on the logger itself, which logs from INFO up
    (get_logger sets no level on a logger that has a handler)."""
    import logging
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.levelname, record.getMessage(),
                            dict(getattr(record, "fields", {}))))
    logger = logging.getLogger(name)
    h, level = Keep(), logger.level
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)


def jax_lane_logs(lanes, pages) -> dict:
    """ocrjax's fused-lane log lines on the mixed batch (the redo counts
    rotated, saturated, colorful), float32 at 960."""
    eng = _lane_engine()
    with captured_logs("ocrjax.fused") as recs:
        eng.ocr_batch(lane_batch(lanes, pages), fused=True)
    return {"batch": list(LANE_BATCH), "det_max_side": SIZE,
            "compute_dtype": "float32",
            "fused": [{"level": lv, "msg": m, "fields": f}
                      for lv, m, f in recs]}


BEAM_EXPECTED = os.path.join(TESTDATA, "expected_jax_beam_fp32_960.json")


def jax_beam_strips(lanes, eng=None) -> dict:
    eng = eng or _lane_engine()
    recs = eng.recognize_strips(lane_strips(lanes), beam=True)
    return {"strings": [r.text for r in recs],
            "conf": [float(r.confidence) for r in recs]}


def jax_beam_expected(pages, lanes) -> dict:
    eng = _lane_engine()
    return {"det_max_side": SIZE, "compute_dtype": "float32",
            "fused": [result_record(r) for r in
                      eng.ocr_batch(list(pages), fused=True, beam=True)],
            "batch": list(LANE_BATCH),
            "bucketed_batch": [result_record(r) for r in eng.ocr_batch(
                lane_batch(lanes, pages), fused=False, beam=True)],
            "strips": jax_beam_strips(lanes, eng)}


FLIP = os.path.join(TESTDATA, "flip_960.npz")
FLIP_EXPECTED = os.path.join(TESTDATA, "expected_jax_flip_fp32_960.json")
FLIP_PAGES = ("upright", "flip180", "rot90")


def render_flip_pages() -> dict:
    """An upright page, a page rotated 180 degrees and one rotated 90
    degrees counter-clockwise (a landscape scan), all 960 x 960."""
    from ocrjax.charset import Charset
    from ocrjax.train import synth
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))

    def page(seed):
        return synth.render_page(np.random.RandomState(seed), charset,
                                 size=(SIZE, SIZE), n_lines=(6, 10),
                                 text_height=(24, 40))[0]

    return {"upright": page(1401),
            "flip180": np.ascontiguousarray(np.rot90(page(1402), 2)),
            "rot90": np.ascontiguousarray(np.rot90(page(1403)))}


def jax_flip_expected(flip) -> dict:
    from ocrjax.api import OcrEngine
    eng = OcrEngine.from_pretrained(config=asset_config(
        det_max_side=SIZE, compute_dtype="float32", rec_try_flip=True))
    batch = [flip[k] for k in FLIP_PAGES]
    return {"pages": list(FLIP_PAGES), "det_max_side": SIZE,
            "compute_dtype": "float32", "rec_try_flip": True,
            "ocr": [result_record(eng.ocr(p)) for p in batch],
            "fused_batch": [result_record(r)
                            for r in eng.ocr_batch(batch, fused=True)],
            "bucketed_batch": [result_record(r)
                               for r in eng.ocr_batch(batch, fused=False)]}


C5 = os.path.join(TESTDATA, "c5_pages.npz")
C5_EXPECTED = os.path.join(TESTDATA, "expected_jax_c5_fp32.json")
A4 = (3508, 2480)          # A4 at 300 dpi, (H, W)
C5_BATCH = ("dense", "sparse", "dense")


def render_c5_pages() -> dict:
    """Two A4 pages at 300 dpi: a dense table-like page (render_page_dense,
    up to 250 lines of height 18-32) and a page with text in its top 700
    rows only, so the blank-tile prescreen drops its lower tiles."""
    from ocrjax.charset import Charset
    from ocrjax.train import synth
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))
    dense = synth.render_page_dense(np.random.RandomState(1501), charset,
                                    size=A4, n_lines=250,
                                    text_height=(18, 32))[0]
    sparse = np.full(A4, 255, np.uint8)
    sparse[:700] = synth.render_page(
        np.random.RandomState(1502), charset, size=(700, A4[1]),
        n_lines=(8, 12), text_height=(24, 40))[0]
    return {"dense": dense, "sparse": sparse}


def record_with_truncation(res) -> dict:
    return {**result_record(res), "truncated": bool(res.truncated)}


@contextlib.contextmanager
def exact_moments():
    """ocrjax's extract_boxes with its one einsum, the per-component moment
    sums, computed exactly: float64 on the host, rounded once to float32,
    as the port sums them. Everything else stays the reference's float32.

    At 2048-pixel tiles the reference's float32 sums, taken about the tile
    centre up to 1,000 px away, cancel in var = E[x^2] - E[x]^2 and tilt a
    box by up to a third of a degree: its own boxes sit up to ~0.1 px from
    these. The port, summing exactly, is held to this evaluation."""
    import jax
    import jax.numpy as jnp
    from ocrjax.postprocess import db_boxes

    def host(m, v):
        m, v = np.asarray(m), np.asarray(v, np.float64)
        out = np.zeros((m.shape[1], v.shape[1]), np.float64)
        for lo in range(0, m.shape[0], 8192):
            out += m[lo:lo + 8192].astype(np.float64).T @ v[lo:lo + 8192]
        return out.astype(np.float32)

    class _Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def einsum(spec, mask, vals, **kw):
            assert spec == "pc,pv->cv"
            return jax.pure_callback(
                host, jax.ShapeDtypeStruct((mask.shape[1], vals.shape[1]),
                                           jnp.float32),
                mask, vals, vmap_method="sequential")

    db_boxes.jnp = _Jnp()
    jax.clear_caches()
    try:
        yield
    finally:
        db_boxes.jnp = jnp
        jax.clear_caches()


def _c5_outputs(c5) -> dict:
    from ocrjax.api import OcrEngine
    eng = OcrEngine.from_pretrained(config=asset_config(
        compute_dtype="float32"))
    return {"ocr_tiled_batch": [record_with_truncation(r) for r in
                                eng.ocr_tiled_batch([c5[k]
                                                     for k in C5_BATCH])],
            "detect_tiled_dense": det_record(eng.detect_tiled(c5["dense"]))}


def _box_gap(a: dict, b: dict) -> float:
    """Largest box-corner difference between two C5 output records."""
    recs = list(zip(a["ocr_tiled_batch"], b["ocr_tiled_batch"])) + [
        (a["detect_tiled_dense"], b["detect_tiled_dense"])]
    return max(float(np.abs(np.asarray(x["boxes"])
                            - np.asarray(y["boxes"])).max())
               for x, y in recs)


def jax_c5_expected(c5) -> dict:
    """The shipped tile settings (2048-pixel tiles, 128 overlap, 384
    candidates a tile, the tile detector) in float32: the reference's
    outputs, the same with exact moment sums (exact_moments), and the
    largest box gap between the two."""
    from ocrjax.config import OcrConfig
    cfg = OcrConfig()
    plain = _c5_outputs(c5)
    with exact_moments():
        exact = _c5_outputs(c5)
    return {"batch": list(C5_BATCH), "compute_dtype": "float32",
            "tile_size": cfg.tile_size, "tile_overlap": cfg.tile_overlap,
            "tile_max_candidates": cfg.tile_max_candidates, **plain,
            "exact_moments": exact,
            "reference_moment_error_px": _box_gap(plain, exact)}


def jax_int8_fold(model) -> dict:
    """ocrjax's BN fold (db_int8._fold_bn under jit, XLA:CPU's rsqrt) of
    every BatchNorm of a port DBDetector: {module name: (g, bias')}, with
    the folded weight w' = w * g. The port's own fold takes the correctly
    rounded rsqrt; XLA:CPU's (rsqrtps and two Newton steps) agrees on about
    89% of channels, so chip_smoke.py and the int8 tests hold the rest of
    the int8 path to the reference with these values, and the port's own
    fold at its own bar."""
    import jax
    from ocrjax.models import db_int8 as jq
    fold = jax.jit(lambda k, s, b, m, v: jq._fold_bn(
        k, {"scale": s, "bias": b}, {"mean": m, "var": v}))
    out = {}
    for name, m in model.named_modules():
        if type(m).__name__ == "BatchNorm":
            vals = [getattr(m, a).detach().cpu().numpy() for a in
                    ("weight", "bias", "running_mean", "running_var")]
            g, b = fold(np.ones((1, 1, 1, len(vals[0])), np.float32), *vals)
            out[name] = (np.asarray(g).reshape(-1), np.asarray(b))
    return out


OPTIN_EXPECTED = os.path.join(TESTDATA, "expected_jax_optin_fp32_960.json")
INT8_FOLD = os.path.join(TESTDATA, "det_int8_fold_jax.npz")
CURL = os.path.join(TESTDATA, "curl_960.npz")
CURL_EXPECTED = os.path.join(TESTDATA, "expected_jax_curl_fp32_960.json")
CURL_SEEDS = (1602, 1606, 1613)          # the third page is upside down
# (page, line, rotated 180 degrees) of each line crop
CURL_STRIP_ROWS = ((0, 4, False), (1, 2, False), (2, 1, False), (1, 2, True))


def jax_optin_expected(pages, lanes) -> dict:
    """The opt-in lanes of ocrjax in float32 at 960:
      * int8: det_int8 on the fused lane over the 4 fixture pages (their
        per-channel activation max equals that of the 4 pages x 4 that
        chip_smoke.py runs as one chunk, so the int8 codes are the same),
        ocr() of page 0, and the bucketed lane on the lane batch;
      * grouped: the fused program with the exact homography warp
        (make_fused_ocr_fn(separable_warp=False)) on the 4 pages;
      * case_gate: rec_flat_case_gate on the lane batch, fused and
        bucketed."""
    from ocrjax import fused as jfused
    from ocrjax.api import OcrEngine
    batch = lane_batch(lanes, pages)
    base = dict(det_max_side=SIZE, compute_dtype="float32")
    eng = OcrEngine.from_pretrained(config=asset_config(**base,
                                                        det_int8=True))
    int8 = {"fused": [result_record(r)
                      for r in eng.ocr_batch(list(pages), fused=True)],
            "ocr": result_record(eng.ocr(pages[0])),
            "bucketed_batch": [result_record(r) for r in
                               eng.ocr_batch(batch, fused=False)]}
    eng = OcrEngine.from_pretrained(config=asset_config(**base))
    cfg = eng.config
    K, W = cfg.fused_lines_per_page, cfg.rec_bucket_for_width(
        10 * cfg.rec_height)
    key = (K, W, False, cfg.replace(det_thresh=0.0, det_box_thresh=0.0,
                                    det_unclip_ratio=0.0, det_min_box_size=0))
    eng._fused_cache = {key: jfused.make_fused_ocr_fn(
        eng, K, W, separable_warp=False)}
    grouped = [result_record(r) for r in eng.ocr_batch(list(pages),
                                                        fused=True)]
    eng = OcrEngine.from_pretrained(config=asset_config(
        **base, rec_flat_case_gate=True))
    gate = {"fused_batch": [result_record(r)
                            for r in eng.ocr_batch(batch, fused=True)],
            "bucketed_batch": [result_record(r)
                               for r in eng.ocr_batch(batch, fused=False)]}
    return {"det_max_side": SIZE, "compute_dtype": "float32",
            "batch": list(LANE_BATCH), "int8": int8, "grouped": grouped,
            "case_gate": gate}


def render_curl_inputs() -> dict:
    """Three 960 pages of long lines under page curl
    (synth.warp_page_projective(curl=1.0): a bow of 1.5% of the page
    height), the third rotated 180 degrees, and line crops of them for
    recognize_strips, one of them upside down."""
    from ocrjax.charset import Charset
    from ocrjax.train import synth
    charset = Charset.from_file(os.path.join(ROOT, "assets",
                                             "rec.charset.txt"))
    out = {}
    for k, seed in enumerate(CURL_SEEDS):
        rng = np.random.RandomState(seed)
        page, quads, _ = synth.render_page(
            rng, charset, size=(SIZE, SIZE), n_lines=(6, 9),
            text_height=(20, 28), max_len=45, min_len=37)
        page, quads = synth.warp_page_projective(page, quads, rng,
                                                 severity=0.0, curl=1.0)
        out[f"page{k}"] = page
        out[f"quads{k}"] = np.stack(quads).astype(np.float32)
    for j, (k, line, rot) in enumerate(CURL_STRIP_ROWS):
        q = out[f"quads{k}"][line]
        y0, y1 = int(q[:, 1].min()) - 8, int(q[:, 1].max()) + 9
        x0, x1 = int(q[:, 0].min()) - 8, int(q[:, 0].max()) + 9
        crop = out[f"page{k}"][max(y0, 0):y1, max(x0, 0):x1]
        out[f"strip{j}"] = np.ascontiguousarray(np.rot90(crop, 2) if rot
                                                else crop)
    out["page2"] = np.ascontiguousarray(np.rot90(out["page2"], 2))
    return out


def curl_pages(curl) -> list:
    return [curl[f"page{k}"] for k in range(len(CURL_SEEDS))]


def curl_strips(curl) -> list:
    return [curl[f"strip{j}"] for j in range(len(CURL_STRIP_ROWS))]


def jax_curved_masks(curl, boxes) -> list:
    """dewarp_curl's `curved` mask over each page's staged strips: the
    quads (one list a page) expanded by the crop margin, warped twice with
    the ink refine (bucket 512) off the page normalized in float32."""
    import jax.numpy as jnp
    from ocrjax.ops import warp as jw
    cfg = asset_config()
    out = []
    for page, quads in zip(curl_pages(curl), boxes):
        quads = np.asarray(quads, np.float32)
        bounds = np.asarray([page.shape[1] - 1.0, page.shape[0] - 1.0],
                            np.float32)
        gray = (page.astype(np.float32) / 255.0 - cfg.rec_mean) / cfg.rec_std
        exp = jw.expand_quads(quads, cfg.rec_crop_margin,
                              cfg.rec_crop_margin, bounds=bounds)
        strips, widths = jw.warp_quads_refined(
            jnp.asarray(gray), jnp.asarray(exp, jnp.float32),
            jnp.asarray(bounds), rec_height=cfg.rec_height,
            bucket_width=512, ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
            margin_fracs=(cfg.rec_crop_margin, cfg.rec_crop_margin),
            x_margin_keep=cfg.rec_ink_x_margin_keep,
            pad_value=(0.0 - cfg.rec_mean) / cfg.rec_std,
            orig_quads=jnp.asarray(quads), flat_frac=cfg.rec_flat_band_frac)
        _, curved = jw.dewarp_curl(
            strips, widths, ink_thresh=(0.5 - cfg.rec_mean) / cfg.rec_std,
            min_dev_px=cfg.rec_dewarp_min_dev_px,
            max_shift_px=cfg.rec_dewarp_max_px,
            pad_value=(0.0 - cfg.rec_mean) / cfg.rec_std)
        out.append(np.asarray(curved).tolist())
    return out


def jax_curl_expected(curl) -> dict:
    """rec_dewarp_curl on the curl pages, without and with rec_try_flip:
    ocr() of each page, ocr_batch fused and bucketed, recognize_strips on
    the line crops (each its own prior group, so the upside-down crop
    flips); and the curved masks over the staged strips of the boxes ocr()
    found."""
    from ocrjax.api import OcrEngine
    pages = curl_pages(curl)
    out = {"pages": len(pages), "det_max_side": SIZE,
           "compute_dtype": "float32", "rec_dewarp_curl": True}
    for flip in (False, True):
        eng = OcrEngine.from_pretrained(config=asset_config(
            det_max_side=SIZE, compute_dtype="float32",
            rec_dewarp_curl=True, rec_try_flip=flip))
        recs = eng.recognize_strips(curl_strips(curl))
        out["try_flip" if flip else "plain"] = {
            "ocr": [result_record(eng.ocr(p)) for p in pages],
            "fused_batch": [result_record(r)
                            for r in eng.ocr_batch(pages, fused=True)],
            "bucketed_batch": [result_record(r)
                               for r in eng.ocr_batch(pages, fused=False)],
            "strips": {"strings": [r.text for r in recs],
                       "conf": [float(r.confidence) for r in recs],
                       "flipped": [bool(r.flipped) for r in recs]}}
    out["curved"] = jax_curved_masks(
        curl, [p["boxes"] for p in out["plain"]["ocr"]])
    return out


def write_int8_fold() -> None:
    """INT8_FOLD: ocrjax's BN fold of the shipped det asset, by the port's
    module names (g and bias' a BatchNorm)."""
    from ocrjax_torch.api import OcrEngine as PortEngine
    from ocrjax_torch.api import asset_config as port_config
    port = PortEngine.from_pretrained(config=port_config(
        compute_dtype="float32"), device="cpu")
    fold = jax_int8_fold(port.det_model)
    np.savez_compressed(INT8_FOLD, **{k: v for name, (g, b) in fold.items()
                                      for k, v in ((name, g),
                                                   (name + ".bias", b))})


def write_optin_fixture() -> None:
    """The opt-in files alone (--write does them with everything else)."""
    pages = np.load(PAGES)["pages"]
    lanes = dict(np.load(LANES))
    _write_json(OPTIN_EXPECTED, jax_optin_expected(pages, lanes))
    write_int8_fold()
    curl = render_curl_inputs()
    np.savez_compressed(CURL, **curl)
    _write_json(CURL_EXPECTED, jax_curl_expected(curl))


BENCH_TRAFFIC = os.path.join(TESTDATA, "bench_traffic.npz")
E2E_PAGES = os.path.join(TESTDATA, "e2e_pages.npz")
E2E_EXPECTED = os.path.join(TESTDATA, "expected_jax_e2e_fp32.json")
TRAIN_BATCHES = os.path.join(TESTDATA, "train_batches.npz")
TRAIN_EXPECTED = os.path.join(TESTDATA, "expected_jax_train_fp32.json")
# the card's bars for the float32 training steps (chip_smoke.py phase 15),
# relative: losses; per parameter leaf, the norm of the 3 steps' update
# (Adam divides each gradient by its own root mean square, so a leaf whose
# gradient cancels, as the stem BatchNorm's where the fast variance
# mean(x^2) - mean(x)^2 cancels on white pages, moves by rounding: 1.2%
# between torch and XLA on the CPU); the norms of the new BatchNorm
# statistics (1.9e-4 there on the CPU); bf16 losses against fp32's
TRAIN_BARS = {"loss_rtol": 1e-3, "update_rtol": 5e-2, "bn_rtol": 1e-3,
              "bf16_loss_rtol": 0.05}
# a bias that a train-mode BatchNorm follows: its exact gradient is 0, so
# Adam steps it on rounding noise in both packages (not compared)
TRAIN_NOISE_LEAVES = ("params/DBHead_0/ConvTranspose_0/bias",
                      "params/DBHead_1/ConvTranspose_0/bias")
TRAIN_STEPS = {"rec": (1e-3, 1500), "det": (3e-4, 1200), "cls": (1e-3, 1500)}
CLS_WIDTHS = (64, 128, 192, 320)


def _charset():
    from ocrjax.charset import Charset
    return Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))


def _texts(lists) -> dict:
    flat = [t for ts in lists for t in ts]
    return {"texts": np.asarray("\n".join(flat)),
            "line_counts": np.asarray([len(ts) for ts in lists], np.int32)}


# bench_main's page count (ocrjax's bench.py); run_bench's default 16 pages
# are the first 16
BENCH_PAGES = 96


def render_bench_traffic() -> dict:
    """run_bench's traffic from ocrjax.train.synth, in run_bench's order,
    as ocrjax_torch.bench_lib.render_traffic lays it out."""
    from ocrjax.train import synth
    charset, cfg = _charset(), asset_config()
    n, W = cfg.line_bucket_for_count(256), 320
    rng = np.random.RandomState(0)
    strips = np.zeros((n, cfg.rec_height, W), np.uint8)
    widths = np.full((n,), W, np.int32)
    strip_texts = []
    for i in range(n):
        t = synth.random_text(rng, charset, 4, 12)
        s = synth.render_line(t, cfg.rec_height)
        w = min(s.shape[1], W)
        strips[i, :, :w] = s[:, :w]
        widths[i] = w
        strip_texts.append(t)
    pages = [synth.render_page(rng, charset, size=(cfg.det_max_side,) * 2)
             for _ in range(BENCH_PAGES)]
    dense = [synth.render_page_dense(np.random.RandomState(1000 + s),
                                     charset, size=(3072, 2048),
                                     n_lines=200) for s in range(3)]
    pt, dt = _texts([p[2] for p in pages]), _texts([d[2] for d in dense])
    return {"strips": strips, "strip_widths": widths,
            "strip_texts": np.asarray("\n".join(strip_texts)),
            "pages": np.stack([p[0] for p in pages]),
            "page_quads": np.concatenate([np.stack(p[1]) for p in pages]),
            "page_texts": pt["texts"], "page_line_counts": pt["line_counts"],
            "dense": np.stack([d[0] for d in dense]),
            "dense_texts": dt["texts"],
            "dense_line_counts": dt["line_counts"]}


def render_e2e_pages() -> dict:
    """evaluate_e2e's pages: RandomState(123), 8 pages of 640 px."""
    from ocrjax.train import synth
    charset, rng = _charset(), np.random.RandomState(123)
    pages = [synth.render_page(rng, charset, size=(640, 640))
             for _ in range(8)]
    return {"pages": np.stack([p[0] for p in pages]),
            **_texts([p[2] for p in pages])}


def jax_e2e_expected() -> dict:
    from ocrjax.api import OcrEngine
    from ocrjax.train.e2e_eval import evaluate_e2e
    eng = OcrEngine.from_pretrained(config=asset_config(
        compute_dtype="float32"))
    return {"seed": 123, "n_pages": 8, "size": 640,
            "compute_dtype": "float32", **evaluate_e2e(eng)}


def render_train_batches() -> dict:
    """3 batches of each trainer, as its loop draws them from
    RandomState(0) at its defaults: rec make_line_batch(64, 192,
    max_len=10); det pages of make_det_batch(8, 320) with their quads (the
    card builds db_gt_maps from them); cls make_line_batch at widths 64,
    128, 192 with train_cls's knobs, snap_rows_to_ink and flip_half."""
    from ocrjax.train import cls_trainer, synth
    charset = _charset()
    out = {}
    rng = np.random.RandomState(0)
    for i in range(3):
        lb = synth.make_line_batch(rng, charset, 64, 192, 32, max_len=10)
        for k in ("images", "widths", "labels", "label_lengths"):
            out[f"rec{i}_{k}"] = getattr(lb, k)
    rng = np.random.RandomState(0)
    for i in range(3):
        pages = [synth.render_page(rng, charset, size=(320, 320),
                                   n_lines=(3, 8)) for _ in range(8)]
        out[f"det{i}_pages"] = np.stack([p[0] for p in pages])
        out[f"det{i}_quads"] = np.concatenate([np.stack(p[1])
                                               for p in pages])
        out[f"det{i}_line_counts"] = np.asarray([len(p[1]) for p in pages],
                                                np.int32)
    rng = np.random.RandomState(0)
    for i in range(3):
        w = CLS_WIDTHS[i % len(CLS_WIDTHS)]
        lb = synth.make_line_batch(
            rng, charset, 64, w, height=32, p_space=0.2, p_word=0.5,
            noise=0.02, quantize_p=0.3, max_rotation=3.0,
            max_len=max(4, w // 12))
        cls_trainer.snap_rows_to_ink(rng, lb)
        out[f"cls{i}_labels"] = cls_trainer.flip_half(rng, lb)
        out[f"cls{i}_images"], out[f"cls{i}_widths"] = lb.images, lb.widths
    return out


def det_batch_maps(batches: dict, i: int):
    """(images (8, 320, 320, 3), gt_shrink, gt_thresh, thresh_mask) of det
    batch i, with ocrjax's db_gt_maps (make_det_batch's arrays)."""
    from ocrjax.train.det_gt import db_gt_maps
    pages = batches[f"det{i}_pages"]
    quads, counts = batches[f"det{i}_quads"], batches[f"det{i}_line_counts"]
    maps, k = [], 0
    for n in counts:
        maps.append(db_gt_maps(list(quads[k:k + n]), pages.shape[1:]))
        k += n
    return (np.repeat(pages[..., None], 3, axis=3),
            *(np.stack(m) for m in zip(*maps)))


def _leaf_norms(before: dict, after: dict) -> tuple:
    updates = {k: float(np.linalg.norm(after[k] - before[k]))
               for k in before if k.startswith("params/")}
    stats = {k: float(np.linalg.norm(after[k]))
             for k in before if k.startswith("batch_stats/")}
    return updates, stats


def jax_train_expected(batches: dict) -> dict:
    """3 steps of each ocrjax step function from the shipped assets at full
    width in float32, with each trainer's tx at its default lr and steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from ocrjax import weights as JW
    from ocrjax.models.cls import create_cls
    from ocrjax.models.crnn import create_crnn
    from ocrjax.models.db import create_db
    from ocrjax.train import cls_trainer, det_trainer, rec_trainer
    from ocrjax_torch.weights import flatten
    cfg, charset = asset_config(compute_dtype="float32"), _charset()

    def load(name):
        return JW.load_variables(os.path.join(ROOT, "assets",
                                              f"{name}.safetensors"))

    def flat(tree):
        return flatten(jax.tree.map(np.asarray, dict(tree)))

    def warm_tx(name):
        lr, steps = TRAIN_STEPS[name]
        return optax.chain(optax.clip_by_global_norm(5.0), optax.adam(
            optax.warmup_cosine_decay_schedule(
                0.0, lr, min(100, steps // 10 + 1), steps)))

    out = {"bars": TRAIN_BARS, "noise_leaves": list(TRAIN_NOISE_LEAVES),
           "compute_dtype": "float32",
           "steps": {k: {"lr": v[0], "steps": v[1]}
                     for k, v in TRAIN_STEPS.items()}}
    # rec
    v = load("rec")
    tx = warm_tx("rec")
    step = rec_trainer.make_train_step(
        create_crnn(cfg, charset.num_classes), tx)
    p, bs, st, losses = v["params"], v["batch_stats"], tx.init(
        v["params"]), []
    for i in range(3):
        p, bs, st, loss = step(p, bs, st, *(jnp.asarray(
            batches[f"rec{i}_{k}"]) for k in (
                "images", "widths", "labels", "label_lengths")))
        losses.append(float(loss))
    upd, stats = _leaf_norms(flat(v), flat({"params": p, "batch_stats": bs}))
    out["rec"] = {"losses": losses, "update_norms": upd, "bn_norms": stats}
    # det
    v = load("det")
    tx = warm_tx("det")
    step = det_trainer.make_det_train_step(create_db(cfg), tx, cfg)
    p, bs, st, losses = v["params"], v["batch_stats"], tx.init(
        v["params"]), []
    for i in range(3):
        p, bs, st, loss, _ = step(p, bs, st, *map(
            jnp.asarray, det_batch_maps(batches, i)))
        losses.append(float(loss))
    upd, stats = _leaf_norms(flat(v), flat({"params": p, "batch_stats": bs}))
    out["det"] = {"losses": losses, "update_norms": upd, "bn_norms": stats}
    # cls
    v = load("cls")
    lr, steps = TRAIN_STEPS["cls"]
    tx = optax.adam(optax.schedules.cosine_decay_schedule(lr, steps,
                                                          alpha=0.1))
    step = cls_trainer.make_cls_train_step(
        create_cls(cfg), tx, cfg.rec_mean, cfg.rec_std, antisym=0.5)
    p, st, losses = v["params"], tx.init(v["params"]), []
    for i in range(3):
        p, st, loss = step(p, st, *(jnp.asarray(batches[f"cls{i}_{k}"])
                                    for k in ("images", "widths", "labels")))
        losses.append(float(loss))
    upd, _ = _leaf_norms(flat(v), flat({"params": p}))
    out["cls"] = {"losses": losses, "update_norms": upd, "bn_norms": {}}
    return out


def write_bench_train_fixture() -> None:
    """The bench, e2e and training files alone (--write does them with
    everything else)."""
    np.savez_compressed(BENCH_TRAFFIC, **render_bench_traffic())
    np.savez_compressed(E2E_PAGES, **render_e2e_pages())
    _write_json(E2E_EXPECTED, jax_e2e_expected())
    batches = render_train_batches()
    np.savez_compressed(TRAIN_BATCHES, **batches)
    _write_json(TRAIN_EXPECTED, jax_train_expected(batches))


ASSETS_EXPECTED = os.path.join(TESTDATA, "expected_jax_assets_fp32.json")
CLS_INIT = os.path.join(TESTDATA, "cls_init_jax.npz")
DET_CROPS = os.path.join(TESTDATA, "det_crops_jax.npz")
# chip_smoke.py phase 18's bars: the mean loss of each 20-step window and
# each final eval number, always; bf16's windows against fp32's. Each
# recipe's per-step loss bar (where the card's renders equal ocrjax's) is
# set from the port's own CPU run of the same recipe: 3x its worst gap to
# ocrjax, within ASSET_LOSS_RTOL_LIMITS
ASSET_BARS = {"window": 20, "window_rtol": 0.05, "eval_atol": 0.03,
              "bf16_window_rtol": 0.05, "crops_paired": 0.9}
ASSET_LOSS_RTOL_LIMITS = (1e-3, 5e-2)
# the card's Pillow has no libraqm, so ocrjax's recipes run under Pillow's
# basic layout, the one the card's renderer takes
ASSET_LAYOUT = "basic"
ASSET_SCRIPTS = ("train_rec_assets", "train_det_assets", "train_cls_assets",
                 "soup_weights", "eval_multiseed")


@contextlib.contextmanager
def pil_layout(name: str):
    """Pillow's text layout forced to `name` ("basic" or "raqm") in both
    packages' renderers (each caches its fonts, so both caches empty)."""
    from PIL import ImageFont
    from ocrjax.train import synth as jsynth
    from ocrjax_torch.train import synth
    import chip_smoke
    engine = {"basic": ImageFont.Layout.BASIC,
              "raqm": ImageFont.Layout.RAQM}[name]
    orig = ImageFont.truetype

    def truetype(font=None, size=10, index=0, encoding="",
                 layout_engine=None):
        return orig(font, size, index, encoding, layout_engine=engine)
    for m in (jsynth, synth):
        m._font_cache.clear()
    try:
        with chip_smoke.patched(ImageFont, "truetype", truetype):
            yield
    finally:
        for m in (jsynth, synth):
            m._font_cache.clear()


@contextlib.contextmanager
def no_jax_disk_cache():
    """The reference scripts point jax's persistent compilation cache into
    the repository; XLA:CPU's loader can reject its own entries
    (conftest.py), so those two settings are dropped while they run."""
    import jax
    import chip_smoke
    orig = jax.config.update

    def update(name, value):
        if name not in ("jax_compilation_cache_dir",
                        "jax_persistent_cache_min_compile_time_secs"):
            orig(name, value)
    with chip_smoke.patched(jax.config, "update", update):
        yield


def jax_modules() -> dict:
    """ocrjax's modules as chip_smoke.run_script takes them."""
    from ocrjax import api, weights
    from ocrjax.train import (checkpoint, cls_trainer, det_crops, det_gt,
                              det_trainer, rec_trainer, synth)
    return {"api": api, "weights": weights, "checkpoint": checkpoint,
            "rec_trainer": rec_trainer, "det_trainer": det_trainer,
            "cls_trainer": cls_trainer, "synth": synth, "det_gt": det_gt,
            "det_crops": det_crops,
            "fp32_config": lambda: asset_config(compute_dtype="float32"),
            "to_numpy": np.asarray}


def reference_script(name: str):
    """The reference's scripts/<name>.py, loaded from its file."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_scripts() -> dict:
    """name -> main of the reference's asset scripts."""
    return {name: reference_script(name).main for name in ASSET_SCRIPTS}


def jax_e2e_pages(n_pages: int, seed: int, max_rotation: float = 0.0,
                  degrade_level: float = 0.0, supersample: int = 1,
                  projective: float = 0.0, curl: float = 0.0) -> tuple:
    """(the pages ocrjax's evaluate_e2e draws (640 px) in its order, their
    ground-truth texts)."""
    from ocrjax.train import synth
    charset, rng, pages, gts = _charset(), np.random.RandomState(seed), [], []
    for _ in range(n_pages):
        page, quads, texts = synth.render_page(
            rng, charset, size=(640, 640), max_rotation=max_rotation,
            supersample=supersample)
        if projective > 0 or curl > 0:
            page, quads = synth.warp_page_projective(
                page, quads, rng, severity=projective, curl=curl)
        if degrade_level > 0:
            page = synth.degrade_image(page, rng, level=degrade_level)
        pages.append(page)
        gts.append(list(texts))
    return pages, gts


def jax_traffic_pages16() -> np.ndarray:
    """The bench traffic's first 16 pages (render_bench_traffic's)."""
    from ocrjax.train import synth
    charset, cfg = _charset(), asset_config()
    rng = np.random.RandomState(0)
    for _ in range(cfg.line_bucket_for_count(256)):
        synth.random_text(rng, charset, 4, 12)     # the strips' texts
    return np.stack([synth.render_page(rng, charset,
                                       size=(cfg.det_max_side,) * 2)[0]
                     for _ in range(16)])


def jax_render_digests() -> dict:
    """chip_smoke.render_digests of ocrjax's renderers, by layout."""
    import chip_smoke
    from ocrjax.train import synth
    out = {}
    for layout in ("raqm", "basic"):
        with pil_layout(layout):
            out[layout] = chip_smoke.render_digests(
                synth, jax_e2e_pages, jax_traffic_pages16)
    return out


def jax_cls_init() -> dict:
    """train_cls's flax init at seed 0 (the script's first width, 64),
    flat."""
    import jax
    import jax.numpy as jnp
    from ocrjax.models.cls import create_cls
    from ocrjax_torch.weights import flatten
    cfg = asset_config(compute_dtype="float32")
    v = create_cls(cfg).init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.rec_height, 64, 1), jnp.float32),
        jnp.full((1,), 64, jnp.int32))
    return flatten(jax.tree.map(np.asarray, dict(v)))


def _renderer() -> dict:
    import cv2
    from PIL import __version__, features
    return {"pillow": __version__, "freetype": features.version("freetype2"),
            "raqm": features.version("raqm"), "layout": ASSET_LAYOUT,
            "opencv": cv2.__version__}


def save_crops(path: str, sets: dict) -> None:
    """Crop sets (crop_key -> DetCropSet) as chip_smoke.load_crops reads
    them."""
    arrays = {}
    for key, c in sets.items():
        arrays[f"{key}__images"] = np.asarray(c.images)
        arrays[f"{key}__widths"] = np.asarray(c.widths)
        arrays[f"{key}__texts"] = np.asarray("\n".join(c.texts))
    np.savez_compressed(path, **arrays)


def jax_assets_expected(work: str, cls_init: dict, log=print) -> dict:
    """Phase 18's reference: ocrjax's scripts on the cut recipes (float32,
    CPU, the basic layout), the render digests under both layouts, and the
    port's own CPU run of the same recipes, which sets bar (ii). Writes
    ocrjax's det crop sets to DET_CROPS, which the port's runs train on."""
    import time
    import chip_smoke as CS
    out = {"renderer": _renderer(), "cuts": CS.ASSET_CUTS,
           "resume_at": CS.ASSET_RESUME_AT, "soup_alpha": CS.SOUP_ALPHA,
           "argv": {"rec": CS.cut_argv(CS.REC_RECIPE, "rec"),
                    "det": CS.cut_argv(CS.DET_RECIPE, "det"),
                    "cls": CS.cut_argv([], "cls"),
                    "eval": ["--degrade", *CS.cut_argv([], "eval")]}}
    t0 = time.time()
    out["digests"] = jax_render_digests()
    log(f"digests ({time.time() - t0:.0f} s)")
    t0 = time.time()
    with pil_layout(ASSET_LAYOUT), no_jax_disk_cache():
        out["jax"] = CS.run_asset_recipes(jax_modules(), jax_scripts(),
                                          os.path.join(work, "jax"))
    out["jax_cpu_s"] = time.time() - t0
    save_crops(DET_CROPS, out["jax"].pop("crop_sets"))
    log(f"ocrjax's recipes ({out['jax_cpu_s']:.0f} s)")
    t0 = time.time()
    with pil_layout(ASSET_LAYOUT):
        port = CS.run_asset_recipes(CS.port_modules(), CS.port_scripts(),
                                    os.path.join(work, "port"),
                                    extra=("--cpu",), cls_init=cls_init,
                                    crops=CS.load_crops())
    out["port_cpu_s"] = time.time() - t0
    log(f"the port's recipes ({out['port_cpu_s']:.0f} s)")
    gaps = {}
    for kind in ("rec", "det", "cls"):
        got, want = port[kind], out["jax"][kind]
        if got["render_digests"] != want["render_digests"]:
            raise AssertionError(f"{kind}: the port's renders differ from "
                                 "ocrjax's on the CPU")
        gaps[kind] = max(abs(a - b) / abs(b) for (_, a), (_, b) in
                         zip(got["losses"], want["losses"]))
    lo, hi = ASSET_LOSS_RTOL_LIMITS
    out["port_cpu"] = {
        "loss_gap": gaps,
        **{kind: {"losses": port[kind]["losses"],
                  "result": port[kind]["result"],
                  "crops": port[kind]["crops"]}
           for kind in ("rec", "det", "cls")},
        "eval_shipped": port["eval_shipped"], "eval_soup": port["eval_soup"]}
    out["bars"] = dict(ASSET_BARS, loss_rtol={
        kind: min(max(3 * g, lo), hi) for kind, g in gaps.items()})
    return out


def write_assets_fixture() -> None:
    """expected_jax_assets_fp32.json and cls_init_jax.npz."""
    import tempfile
    cls_init = jax_cls_init()
    np.savez_compressed(CLS_INIT, **cls_init)
    with tempfile.TemporaryDirectory(prefix="ocrjax_assets_") as work:
        _write_json(ASSETS_EXPECTED, jax_assets_expected(
            work, cls_init, log=lambda m: print(m, flush=True)))


def _write_json(path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


def write_fixture() -> None:
    pages = render_pages()
    os.makedirs(TESTDATA, exist_ok=True)
    np.savez_compressed(PAGES, pages=pages, seeds=np.asarray(SEEDS))
    with open(EXPECTED, "w") as f:
        json.dump(jax_expected(pages), f, indent=1)
        f.write("\n")
    lanes = render_lane_inputs()
    np.savez_compressed(LANES, **lanes)
    with open(LANES_EXPECTED, "w") as f:
        json.dump(jax_lane_expected(lanes, pages), f, indent=1)
        f.write("\n")
    _write_json(BEAM_EXPECTED, jax_beam_expected(pages, lanes))
    _write_json(LOGS_EXPECTED, jax_lane_logs(lanes, pages))
    flip = render_flip_pages()
    np.savez_compressed(FLIP, **flip)
    _write_json(FLIP_EXPECTED, jax_flip_expected(flip))
    c5 = render_c5_pages()
    np.savez_compressed(C5, **c5)
    _write_json(C5_EXPECTED, jax_c5_expected(c5))
    write_optin_fixture()
    write_bench_train_fixture()


# ---------------------------------------------------------------------------
# the reference's hardware gates (chip_smoke.py phase 19) and its
# evaluation and bench scripts (phase 20), at the CPU tests' cuts
# ---------------------------------------------------------------------------

GATES_EXPECTED = os.path.join(TESTDATA, "expected_jax_gates_fp32.json")
SCRIPTS_EXPECTED = os.path.join(TESTDATA, "expected_jax_scripts_fp32.json")
# each gate's cut on the CPU: keywords of chip_smoke's gate function (the
# card runs the reference's sizes): one page or one seed, the dense page
# 1536x1024 with 80 lines, the tiled batch 2 pages
GATE_CUTS = {"e2e": {"n_pages": 1}, "rotated": {"n_pages": 1},
             "try_flip": {"n_pages": 1}, "inverted": {"n_pages": 1},
             "degraded": {"n_pages": 1},
             "dense_c5": {"size": [1536, 1024], "n_lines": 80},
             "tiled_batch": {"n_pages": 2}, "tiled_e2e": {"seeds": [42]},
             "short_strips": {"n_pages": 1}, "projective": {"n_pages": 1}}
# the gates' fields that are times
GATE_TIMINGS = {"tiled_batch": ("serial_s", "batch_s", "batch_over_serial")}
# each script's tiny cut on the CPU: its flags (calibrate_unclip's 3 pages
# are the fewest on which the four ratios read differently), the config
# both packages' from_pretrained build (float32, and for bench_int8_det a
# 128-pixel canvas), and evaluate_e2e's pages for eval_beam (its accuracy
# loop draws 4 a call)
SCRIPT_CUTS = {
    "eval_quality_breakdown": {"argv": ["--pages-per-font", "2"]},
    "eval_xheight": {"argv": ["--pages", "1"]},
    "eval_beam": {"argv": ["--seeds", "1", "--repeats", "1"],
                  "e2e_pages": 1},
    "bench_int8_det": {"argv": [], "config": {"det_max_side": 128}},
    "bench_try_flip": {"argv": ["--pages", "2", "--repeats", "1"]},
    "eval_tiled_quality": {"argv": ["--seeds", "1"]},
    "probe_dense": {"argv": ["--pages", "1", "--lines", "40", "--height",
                             "1024", "--width", "1024"]},
    "calibrate_unclip": {"argv": ["--pages", "3"]},
}


def gate_digests(synth, charset, e2e_pages) -> dict:
    """chip_smoke.digest of the pages each page gate draws at GATE_CUTS,
    from `synth` and `charset` (either package's) and `e2e_pages`
    (evaluate_e2e's drawing: (n_pages, seed, **kw) -> (pages, texts))."""
    import chip_smoke as CS
    c = GATE_CUTS
    d = {}
    for name, seed, kw in (("e2e", 123, {}), ("degraded", 321,
                                              {"degrade_level": 0.5}),
                           ("projective", 555, {"projective": 0.3,
                                                "curl": 0.3})):
        d[name] = CS.digest(np.stack(e2e_pages(c[name]["n_pages"], seed,
                                               **kw)[0]))
    for name, seed, kw in (("rotated", 9, {"max_rotation": 10}),
                           ("try_flip", 11, {}), ("inverted", 17, {}),
                           ("tiled_batch", 21, {"size": (2048, 2048),
                                                "n_lines": (10, 14),
                                                "max_len": 12})):
        d[name] = CS.digest(np.stack([p for p, _, _ in CS.draw_pages(
            synth, charset, seed, c[name]["n_pages"], **kw)]))
    d["tiled_e2e"] = CS.digest(np.stack([CS.draw_pages(
        synth, charset, s, 1, size=(2048, 2048), n_lines=(12, 16),
        max_len=12)[0][0] for s in c["tiled_e2e"]["seeds"]]))
    d["dense_c5"] = CS.digest(CS.draw_dense(synth, charset,
                                            **c["dense_c5"])[0])
    d["short_strips"] = CS.digest(np.stack([
        p for pages in CS.draw_short_strips(
            synth, charset, **c["short_strips"]).values()
        for p, _, _ in pages]))
    return d


def _jax_engine(**overrides):
    from ocrjax.api import OcrEngine as JaxEngine
    return JaxEngine.from_pretrained(
        config=asset_config(compute_dtype="float32", **overrides))


def jax_gates_expected() -> dict:
    """ocrjax's float32 measurement of every gate of tests/test_tpu.py at
    GATE_CUTS on the CPU: each test's body with its asserts turned into
    the numbers they test (the Pallas kernels in interpret mode)."""
    import jax.numpy as jnp
    import chip_smoke as CS
    from scripts.eval_quality_breakdown import _align_subs
    from scripts.eval_xheight import case_flip
    from ocrjax.ops.pallas.cc_label import label_components_pallas
    from ocrjax.ops.pallas.conv_fused import (conv3x3_bn_relu,
                                              conv_bn_relu_xla)
    from ocrjax.postprocess.db_boxes import extract_boxes, label_components
    from ocrjax.train import synth
    from ocrjax.train.e2e_eval import _levenshtein, evaluate_e2e
    from ocrjax_torch.scripts.probe_dense import match
    c, out = GATE_CUTS, {}
    eng = _jax_engine()
    charset = eng.charset

    rng = np.random.RandomState(0)
    B, H, W, Cin, Cout = 2, 32, 64, 128, 128
    x = jnp.asarray(rng.randn(B, H, W, Cin).astype(np.float32))
    w = jnp.asarray(rng.randn(3, 3, Cin, Cout).astype(np.float32) * 0.05)
    scale = jnp.asarray(rng.rand(Cout).astype(np.float32) + 0.5)
    bias = jnp.asarray(rng.randn(Cout).astype(np.float32) * 0.1)
    got = np.asarray(conv3x3_bn_relu(x, w, scale, bias, interpret=True,
                                     force_pallas=True))
    want = np.asarray(conv_bn_relu_xla(
        x.astype(jnp.bfloat16), w, scale, bias)).astype(np.float32)
    d = np.abs(got - want)
    out["conv"] = {"max_abs_err": float(d.max()), "worst_over_tolerance":
                   float((d - (0.25 + 0.1 * np.abs(want))).max())}

    out["recognize"] = {"text": eng.recognize(
        synth.render_line("TPU 123", height=32)).text}

    prob = np.zeros((256, 256), np.float32)
    prob[30:50, 20:200] = 0.9
    out["extract_boxes"] = {"valid": int(np.asarray(extract_boxes(
        jnp.asarray(prob), max_candidates=16)["valid"]).sum())}

    bm = np.zeros((256, 256), bool)
    bm[10:30, 10:100] = True
    bm[50:60, 5:250] = True
    bm[100:140, 100:140] = True
    got = np.asarray(label_components_pallas(jnp.asarray(bm), n_iters=4,
                                             interpret=True))
    want = np.asarray(label_components(jnp.asarray(bm), n_iters=4))
    out["ccl"] = {"labels_differing": int((got != want).sum()),
                  "components": int(np.unique(want[want < 2 ** 30]).size)}

    for name, seed, kw in (("e2e", 123, {}), ("degraded", 321,
                                              {"degrade_level": 0.5}),
                           ("projective", 555, {"projective": 0.3,
                                                "curl": 0.3})):
        out[name] = dict(evaluate_e2e(eng, n_pages=c[name]["n_pages"],
                                      seed=seed, **kw))

    rng = np.random.RandomState(9)
    tot = found = exact = 0
    for _ in range(c["rotated"]["n_pages"]):
        page, quads, texts = synth.render_page(rng, charset, max_rotation=10)
        res = eng.ocr(np.repeat(page[..., None], 3, axis=2))
        tot += len(texts)
        f, e = match(quads, texts, res.lines)
        found, exact = found + f, exact + e
    out["rotated"] = {"lines": tot, "found": found / tot,
                      "exact": exact / tot}

    flip = _jax_engine()
    flip.config = flip.config.replace(rec_try_flip=True)
    rng = np.random.RandomState(11)
    tot = up = dn = 0
    for _ in range(c["try_flip"]["n_pages"]):
        page, quads, texts = synth.render_page(rng, charset)
        img = np.repeat(page[..., None], 3, axis=2)
        up += CS.multiset_hits(texts, [l.text for l in flip.ocr(img).lines])
        dn += CS.multiset_hits(texts, [l.text for l in
                                       flip.ocr(img[::-1, ::-1]).lines])
        tot += len(texts)
    out["try_flip"] = {"lines": tot, "upright": up / tot,
                       "upside_down": dn / tot}

    rng = np.random.RandomState(17)
    tot = exact = 0
    for _ in range(c["inverted"]["n_pages"]):
        page, quads, texts = synth.render_page(rng, charset)
        res = eng.ocr(np.repeat((255 - page)[..., None], 3, axis=2))
        tot += len(texts)
        exact += CS.multiset_hits(texts, [l.text for l in res.lines])
    out["inverted"] = {"lines": tot, "exact": exact / tot}

    rng = np.random.RandomState(5)
    page, quads, texts = synth.render_page_dense(
        rng, charset, size=tuple(c["dense_c5"]["size"]),
        n_lines=c["dense_c5"]["n_lines"])
    res = eng.ocr_tiled(np.repeat(page[..., None], 3, axis=2))
    found, exact = match(quads, texts, res.lines)
    out["dense_c5"] = {"rendered": len(texts),
                       "truncated": bool(res.truncated),
                       "found": found / len(texts),
                       "exact": exact / len(texts)}

    rng = np.random.RandomState(21)
    imgs = []
    for _ in range(c["tiled_batch"]["n_pages"]):
        page, _, texts = synth.render_page(
            rng, charset, size=(2048, 2048), n_lines=(10, 14), max_len=12)
        imgs.append(np.repeat(page[..., None], 3, axis=2))
    eng.ocr_tiled(imgs[0])
    eng.ocr_tiled_batch(imgs)
    serial = [eng.ocr_tiled(im) for im in imgs]
    batch = eng.ocr_tiled_batch(imgs)
    out["tiled_batch"] = {
        "same_strings": all([l.text for l in rs.lines] ==
                            [l.text for l in rb.lines]
                            for rs, rb in zip(serial, batch)),
        "lines": [len(r.lines) for r in batch],
        "strings": [[l.text for l in r.lines] for r in batch]}

    per_seed, lines, truth = [], [], []
    for seed in c["tiled_e2e"]["seeds"]:
        rng = np.random.RandomState(seed)
        page, quads, texts = synth.render_page(
            rng, charset, size=(2048, 2048), n_lines=(12, 16), max_len=12)
        preds = [l.text for l in eng.ocr_tiled(
            np.repeat(page[..., None], 3, axis=2)).lines]
        per_seed.append(CS.multiset_hits(texts, preds) / len(texts))
        lines.append(len(preds))
        truth.append(len(texts))
    out["tiled_e2e"] = {"per_seed_exact": per_seed,
                        "mean_exact": float(np.mean(per_seed)),
                        "lines": lines, "truth": truth}

    stats, case_misses = {}, 0
    for L in (1, 2):
        rng = np.random.RandomState(42 + L)
        total = exact = 0
        for _ in range(c["short_strips"]["n_pages"]):
            page, _, texts = synth.render_page(
                rng, charset, size=(640, 640), n_lines=(5, 8), max_len=L,
                min_len=L)
            preds = [ln.text for ln in eng.ocr(
                np.repeat(page[..., None], 3, axis=2)).lines]
            total += len(texts)
            for t in texts:
                if t in preds:
                    preds.remove(t)
                    exact += 1
                elif preds:
                    d = [_levenshtein(t, p) for p in preds]
                    p = preds.pop(int(np.argmin(d)))
                    case_misses += any(
                        "∅" not in s and case_flip(*s)
                        for s in _align_subs(t, p))
        stats[L] = (exact, total)
    out["short_strips"] = {
        "rec_flat_band_frac": eng.config.rec_flat_band_frac,
        "len1": stats[1][0] / stats[1][1], "len2": stats[2][0] / stats[2][1],
        "counts": {str(L): list(v) for L, v in stats.items()},
        "case_misses": int(case_misses)}

    return {"cuts": GATE_CUTS, "numbers": out,
            "digests": gate_digests(synth, charset, jax_e2e_pages)}


@contextlib.contextmanager
def fp32_engines(engine_cls, config_fn, **overrides):
    """engine_cls.from_pretrained builds its engine from config_fn(
    compute_dtype="float32", **overrides) where its caller gives no
    config (the scripts call it bare)."""
    import chip_smoke
    orig = engine_cls.from_pretrained.__func__

    def from_pretrained(cls, path=None, config=None, **kw):
        return orig(cls, path, config or config_fn(
            compute_dtype="float32", **overrides), **kw)
    with chip_smoke.patched(engine_cls, "from_pretrained",
                            classmethod(from_pretrained)):
        yield


@contextlib.contextmanager
def e2e_pages_cut(module, n_pages):
    """module.evaluate_e2e drawing n_pages a call (None: as called)."""
    import chip_smoke
    orig = module.evaluate_e2e

    def evaluate_e2e(engine, **kw):
        if n_pages is not None:
            kw["n_pages"] = n_pages
        return orig(engine, **kw)
    with chip_smoke.patched(module, "evaluate_e2e", evaluate_e2e):
        yield


def jax_script_output(name: str) -> str:
    """What ocrjax's scripts/<name>.py prints at SCRIPT_CUTS[name] on the
    CPU in float32."""
    import io
    import chip_smoke
    from ocrjax.api import OcrEngine as JaxEngine
    from ocrjax.train import e2e_eval
    cut = SCRIPT_CUTS[name]
    sys.path.insert(0, ROOT)
    main = reference_script(name).main
    argv = [f"scripts/{name}.py", *cut["argv"]]
    if name != "bench_int8_det":
        argv.append("--cpu")
    buf = io.StringIO()
    with fp32_engines(JaxEngine, asset_config, **cut.get("config", {})), \
            e2e_pages_cut(e2e_eval, cut.get("e2e_pages")), \
            no_jax_disk_cache(), \
            chip_smoke.patched(sys, "argv", argv), \
            contextlib.redirect_stdout(buf):
        main()
    return buf.getvalue()


def jax_scripts_expected(log=print) -> dict:
    import chip_smoke as CS
    out = {}
    for name in CS.SCRIPTS:
        text = jax_script_output(name)
        log(text)
        out[name] = {"cut": SCRIPT_CUTS[name], "text": text,
                     "parsed": CS.parse_script_output(name, text)}
    return out


# ---------------------------------------------------------------------------
# the reference's diagnostic scripts (tests/test_torch_diag_scripts.py)
# ---------------------------------------------------------------------------

DIAG_EXPECTED = os.path.join(TESTDATA, "expected_jax_diag_fp32.json")
# each diagnostic script's tiny cut on the CPU, the same for both packages:
# its flags, and the size it fixes where it fixes one (diag_dense_stages'
# page, diag_tile_det's tile side T)
DIAG_CUTS = {
    "diag_dense": {"argv": ["--size", "1024x1024", "--n-lines", "40"]},
    "diag_dense_stages": {"argv": ["--pages", "1", "--n-lines", "40",
                                   "--repeats", "1"],
                          "page_size": [1024, 1024]},
    "diag_tile_det": {"argv": ["--tiles", "1"], "tile": 256},
    "diag_rec_fetch": {"argv": ["--pages", "2", "--repeats", "1"]},
    "diag_reroute": {"argv": ["--pages", "4"]},
}


def reference_diag(name: str):
    """The reference's scripts/<name>.py cut to DIAG_CUTS[name]: diag_tile_det
    fixes its tile side in a local (T = 2048), which is cut in its source."""
    if "tile" not in DIAG_CUTS[name]:
        return reference_script(name)
    import importlib.util
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    src = open(path).read()
    assert src.count("    T = 2048\n") == 1
    src = src.replace("    T = 2048\n", f"    T = {DIAG_CUTS[name]['tile']}\n")
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_loader(f"reference_{name}", loader=None))
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


@contextlib.contextmanager
def float32_configs(config_module):
    """config_module.OcrConfig building float32 configs (diag_tile_det
    builds its configs bare, without an engine)."""
    import functools
    import chip_smoke
    with chip_smoke.patched(config_module, "OcrConfig", functools.partial(
            config_module.OcrConfig, compute_dtype="float32")):
        yield


def jax_diag_output(name: str) -> tuple:
    """(what ocrjax's scripts/<name>.py prints at DIAG_CUTS[name] on the CPU
    in float32, the arrays it saves with np.savez)."""
    import io
    import chip_smoke
    from ocrjax import config as jconfig
    from ocrjax.api import OcrEngine as JaxEngine
    from ocrjax.train import synth as jsynth
    cut = DIAG_CUTS[name]
    sys.path.insert(0, ROOT)
    main = reference_diag(name).main
    # diag_reroute has no --cpu: it sets JAX_PLATFORMS=cpu itself
    argv = [f"scripts/{name}.py", *cut["argv"]] + \
        ([] if name == "diag_reroute" else ["--cpu"])
    render_dense = jsynth.render_page_dense

    def dense(rng, charset, size=None, **kw):
        return render_dense(rng, charset, size=tuple(cut["page_size"]), **kw)
    saved = {}
    buf = io.StringIO()
    with contextlib.ExitStack() as st:
        st.enter_context(fp32_engines(JaxEngine, asset_config))
        if "tile" in cut:
            st.enter_context(float32_configs(jconfig))
        if "page_size" in cut:
            st.enter_context(chip_smoke.patched(jsynth, "render_page_dense",
                                                dense))
        st.enter_context(no_jax_disk_cache())
        st.enter_context(chip_smoke.patched(sys, "argv", argv))
        st.enter_context(chip_smoke.patched(
            np, "savez", lambda path, **arrays: saved.update(arrays)))
        st.enter_context(contextlib.redirect_stdout(buf))
        main()
    return buf.getvalue(), saved


def jax_diag_expected(log=print) -> dict:
    import chip_smoke as CS
    out = {}
    for name in CS.DIAG_SCRIPTS:
        text, saved = jax_diag_output(name)
        log(text)
        out[name] = {"cut": DIAG_CUTS[name], "text": text,
                     "parsed": CS.parse_script_output(name, text)}
        if saved:
            out[name]["saved"] = {k: np.asarray(v).tolist()
                                  for k, v in saved.items()}
    return out


def write_diag_fixture() -> None:
    _write_json(DIAG_EXPECTED, jax_diag_expected(
        log=lambda m: print(m, flush=True)))


def write_gates_fixture() -> None:
    _write_json(GATES_EXPECTED, jax_gates_expected())


def write_scripts_fixture() -> None:
    _write_json(SCRIPTS_EXPECTED, jax_scripts_expected(
        log=lambda m: print(m, flush=True)))


def test_bench_traffic_is_current():
    """bench_traffic.npz is run_bench's traffic from ocrjax.train.synth at
    the reference's sizes, and bench_lib reads it."""
    from ocrjax_torch import bench_lib
    committed = bench_lib.load_traffic(BENCH_TRAFFIC)
    got = render_bench_traffic()
    assert sorted(committed) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    assert committed["strips"].shape == (256, 32, 320)
    assert committed["pages"].shape == (BENCH_PAGES, SIZE, SIZE)
    assert committed["dense"].shape == (3, 3072, 2048)
    dense = bench_lib.traffic_texts(committed, "dense")
    assert [len(t) for t in dense] == [200, 200, 200]
    assert len(bench_lib.traffic_texts(committed, "strip")) == 256
    assert sum(map(len, bench_lib.traffic_texts(committed, "page"))) == \
        len(committed["page_quads"])


def test_e2e_and_train_fixtures_are_current():
    """The e2e pages and the training batches re-render bit for bit; the
    expectations cover every parameter leaf of the shipped assets."""
    committed = np.load(E2E_PAGES)
    got = render_e2e_pages()
    for k, v in got.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    with open(E2E_EXPECTED) as f:
        e2e = json.load(f)
    assert (e2e["seed"], e2e["n_pages"], e2e["size"]) == (123, 8, 640)
    assert 0.5 < e2e["line_exact_match"] <= 1.0
    committed = np.load(TRAIN_BATCHES)
    got = render_train_batches()
    assert sorted(committed.files) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    with open(TRAIN_EXPECTED) as f:
        want = json.load(f)
    assert want["bars"] == TRAIN_BARS
    assert want["noise_leaves"] == list(TRAIN_NOISE_LEAVES)
    for name in ("rec", "det", "cls"):
        keys = _flat_keys(name)
        assert set(want[name]["update_norms"]) == {
            k for k in keys if k.startswith("params/")}, name
        assert set(want[name]["bn_norms"]) == {
            k for k in keys if k.startswith("batch_stats/")}, name
        assert len(want[name]["losses"]) == 3
        assert all(np.isfinite(want[name]["losses"]))


def _flat_keys(name: str) -> set:
    from ocrjax_torch.weights import read_safetensors
    return set(read_safetensors(os.path.join(
        ROOT, "assets", f"{name}.safetensors"))[0])


def test_fixture_pages_and_expected_outputs_are_current():
    committed = np.load(PAGES)
    pages = render_pages()
    np.testing.assert_array_equal(committed["pages"], pages)
    assert tuple(committed["seeds"]) == SEEDS
    with open(EXPECTED) as f:
        want = json.load(f)
    got = jax_expected(pages)
    assert got["seeds"] == want["seeds"]
    for g, w in zip(got["pages"], want["pages"]):
        assert g["strings"] == w["strings"]
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=FLOAT_TOL)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=FLOAT_TOL)


def test_lane_fixture_inputs_and_cheap_outputs_are_current():
    committed = np.load(LANES)
    lanes = render_lane_inputs()
    assert sorted(committed.files) == sorted(lanes)
    for k, v in lanes.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    with open(LANES_EXPECTED) as f:
        want = json.load(f)
    assert want["batch"] == list(LANE_BATCH)
    # every reroute of the fused lane is in the batch: 32 or more lines,
    # an oversize page, and answers for every page
    n_lines = [len(p["strings"]) for p in want["fused_batch"]]
    assert n_lines[LANE_BATCH.index("dense")] >= 32 and min(n_lines) > 0
    assert max(lanes["big"].shape) > SIZE
    from ocrjax.preprocess import color_fraction
    assert color_fraction(lanes["color"]) > 0.005      # the reroute's bar
    got = jax_cheap_expected(lanes)
    assert got["strips"]["strings"] == want["strips"]["strings"]
    np.testing.assert_allclose(got["strips"]["conf"], want["strips"]["conf"],
                               atol=FLOAT_TOL)
    # a homography entry is as large as a page coordinate: relative bar
    np.testing.assert_allclose(got["homographies"], want["homographies"],
                               rtol=1e-4, atol=FLOAT_TOL)
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got["detect_tilted"][key],
                                   want["detect_tilted"][key], atol=FLOAT_TOL)


def test_beam_fixture_is_current():
    with open(BEAM_EXPECTED) as f:
        want = json.load(f)
    assert want["batch"] == list(LANE_BATCH)
    assert len(want["fused"]) == len(SEEDS)
    assert min(len(p["strings"]) for p in want["fused"]) > 0
    got = jax_beam_strips(dict(np.load(LANES)))
    assert got["strings"] == want["strips"]["strings"]
    np.testing.assert_allclose(got["conf"], want["strips"]["conf"],
                               atol=FLOAT_TOL)


def test_flip_fixture_inputs_are_current():
    committed = np.load(FLIP)
    flip = render_flip_pages()
    assert sorted(committed.files) == sorted(flip)
    for k, v in flip.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    with open(FLIP_EXPECTED) as f:
        want = json.load(f)
    assert want["pages"] == list(FLIP_PAGES) and want["rec_try_flip"]
    for key in ("ocr", "fused_batch", "bucketed_batch"):
        assert min(len(p["strings"]) for p in want[key]) >= 4


def test_c5_fixture_inputs_are_current():
    """The A4 pages re-render bit for bit; every tile of the plan labels a
    coarse grid past 65,535 pixels (the CCL kernel's general path); the
    prescreen drops the sparse page's lower tiles; the dense page holds
    150-250 lines."""
    committed = np.load(C5)
    c5 = render_c5_pages()
    assert sorted(committed.files) == sorted(c5)
    for k, v in c5.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    from ocrjax.config import OcrConfig
    from ocrjax.tiling import tile_plan
    cfg = OcrConfig()
    corners = tile_plan(*A4, cfg)
    grids = sorted({(th // cfg.det_cc_downsample, tw // cfg.det_cc_downsample)
                    for (_, _, th, tw) in corners})
    assert grids == [(448, 192), (448, 512), (512, 192), (512, 512)]
    assert min(h * w for h, w in grids) > 65535
    with open(C5_EXPECTED) as f:
        want = json.load(f)
    assert want["batch"] == list(C5_BATCH)
    assert (want["tile_size"], want["tile_overlap"],
            want["tile_max_candidates"]) == (2048, 128, 384)
    n = [len(p["strings"]) for p in want["ocr_tiled_batch"]]
    assert 150 <= n[0] <= 250 and n[0] == n[2] and 0 < n[1] < 20
    assert len(want["detect_tiled_dense"]["boxes"]) == n[0]
    exact = want["exact_moments"]
    assert [p["strings"] for p in exact["ocr_tiled_batch"]] == \
        [p["strings"] for p in want["ocr_tiled_batch"]]
    assert want["reference_moment_error_px"] == _box_gap(want, exact) > 0


def test_optin_fixture_is_current():
    """The opt-in expectations cover what they claim: each flag reads some
    page otherwise than the float separable lane does; the committed BN
    fold is ocrjax's fold of the shipped det asset."""
    with open(OPTIN_EXPECTED) as f:
        want = json.load(f)
    with open(EXPECTED) as f:
        plain = json.load(f)["pages"]
    with open(LANES_EXPECTED) as f:
        lanes = json.load(f)
    assert want["batch"] == list(LANE_BATCH)
    assert len(want["int8"]["fused"]) == len(want["grouped"]) == len(SEEDS)
    assert len(want["int8"]["bucketed_batch"]) == len(LANE_BATCH)
    # the int8 activation scale spans the batch: page 0 alone (ocr) and in
    # the 4-page chunk reads the same strings with other scores
    one, four = want["int8"]["ocr"], want["int8"]["fused"][0]
    assert one["strings"] == four["strings"] and one["scores"] != four["scores"]
    for got, ref in ((want["int8"]["fused"], plain),
                     (want["grouped"], plain),
                     (want["case_gate"]["fused_batch"],
                      lanes["fused_batch"])):
        assert min(len(p["strings"]) for p in got) > 0
        assert any(a["strings"] != b["strings"] for a, b in zip(got, ref))
    from ocrjax_torch.api import OcrEngine as PortEngine
    from ocrjax_torch.api import asset_config as port_config
    port = PortEngine.from_pretrained(config=port_config(
        compute_dtype="float32"), device="cpu")
    committed = np.load(INT8_FOLD)
    fold = jax_int8_fold(port.det_model)
    assert sorted(committed.files) == sorted(
        k for name in fold for k in (name, name + ".bias"))
    for name, (g, b) in fold.items():
        np.testing.assert_array_equal(committed[name], g, err_msg=name)
        np.testing.assert_array_equal(committed[name + ".bias"], b)


def test_curl_fixture_inputs_are_current():
    """The curl inputs re-render bit for bit; the dewarp bends at least a
    quarter of the staged strips (the curved masks re-run); with
    rec_try_flip the upside-down crop flips."""
    committed = np.load(CURL)
    curl = render_curl_inputs()
    assert sorted(committed.files) == sorted(curl)
    for k, v in curl.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    with open(CURL_EXPECTED) as f:
        want = json.load(f)
    masks = want["curved"]
    assert jax_curved_masks(curl, [p["boxes"] for p in
                                   want["plain"]["ocr"]]) == masks
    assert sum(map(sum, masks)) * 4 >= sum(map(len, masks))
    for key in ("plain", "try_flip"):
        for lane in ("ocr", "fused_batch", "bucketed_batch"):
            assert min(len(p["strings"]) for p in want[key][lane]) >= 6
    assert want["try_flip"]["strips"]["flipped"] == [
        rot for _, _, rot in CURL_STRIP_ROWS]



def test_assets_fixture_is_current():
    """expected_jax_assets_fp32.json (chip_smoke.py phase 18): its cuts,
    recipes and bars are chip_smoke's and follow from its own numbers;
    ocrjax's renderers and the port's still draw the digests it holds,
    under both layouts; cls_init_jax.npz is train_cls's flax init and
    det_crops_jax.npz holds every crop set the recipes make."""
    import chip_smoke as CS
    from ocrjax.train import synth as jsynth
    with open(ASSETS_EXPECTED) as f:
        want = json.load(f)
    assert want["cuts"] == json.loads(json.dumps(CS.ASSET_CUTS))
    assert (want["resume_at"], want["soup_alpha"]) == (CS.ASSET_RESUME_AT,
                                                       CS.SOUP_ALPHA)
    assert want["argv"] == {"rec": CS.cut_argv(CS.REC_RECIPE, "rec"),
                            "det": CS.cut_argv(CS.DET_RECIPE, "det"),
                            "cls": CS.cut_argv([], "cls"),
                            "eval": ["--degrade", *CS.cut_argv([], "eval")]}
    assert want["renderer"]["layout"] == ASSET_LAYOUT
    lo, hi = ASSET_LOSS_RTOL_LIMITS
    gaps = want["port_cpu"]["loss_gap"]
    assert want["bars"] == dict(ASSET_BARS, loss_rtol={
        k: min(max(3 * g, lo), hi) for k, g in gaps.items()})
    steps = {k: CS.ASSET_CUTS[k]["--steps"][1] for k in ("rec", "det", "cls")}
    for kind, n in steps.items():
        run = want["jax"][kind]
        assert [s for s, _ in run["losses"]] == list(range(1, n + 1))
        assert len(run["digests"]) == n and run["render_digests"]
        assert all(np.isfinite(v) for _, v in run["losses"])
        assert len(want["port_cpu"][kind]["losses"]) == n
    assert set(want["jax"]["rec"]["result"]) == {"exact_match"}
    assert set(want["jax"]["det"]["result"]) == {"recall", "precision"}
    assert set(want["jax"]["cls"]["result"]) == {"accuracy"}
    tiers = [t[0] for t in CS.EVAL_TIERS]
    for name in ("eval_shipped", "eval_soup"):
        assert list(want["jax"][name]) == tiers
    # on the CPU the port reads the shipped assets as ocrjax does
    assert want["port_cpu"]["eval_shipped"] == want["jax"]["eval_shipped"]
    # the digests: ocrjax's renderers and the port's, both layouts
    assert set(want["digests"]) == {"raqm", "basic"}
    assert jax_render_digests() == want["digests"]
    for layout, digests in want["digests"].items():
        with pil_layout(layout):
            assert CS.port_render_digests() == digests
    assert want["digests"]["raqm"]["fonts"] == CS.digest(np.frombuffer(
        b"".join(open(f, "rb").read() for f in jsynth.FONTS), np.uint8))
    init = dict(np.load(CLS_INIT))
    fresh = jax_cls_init()
    assert set(init) == set(fresh)
    for k in init:
        np.testing.assert_array_equal(init[k], fresh[k])
    keys = {k for kind in ("rec", "cls")
            for k in want["port_cpu"][kind]["crops"]}
    assert set(CS.load_crops()) == keys


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    written = []
    if "--write" in sys.argv:
        write_fixture()
        written = [PAGES, EXPECTED, LANES, LANES_EXPECTED, BEAM_EXPECTED,
                   LOGS_EXPECTED, FLIP, FLIP_EXPECTED, C5, C5_EXPECTED]
    elif "--write-optin" in sys.argv:
        write_optin_fixture()
    elif "--write-bench-train" in sys.argv:
        write_bench_train_fixture()
    elif "--write-assets" in sys.argv:
        write_assets_fixture()
        written = [CLS_INIT, DET_CROPS, ASSETS_EXPECTED]
    elif "--write-gates" in sys.argv:
        write_gates_fixture()
        written = [GATES_EXPECTED]
    elif "--write-scripts" in sys.argv:
        write_scripts_fixture()
        written = [SCRIPTS_EXPECTED]
    elif "--write-diag" in sys.argv:
        write_diag_fixture()
        written = [DIAG_EXPECTED]
    elif "--write-logs" in sys.argv:
        lanes = dict(np.load(LANES))
        _write_json(LOGS_EXPECTED, jax_lane_logs(
            lanes, np.load(PAGES)["pages"]))
        written = [LOGS_EXPECTED]
    bench_train = [BENCH_TRAFFIC, E2E_PAGES, E2E_EXPECTED, TRAIN_BATCHES,
                   TRAIN_EXPECTED]
    if "--write" in sys.argv or "--write-optin" in sys.argv:
        written += [OPTIN_EXPECTED, INT8_FOLD, CURL, CURL_EXPECTED]
    if "--write" in sys.argv or "--write-bench-train" in sys.argv:
        written += bench_train
    for path in written:
        print(f"wrote {path} ({os.path.getsize(path)} B)")
