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
    flip = render_flip_pages()
    np.savez_compressed(FLIP, **flip)
    _write_json(FLIP_EXPECTED, jax_flip_expected(flip))
    c5 = render_c5_pages()
    np.savez_compressed(C5, **c5)
    _write_json(C5_EXPECTED, jax_c5_expected(c5))
    write_optin_fixture()


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


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    written = []
    if "--write" in sys.argv:
        write_fixture()
        written = [PAGES, EXPECTED, LANES, LANES_EXPECTED, BEAM_EXPECTED,
                   FLIP, FLIP_EXPECTED, C5, C5_EXPECTED]
    elif "--write-optin" in sys.argv:
        write_optin_fixture()
    if written or "--write-optin" in sys.argv:
        for path in written + [OPTIN_EXPECTED, INT8_FOLD, CURL,
                               CURL_EXPECTED]:
            print(f"wrote {path} ({os.path.getsize(path)} B)")
