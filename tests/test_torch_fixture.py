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


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if "--write" in sys.argv:
        write_fixture()
        for path in (PAGES, EXPECTED, LANES, LANES_EXPECTED, BEAM_EXPECTED,
                     FLIP, FLIP_EXPECTED, C5, C5_EXPECTED):
            print(f"wrote {path} ({os.path.getsize(path)} B)")
