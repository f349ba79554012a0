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

Regenerate (after an intended change to the renderer, weights or
pipeline) with:
    JAX_PLATFORMS=cpu python tests/test_torch_fixture.py --write
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "ocrjax_torch", "testdata")
PAGES = os.path.join(TESTDATA, "pages_960.npz")
EXPECTED = os.path.join(TESTDATA, "expected_jax_fp32_960.json")
SEEDS = (1101, 1102, 1103, 1104)
SIZE = 960
# XLA:CPU may round the last bit of a float differently on another host
# CPU; coordinates and scores are held to 1e-4, strings exactly.
FLOAT_TOL = 1e-4


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


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if "--write" in sys.argv:
        write_fixture()
        for path in (PAGES, EXPECTED, LANES, LANES_EXPECTED):
            print(f"wrote {path} ({os.path.getsize(path)} B)")
