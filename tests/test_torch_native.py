"""The port's native host library (ocrjax_torch/csrc/ocr_native.cpp through
postprocess/native_boxes.py) on the CPU, held bit for bit against its numpy
twins in ocrjax_torch.preprocess and against ocrjax's native library.

Bars: identical labels, boxes and scores to ocrjax's native functions;
packed bytes and canvases (scale, valid size, chroma fraction) identical
to the numpy twins and to ocrjax's decode_canvas_native. The decode is
held at widths that take the SSSE3 luma path (16 pixels a step) and its
scalar tail.
"""

import ctypes
import dataclasses

import numpy as np
import pytest

from ocrjax import preprocess as jpre
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.postprocess import native_boxes as jnb
from ocrjax_torch import preprocess as P
from ocrjax_torch.config import OcrConfig
from ocrjax_torch.postprocess import native_boxes as NB

CFG = OcrConfig(det_max_side=256)


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    if not (NB.native_available() and jnb.native_available()):
        pytest.fail("the native libraries did not build: g++ is needed")


def test_library_builds_with_gpp_into_a_build_dir(tmp_path):
    path = NB.build_library(str(tmp_path))
    assert path.startswith(str(tmp_path)) and path.endswith(".so")
    assert "libocr_native-" in path
    # the same source and flags give the same name: no rebuild
    assert NB.build_library(str(tmp_path)) == path
    lib = NB.open_library(path)
    bm = np.array([[1, 0, 1], [0, 0, 1]], np.uint8)
    labels = np.empty((2, 3), np.int32)
    n = lib.occ_label(bm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      2, 3, labels.ctypes.data_as(
                          ctypes.POINTER(ctypes.c_int32)))
    assert n == 2 and labels.tolist() == [[0, -1, 1], [-1, -1, 1]]


def _maps():
    rng = np.random.RandomState(0)
    rect = np.zeros((128, 128), np.float32)
    rect[30:50, 20:80] = 0.9
    rect[70:94, 16:116] = 0.8
    rot = np.zeros((128, 128), np.float32)
    for i in range(60):
        for t in range(3):
            rot[20 + i, 30 + i + t] = 0.95
    scored = np.zeros((64, 64), np.float32)
    scored[10:20, 10:40] = 0.9
    scored[40:50, 10:40] = 0.45
    noisy = rng.rand(96, 80).astype(np.float32)
    blobs = np.zeros((100, 140), np.float32)
    for _ in range(12):
        y, x = rng.randint(0, 90), rng.randint(0, 120)
        blobs[y:y + rng.randint(3, 10), x:x + rng.randint(5, 20)] = \
            rng.uniform(0.5, 1.0)
    return {"rect": rect, "rotated": rot, "scored": scored, "noisy": noisy,
            "blobs": blobs, "empty": np.zeros((32, 32), np.float32)}


@pytest.mark.parametrize("name", list(_maps()))
def test_label_components_equal_ocrjax(name):
    for th in (0.3, 0.6):
        bm = _maps()[name] > th
        got, n = NB.label_components_native(bm)
        want, wn = jnb.label_components_native(bm)
        assert n == wn
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(_maps()))
@pytest.mark.parametrize("kw", [{}, {"box_thresh": 0.6},
                                {"min_box_size": 1, "unclip_ratio": 0.0},
                                {"max_candidates": 3, "box_thresh": 0.3}])
def test_extract_boxes_equal_ocrjax(name, kw):
    prob = _maps()[name]
    got = NB.extract_boxes_native(prob, **kw)
    want = jnb.extract_boxes_native(prob, **kw)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if name == "empty":
        assert got[0].shape == (0, 4, 2)
    if name == "scored" and kw.get("box_thresh") == 0.6:
        assert len(got[1]) == 1 and got[1][0] > 0.8


def test_extract_boxes_falls_back_to_host_boxes(monkeypatch):
    from ocrjax_torch.postprocess.host_boxes import extract_boxes_host
    prob = _maps()["rect"]
    monkeypatch.setattr(NB, "_load", lambda: None)
    got = NB.extract_boxes_native(prob)
    for a, b in zip(got, extract_boxes_host(prob)):
        np.testing.assert_array_equal(a, b)


def test_pack_nibbles_native_equals_numpy_on_stacked_pages():
    rng = np.random.RandomState(3)
    for shape in [(3, 64, 96), (2, 256, 250), (1, 960, 960), (24, 16)]:
        g = (rng.rand(*shape) * 255).astype(np.uint8)
        g.reshape(-1)[:256] = np.arange(256)          # every level
        before = P.native_calls["pack"]
        got = P.pack_nibbles(g)
        assert P.native_calls["pack"] == before + 1
        np.testing.assert_array_equal(got, P.pack_nibbles_numpy(g))
        np.testing.assert_array_equal(got, jpre.pack_nibbles(g))
    # H % 4 != 0 keeps the numpy route (the dither phase of a stack)
    g = (rng.rand(2, 30, 64) * 255).astype(np.uint8)
    before = P.native_calls["pack"]
    np.testing.assert_array_equal(P.pack_nibbles(g), jpre.pack_nibbles(g))
    assert P.native_calls["pack"] == before


def _pages():
    """Canvas-sized, larger (resized), inverted, grey 2-D and HW1, colour
    pages; widths that are and are not multiples of the SSSE3 step."""
    rng = np.random.RandomState(11)

    def doc(h, w, c=3, ink=30, paper=235):
        img = np.full((h, w, c) if c else (h, w), paper, np.uint8)
        for _ in range(8):
            y, x = rng.randint(0, h - 6), rng.randint(0, w - 20)
            img[y:y + rng.randint(2, 6), x:x + rng.randint(5, 20)] = ink
        img = img.astype(np.int16) + rng.randint(-12, 13, img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)
    colour = doc(240, 203)
    colour[40:120, 30:160] = [250, 220, 20]
    return {
        "canvas": doc(256, 256), "canvas_odd": doc(200, 251),
        "resized": doc(517, 333), "resized_wide": doc(300, 701),
        "inverted": np.asarray(255 - doc(256, 256), np.uint8),
        "inverted_resized": np.asarray(255 - doc(400, 259), np.uint8),
        "gray2d": doc(190, 257, c=0), "gray_hw1": doc(300, 270, c=1),
        "colour": colour, "tiny": doc(7, 21),
    }


@pytest.mark.parametrize("name", list(_pages()))
def test_decode_canvas_native_equals_twin_and_ocrjax(name):
    img = _pages()[name]
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    got = P.decode_canvas_native(img, CFG)
    twin = P.decode_canvas_luma_first(img, CFG)
    want = jpre.decode_canvas_native(img, jcfg)
    for other in (twin, want):
        np.testing.assert_array_equal(got[0], other[0])
        assert got[1] == other[1] and tuple(got[2]) == tuple(other[2])
        assert got[3] == other[3]
    if name.startswith("inverted"):
        assert got[0].mean() > 128
    # the decode's polarity agrees with is_inverted on document pages
    rgb = P.load_image(img, auto_invert=False)
    assert P.native_inverted(rgb) == P.is_inverted(rgb)


def test_native_inverted_takes_the_lower_median():
    """An even sample count whose two middle channel means straddle 128:
    the native decode (and its twin) inverts, np.median's average does
    not. Both packages' native decodes agree with the twin."""
    img = np.zeros((8, 4, 3), np.uint8)             # stride 4: 2x1 samples
    img[0, 0] = 127
    img[4, 0] = 130
    assert P.native_inverted(img) and not P.is_inverted(img)
    cfg = OcrConfig(det_max_side=8)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    got = P.decode_canvas_native(img, cfg)[0]
    np.testing.assert_array_equal(got, P.decode_canvas_luma_first(img, cfg)[0])
    np.testing.assert_array_equal(got, jpre.decode_canvas_native(img,
                                                                 jcfg)[0])


def test_pooled_chunk_decode_equals_serial_and_isolates_failures(
        monkeypatch):
    pages = list(_pages().values())
    bad = np.zeros((10, 10, 4), np.uint8)           # four channels
    images = pages[:4] + [bad] + pages[4:] + [np.zeros((5, 5), np.float32)]
    idxs = range(len(images))
    before = P.native_calls["decode"]
    pooled = P.decode_chunk_to_gray(images, idxs, CFG, color_frac=0.05)
    assert P.native_calls["decode"] - before == len(pages)
    serial = [P.decode_chunk_to_gray(images, [i], CFG, color_frac=0.05)
              for i in idxs]
    for k in range(4):
        np.testing.assert_array_equal(
            pooled[k], np.concatenate([s[k] for s in serial]))
    assert list(pooled[4]) == [s[4][0] for s in serial]
    assert pooled[3].tolist() == [True] * 4 + [False] + [True] * 6 + [False]
    assert pooled[4][-3]                               # the colour page
    # without the library the numpy twin gives the same chunk
    monkeypatch.setattr(NB, "_load", lambda: None)
    twin = P.decode_chunk_to_gray(images, idxs, CFG, color_frac=0.05)
    for k in range(4):
        np.testing.assert_array_equal(pooled[k], twin[k])
    assert pooled[4] == twin[4]


def test_chunk_decode_equals_ocrjax_on_a_chunk():
    pages = list(_pages().values())
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    got = P.decode_chunk_to_gray(pages, range(len(pages)), CFG,
                                 color_frac=0.05)
    want = jpre.decode_chunk_to_gray(pages, list(range(len(pages))), jcfg,
                                     color_frac=0.05)
    for k in range(4):
        np.testing.assert_array_equal(got[k], want[k])
    assert got[4] == want[4]


def test_build_failure_warns_once_and_keeps_the_numpy_route(monkeypatch):
    import logging
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)
    log = logging.getLogger("ocrjax_torch.native")
    h = Keep()
    log.addHandler(h)
    monkeypatch.setattr(NB, "_lib", None)
    monkeypatch.setattr(NB, "_build_failed", False)
    monkeypatch.setattr(NB, "SOURCE", "/nonexistent/ocr_native.cpp")
    try:
        g = (np.random.RandomState(0).rand(2, 16, 32) * 255).astype(np.uint8)
        np.testing.assert_array_equal(P.pack_nibbles(g),
                                      P.pack_nibbles_numpy(g))
        assert P.decode_canvas_native(_pages()["canvas"], CFG) is None
        assert not NB.native_available()
    finally:
        log.removeHandler(h)
    assert len(records) == 1
    r = records[0]
    assert r.levelname == "WARNING" and "numpy twins" in r.getMessage()
    assert "error" in r.fields
