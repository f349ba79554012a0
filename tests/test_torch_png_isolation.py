"""Per-page isolation of malformed PNG files, and the module-level API.

A batch of good pages written to PNG plus malformed PNG files (an IHDR
chunk of the wrong length with a valid CRC, a file cut inside its IDAT
chunk, a bad CRC, an IHDR whose dimensions the data does not fill) gives
the same per-page results in the port as in ocrjax on every batch lane:
ocr_batch fused and bucketed, the full-resolution lane and ocr_tiled_batch.
Each bad file reads as an empty page; the good pages keep their lines (the
goldens' bar: identical strings, boxes within 0.011 px, scores within
2e-3). Both engines on the shipped assets in float32 at det_max_side=512.

The port's decoder raises ImageDecodeError (an OSError) for each bad file;
ocrjax's cv2 cannot read any of them either.

Module level: ocrjax_torch exports get_default_engine, detect, recognize
and ocr on a default engine built lazily, as ocrjax does.
"""

import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from ocrjax import api_det as jax_api_det
from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax_torch import api as port_api
from ocrjax_torch import api_det, imageio
from ocrjax_torch.api import OcrEngine, asset_config
from test_torch_fixture import few_torch_threads, jax_fields  # noqa: F401
from test_torch_slice import _page

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAD = ("ihdr_length", "cut_idat", "bad_crc", "short_data")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _chunks(data: bytes):
    pos, out = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def malformed(good: bytes) -> dict:
    """Four malformed variants of a valid PNG file's bytes."""
    sig, chunks = good[:8], _chunks(good)
    assert chunks[0][0] == b"IHDR" and chunks[1][0] == b"IDAT"
    ihdr, rest = chunks[0][1], b"".join(_chunk(k, b) for k, b in chunks[1:])
    bad_crc = bytearray(good)
    bad_crc[8 + 12 + 13 + 8 + 5] ^= 0xFF          # a byte of the IDAT body
    W, H = struct.unpack(">II", ihdr[:8])
    return {
        # valid CRC, 15 bytes: the decoder used to raise struct.error
        "ihdr_length": sig + _chunk(b"IHDR", ihdr + b"\0\0") + rest,
        "cut_idat": good[:8 + 25 + 8 + len(chunks[1][1]) // 2],
        "bad_crc": bytes(bad_crc),
        "short_data": sig + _chunk(b"IHDR", struct.pack(">II", W, 4 * H)
                                   + ihdr[8:]) + rest,
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    paths = {}
    for name, seed in (("a", 7), ("b", 11)):
        p = str(d / f"{name}.png")
        cv2.imwrite(p, _page(seed))
        paths[name] = p
    with open(paths["a"], "rb") as f:
        good = f.read()
    for name, data in malformed(good).items():
        p = str(d / f"{name}.png")
        with open(p, "wb") as f:
            f.write(data)
        paths[name] = p
    return paths


@pytest.fixture(scope="module")
def batch(files):
    # good pages first, last and between the bad ones
    return [files[k] for k in ("a", "ihdr_length", "cut_idat", "b",
                               "bad_crc", "short_data", "a")]


@pytest.fixture(scope="module")
def engines():
    cfg = asset_config(det_max_side=512, compute_dtype="float32",
                       tile_size=512, tile_overlap=64,
                       tile_max_candidates=128)
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**jax_fields(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


@pytest.mark.parametrize("name", BAD)
def test_malformed_png_raises_image_decode_error(files, name):
    assert cv2.imread(files[name], cv2.IMREAD_COLOR) is None
    with pytest.raises(imageio.ImageDecodeError):
        imageio.read_image(files[name])


def _assert_same_pages(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert [line.text for line in g.lines] == \
            [line.text for line in w.lines], k
        if not w.lines:
            continue
        gq = np.stack([line.box.quad for line in g.lines])
        wq = np.stack([line.box.quad for line in w.lines])
        assert np.abs(gq - wq).max() <= 0.011
        gs = np.asarray([line.box.score for line in g.lines])
        ws = np.asarray([line.box.score for line in w.lines])
        assert np.abs(gs - ws).max() <= 2e-3


LANES = {
    "fused": (lambda e, b: e.ocr_batch(b, fused=True),
              lambda e, b: e.ocr_batch(b, fused=True)),
    "bucketed": (lambda e, b: e.ocr_batch(b, fused=False),
                 lambda e, b: e.ocr_batch(b, fused=False)),
    "fullres": (lambda e, b: api_det.ocr_fullres_batch(e, b),
                lambda e, b: jax_api_det.ocr_fullres_batch(e, b)),
    "tiled": (lambda e, b: e.ocr_tiled_batch(b),
              lambda e, b: e.ocr_tiled_batch(b)),
}


@pytest.mark.parametrize("lane", sorted(LANES))
def test_bad_files_are_isolated_as_in_ocrjax(engines, batch, lane):
    jax_engine, port = engines
    port_fn, jax_fn = LANES[lane]
    got, want = port_fn(port, batch), jax_fn(jax_engine, batch)
    _assert_same_pages(got, want)
    assert [bool(r.lines) for r in got] == [True, False, False, True,
                                            False, False, True]


def test_module_api_names_exist_and_import_builds_no_engine():
    code = ("import ocrjax_torch, sys; "
            "assert 'ocrjax_torch.api' not in sys.modules; "
            "names = [n for n in ('get_default_engine', 'detect', "
            "'recognize', 'ocr', 'OcrEngine') "
            "if callable(getattr(ocrjax_torch, n))]; "
            "from ocrjax_torch import api; "
            "assert api._default_engine is None; print(len(names))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "5"


def test_module_api_uses_one_default_engine_on_cuda(monkeypatch):
    """The default engine is from_pretrained() with the device left at
    "cuda", built once; on the CPU the device is patched, and the module
    functions then return what an explicit engine returns."""
    import ocrjax_torch
    calls = []
    real = OcrEngine.from_pretrained.__func__

    def on_cpu(cls, *a, **kw):
        calls.append(kw.get("device", "cuda"))
        kw["device"] = "cpu"
        return real(cls, *a, **kw)

    monkeypatch.setattr(OcrEngine, "from_pretrained", classmethod(on_cpu))
    monkeypatch.setattr(port_api, "_default_engine", None)
    eng = ocrjax_torch.get_default_engine()
    assert ocrjax_torch.get_default_engine() is eng and calls == ["cuda"]
    # a small canvas keeps the CPU run short; explicit engine, same config
    eng.config = eng.config.replace(det_max_side=512)
    ref = OcrEngine.from_pretrained(config=eng.config, device="cpu")
    page = _page(7)
    got, want = ocrjax_torch.ocr(page), ref.ocr(page)
    assert [line.text for line in got.lines] == \
        [line.text for line in want.lines] and want.lines
    boxes = ocrjax_torch.detect(page)
    assert [b.score for b in boxes] == [b.score for b in ref.detect(page)]
    strip = page[:64, :200]
    assert ocrjax_torch.recognize(strip) == ref.recognize(strip)
    assert len(calls) == 2   # the module functions built no second engine
