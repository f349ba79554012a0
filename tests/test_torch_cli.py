"""The port's CLI (ocrjax_torch/cli.py) against ocrjax.cli, and the PNG
decoder it rests on (ocrjax_torch/imageio.py) against cv2.imread.

CLI: both run in process with --cpu on the same PNG files and the shipped
assets at --det-max-side 512; texts identical, quads within 0.02 px after
the CLI's 0.01 rounding, the same exit codes (1 for a missing file, the
port's bench traffic file included, 2 for no input, a charset of the wrong
size and, in the port, --viz without PIL). PNG: every colour type of
8-bit depth and all five scanline filters, byte for byte equal to
cv2.imread(IMREAD_COLOR) + BGR -> RGB, decoded with cv2 blocked from
importing.
"""

import contextlib
import io
import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from ocrjax import cli as jcli
from ocrjax.train.synth import render_line
from ocrjax_torch import cli as tcli
from ocrjax_torch import imageio
from test_torch_fixture import few_torch_threads  # noqa: F401
from test_torch_slice import _page

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(px: np.ndarray, ctype: int, filters, palette=None,
               trns: bytes = None) -> bytes:
    """(H, W, bpp) uint8 samples -> PNG bytes, row y filtered with
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    H, W, bpp = px.shape
    raw = px.reshape(H, W * bpp).astype(np.int16)
    prev = np.zeros(W * bpp, np.int16)
    rows = []
    for y in range(H):
        f = filters[y % len(filters)]
        line = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int16), line[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int16), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = (0, a, b, (a + b) >> 1, paeth)[f]
        rows.append(bytes([f]) + ((line - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = line
    out = imageio.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(b"".join(rows), 6))
            + _chunk(b"IEND", b""))


def _cases():
    rng = np.random.RandomState(0)
    H, W = 23, 37
    smooth = np.clip(rng.randn(H, W, 4).cumsum(1) * 20 + 128, 0,
                     255).astype(np.uint8)
    noise = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
    palette = rng.randint(0, 256, (40, 3))
    idx = rng.randint(0, 40, (H, W, 1)).astype(np.uint8)
    out = []
    for label, px in (("smooth", smooth), ("noise", noise)):
        out += [(f"grey {label}", px[..., :1], 0, None, None),
                (f"rgb {label}", px[..., :3], 2, None, None),
                (f"grey+alpha {label}", px[..., :2], 4, None, None),
                (f"rgba {label}", px, 6, None, None)]
    out += [("palette", idx, 3, palette, None),
            ("palette with tRNS", idx, 3, palette, bytes(range(0, 200, 5)))]
    return out


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4), (4, 3, 2, 1, 0, 3)],
                         ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_png_decoder_equals_cv2(tmp_path, case, filters):
    _, px, ctype, palette, trns = case
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(encode_png(px, ctype, filters, palette, trns))
    want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    got = imageio.read_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _without_cv2(code: str) -> subprocess.CompletedProcess:
    """Runs code in a fresh interpreter where `import cv2` fails."""
    return subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['cv2'] = None\n"
         + code], cwd=ROOT, capture_output=True, text=True)


def test_load_image_decodes_png_without_cv2(tmp_path):
    """load_image on PNG paths of the CLI's kinds (a PIL-written grey page
    and an RGBA strip) with cv2 blocked: equal to cv2.imread + BGR -> RGB
    (and the canonical polarity) as read here."""
    from PIL import Image
    page = _page(103)[..., 0]
    rgba = np.dstack([np.repeat(render_line("Sum: 42", 32)[..., None], 3, 2),
                      np.full((32, render_line("Sum: 42", 32).shape[1]), 200,
                              np.uint8)])
    paths = [str(tmp_path / "page.png"), str(tmp_path / "strip.png")]
    Image.fromarray(page).save(paths[0])
    Image.fromarray(rgba, "RGBA").save(paths[1])
    out = str(tmp_path / "out.npz")
    res = _without_cv2(
        "import numpy as np\n"
        "from ocrjax_torch import preprocess\n"
        f"a = [preprocess.load_image(p) for p in {paths!r}]\n"
        f"np.savez({out!r}, *a)\n"
        "assert 'cv2' not in [m for m in sys.modules if sys.modules[m]]\n")
    assert res.returncode == 0, res.stderr
    got = np.load(out)
    from ocrjax_torch import preprocess
    for k, p in enumerate(paths):
        want = preprocess.load_image(cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1])
        np.testing.assert_array_equal(got[f"arr_{k}"], want)


def test_other_formats_need_cv2(tmp_path):
    """A JPEG decodes through cv2 where it imports; without cv2 the error
    names the format. A 16-bit PNG goes the same way."""
    jpg = str(tmp_path / "x.jpg")
    img = np.random.RandomState(1).randint(0, 256, (20, 30, 3)).astype(
        np.uint8)
    cv2.imwrite(jpg, img)
    np.testing.assert_array_equal(imageio.read_image(jpg),
                                  cv2.imread(jpg)[..., ::-1])
    png16 = str(tmp_path / "x16.png")
    cv2.imwrite(png16, img.astype(np.uint16) * 257)
    assert imageio.decode_png(open(png16, "rb").read()) is None
    for path, name in ((jpg, "JPEG"), (png16, "bit depth 16")):
        res = _without_cv2(
            "from ocrjax_torch import imageio\n"
            f"try:\n    imageio.read_image({path!r})\n"
            "except imageio.ImageDecodeError as e:\n    print(e)\n")
        assert res.returncode == 0 and name in res.stdout, res.stderr
    bad = str(tmp_path / "bad.png")
    data = bytearray(encode_png(img, 2, (4,)))
    data[40] ^= 0xFF                                  # inside IDAT
    open(bad, "wb").write(bytes(data))
    with pytest.raises(imageio.ImageDecodeError, match="CRC"):
        imageio.read_image(bad)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    paths = {"strip": str(d / "strip.png"), "p0": str(d / "p0.png"),
             "p1": str(d / "p1.png")}
    cv2.imwrite(paths["strip"], render_line("Sum: 4289", height=32))
    cv2.imwrite(paths["p0"], _page(101, n_lines=(3, 6), text_height=(20, 40)))
    cv2.imwrite(paths["p1"], _page(102, n_lines=(3, 6), text_height=(20, 40)))
    return paths


def _run(module, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _flat(items):
    texts, quads = [], []
    for it in items:
        texts.append(it.get("text"))
        for e in it.get("lines", []) + it.get("boxes", []):
            texts.append(e.get("text"))
            quads.append(e["quad"])
    return texts, np.asarray(quads)


@pytest.mark.parametrize("argv", [["recognize", "strip"], ["detect", "p0"],
                                  ["ocr", "p0"], ["ocr", "p0", "p1"],
                                  ["ocr", "p0", "p1", "--fused"]],
                         ids=lambda a: "-".join(a))
def test_cli_json_matches_ocrjax(files, argv):
    args = [files.get(a, a) for a in argv] + [
        "--cpu", "--json", "--det-max-side", "512"]
    rj, oj, _ = _run(jcli, args)
    rt, ot, _ = _run(tcli, args)
    assert rj == rt == 0
    want, got = json.loads(oj), json.loads(ot)
    assert [sorted(i) for i in got] == [sorted(i) for i in want]
    (tw, qw), (tg, qg) = _flat(want), _flat(got)
    assert tg == tw
    assert qg.shape == qw.shape
    if len(qw):
        assert np.abs(qg - qw).max() <= 0.02
    if argv[0] == "recognize":
        assert got[0]["text"] == "Sum: 4289"
        assert got[0]["confidence"] == pytest.approx(want[0]["confidence"],
                                                     abs=1e-4)


def test_cli_exit_codes(files, tmp_path, monkeypatch):
    assert _run(tcli, ["recognize", "/nope/missing.png", "--cpu"])[0] == 1
    assert _run(jcli, ["recognize", "/nope/missing.png", "--cpu"])[0] == 1
    assert _run(tcli, ["ocr", "--cpu"])[0] == 2
    # bench runs (tests/test_torch_bench.py); a missing traffic file is a
    # missing input file
    rc, _, err = _run(tcli, ["bench", "--cpu", "--traffic",
                             "/nope/missing.npz"])
    assert rc == 1 and "missing.npz" in err
    bad = tmp_path / "bad_charset.txt"
    bad.write_text("a\nb\n")
    for module in (tcli, jcli):
        with pytest.raises(SystemExit) as e:
            _run(module, ["recognize", files["strip"], "--cpu", "--charset",
                          str(bad)])
        assert e.value.code == 2
    # a file that is not an image: both CLIs answer with exit code 1
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"not an image")
    monkeypatch.setitem(sys.modules, "cv2", None)
    rc, _, err = _run(tcli, ["recognize", str(junk), "--cpu"])
    assert rc == 1 and "unknown format" in err
    # --viz draws with PIL: without it, exit 2 before any work
    monkeypatch.setitem(sys.modules, "PIL", None)
    rc, out, err = _run(tcli, ["detect", files["p0"], "--cpu", "--viz",
                               str(tmp_path / "v.png")])
    assert rc == 2 and "PIL" in err and out == ""
    assert not (tmp_path / "v.png").exists()


def test_cli_viz_and_profile_and_text_output(files, tmp_path):
    """--viz writes the same picture as the reference CLI; --profile writes
    a torch.profiler trace; the plain output lists each image."""
    views = {}
    for name, module in (("port", tcli), ("ref", jcli)):
        dest = str(tmp_path / f"{name}.png")
        rc, _, _ = _run(module, ["ocr", files["p0"], "--cpu",
                                 "--det-max-side", "512", "--viz", dest])
        assert rc == 0
        views[name] = cv2.imread(dest)
    np.testing.assert_array_equal(views["port"], views["ref"])
    assert (views["port"][..., 1] > views["port"][..., 2] + 100).any()
    prof = tmp_path / "prof"
    rc, out, _ = _run(tcli, ["recognize", files["strip"], "--cpu",
                             "--profile", str(prof)])
    assert rc == 0 and out.startswith(f"== {files['strip']} (")
    assert "Sum: 4289" in out
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1 and json.load(open(traces[0]))["traceEvents"]
