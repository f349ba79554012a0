"""The fonts that ship with the port (ocrjax_torch/fonts/): the six DejaVu
faces byte for byte as the system's, the renderer reading only them, and
its strips and pages equal to ocrjax's synth (which reads the system's
files) bit for bit. A missing font raises and names its file."""

import hashlib
import os

import numpy as np
import pytest

from ocrjax.charset import Charset as JaxCharset
from ocrjax.train import synth as jsynth
from ocrjax_torch.charset import Charset
from ocrjax_torch.train import synth
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARSET = os.path.join(ROOT, "assets", "rec.charset.txt")
FONT_DIR = os.path.join(ROOT, "ocrjax_torch", "fonts")
SYSTEM_DIR = "/usr/share/fonts/truetype/dejavu"   # where ocrjax reads them


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_fonts_ship_in_the_package_with_their_licence():
    assert [os.path.dirname(f) for f in synth.FONTS] == [FONT_DIR] * 6
    assert [os.path.basename(f) for f in synth.FONTS] == [
        os.path.basename(f) for f in jsynth.FONTS]
    assert all(os.path.isfile(f) for f in synth.FONTS)
    assert sum(os.path.getsize(f) for f in synth.FONTS) == 2_883_376
    with open(os.path.join(FONT_DIR, "copyright")) as f:
        licence = f.read()
    assert "License: bitstream-vera" in licence
    assert "DejaVu changes are in public domain" in licence


@pytest.mark.parametrize("i", range(6))
def test_shipped_font_equals_the_system_one(i):
    system = os.path.join(SYSTEM_DIR, os.path.basename(synth.FONTS[i]))
    if not os.path.isfile(system):
        pytest.skip(f"no system font {system} here")
    assert _sha(synth.FONTS[i]) == _sha(system)


@pytest.fixture(scope="module")
def charsets():
    return Charset.from_file(CHARSET), JaxCharset.from_file(CHARSET)


def _render(name, mod, cs, seed):
    rng = np.random.RandomState(seed)
    if name == "make_line_batch":
        lb = mod.make_line_batch(rng, cs, 16, 192, 32, max_len=10,
                                 p_space=0.06, p_word=0.25, max_rotation=4.0,
                                 stretch=0.15, degrade=0.45)
        return [lb.images, lb.widths, lb.labels]
    if name == "render_page":
        page, quads, texts = mod.render_page(rng, cs, size=(480, 480),
                                             max_rotation=5.0)
    else:
        page, quads, texts = mod.render_page_dense(rng, cs, size=(512, 384),
                                                   n_lines=30)
    return [page, np.asarray(quads), texts]


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("name", ["make_line_batch", "render_page",
                                  "render_page_dense"])
def test_shipped_fonts_render_as_ocrjax(charsets, name, seed):
    got = _render(name, synth, charsets[0], seed)
    want = _render(name, jsynth, charsets[1], seed)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_a_missing_font_raises_naming_it(tmp_path):
    missing = str(tmp_path / "DejaVuSans.ttf")
    cs = Charset.from_file(CHARSET)
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        synth.render_line("text", font_path=missing)
    with pytest.raises(FileNotFoundError, match="DejaVuSans.ttf"):
        synth.make_line_batch(np.random.RandomState(0), cs, 4, 128, 32,
                              fonts=[missing])
    with pytest.raises(FileNotFoundError, match="DejaVuSans.ttf"):
        synth.render_page(np.random.RandomState(0), cs, size=(256, 256),
                          fonts=[missing])


def test_layout_engine_names_pillows_layout():
    from PIL import features
    assert synth.layout_engine() == ("raqm" if features.check("raqm")
                                     else "basic")
