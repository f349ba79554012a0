"""The port's synthetic renderer (ocrjax_torch/train/synth.py) against
ocrjax.train.synth: every renderer gives the same bytes, texts, quads and
labels at the same seeds, and leaves its random state where ocrjax's does
(the next draw is equal), with every augmentation of make_line_batch on.

The card's machine has neither PIL nor cv2: importing the port's training
and bench modules must load neither.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ocrjax.charset import Charset as JaxCharset
from ocrjax.train import synth as jsynth
from ocrjax_torch.charset import Charset
from ocrjax_torch.train import synth
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARSET = os.path.join(ROOT, "assets", "rec.charset.txt")


@pytest.fixture(scope="module")
def charsets():
    return Charset.from_file(CHARSET), JaxCharset.from_file(CHARSET)


def _same(a, b):
    """Equal nested outputs: arrays bit for bit, everything else ==."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _both(fn_name, charsets, seed, *args, call=None, **kw):
    """Runs the named renderer of both packages from one seed, as
    fn(rng, charset, *args, **kw) or call(fn, rng); returns (port output,
    ocrjax output, port's next draw, ocrjax's next draw)."""
    out = []
    for mod, cs in ((synth, charsets[0]), (jsynth, charsets[1])):
        rng = np.random.RandomState(seed)
        fn = getattr(mod, fn_name)
        res = call(fn, rng) if call else fn(rng, cs, *args, **kw)
        out.append((res, rng.rand()))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("fn,kw", [
    ("random_text", {"min_len": 4, "max_len": 12}),
    ("random_text", {"p_space": 0.2, "char_weights": {"l": 0.2, "I": 3.0}}),
    ("word_text", {}),
])
def test_text_draws_match(charsets, seed, fn, kw):
    a, b, na, nb = _both(fn, charsets, seed, **kw)
    assert a == b and na == nb


@pytest.mark.parametrize("kw", [
    {},
    {"height": 40, "font_path": synth.FONTS[3], "noise": 0.05, "pad": 2},
    {"height": 24, "supersample": 3},
])
def test_render_line_matches(kw):
    ra, rb = np.random.RandomState(3), np.random.RandomState(3)
    kw_j = dict(kw, font_path=kw.get("font_path", jsynth.FONTS[0]))
    _same(synth.render_line("Hello, World_42", rng=ra, **kw),
          jsynth.render_line("Hello, World_42", rng=rb, **kw_j))
    assert ra.rand() == rb.rand()


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(p_space=0.2, max_rotation=3.0, quantize_p=0.3, p_word=0.5,
             stretch=0.3, degrade=0.3, flat_snap=0.5,
             font_weights=[1, 2, 1, 1, 3, 1])),
    (5, dict(max_rotation=3.0, noise=0.0, min_len=2, max_len=8)),
])
def test_make_line_batch_matches(charsets, seed, kw):
    a, b, na, nb = _both("make_line_batch", charsets, seed, 12, 192, **kw)
    for field in ("images", "widths", "labels", "label_lengths", "texts"):
        _same(getattr(a, field), getattr(b, field))
    assert na == nb


@pytest.mark.parametrize("seed,kw", [
    (11, {}),
    (12, dict(size=(512, 384), max_rotation=8.0, p_word=0.5)),
    (13, dict(size=(320, 320), n_lines=(6, 12), supersample=2)),
])
def test_render_page_matches(charsets, seed, kw):
    a, b, na, nb = _both("render_page", charsets, seed, **kw)
    _same(list(a), list(b))
    assert na == nb


def test_render_page_dense_matches(charsets):
    a, b, na, nb = _both("render_page_dense", charsets, 1000,
                         size=(768, 512), n_lines=60, p_word=0.3)
    _same(list(a), list(b))
    assert na == nb and len(a[2]) == 60


def test_degrade_and_projective_warp_match(charsets):
    page, quads, _ = jsynth.render_page(np.random.RandomState(21),
                                        charsets[1], size=(320, 320))
    for level in (0.3, 1.0):
        a, b, na, nb = _both("degrade_image", charsets, 4, call=lambda f, r:
                             f(page, r, level=level))
        _same(a, b)
        assert na == nb
    a, b, na, nb = _both("warp_page_projective", charsets, 9, call=lambda
                         f, r: f(page, quads, r, severity=0.6, curl=0.5))
    _same(list(a), list(b))
    assert na == nb


def test_flat_snap_strip_matches():
    strip = jsynth.render_line("ace", 32)
    for gate in (False, True):
        _same(synth.flat_snap_strip(strip, 0.46, case_gate=gate),
              jsynth.flat_snap_strip(strip, 0.46, case_gate=gate))
    assert synth.flat_snap_strip(jsynth.render_line("Ajg", 32), 0.46) is None


def test_training_and_bench_modules_import_without_pil_or_cv2():
    """As on the card's machine: PIL and cv2 blocked from importing."""
    code = ("import sys\n"
            "sys.modules['PIL'] = None; sys.modules['cv2'] = None\n"
            "import ocrjax_torch.train, ocrjax_torch.train.synth\n"
            "import ocrjax_torch.bench_lib, ocrjax_torch.utils.roofline\n"
            "import ocrjax_torch.train.e2e_eval, ocrjax_torch.train.det_gt\n"
            "import ocrjax_torch.train.checkpoint\n"
            "import ocrjax_torch.train.rec_trainer\n"
            "import ocrjax_torch.train.det_trainer\n"
            "import ocrjax_torch.train.cls_trainer\n"
            "import ocrjax_torch.train.det_crops\n"
            "from ocrjax_torch.train import synth\n"
            "try:\n"
            "    synth.render_line('a')\n"
            "except ImportError:\n"
            "    print('no PIL')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "no PIL"
