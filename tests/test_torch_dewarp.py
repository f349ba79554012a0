"""Curved-baseline dewarp (ops.warp.dewarp_curl, rec_dewarp_curl) against
ocrjax: the function on bowed, straight, clamped and blank strips, and the
flag on every entry point, whose insertion points differ: C1
(recognize_strips) and the fused lane dewarp before the orientation stage,
the staged and pooled lanes after it.

Bars: the `curved` mask identical; dewarped strips within 1e-5 (the 3x3
solves and the node matmuls round in another order); a straight strip
bit for bit unchanged; lanes at the goldens bar (identical strings and
order, boxes within 0.011 px, scores within 2e-3), strip confidences within
1e-5.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.ops import warp as jwarp
from ocrjax.train import synth
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.models import cls as cls_lib
from ocrjax_torch.ops import warp as twarp
from test_torch_fixture import few_torch_threads, jax_fields  # noqa: F401
from test_torch_slice import _assert_same

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_dewarp import _bow, _strip  # noqa: E402  (ocrjax's strip helpers)


def _strips(width=320):
    """Bowed strips both ways and at several amplitudes, straight ones
    (one with the ascender/descender trend), a short one with too few
    inked columns, a blank one; widths clipped to the bucket."""
    out = []
    for text, amp in (("Hello worldly", 5.0), ("Hello worldly", 0.0),
                      ("lll lll ppp ppp", 0.0), ("Curly bowed line", -7.0),
                      ("abc", 4.0), ("A long bowed line of text", 12.0),
                      ("Shallow bow here", 1.5)):
        flat, w = _strip(text)
        s = _bow(flat, w, amp) if amp else flat
        out.append((s[:, :width], min(w, width)))
    out.append((np.ones((32, width), np.float32), width // 2))
    strips = np.stack([s for s, _ in out]).astype(np.float32)
    return strips, np.asarray([w for _, w in out], np.int32)


@pytest.mark.parametrize("width,kw", [
    (320, dict(ink_thresh=0.0, pad_value=1.0)),
    (320, dict(ink_thresh=0.0, min_dev_px=3.0, max_shift_px=2.0,
               pad_value=-1.0)),               # the clamp bites
    (200, dict(ink_thresh=0.0, segments=16, pad_value=-1.0)),  # 200 % 16
])
def test_dewarp_curl_matches_ocrjax(width, kw):
    strips, widths = _strips(width)
    want, want_c = (np.asarray(a) for a in jwarp.dewarp_curl(
        jnp.asarray(strips), jnp.asarray(widths), **kw))
    got, got_c = twarp.dewarp_curl(torch.from_numpy(strips),
                                   torch.from_numpy(widths), **kw)
    got, got_c = got.numpy(), got_c.numpy()
    np.testing.assert_array_equal(got_c, want_c)
    assert 2 <= got_c.sum() < len(got_c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the straight tier: untouched bit for bit, blank strip included
    np.testing.assert_array_equal(got[~got_c], strips[~got_c])
    assert not got_c[-1]


def test_maybe_dewarp_curl_follows_the_config():
    strips, widths = _strips()
    cfg = asset_config(rec_dewarp_curl=True)
    s, w = torch.from_numpy(strips), torch.from_numpy(widths)
    assert twarp.maybe_dewarp_curl(s, w, cfg.replace(
        rec_dewarp_curl=False)) is s
    want = np.asarray(jwarp.maybe_dewarp_curl(
        jnp.asarray(strips), jnp.asarray(widths),
        JaxConfig(**jax_fields(cfg))))
    np.testing.assert_allclose(twarp.maybe_dewarp_curl(s, w, cfg).numpy(),
                               want, rtol=0, atol=1e-5)


def _curl_page(seed, rot180=False):
    """A 512 page of long lines under page curl (amplitude 1.5% of the
    height): the dewarp fires on most of its strips."""
    from ocrjax.charset import Charset
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    charset = Charset.from_file(os.path.join(root, "assets",
                                             "rec.charset.txt"))
    rng = np.random.RandomState(seed)
    page, quads, _ = synth.render_page(rng, charset, size=(512, 512),
                                       n_lines=(4, 6), text_height=(16, 22),
                                       max_len=32, min_len=26)
    page = synth.warp_page_projective(page, quads, rng, severity=0.0,
                                      curl=1.0)[0]
    return np.ascontiguousarray(np.rot90(page, 2)) if rot180 else page


def _bowed_line_strips():
    """Line crops of a curl page, upright and rotated 180 degrees."""
    page = _curl_page(701)
    out = []
    for y0, y1 in ((60, 110), (150, 200), (260, 320)):
        crop = page[y0:y1, 40:470]
        out += [crop, np.ascontiguousarray(np.rot90(crop, 2))]
    return out


@pytest.fixture(scope="module")
def engines():
    out = {}
    for flip in (False, True):
        cfg = asset_config(det_max_side=512, compute_dtype="float32",
                           rec_dewarp_curl=True, rec_try_flip=flip)
        out[flip] = (JaxEngine.from_pretrained(config=JaxConfig(
            **jax_fields(cfg))),
            OcrEngine.from_pretrained(config=cfg, device="cpu"))
    return out


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "try_flip"])
def test_recognize_strips_dewarps_as_ocrjax(engines, flip):
    """C1: dewarp, then (with rec_try_flip) the orientation stage."""
    jax_engine, port = engines[flip]
    strips = _bowed_line_strips()
    want = jax_engine.recognize_strips(strips, same_page=flip)
    got = port.recognize_strips(strips, same_page=flip)
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.flipped for r in got] == [r.flipped for r in want]
    np.testing.assert_allclose([r.confidence for r in got],
                               [r.confidence for r in want], atol=1e-5)
    if flip:
        assert any(r.flipped for r in got)


def test_the_two_insertion_orders_differ():
    """Dewarp-then-flip (C1, fused) and flip-then-dewarp (staged, pooled)
    give other strips, so the lane tests tell the orders apart."""
    cfg = asset_config(rec_dewarp_curl=True)
    strips, widths = (torch.from_numpy(a) for a in _strips())
    strips, widths = strips[:1], widths[:1]                # the 5 px bow
    pad = (0.0 - cfg.rec_mean) / cfg.rec_std
    every = torch.ones(1, dtype=torch.bool)
    a = cls_lib.flip_strips_by_width(
        twarp.maybe_dewarp_curl(strips, widths, cfg), widths, every, pad)
    b = twarp.maybe_dewarp_curl(
        cls_lib.flip_strips_by_width(strips, widths, every, pad), widths, cfg)
    assert twarp.dewarp_curl(strips, widths, ink_thresh=0.0)[1].all()
    assert (a - b).abs().max() > 1e-3


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "try_flip"])
def test_every_lane_dewarps_as_ocrjax(engines, flip):
    """The fused lane (ocr_batch), the bucketed lane and the staged
    single-page lane on curl pages, one of them upside down."""
    jax_engine, port = engines[flip]
    pages = [_curl_page(701), _curl_page(703, rot180=flip)]
    for g, w in zip(port.ocr_batch(pages, fused=True),
                    jax_engine.ocr_batch(pages, fused=True)):
        _assert_same(g, w)
    for g, w in zip(port.ocr_batch(pages, fused=False),
                    jax_engine.ocr_batch(pages, fused=False)):
        _assert_same(g, w)
    staged = dict(ocr_single_fused=False)
    jax_staged = JaxEngine.from_pretrained(config=jax_engine.config.replace(
        **staged))
    port_staged = OcrEngine.from_pretrained(
        config=port.config.replace(**staged), device="cpu")
    _assert_same(port_staged.ocr(pages[1]), jax_staged.ocr(pages[1]))


def test_curved_masks_on_the_curl_fixture_match_ocrjax():
    """The committed curl pages (chip_smoke.py phase 10): the port's
    curved masks over the staged strips of the recorded boxes equal the
    ones ocrjax recorded, which bend at least a quarter of the strips."""
    import json
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from test_torch_fixture import CURL, CURL_EXPECTED, curl_pages
    with open(CURL_EXPECTED) as f:
        want = json.load(f)
    pages = curl_pages(dict(np.load(CURL)))
    boxes = [p["boxes"] for p in want["plain"]["ocr"]]
    masks = chip_smoke.port_curved_masks(pages, boxes, device="cpu")
    assert masks == want["curved"]
    assert sum(map(sum, masks)) * 4 >= sum(map(len, masks))
