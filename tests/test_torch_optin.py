"""The remaining opt-in paths against ocrjax: warp_quads_grouped,
snap_strips_to_ink, the fused program with the exact homography warp
(separable_warp=False), and rec_flat_case_gate on every lane.

Bars: strips as in test_torch_warp_staged.py (the homography warp within
2e-3: its 8x8 solves round in another order; the snap within 1e-5, widths
identical); lanes at the goldens bar (identical strings and order, boxes
within 0.011 px, scores within 2e-3), strip confidences within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrjax import fused as jfused
from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.ops import warp as jw
from ocrjax.train import synth
from ocrjax_torch import fused as tfused
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.ops import warp as tw
from test_torch_fixture import few_torch_threads  # noqa: F401
from test_torch_slice import _assert_same, _page
from test_torch_warp_staged import PAD, _page as _bar_pages, _quads, _t


def test_warp_quads_grouped_matches_ocrjax():
    """Quads grouped per page, (B, K, 4, 2): ocrjax's nested vmap and the
    port's pooled gather with repeated page ids."""
    pages = _bar_pages(4)
    quads = _quads(5).reshape(2, 3, 4, 2)
    want_s, want_w = jw.warp_quads_grouped(
        jnp.asarray(pages), jnp.asarray(quads), rec_height=32,
        bucket_width=192, pad_value=PAD)
    got_s, got_w = tw.warp_quads_grouped(_t(pages), _t(quads), rec_height=32,
                                         bucket_width=192, pad_value=PAD)
    assert got_s.shape == (2, 3, 32, 192) and got_w.shape == (2, 3)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=2e-3)
    # strip k of page b is the pooled warp of quad (b, k) off page b
    ids = torch.arange(2).repeat_interleave(3)
    pool_s, _ = tw.warp_quads_multi(_t(pages), ids, _t(quads).reshape(6, 4, 2),
                                    rec_height=32, bucket_width=192,
                                    pad_value=PAD)
    assert torch.equal(got_s.reshape(6, 32, 192), pool_s)


def test_snap_strips_to_ink_matches_ocrjax():
    """Loose probe strips off the bar pages, a blank strip (passes through
    unchanged) and a strip whose ink sits off centre."""
    pages = _bar_pages(6)
    quads = _quads(7)
    quads[:, :, 1] += np.asarray([-6, 6, 0, -3, 4, 0], np.float32)[:, None]
    strips, widths = tw.warp_quads(_t(pages[0]), _t(quads), rec_height=32,
                                   bucket_width=192, pad_value=PAD)
    strips = torch.cat([strips, torch.ones((1, 32, 192))])
    widths = torch.cat([widths, torch.tensor([120], dtype=torch.int32)])
    kw = dict(ink_thresh=0.0, min_count=2, pad_y=2.0, pad_x=3.0)
    want_s, want_w = jw.snap_strips_to_ink(jnp.asarray(strips.numpy()),
                                           jnp.asarray(widths.numpy()), **kw)
    got_s, got_w = tw.snap_strips_to_ink(strips, widths, **kw)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)
    assert torch.equal(got_s[-1], strips[-1]) and int(got_w[-1]) == 120
    assert (got_w[:-1] != widths[:-1]).any()


@pytest.fixture(scope="module")
def config():
    return asset_config(det_max_side=512, compute_dtype="float32")


def _pair(config, **kw):
    cfg = config.replace(**kw)
    return (JaxEngine.from_pretrained(config=JaxConfig(
        **dataclasses.asdict(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


def test_grouped_fused_program_matches_ocrjax(config):
    """make_fused_ocr_fn(separable_warp=False) against FusedOcr with the
    same switch, through ocr_pages_fused: the homography warp and refine
    on the fused lane, on a straight and a slightly tilted page."""
    jax_engine, port = _pair(config)
    pages = [_page(101, n_lines=(3, 6), text_height=(20, 40)),
             _page(202, n_lines=(3, 5), text_height=(22, 36),
                   max_rotation=2.0)]
    cfg = jax_engine.config
    K, Wb = cfg.fused_lines_per_page, cfg.rec_bucket_for_width(
        10 * cfg.rec_height)
    key = (K, Wb, False, cfg.replace(det_thresh=0.0, det_box_thresh=0.0,
                                     det_unclip_ratio=0.0,
                                     det_min_box_size=0))
    jax_engine._fused_cache = {key: jfused.make_fused_ocr_fn(
        jax_engine, K, Wb, separable_warp=False)}
    want = jax_engine.ocr_batch(pages, fused=True)
    got = tfused.ocr_pages_fused(port, pages, separable_warp=False)
    assert not tfused._fused_for(port, K, Wb, False, False).separable_warp
    for g, w in zip(got, want):
        _assert_same(g, w)
    # the grouped program reads other strips than the separable one
    sep = port.ocr_batch(pages, fused=True)
    assert any(abs(a.confidence - b.confidence) > 1e-5
               for r, s in zip(got, sep) for a, b in zip(r.lines, s.lines))


def _short_line_page(seed, size=(512, 512)):
    """1-3 glyph lines: the flat-band rescale, and so its case gate,
    decides how they are cropped."""
    from ocrjax.charset import Charset
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    charset = Charset.from_file(os.path.join(root, "assets",
                                             "rec.charset.txt"))
    page, _, _ = synth.render_page(np.random.RandomState(seed), charset,
                                   size=size, n_lines=(8, 12),
                                   text_height=(20, 36), max_len=3,
                                   min_len=1)
    return page


def test_case_gate_on_every_lane_matches_ocrjax(config):
    """rec_flat_case_gate=True on the fused, bucketed, staged and
    full-resolution lanes and in recognize_strips."""
    jax_engine, port = _pair(config, rec_flat_case_gate=True)
    page = _short_line_page(803)
    big = _short_line_page(804, size=(700, 560))       # downscaled at 512
    checks = [
        ("fused", lambda e: e.ocr_batch([page], fused=True)),
        ("bucketed", lambda e: e.ocr_batch([page, big], fused=False)),
        ("full resolution", lambda e: [e.ocr(big)])]
    for name, run in checks:
        for g, w in zip(run(port), run(jax_engine)):
            _assert_same(g, w)
    staged = dict(ocr_single_fused=False, rec_flat_case_gate=True)
    jax_staged, port_staged = _pair(config, **staged)
    _assert_same(port_staged.ocr(page), jax_staged.ocr(page))
    strips = [page[y:y + 48, 30:200] for y in (40, 200, 330)]
    got = port.recognize_strips(strips)
    want = jax_engine.recognize_strips(strips)
    assert [r.text for r in got] == [r.text for r in want]
    np.testing.assert_allclose([r.confidence for r in got],
                               [r.confidence for r in want], atol=1e-5)
    # the gate moves this page's crops: the same lanes read it otherwise
    # with the gate off
    off = OcrEngine.from_pretrained(config=config, device="cpu")
    on_res = port.ocr_batch([page], fused=True)[0]
    off_res = off.ocr_batch([page], fused=True)[0]
    assert any(a.text != b.text or abs(a.confidence - b.confidence) > 1e-4
               for a, b in zip(on_res.lines, off_res.lines))
