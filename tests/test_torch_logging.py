"""The port's structured logging (ocrjax_torch/utils/logging.py) and every
reference log site's counterpart, against ocrjax on the CPU.

The formatters give ocrjax's output for the same record (the JSON `ts`
aside). Each site fires in both packages on the same input with the same
level, message and field names, and the same field values where both
compute them (a decode error's text names each package's own decoder):
an inverted page, a malformed PNG in a chunk, a device OOM in the fused
and the tile dispatch, a tile page at the candidate cap, an untrained
orientation classifier, and the fused lane's redo counts on the mixed
batch at 512.
"""

import dataclasses
import io
import json
import logging
import os

import numpy as np
import pytest
import torch

from ocrjax.utils import logging as JL
from ocrjax_torch.utils import logging as TL
from test_torch_fixture import captured_logs, few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(exc=False):
    rec = logging.LogRecord("x.y", logging.WARNING, __file__, 1,
                            "page %d failed", (3,), None)
    rec.fields = {"page": 3, "error": "ValueError: bad", "depth": 0}
    if exc:
        try:
            raise ValueError("boom")
        except ValueError:
            import sys
            rec.exc_info = sys.exc_info()
    return rec


@pytest.mark.parametrize("exc", [False, True])
def test_formatters_equal_ocrjax(exc):
    rec = _record(exc)
    a = json.loads(TL.JsonFormatter().format(rec))
    b = json.loads(JL.JsonFormatter().format(rec))
    assert abs(a.pop("ts") - b.pop("ts")) < 5.0
    assert a == b and a["page"] == 3 and a["msg"] == "page 3 failed"
    fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
    assert TL.TextFormatter(fmt).format(rec) == JL.TextFormatter(fmt).format(
        rec)
    assert TL.TextFormatter(fmt).format(rec).endswith(
        " page=3 error=ValueError: bad depth=0") or exc


def test_get_logger_and_log_fields_equal_ocrjax():
    outs = []
    for mod, name in ((TL, "test.torch.logging.t"),
                      (JL, "test.torch.logging.j")):
        s = io.StringIO()
        log = mod.get_logger(name, json_logs=True, stream=s)
        assert not log.propagate and log.level == logging.INFO
        mod.log_fields(log, "redo", rotated=1)
        mod.log_fields(log, "warning", "oom", chunk_pages=4, depth=0)
        mod.log_fields(log, "debug", "hidden")
        outs.append([json.loads(x) for x in s.getvalue().splitlines()])
    for rows in outs:
        for r in rows:
            r.pop("ts"), r.pop("logger")
    assert outs[0] == outs[1] and len(outs[0]) == 2
    assert TL.get_logger().name == "ocrjax_torch"


def _same(port, ref, values=True):
    assert [(lv, m) for lv, m, _ in port] == [(lv, m) for lv, m, _ in ref]
    assert [sorted(f) for _, _, f in port] == [sorted(f) for _, _, f in ref]
    if values:
        assert [f for _, _, f in port] == [f for _, _, f in ref]
    assert port


def _inverted_page():
    img = np.full((64, 96, 3), 30, np.uint8)
    img[20:30, 10:80] = 220
    return img


def test_inverted_page_logs_as_ocrjax():
    from ocrjax import preprocess as jpre
    from ocrjax_torch import preprocess as tpre
    with captured_logs("ocrjax_torch.preprocess") as port:
        out = tpre.load_image(_inverted_page())
    with captured_logs("ocrjax.preprocess") as ref:
        want = jpre.load_image(_inverted_page())
    np.testing.assert_array_equal(out, want)
    _same(port, ref)
    assert port == [("INFO", "inverted-polarity page: canonicalized to "
                     "dark-on-light", {"inverted": True})]


def test_malformed_png_in_a_chunk_logs_as_ocrjax(tmp_path):
    from ocrjax import preprocess as jpre
    from ocrjax.config import OcrConfig as JaxConfig
    from ocrjax_torch import preprocess as tpre
    from ocrjax_torch.config import OcrConfig
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    page = np.full((64, 64, 3), 240, np.uint8)
    cfg = OcrConfig(det_max_side=64)
    with captured_logs("ocrjax_torch.preprocess") as port:
        ok = tpre.decode_chunk_to_gray([page, str(bad)], [0, 1], cfg)[3]
    with captured_logs("ocrjax.preprocess") as ref:
        jok = jpre.decode_chunk_to_gray(
            [page, str(bad)], [0, 1], JaxConfig(**dataclasses.asdict(cfg)))[3]
    assert ok.tolist() == jok.tolist() == [True, False]
    _same(port, ref, values=False)
    assert port[0][:2] == ("WARNING", "page decode failed (isolated)")
    assert port[0][2]["page"] == ref[0][2]["page"] == 1
    assert "Error" in port[0][2]["error"]


@pytest.fixture(scope="module")
def tiny():
    """A TINY engine of each package, random weights."""
    from ocrjax.api import OcrEngine as JaxEngine
    from ocrjax.charset import Charset as JaxCharset
    from ocrjax.config import TINY as JAX_TINY
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.charset import Charset
    from ocrjax_torch.config import TINY
    return (JaxEngine(config=JAX_TINY, charset=JaxCharset("abcdef"), seed=0),
            OcrEngine(config=TINY, charset=Charset("abcdef"), device="cpu"))


@pytest.fixture
def tiny_engines(tiny):
    """-> set(**config overrides) -> the TINY engines with them; the
    engines get their configs back after the test."""
    configs = [e.config for e in tiny]

    def with_config(**over):
        for e, c in zip(tiny, configs):
            e.config = c.replace(**over)
        return tiny
    yield with_config
    for e, c in zip(tiny, configs):
        e.config = c


def test_untrained_cls_warns_as_ocrjax(tiny_engines):
    jeng, teng = tiny_engines(rec_try_flip=True)
    with captured_logs("ocrjax_torch.api") as port:
        teng.warn_untrained_cls()
        teng.warn_untrained_cls()              # once
    with captured_logs("ocrjax.api") as ref:
        jeng.warn_untrained_cls()
        jeng.warn_untrained_cls()
    _same(port, ref)
    assert port[0][2] == {"trained": False}


def test_fused_oom_halving_logs_as_ocrjax(tiny_engines, monkeypatch):
    from ocrjax import fused as JF
    from ocrjax_torch import fused as TF
    jeng, teng = tiny_engines(det_max_side=256, fused_chunk_pages=4,
                              fused_rotation_reroute_deg=0.0)
    page = np.full((256, 256, 3), 235, np.uint8)
    page[100:120, 40:200] = 20
    imgs = [page] * 4
    real_detect = TF.FusedOcr.detect

    def detect(self, gray_up, thr, wh):
        if gray_up.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return real_detect(self, gray_up, thr, wh)
    monkeypatch.setattr(TF.FusedOcr, "detect", detect)
    real_make = JF.make_fused_ocr_fn

    def make(engine, *a, **kw):
        real = real_make(engine, *a, **kw)

        def guard(det_vars, rec_vars, cls_vars, grays, thr, wh):
            if grays.shape[0] > 1:
                raise RuntimeError("RESOURCE_EXHAUSTED: fake OOM for test")
            return real(det_vars, rec_vars, cls_vars, grays, thr, wh)
        return guard
    monkeypatch.setattr(JF, "make_fused_ocr_fn", make)
    with captured_logs("ocrjax_torch.fused") as port:
        teng.ocr_batch(imgs, fused=True)
    with captured_logs("ocrjax.fused") as ref:
        jeng.ocr_batch(imgs, fused=True)
    oom = [r for r in ref if r[0] == "WARNING"]
    _same([r for r in port if r[0] == "WARNING"], oom)
    assert [f for _, _, f in oom] == [
        {"chunk_pages": 4, "depth": 0}, {"chunk_pages": 2, "depth": 1},
        {"chunk_pages": 2, "depth": 1}]


def test_tile_oom_halving_logs_as_ocrjax(tiny_engines, monkeypatch):
    from ocrjax import api_det as JA
    from ocrjax_torch import tiling as TT
    jeng, teng = tiny_engines(tile_size=256, tile_overlap=32)
    page = np.full((256, 480, 3), 235, np.uint8)
    page[100:120, 40:400] = 20
    assert len(TT._prep_page(teng, page)[1][0]) == 2     # one pair
    fwd = TT._tile_forward(teng)
    real_fwd = type(fwd).forward
    seen = []

    def forward(self, tiles_up):
        seen.append(tiles_up.shape[0])
        if seen == [2]:
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return real_fwd(self, tiles_up)
    monkeypatch.setattr(type(fwd), "forward", forward)
    real_fetch = JA.fetch_det
    jseen = []

    def fetch(packed, *a, **kw):
        jseen.append(packed[0].shape[0])
        if jseen == [2]:
            raise RuntimeError("RESOURCE_EXHAUSTED: fake OOM for test")
        return real_fetch(packed, *a, **kw)
    monkeypatch.setattr(JA, "fetch_det", fetch)
    with captured_logs("ocrjax_torch.tiling") as port:
        teng.detect_tiled(page)
    with captured_logs("ocrjax.tiling") as ref:
        jeng.detect_tiled(page)
    _same(port, ref)
    assert port[0] == ("WARNING", "device OOM: halving tile batch",
                       {"tiles": 2, "depth": 0})


@pytest.fixture(scope="module")
def engines_512():
    from ocrjax.api import OcrEngine as JaxEngine
    from ocrjax.config import OcrConfig as JaxConfig
    from ocrjax_torch.api import OcrEngine, asset_config
    cfg = asset_config(det_max_side=512, compute_dtype="float32",
                       tile_size=512, tile_overlap=64)
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**dataclasses.asdict(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


def _render(seed, size, **kw):
    from ocrjax.charset import Charset
    from ocrjax.train import synth
    cs = Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    return synth.render_page(np.random.RandomState(seed), cs, size=size,
                             **kw)[0]


def test_tile_candidate_cap_logs_as_ocrjax(engines_512):
    jeng, teng = engines_512
    page = _render(1401, (512, 1100), n_lines=(4, 6), text_height=(24, 36))
    over = dict(det_max_candidates=2, tile_max_candidates=2)
    jeng.config = jeng.config.replace(**over)
    teng.config = teng.config.replace(**over)
    try:
        with captured_logs("ocrjax_torch.tiling") as port:
            teng.detect_tiled(page)
        with captured_logs("ocrjax.tiling") as ref:
            jeng.detect_tiled(page)
    finally:
        for e in (jeng, teng):
            e.config = e.config.replace(det_max_candidates=64,
                                        tile_max_candidates=384)
    _same(port, ref)
    assert port[0][:2] == ("WARNING", "tile candidate cap reached — page "
                           "likely truncated")
    assert port[0][2]["cap"] == 2


def test_redo_counts_equal_ocrjax_on_the_mixed_batch(engines_512):
    """The fused lane's redo line: tilted and saturated pages and colour
    pages counted as ocrjax counts them."""
    from ocrjax.train import synth
    from ocrjax.charset import Charset
    jeng, teng = engines_512
    cs = Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))

    def rgb(g):
        return np.repeat(g[..., None], 3, 2)
    ink = _render(901, (512, 512), n_lines=(3, 5), text_height=(22, 36))
    batch = [
        rgb(_render(101, (512, 512), n_lines=(3, 6), text_height=(20, 40))),
        rgb(_render(201, (512, 512), n_lines=(2, 4), text_height=(22, 36),
                    max_rotation=8.0)),
        np.stack([np.full_like(ink, 255), np.full_like(ink, 255), ink], -1),
        rgb(synth.render_page_dense(np.random.RandomState(601), cs,
                                    size=(512, 512), n_lines=40,
                                    text_height=(14, 18))[0]),
        rgb(_render(1202, (700, 640), n_lines=(3, 5), text_height=(30, 44),
                    max_rotation=8.0)),
    ]
    with captured_logs("ocrjax_torch.fused") as port:
        teng.ocr_batch(batch, fused=True)
    with captured_logs("ocrjax.fused") as ref:
        jeng.ocr_batch(batch, fused=True)
    _same(port, ref)
    f = port[0][2]
    assert f["rotated"] >= 1 and f["saturated"] >= 1 and f["colorful"] == 1
