"""The port's byte-packed payloads (ocrjax_torch/ops/bytepack.py), case
for case as tests/test_bytepack.py holds ocrjax's, and the layout across
the two packages.

Packing is transport only: the uint8 payloads unpack bit for bit to what
the float32 payloads unpack to (token ids, counts and flags as bytes,
float columns as their four raw bytes, never quantized). The reference's
end-to-end cases are `slow` there; here they run at its small size (the
TINY config, 256-pixel pages).

Across the packages (the shipped assets in float32 at det_max_side=512):
ocrjax's unpack_fused, unpack_rec, unpack_rec_flip and unpack_det read
the port's payloads and the port's unpackers read ocrjax's, to the same
values; the two packages' payloads on the same inputs agree exactly in
flags and in the tokens and counts of every line (the port's empty fused
line slots read 0), and within the goldens bar
(tests/test_goldens.py) in boxes (0.011 px), scores and confidences
(2e-3).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ocrjax_torch.api import OcrEngine
from ocrjax_torch.charset import Charset, default_charset
from ocrjax_torch.config import TINY
from ocrjax_torch.ops.bytepack import (HostCopy, bytes_to_f32, f32_to_bytes,
                                       use_byte_fetch)
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_TOL = 0.011
SCORE_TOL = 2e-3


def test_f32_bytes_roundtrip_exact():
    rng = np.random.RandomState(0)
    x = rng.randn(7, 13).astype(np.float32)
    # every special encoding a confidence or a coordinate could hit
    x[0, :6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-42]  # a denormal
    b = f32_to_bytes(torch.from_numpy(x)).numpy()
    assert b.dtype == np.uint8 and b.shape == (7, 52)
    y = bytes_to_f32(b)
    np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


def test_f32_bytes_match_ocrjax_byte_order():
    """The port's bytes are XLA's bitcast bytes, low byte first, on
    NaNs (quiet, signalling, with payloads), infinities, zeros, denormals
    and normals; a non-contiguous input (a gathered or transposed column
    block) packs as its contiguous copy."""
    import jax.numpy as jnp
    from ocrjax.ops.bytepack import f32_to_bytes as jax_f32_to_bytes
    bits = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                     0x7FC00000, 0xFFC00001, 0x7F800001, 0x7FBFFFFF,
                     0x00000001, 0x807FFFFF, 0x00800000, 0x3F800000,
                     0xBF7FFFFF, 0x12345678, 0xDEADBEEF, 0x7F7FFFFF],
                    np.uint32)
    rng = np.random.RandomState(1)
    bits = np.concatenate([bits, rng.randint(0, 2**32, 48, dtype=np.uint64)
                           .astype(np.uint32)]).reshape(8, 8)
    x = bits.view(np.float32)
    got = f32_to_bytes(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_f32_to_bytes(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert bits[1, 5] == 0x12345678
    np.testing.assert_array_equal(got[1, 20:24], [0x78, 0x56, 0x34, 0x12])
    np.testing.assert_array_equal(bytes_to_f32(got).view(np.uint32), bits)
    t = torch.from_numpy(x).t()
    assert not t.is_contiguous()
    np.testing.assert_array_equal(f32_to_bytes(t).numpy(),
                                  np.asarray(jax_f32_to_bytes(
                                      jnp.asarray(x.T.copy()))))


def test_bytes_to_f32_accepts_noncontiguous_slice():
    buf = np.arange(40, dtype=np.uint8).reshape(2, 20)
    sl = buf[:, 4:12]  # strided rows, as sliced out of a fetched payload
    got = bytes_to_f32(sl)
    want = np.ascontiguousarray(sl).view(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_host_copy_of_a_cpu_tensor_reads_it_as_it_is():
    """Off the card there is nothing to copy: the tensor's values, no
    event, whatever its dtype."""
    for t in (torch.arange(12, dtype=torch.uint8).reshape(3, 4),
              torch.linspace(-1, 1, 6).reshape(2, 3)):
        cp = HostCopy(t)
        assert cp.event is None
        np.testing.assert_array_equal(cp.result(), t.numpy())


def _engine(fetch_bytes: bool) -> OcrEngine:
    cfg = TINY.replace(det_max_side=256, det_box_thresh=0.45,
                       fetch_bytes=fetch_bytes)
    return OcrEngine(config=cfg, charset=Charset("abcdef"), seed=0,
                     device="cpu")


@pytest.fixture(scope="module")
def engines():
    return _engine(True), _engine(False)


@pytest.fixture(scope="module")
def page():
    from ocrjax_torch.train.synth import render_page
    rng = np.random.RandomState(3)
    img, _, _ = render_page(rng, default_charset(), size=(256, 256))
    return np.repeat(img[..., None], 3, axis=2)


def test_rec_packed_payload_parity(engines):
    from ocrjax_torch.api_det import pack_rec, rec_strips, unpack_rec

    eb, ef = engines
    assert use_byte_fetch(eb) and not use_byte_fetch(ef)
    rng = np.random.RandomState(1)
    strips = torch.from_numpy(rng.randn(4, eb.config.rec_height, 64)
                              .astype(np.float32))
    widths = torch.tensor([64, 40, 17, 64], dtype=torch.int32)

    def payload(eng):
        return pack_rec(eng, *rec_strips(eng, strips, widths)).numpy()
    pb, pf = payload(eb), payload(ef)
    T = eb.config.rec_max_tokens
    assert pb.dtype == np.uint8 and pb.shape == (4, T + 5)
    assert pf.dtype == np.float32 and pf.shape == (4, T + 2)
    got, want = unpack_rec(pb, T), unpack_rec(pf, T)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(  # bitcast, not quantized: bit-exact
        got[2].view(np.uint32), want[2].astype(np.float32).view(np.uint32))


def test_rec_forced_flip_payload_parity(engines):
    from ocrjax_torch.api_det import (pack_rec_flip, rec_strips_forced_flip,
                                      unpack_rec_flip)

    eb, ef = engines
    rng = np.random.RandomState(2)
    strips = torch.from_numpy(rng.randn(4, eb.config.rec_height, 64)
                              .astype(np.float32))
    widths = torch.tensor([64, 40, 17, 64], dtype=torch.int32)
    flip = torch.tensor([True, False, True, False])

    def payload(eng):
        return pack_rec_flip(eng, *rec_strips_forced_flip(
            eng, strips, widths, flip)).numpy()
    T = eb.config.rec_max_tokens
    pb, pf = payload(eb), payload(ef)
    assert pb.shape == (4, T + 6) and pf.shape == (4, T + 3)
    got, want = unpack_rec_flip(pb, T), unpack_rec_flip(pf, T)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(
        got[2].view(np.uint32), want[2].astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[3], flip.numpy())


def _same_results(got, want):
    assert len(got) == len(want)
    for b, f in zip(got, want):
        assert [line.text for line in b.lines] == \
            [line.text for line in f.lines]
        assert [line.confidence for line in b.lines] == \
            [line.confidence for line in f.lines]
        for lb, lf in zip(b.lines, f.lines):
            np.testing.assert_array_equal(lb.box.quad, lf.box.quad)
            assert lb.box.score == lf.box.score


def test_fused_path_parity_end_to_end(engines, page):
    """The same page through ocr_pages_fused under both transports:
    identical strings, confidences, boxes and scores."""
    from ocrjax_torch.fused import ocr_pages_fused

    eb, ef = engines
    rb = ocr_pages_fused(eb, [page, page])
    rf = ocr_pages_fused(ef, [page, page])
    assert len(rb) == 2
    _same_results(rb, rf)


def test_pooled_path_parity_end_to_end(engines, page):
    from ocrjax_torch.bucketing import ocr_pages

    eb, ef = engines
    _same_results(ocr_pages(eb, [page]), ocr_pages(ef, [page]))


def test_use_byte_fetch_guards():
    """Charsets past 255 classes and token lengths past 255 keep the
    float32 payloads (byte ids would wrap), and the payloads then are
    float32 rows that carry the ids whole."""
    from ocrjax_torch.api_det import pack_rec, unpack_rec
    big = Charset("".join(chr(0x100 + i) for i in range(300)))
    eng = OcrEngine(config=TINY, charset=big, seed=0, device="cpu")
    assert not use_byte_fetch(eng)
    eng2 = OcrEngine(config=TINY.replace(rec_max_tokens=256),
                     charset=Charset("abcdef"), seed=0, device="cpu")
    assert not use_byte_fetch(eng2)
    T = TINY.rec_max_tokens
    tokens = torch.tensor([[299, 256, 1] + [0] * (T - 3)], dtype=torch.int32)
    p = pack_rec(eng, tokens, torch.tensor([3]), torch.tensor([0.5]))
    assert p.dtype == torch.float32
    got = unpack_rec(p.numpy(), T)
    assert got[0][0, :3].tolist() == [299, 256, 1] and got[1][0] == 3


# --- the layout across the two packages -------------------------------------

@pytest.fixture(scope="module")
def asset_engines():
    """-> (fetch_bytes, rec_try_flip) -> (ocrjax engine, port engine) on the
    shipped assets, float32, det_max_side=512."""
    from ocrjax.api import OcrEngine as JaxEngine
    from ocrjax.config import OcrConfig as JaxConfig
    from ocrjax_torch.api import asset_config
    made = {}

    def get(fetch_bytes=True, try_flip=False):
        key = (fetch_bytes, try_flip)
        if key not in made:
            cfg = asset_config(det_max_side=512, compute_dtype="float32",
                               fetch_bytes=fetch_bytes,
                               rec_try_flip=try_flip)
            made[key] = (JaxEngine.from_pretrained(
                config=JaxConfig(**dataclasses.asdict(cfg))),
                OcrEngine.from_pretrained(config=cfg, device="cpu"))
        return made[key]
    return get


@pytest.fixture(scope="module")
def pages_512():
    from ocrjax.charset import Charset as JaxCharset
    from ocrjax.train import synth
    cs = JaxCharset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    return np.stack([synth.render_page(np.random.RandomState(s), cs,
                                       size=(512, 512), n_lines=(3, 6),
                                       text_height=(20, 36))[0]
                     for s in (101, 102)])


def _close_dicts(a: dict, b: dict):
    """a: the port's rows, b: ocrjax's. Valid and flipped equal in every
    slot, tokens and counts in every occupied slot; the port recognizes
    only the occupied slots, so its empty slots' tokens, counts and
    confidences read 0 (ocrjax's hold what its CRNN read in an empty
    strip, which no reader uses)."""
    assert set(a) == set(b)
    for k in ("valid", "flipped"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    v = a["valid"]
    assert v.any() and not v.all()
    for k in ("tokens", "n_tokens"):
        np.testing.assert_array_equal(a[k][v], b[k][v], err_msg=k)
    for k in ("tokens", "n_tokens", "conf"):
        assert not a[k][~v].any(), k
    assert np.abs(a["quads"][v] - b["quads"][v]).max() <= BOX_TOL
    assert np.abs(a["scores"][v] - b["scores"][v]).max() <= SCORE_TOL
    assert np.abs(a["conf"][v] - b["conf"][v]).max() <= SCORE_TOL


def _same_dicts(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("fetch_bytes,try_flip", [(True, True),
                                                  (False, False)])
def test_fused_payload_layout_across_packages(asset_engines, pages_512,
                                              fetch_bytes, try_flip):
    """FusedOcr's rows and ocrjax's fused program's rows on the same pages:
    one shape and dtype, each package's unpack_fused reads both to the
    same values, and the two agree at the goldens bar in every occupied
    slot; the port's empty slots read 0."""
    import jax
    from ocrjax import fused as JF
    from ocrjax import preprocess as jpre
    from ocrjax.api_det import _det_state
    from ocrjax_torch import fused as TF
    from ocrjax_torch import preprocess as tpre

    jeng, teng = asset_engines(fetch_bytes, try_flip)
    cfg = teng.config
    K, W, T = 8, 320, cfg.rec_max_tokens
    packed = tpre.pack_for_upload(pages_512, cfg)
    np.testing.assert_array_equal(
        packed, jpre.pack_for_upload(pages_512, jeng.config))
    wh = np.full((2, 2), 512.0, np.float32)
    thr = (cfg.det_thresh, cfg.det_box_thresh, cfg.det_unclip_ratio,
           float(cfg.det_min_box_size))
    pt = TF.FusedOcr(teng, K, W)(torch.from_numpy(packed), thr,
                                 torch.from_numpy(wh)).numpy()
    prog = JF.make_fused_ocr_fn(jeng, K, W)
    pj = np.asarray(prog(_det_state(jeng).variables, jeng.rec_variables,
                         jeng.cls_variables, jax.device_put(packed),
                         np.asarray(thr, np.float32), wh))
    assert pt.shape == pj.shape and pt.dtype == pj.dtype
    width = K * (T + 42) if fetch_bytes else K * (T + 12)
    assert pt.shape == (2, width + (K if try_flip else 0))
    for p in (pt, pj):
        _same_dicts(TF.unpack_fused(p, K, T, try_flip),
                    JF.unpack_fused(p, K, T, try_flip))
    _close_dicts(TF.unpack_fused(pt, K, T, try_flip),
                 JF.unpack_fused(pj, K, T, try_flip))


@pytest.mark.parametrize("fetch_bytes", [True, False])
def test_rec_payload_layout_across_packages(asset_engines, fetch_bytes):
    """pack_rec / pack_rec_flip against ocrjax's packed recognition
    programs on the same rendered line strips: each package's unpack_rec
    and unpack_rec_flip read both."""
    import jax.numpy as jnp
    from ocrjax import api_det as JA
    from ocrjax.charset import Charset as JaxCharset
    from ocrjax.train import synth
    from ocrjax_torch import api_det as TA
    from ocrjax_torch import preprocess as tpre

    jeng, teng = asset_engines(fetch_bytes)
    cfg = teng.config
    T = cfg.rec_max_tokens
    cs = JaxCharset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    rng = np.random.RandomState(7)
    strips = np.full((8, cfg.rec_height, 128), 255, np.uint8)
    widths = np.zeros(8, np.int32)
    for i in range(8):
        s = synth.render_line(synth.random_text(rng, cs, 3, 9),
                              cfg.rec_height)
        widths[i] = min(s.shape[1], 128)
        strips[i, :, :widths[i]] = s[:, :widths[i]]
    x = tpre.rec_normalize(torch.from_numpy(strips), cfg.rec_mean,
                           cfg.rec_std)[:, 0]
    w = torch.from_numpy(widths)
    flip = np.array([0, 1, 0, 0, 1, 0, 0, 0], bool)

    pt = TA.pack_rec(teng, *TA.rec_strips(teng, x, w)).numpy()
    pj = np.asarray(JA._rec_strips_packed_jit(jeng, jnp.asarray(x.numpy()),
                                              jnp.asarray(widths)))
    ft = TA.pack_rec_flip(teng, *TA.rec_strips_forced_flip(
        teng, x, w, torch.from_numpy(flip))).numpy()
    fj = np.asarray(JA._rec_strips_forced_flip_packed_jit(
        jeng, jnp.asarray(x.numpy()), jnp.asarray(widths),
        jnp.asarray(flip)))
    for a, b, n in ((pt, pj, 5 if fetch_bytes else 2),
                    (ft, fj, 6 if fetch_bytes else 3)):
        assert a.shape == b.shape == (8, T + n) and a.dtype == b.dtype
    for unpack_t, unpack_j, a, b in (
            (TA.unpack_rec, JA.unpack_rec, pt, pj),
            (TA.unpack_rec_flip, JA.unpack_rec_flip, ft, fj)):
        for p in (a, b):
            for u, v in zip(unpack_t(p, T), unpack_j(p, T)):
                np.testing.assert_array_equal(u, v)
        got, want = unpack_t(a, T), unpack_j(b, T)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].max() > 0
        assert np.abs(got[2] - want[2]).max() <= SCORE_TOL
        if len(got) == 4:
            np.testing.assert_array_equal(got[3], want[3])
            np.testing.assert_array_equal(got[3], flip)


def test_det_payload_layout_across_packages(asset_engines, pages_512):
    """pack_det's rows against ocrjax's detector payload on the same
    canvases: unpack_det of either package reads both, valid slots equal,
    their boxes and scores at the goldens bar."""
    import jax.numpy as jnp
    from ocrjax import api_det as JA
    from ocrjax import preprocess as jpre
    from ocrjax_torch import api_det as TA
    from ocrjax_torch import preprocess as tpre

    jeng, teng = asset_engines()
    cfg = teng.config
    C = cfg.det_max_candidates
    packed = tpre.pack_for_upload(pages_512, cfg)
    pt = TA.pack_det(TA.det_state(teng).forward(
        torch.from_numpy(packed))[1]).numpy()
    st = JA._det_state(jeng)
    pj = np.asarray(st.forward(st.variables, jnp.asarray(
        jpre.pack_for_upload(pages_512, jeng.config)))[1])
    assert pt.shape == pj.shape == (2, C * 10) and pt.dtype == pj.dtype
    for p in (pt, pj):
        for u, v in zip(TA.unpack_det(p, C), JA.unpack_det(p, C)):
            np.testing.assert_array_equal(u, v)
    (bt, st_, vt), (bj, sj, vj) = TA.unpack_det(pt, C), JA.unpack_det(pj, C)
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() > 0
    assert np.abs(bt[vt] - bj[vj]).max() <= BOX_TOL
    assert np.abs(st_[vt] - sj[vj]).max() <= SCORE_TOL
