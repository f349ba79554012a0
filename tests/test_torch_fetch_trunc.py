"""The port's truncated first fetches (cfg.fetch_max_tokens,
cfg.det_fetch_candidates), case for case as tests/test_fetch_trunc.py holds
ocrjax's, and against ocrjax where the two must agree.

Both truncations are transport only and exact: the token slice drops only
CTC padding (the whole payload, still on the device, is refetched where a
line has more tokens), and the candidate slice is a prefix of the slots,
which extract_boxes fills in ascending raster root order (refetched where
a page used a later slot). Every parity case runs the same inputs
truncated and whole and compares the host results exactly, including the
settings that force the refetch on every chunk. The reference's
end-to-end cases are `slow` there; here they run at its small size (the
TINY config, 256-pixel pages).

On the shipped assets in float32 at det_max_side=512: the bytes the
fused lane copies, K1's slot order on real pages, and the tiled latch's
states on a dense-then-sparse stream against ocrjax's
(tests/test_torch_fetch_counts.py holds the refetch counts to ocrjax's).
"""

import os

import numpy as np
import pytest
import torch

from ocrjax_torch.api import OcrEngine
from ocrjax_torch.charset import default_charset
from ocrjax_torch.config import TINY
from ocrjax_torch.ops import bytepack
from ocrjax_torch.ops.bytepack import truncate_tokens
from test_torch_fixture import (  # noqa: F401
    PAGES, few_torch_threads, jax_fields)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_truncate_tokens_slice_both_dtypes():
    import jax.numpy as jnp
    from ocrjax.ops.bytepack import truncate_tokens_jit
    rng = np.random.RandomState(0)
    K, T, T_f, rest = 3, 16, 5, 7
    for dt in (np.uint8, np.float32):
        payload = rng.randint(0, 200, size=(4, K * T + rest)).astype(dt)
        got = truncate_tokens(torch.from_numpy(payload), K, T, T_f).numpy()
        tok = payload[:, :K * T].reshape(4, K, T)[:, :, :T_f]
        want = np.concatenate(
            [tok.reshape(4, K * T_f), payload[:, K * T:]], axis=1)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == dt
        np.testing.assert_array_equal(got, np.asarray(truncate_tokens_jit(
            jnp.asarray(payload), K, T, T_f)))


def test_truncate_det_prefix_and_n_need():
    import jax.numpy as jnp
    from ocrjax.api_det import _truncate_det_jit
    from ocrjax_torch.api_det import pack_det, truncate_det

    rng = np.random.RandomState(1)
    B, C, Kf = 2, 8, 3
    out = {"boxes": torch.from_numpy(rng.randn(B, C, 4, 2)
                                     .astype(np.float32)),
           "scores": torch.from_numpy(rng.rand(B, C).astype(np.float32)),
           "valid": torch.tensor([[1, 1, 0, 0, 0, 0, 0, 0],
                                  [1, 0, 1, 0, 1, 0, 0, 0]], dtype=torch.bool)}
    packed = pack_det(out)
    arr = truncate_det(packed, C, Kf).numpy()
    assert arr.shape == (B, Kf * 10 + 1)
    np.testing.assert_array_equal(
        arr[:, :Kf * 8], out["boxes"].numpy()[:, :Kf].reshape(B, Kf * 8))
    np.testing.assert_array_equal(arr[:, Kf * 8:Kf * 9],
                                  out["scores"].numpy()[:, :Kf])
    # highest USED slot: page 0 used slots {0,1} -> 2; page 1 up to 4 -> 5
    np.testing.assert_array_equal(arr[:, Kf * 10], [2.0, 5.0])
    np.testing.assert_array_equal(
        arr, np.asarray(_truncate_det_jit(jnp.asarray(packed.numpy()),
                                          C, Kf)))


def test_fetch_det_saturation_latch():
    """Dense streams flip the adapt latch to whole-row fetches after one
    overflow; a sparse page under Kf / 2 used slots resets it. Outputs
    stay exact in every phase."""
    from ocrjax_torch.api_det import fetch_det, pack_det, unpack_det

    rng = np.random.RandomState(7)
    C, Kf = 8, 4
    cfg = TINY.replace(det_max_candidates=C, det_fetch_candidates=Kf)

    def payload(n_used):
        v = np.zeros((1, C), bool)
        v[0, :n_used] = True
        return pack_det({"boxes": torch.from_numpy(
            rng.randn(1, C, 4, 2).astype(np.float32)),
            "scores": torch.from_numpy(rng.rand(1, C).astype(np.float32)),
            "valid": torch.from_numpy(v)})

    def check(p):
        got = fetch_det([p], cfg, adapt=adapt)
        for g, w in zip(got, unpack_det(p.numpy(), C)):
            np.testing.assert_array_equal(g, w)

    adapt = {}
    check(payload(6))   # > Kf: overflow
    assert adapt.get("full") is True
    check(payload(5))   # whole rows first; > Kf / 2 keeps the latch on
    assert adapt.get("full") is True
    check(payload(2))   # <= Kf / 2: the latch resets
    assert adapt.get("full") is False


def _engine(**over) -> OcrEngine:
    cfg = TINY.replace(det_max_side=256, det_box_thresh=0.45, **over)
    return OcrEngine(config=cfg, charset=default_charset(), seed=0,
                     device="cpu")


@pytest.fixture(scope="module")
def pages():
    from ocrjax_torch.train.synth import render_page
    rng = np.random.RandomState(5)
    out = []
    for _ in range(3):
        img, _, _ = render_page(rng, default_charset(), size=(256, 256))
        out.append(np.repeat(img[..., None], 3, axis=2))
    return out


def _diff_results(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [line.text for line in a.lines] == \
            [line.text for line in b.lines]
        assert [line.confidence for line in a.lines] == \
            [line.confidence for line in b.lines]
        for la, lb in zip(a.lines, b.lines):
            np.testing.assert_array_equal(la.box.quad, lb.box.quad)
            assert la.box.score == lb.box.score


# the production default, and the floors that force the refetch on every
# page and line
_TRUNC_CASES = [dict(), dict(fetch_max_tokens=2, det_fetch_candidates=1)]


@pytest.mark.parametrize("over", _TRUNC_CASES)
def test_fused_path_parity(pages, over):
    from ocrjax_torch.fused import ocr_pages_fused

    et = _engine(**over)
    assert et.config.fetch_max_tokens and et.config.det_fetch_candidates
    ef = _engine(fetch_max_tokens=0, det_fetch_candidates=0)
    _diff_results(ocr_pages_fused(et, pages), ocr_pages_fused(ef, pages))


@pytest.mark.parametrize("over", _TRUNC_CASES)
def test_pooled_path_parity(pages, over):
    from ocrjax_torch.bucketing import ocr_pages

    et = _engine(**over)
    ef = _engine(fetch_max_tokens=0, det_fetch_candidates=0)
    _diff_results(ocr_pages(et, pages), ocr_pages(ef, pages))


def test_detect_and_single_page_parity(pages):
    et = _engine(det_fetch_candidates=1, fetch_max_tokens=2)
    ef = _engine(det_fetch_candidates=0, fetch_max_tokens=0)
    bt = et.detect(pages[0])
    bf = ef.detect(pages[0])
    assert len(bt) == len(bf) > 0
    for a, b in zip(bt, bf):
        np.testing.assert_array_equal(a.quad, b.quad)
        assert a.score == b.score
    _diff_results([et.ocr(pages[0])], [ef.ocr(pages[0])])


def test_tiled_path_parity(pages):
    from ocrjax_torch.tiling import ocr_tiled

    et = _engine(det_fetch_candidates=1, fetch_max_tokens=2)
    ef = _engine(det_fetch_candidates=0, fetch_max_tokens=0)
    _diff_results([ocr_tiled(et, pages[0])], [ocr_tiled(ef, pages[0])])


# --- against ocrjax, on the shipped assets ----------------------------------

@pytest.fixture(scope="module")
def fixture_pages():
    """The committed fixture pages (pages_960.npz), resized to 512 so the
    lanes run at det_max_side=512 without a downscale."""
    import cv2
    with np.load(PAGES) as f:
        pages = f["pages"]
    return [np.repeat(cv2.resize(p, (512, 512),
                                 interpolation=cv2.INTER_AREA)[..., None],
                      3, axis=2) for p in pages]


def _engines(**over):
    from ocrjax.api import OcrEngine as JaxEngine
    from ocrjax.config import OcrConfig as JaxConfig
    from ocrjax_torch.api import asset_config
    cfg = asset_config(det_max_side=512, compute_dtype="float32", **over)
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**jax_fields(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


@pytest.mark.parametrize("fetch_bytes", [True, False])
def test_fused_lane_copies_the_formula_bytes(fixture_pages, fetch_bytes):
    """add_bytes of fused_fetch: K * (T' + 42) bytes a page as bytes,
    4 * K * (T' + 12) as float32 (T' = fetch_max_tokens), the first fetch
    of every chunk and nothing more where no line passes T'; at a 4-token
    prefix every chunk also refetches its T-wide rows."""
    from ocrjax_torch.utils.profiling import StageTimer
    _, teng = _engines(fetch_bytes=fetch_bytes, fused_chunk_pages=2)
    cfg = teng.config
    K, T, B = cfg.fused_lines_per_page, cfg.rec_max_tokens, 4

    def row(t):
        return K * (t + 42) if fetch_bytes else 4 * K * (t + 12)
    for t_f, full in ((48, 0), (4, 2)):
        teng.config = cfg.replace(fetch_max_tokens=t_f)
        timer = StageTimer("cpu")
        bytepack.refetches.clear()
        with timer.active():
            teng.ocr_batch(fixture_pages, fused=True)
        assert bytepack.refetches["fused_fetch"] == full
        assert timer.bytes["fused_fetch"] == B * row(t_f) + full * 2 * row(T)
        assert timer.host_report(calls=True)["fused_fetch"]["mb"] == round(
            timer.bytes["fused_fetch"] / 2**20, 2)


def test_det_slots_fill_a_prefix_in_root_order(fixture_pages):
    """K1's labels on real pages: extract_boxes' slot k holds the
    component with the k-th smallest root (min linear index), so the used
    slots are a prefix as long as the component count and every valid
    slot lies below n_need; a prefix of exactly n_need slots fetches
    every valid candidate without a refetch."""
    from ocrjax_torch import api_det, preprocess
    from ocrjax_torch.api_det import fetch_det, pack_det, truncate_det
    from ocrjax_torch.ops.cc_label import label_components
    from ocrjax_torch.postprocess import db_boxes
    _, teng = _engines()
    cfg = teng.config
    C, d = cfg.det_max_candidates, cfg.det_cc_downsample
    grays = np.stack([preprocess.to_gray(p) for p in fixture_pages])
    prob, cand = api_det.det_state(teng).forward(
        torch.from_numpy(preprocess.pack_for_upload(grays, cfg)))
    kw = db_boxes.static_kwargs_from_config(cfg)
    assert kw["cc_downsample"] == d
    fg = prob > cfg.det_thresh
    B, H, W = fg.shape
    fg_c = fg.reshape(B, H // d, d, W // d, d).any(dim=4).any(dim=2)
    labels = label_components(fg_c, cfg.det_cc_iters).reshape(B, -1)
    lin = torch.arange(labels.shape[1], dtype=labels.dtype)
    packed = pack_det(cand)
    n_need = truncate_det(packed, C, 1)[:, -1].numpy()
    valid, scores = cand["valid"].numpy(), cand["scores"].numpy()
    fg_s, prob_s = fg[:, ::d, ::d].reshape(B, -1), prob[:, ::d, ::d]
    for b in range(B):
        roots = torch.nonzero((labels[b] == lin) & fg_c[b].reshape(-1))[:, 0]
        assert valid[b].sum() > 0
        assert n_need[b] <= min(len(roots), C)
        for k in np.nonzero(valid[b])[0]:
            mine = fg_s[b] & (labels[b] == roots[k])
            assert scores[b, k] == pytest.approx(
                float(prob_s[b].reshape(-1)[mine].mean()), abs=1e-5)
    Kf = int(n_need.max())
    if Kf < C:
        bytepack.refetches.clear()
        got = fetch_det([packed], cfg.replace(det_fetch_candidates=Kf))
        assert bytepack.refetches["det_fetch"] == 0
        b, sc, v = api_det.unpack_det(packed.numpy(), C)
        np.testing.assert_array_equal(got[2], v)
        np.testing.assert_array_equal(got[0][v], b[v])
        np.testing.assert_array_equal(got[1][v], sc[v])


def test_tiled_latch_states_as_ocrjax():
    """A dense page overflows a 16-slot prefix and flips the engine's
    latch to whole-row fetches; a sparse page resets it. Over a stream of
    detect_tiled calls the port's latch reads as ocrjax's after every
    call; ocr_tiled (the windowed lane's one fetch for all tile groups)
    moves it the same way; every result is that of whole fetches."""
    from ocrjax.charset import Charset as JaxCharset
    from ocrjax.train import synth
    cs = JaxCharset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    dense = synth.render_page_dense(np.random.RandomState(601), cs,
                                    size=(768, 512), n_lines=40,
                                    text_height=(14, 18))[0]
    sparse = synth.render_page(np.random.RandomState(101), cs,
                               size=(768, 512), n_lines=(2, 3),
                               text_height=(22, 30))[0]
    over = dict(tile_size=512, tile_overlap=64, det_fetch_candidates=16)
    jeng, teng = _engines(**over)
    whole = OcrEngine.from_pretrained(
        config=teng.config.replace(det_fetch_candidates=0), device="cpu")
    states = {"port": [], "ocrjax": []}
    for page in (dense, sparse, dense, sparse):
        got = teng.detect_tiled(page)
        jeng.detect_tiled(page)
        states["port"].append(teng._det_fetch_adapt.get("full"))
        states["ocrjax"].append(jeng._det_fetch_adapt.get("full"))
        want = whole.detect_tiled(page)
        assert [b.quad.tolist() for b in got] == \
            [b.quad.tolist() for b in want]
    assert states["port"] == states["ocrjax"] == [True, False, True, False]
    for page, full in ((dense, True), (sparse, False)):
        got = teng.ocr_tiled(page)
        assert teng._det_fetch_adapt.get("full") is full
        _diff_results([got], [whole.ocr_tiled(page)])
