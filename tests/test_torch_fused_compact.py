"""The fused lane's occupied-slot compaction (ocrjax_torch/fused.py) on
the CPU, with the shipped assets in float32 at 256-pixel pages and the
line-count buckets (4, 8).

FusedOcr's first program warps every line slot and counts the occupied
ones; its second runs the CRNN and CTC on the occupied slots alone,
gathered at their count bucket, in passes of the largest bucket where
more are occupied. Held here: (a) every occupied slot reads what the
CRNN and CTC read over all of the first program's strips (tokens and
counts exactly, confidences within 1e-6) and every empty slot reads 0;
(b) the rows recognized are the count's bucket, or the passes of a count
past the largest bucket; (c) a page whose K slots are all occupied
recognizes all K and still goes to the bucketed redo as truncated;
(d) ocr_pages_fused over three chunks, which reads each chunk's count
once the next chunk is packed, returns the rows of per-chunk FusedOcr
calls, op by op and through replayed programs.
"""

import os

import numpy as np
import pytest
import torch

from ocrjax_torch import bucketing, fused, graphs, preprocess
from ocrjax_torch.api import OcrEngine, OcrResult, asset_config
from ocrjax_torch.api_det import crnn_decode, upload_thresholds
from ocrjax_torch.charset import Charset
from ocrjax_torch.ops import bytepack
from ocrjax_torch.train import synth
from test_torch_fixture import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256


@pytest.fixture(scope="module")
def eng():
    cfg = asset_config(det_max_side=SIZE, compute_dtype="float32",
                       fused_chunk_pages=2, line_batch_buckets=(4, 8))
    return OcrEngine.from_pretrained(config=cfg, device="cpu")


def _pages(seeds, n_lines):
    cs = Charset.from_file(os.path.join(ROOT, "assets", "rec.charset.txt"))
    out = []
    for seed in seeds:
        g = synth.render_page(np.random.RandomState(seed), cs,
                              size=(SIZE, SIZE), n_lines=n_lines,
                              text_height=(16, 22))[0]
        out.append(np.repeat(g[..., None], 3, 2))
    return out


@pytest.fixture(scope="module")
def sparse():
    """Five pages of 2-4 lines: chunks of 2 pages hold 4-8 lines."""
    return _pages((21, 22, 23, 24, 25), (2, 4))


@pytest.fixture(scope="module")
def dense():
    """Two pages of 6-8 lines: a 2-page chunk holds more than 8."""
    return _pages((31, 32), (6, 8))


def _inputs(eng, pages):
    cfg = eng.config
    grays, _, valid_hw, _, _ = preprocess.decode_chunk_to_gray(
        pages, range(len(pages)), cfg)
    return (torch.from_numpy(preprocess.pack_for_upload(grays, cfg)),
            torch.from_numpy(valid_hw[:, ::-1].astype(np.float32).copy()))


def _rows(fp, eng, pages):
    """(the first program's outputs, the count, the rows recognized, the
    unpacked payload) of one chunk."""
    up, wh = _inputs(eng, pages)
    det = fp.detect(up, upload_thresholds(eng), wh)
    n_valid = fp.count(det)
    before = fused.slot_counts["recognized"]
    payload = fp.recognize(det, n_valid).numpy()
    rows = fused.slot_counts["recognized"] - before
    out = fused.unpack_fused(payload, fp.K, eng.config.rec_max_tokens,
                             eng.config.rec_try_flip)
    return det[0], n_valid, rows, out


def _check_against_all_slots(eng, first, out):
    """(a): the occupied slots against crnn_decode over every slot's
    strip; the empty slots 0."""
    strips, widths, valid = first[0], first[1], out["valid"]
    B, K = valid.shape
    with torch.inference_mode():
        tokens, n_tokens, conf = (t.numpy() for t in crnn_decode(
            eng, strips, widths))
    v = valid.reshape(-1)
    assert v.any()
    np.testing.assert_array_equal(
        out["tokens"].reshape(B * K, -1)[v], tokens[v])
    np.testing.assert_array_equal(out["n_tokens"].reshape(-1)[v],
                                  n_tokens[v])
    np.testing.assert_allclose(out["conf"].reshape(-1)[v], conf[v],
                               atol=1e-6, rtol=0)
    assert (n_tokens[v] > 0).any()
    for k in ("tokens", "n_tokens", "conf"):
        assert not out[k][~valid].any(), k


@pytest.mark.parametrize("which", ["sparse", "dense"])
def test_occupied_slots_read_as_every_slot_recognized(eng, sparse, dense,
                                                      which):
    """(a) and (b): a chunk of 4-8 occupied slots recognizes its bucket's
    rows; one past the largest bucket (8) recognizes in passes of 8 and
    the rest at its bucket, and reads the same."""
    pages = sparse[:2] if which == "sparse" else dense
    fp = fused.FusedOcr(eng, 12, 64)
    first, n_valid, rows, out = _rows(fp, eng, pages)
    assert n_valid == int(out["valid"].sum())
    cfg = eng.config
    if which == "sparse":
        assert 0 < n_valid <= 8
        assert rows == cfg.line_bucket_for_count(n_valid)
        assert fused.rec_row_chunks(cfg, n_valid, 24) == (rows,)
    else:
        assert 8 < n_valid <= 16
        want = (8, cfg.line_bucket_for_count(n_valid - 8))
        assert fused.rec_row_chunks(cfg, n_valid, 24) == want
        assert rows == sum(want)
    _check_against_all_slots(eng, first, out)


def test_row_chunks_stay_within_the_slots(eng):
    cfg = eng.config
    assert fused.rec_row_chunks(cfg, 0, 16) == ()
    assert fused.rec_row_chunks(cfg, 3, 16) == (4,)
    assert fused.rec_row_chunks(cfg, 5, 16) == (8,)
    assert fused.rec_row_chunks(cfg, 17, 32) == (8, 8, 4)
    assert fused.rec_row_chunks(cfg, 5, 6) == (6,)      # every slot
    assert fused.rec_row_chunks(cfg, 10, 10) == (8, 2)


def test_a_page_with_every_slot_occupied(eng, dense, monkeypatch):
    """(c): K = 4 slots on a page of 6-8 lines: all 4 recognized, all
    read as over all slots, and the page goes to the bucketed redo as
    truncated."""
    K = 4
    fp = fused.FusedOcr(eng, K, 64)
    first, n_valid, rows, out = _rows(fp, eng, dense[:1])
    assert n_valid == rows == K and out["valid"].all()
    _check_against_all_slots(eng, first, out)
    redone = []

    def bucketed(engine, images, beam=False):
        redone.extend(images)
        return [OcrResult(lines=[], truncated=True) for _ in images]

    monkeypatch.setattr(bucketing, "ocr_pages", bucketed)
    res = fused.ocr_pages_fused(eng, dense[:1], lines_per_page=K)
    assert len(redone) == 1 and res[0].truncated


@pytest.mark.parametrize("route", ["eager", "graphed"])
def test_three_chunks_match_per_chunk_calls(eng, sparse, monkeypatch,
                                            route):
    """(d): five pages in chunks of 2, 2, 1. The lane packs chunk k + 1
    before it reads chunk k's count and recognizes chunk k, then detects
    chunk k + 1; each chunk's rows equal a FusedOcr call on it alone.
    "graphed": through the stand-in graphs of tests/test_torch_graphs.py,
    so that every chunk's detection replays over the last one's outputs."""
    from test_torch_graphs import StandInBackend
    if route == "graphed":
        monkeypatch.setitem(graphs.BACKENDS, "cpu", StandInBackend())
    K, W = 8, 64
    cfg = eng.config
    T = cfg.rec_max_tokens
    steps, got = [], []
    pack, unpack = preprocess.pack_for_upload, fused.unpack_fused
    fp = fused._fused_for(eng, K, W, False)

    def spy(name, fn):
        def run(*a, **k):
            steps.append(name)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(preprocess, "pack_for_upload", spy("pack", pack))
    for name in ("detect", "count", "recognize"):
        monkeypatch.setattr(fp, name, spy(name, getattr(fp, name)))

    def keep(payload, *a, **k):
        got.append(payload.copy())
        return unpack(payload, *a, **k)

    monkeypatch.setattr(fused, "unpack_fused", keep)
    fused.ocr_pages_fused(eng, sparse, lines_per_page=K, bucket_width=W)
    assert steps == ["pack", "detect",
                     "pack", "count", "recognize", "detect",
                     "pack", "count", "recognize", "detect",
                     "count", "recognize"]
    monkeypatch.undo()
    plain = fused.FusedOcr(eng, K, W)
    assert len(got) == 3
    for (lo, hi), rows in zip([(0, 2), (2, 4), (4, 5)], got):
        up, wh = _inputs(eng, sparse[lo:hi])
        want = plain(up, upload_thresholds(eng), wh).numpy()
        T_f = cfg.fetch_max_tokens if 0 < cfg.fetch_max_tokens < T else T
        if rows.shape != want.shape:          # the first fetch's columns
            want = bytepack.truncate_tokens(
                torch.from_numpy(want), K, T, T_f).numpy()
        np.testing.assert_array_equal(rows, want)


def test_cli_profile_prints_the_recognized_share(sparse, tmp_path):
    """The counter's reader: the CLI's --profile prints the slots the
    fused lane recognized after the run."""
    import contextlib
    import io
    import re

    import cv2

    from ocrjax_torch import cli
    from ocrjax_torch.config import OcrConfig
    paths = []
    for i, page in enumerate(sparse[:2]):
        paths.append(str(tmp_path / f"p{i}.png"))
        cv2.imwrite(paths[-1], page)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["ocr", *paths, "--fused", "--cpu", "--det-max-side",
                       str(SIZE), "--profile", str(tmp_path / "prof")])
    assert rc == 0
    m = re.search(r"fused slots: (\d+) of 64 recognized \(([\d.]+)%\), "
                  r"(\d+) occupied, 1 chunks", err.getvalue())
    assert m, err.getvalue()
    rows, occupied = int(m[1]), int(m[3])
    assert 0 < occupied <= rows == OcrConfig().line_bucket_for_count(
        occupied)
    assert float(m[2]) == round(100 * rows / 64, 1)
