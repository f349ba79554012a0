"""How often the port's lanes refetch a truncated payload, against
ocrjax on the same pages (cfg.fetch_max_tokens, cfg.det_fetch_candidates;
see tests/test_torch_fetch_trunc.py for the truncations themselves).

Both engines run the shipped assets in float32 at det_max_side=512 on
two of the committed fixture pages (pages_960.npz, resized to 512):
at the defaults neither package refetches, and at short prefixes both
refetch the same fused chunks, pooled concats and candidate chunks. A
refetch costs a second copy and never a result: every result equals
that of whole fetches.
"""

import dataclasses

import numpy as np
import pytest

from ocrjax_torch.api import OcrEngine
from ocrjax_torch.ops import bytepack
from test_torch_fetch_trunc import _diff_results
from test_torch_fixture import PAGES, few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def fixture_pages():
    """Fixture pages 0 and 3, resized to 512 (no downscale in the lanes);
    their longest lines read 13 and 10 characters."""
    import cv2
    with np.load(PAGES) as f:
        pages = f["pages"]
    return [np.repeat(cv2.resize(pages[i], (512, 512),
                                 interpolation=cv2.INTER_AREA)[..., None],
                      3, axis=2) for i in (0, 3)]


def _engines(**over):
    from ocrjax.api import OcrEngine as JaxEngine
    from ocrjax.config import OcrConfig as JaxConfig
    from ocrjax_torch.api import asset_config
    cfg = asset_config(det_max_side=512, compute_dtype="float32", **over)
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**dataclasses.asdict(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


def _jax_refetches(monkeypatch):
    """Counts ocrjax's refetches by the unpack calls they make: a fused
    chunk unpacked at the full token width, a pooled concat unpacked at
    it, a candidate payload unpacked whole (fetch_det unpacks whole rows
    only on a refetch when it truncates)."""
    from ocrjax import api_det as JA
    from ocrjax import fused as JF
    seen = {"fused": [], "rec": [], "det": 0}
    real = {"fused": JF.unpack_fused, "rec": JA.unpack_rec,
            "det": JA.unpack_det}

    def fused(payload, K, max_tokens, try_flip=False):
        seen["fused"].append(max_tokens)
        return real["fused"](payload, K, max_tokens, try_flip)

    def rec(packed, max_tokens):
        seen["rec"].append(max_tokens)
        return real["rec"](packed, max_tokens)

    def det(packed, C):
        seen["det"] += 1
        return real["det"](packed, C)
    monkeypatch.setattr(JF, "unpack_fused", fused)
    monkeypatch.setattr(JA, "unpack_rec", rec)
    monkeypatch.setattr(JA, "unpack_det", det)
    return seen


@pytest.mark.parametrize("over", [
    dict(),
    dict(fetch_max_tokens=12, det_fetch_candidates=6, fused_chunk_pages=1)])
def test_refetch_counts_equal_ocrjax(fixture_pages, monkeypatch, over):
    """The fused and pooled lanes: as many fused chunks, pooled concats
    and candidate chunks refetched as ocrjax refetches (none at the
    defaults; at a 12-token prefix and a page a chunk, page 0's chunk
    only), and the same results as with whole fetches."""
    pages = fixture_pages
    jeng, teng = _engines(**over)
    cfg = teng.config
    T = cfg.rec_max_tokens
    seen = _jax_refetches(monkeypatch)
    jeng.ocr_batch(pages, fused=True)
    jeng.ocr_batch(pages, fused=False)
    want = {"fused_fetch": sum(t == T for t in seen["fused"]),
            "rec_fetch_decode": int(T in seen["rec"]),
            "det_fetch": seen["det"]}
    bytepack.refetches.clear()
    got_f = teng.ocr_batch(pages, fused=True)
    got_b = teng.ocr_batch(pages, fused=False)
    assert {k: bytepack.refetches[k] for k in want} == want
    assert seen["fused"].count(cfg.fetch_max_tokens) == \
        len(pages) // min(cfg.fused_chunk_pages, len(pages))
    if over:
        assert want == {"fused_fetch": 1, "rec_fetch_decode": 1,
                        "det_fetch": want["det_fetch"]}
        assert want["det_fetch"] > 0
    else:
        assert want == {"fused_fetch": 0, "rec_fetch_decode": 0,
                        "det_fetch": 0}
    whole = OcrEngine.from_pretrained(
        config=cfg.replace(fetch_max_tokens=0, det_fetch_candidates=0),
        device="cpu")
    _diff_results(got_f, whole.ocr_batch(pages, fused=True))
    _diff_results(got_b, whole.ocr_batch(pages, fused=False))
