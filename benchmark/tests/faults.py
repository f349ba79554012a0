"""Faults planted under a run's timed path (small.run(fault=...)): each
breaks what the program returns where it is produced, and the check must
read the run as not correct."""

from __future__ import annotations


def half_pages(engine):
    """Half of each call's pages come back empty, as if the batch had been
    cut in two and only one half computed."""
    from ocrjax_torch.api import OcrResult
    for name in ("ocr_batch", "ocr_tiled_batch"):
        def cut(images, *a, _orig=getattr(engine, name), **kw):
            return [r if k % 2 == 0 else OcrResult(lines=[])
                    for k, r in enumerate(_orig(images, *a, **kw))]
        setattr(engine, name, cut)
    calls = [0]

    def ocr(image, *a, _orig=engine.ocr, **kw):
        calls[0] += 1
        r = _orig(image, *a, **kw)
        return r if calls[0] % 2 else OcrResult(lines=[])
    engine.ocr = ocr


def altered_token(engine):
    """Every decoded line's first token moves to the next class, inside
    the greedy CTC decode that produces it."""
    import torch

    from ocrjax_torch.ops import ctc
    orig = ctc.ctc_greedy_decode

    def decode(logits, lengths, **kw):
        tokens, n_tokens, conf = orig(logits, lengths, **kw)
        classes = logits.shape[-1]
        first = tokens[:, :1] % (classes - 1) + 1
        tokens = torch.cat([torch.where(n_tokens[:, None] > 0, first,
                                        tokens[:, :1]), tokens[:, 1:]], 1)
        return tokens, n_tokens, conf
    ctc.ctc_greedy_decode = decode
