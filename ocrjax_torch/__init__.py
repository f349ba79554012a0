"""ocrjax_torch — the PyTorch/CUDA port of ocrjax for NVIDIA Hopper.

Same two-stage OCR (DB detection, CRNN + CTC recognition) and the same
shipped weights, in PyTorch; each TPU kernel of ocrjax becomes a kernel
written by hand for Hopper (csrc/). The package imports nothing of ocrjax
or JAX. Module names mirror ocrjax's so each counterpart is easy to find.
"""

from ocrjax_torch.charset import Charset
from ocrjax_torch.config import OcrConfig

__version__ = "0.1.0"


_API = ("OcrEngine", "get_default_engine", "detect", "recognize", "ocr")


def __getattr__(name):
    # Lazy: the models load only when the engine is used; the default
    # engine of detect / recognize / ocr is built on their first call.
    if name in _API:
        from ocrjax_torch import api

        return getattr(api, name)
    raise AttributeError(f"module 'ocrjax_torch' has no attribute {name!r}")


__all__ = ["OcrConfig", "Charset", *_API, "__version__"]
