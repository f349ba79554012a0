"""Public API of the port: OcrEngine and its result types (port of
ocrjax/api.py): recognize / recognize_strips, detect, ocr and ocr_batch on
the fused, staged and bucketed lanes, greedy CTC.

The engine runs on the card unless the caller asks for the CPU: the default
device is "cuda", and constructing it without CUDA raises. Options that
later slices port (beam CTC, rec_try_flip, det_int8, rec_dewarp_curl) raise
NotImplementedError instead of answering differently from the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from ocrjax_torch import preprocess, weights as W
from ocrjax_torch.charset import Charset, default_charset
from ocrjax_torch.config import OcrConfig
from ocrjax_torch.models.cls import create_cls
from ocrjax_torch.models.crnn import create_crnn
from ocrjax_torch.models.db import create_db

ImageLike = preprocess.ImageLike
Flat = Mapping[str, np.ndarray]   # flax path -> array, as weights reads it


@dataclasses.dataclass
class RecResult:
    """One recognized text line."""
    text: str
    confidence: float
    flipped: bool = False


@dataclasses.dataclass
class DetBox:
    """A detected text region: 4 corners (x, y) in original image coords,
    clockwise from top-left, and the mean prob-map score."""
    quad: np.ndarray
    score: float


@dataclasses.dataclass
class OcrLine:
    box: DetBox
    text: str
    confidence: float


@dataclasses.dataclass
class OcrResult:
    lines: List[OcrLine]
    # True when the page saturated the fused lane's line capacity
    # (ocr_pages_fused then redoes it on the bucketed lane)
    truncated: bool = False

    @property
    def text(self) -> str:
        return "\n".join(line.text for line in self.lines)


ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def asset_config(path: str = None, metas=None, **overrides) -> OcrConfig:
    """The OcrConfig that from_pretrained builds when given none: the
    `config` metadata of rec.safetensors, then det.safetensors, then
    `overrides` (e.g. compute_dtype="float32")."""
    if metas is None:
        path = path or ASSETS
        metas = [W.read_safetensors(p)[1] for p in (
            os.path.join(path, f"{n}.safetensors") for n in ("rec", "det"))
            if os.path.exists(p)]
    cfg = {}
    for meta in metas:
        if "config" in meta:
            cfg.update(json.loads(meta["config"]))
    cfg.update(overrides)
    return OcrConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in cfg.items()})


def _refuse_unported(cfg: OcrConfig) -> None:
    for flag, where in [("rec_try_flip", "orientation"),
                        ("det_int8", "opt-in paths"),
                        ("rec_dewarp_curl", "opt-in paths")]:
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{flag}=True is not ported yet (ROADMAP.md: {where})")


def _build(module: torch.nn.Module, sd, seed: int, device) -> torch.nn.Module:
    if sd is None:
        W.init_random_(module, seed)
    else:
        W.load_into(module, sd)
    return module.to(device).eval()


class OcrEngine:
    """Owns the config, charset, models and weights on one device.

    rec_weights / det_weights / cls_weights: flax-layout {path: array}
    dicts (weights.read_safetensors); None gives random weights from
    `seed`.
    """

    def __init__(self, config: Optional[OcrConfig] = None,
                 charset: Optional[Charset] = None,
                 rec_weights: Optional[Flat] = None,
                 det_weights: Optional[Flat] = None,
                 cls_weights: Optional[Flat] = None,
                 device: str = "cuda", seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available: pass device='cpu' to run the "
                    "port on the CPU")
            # true float32 everywhere: the moments product and the warp
            # matmuls must not round to TF32, and fp32 runs are held to
            # the reference's numbers
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {device!r}")
        self.config = config or OcrConfig()
        _refuse_unported(self.config)
        self.charset = charset or default_charset()
        cfg = self.config
        det_arch = dict(channels=(64, 128, 256, 512), blocks_per_stage=2,
                        head_stride=cfg.det_head_stride)
        self.rec_model = _build(
            create_crnn(cfg, self.charset.num_classes),
            rec_weights and W.crnn_state_dict(rec_weights)[0], seed,
            self.device)
        self.det_model = _build(
            create_db(cfg),
            det_weights and W.db_state_dict(det_weights, det_arch)[0],
            seed + 1, self.device)
        self.cls_model = _build(
            create_cls(cfg), cls_weights and W.cls_state_dict(cls_weights)[0],
            seed + 2, self.device)
        self._fused_cache = {}
        self._det = None   # api_det.DetState, built by the staged lanes

    @classmethod
    def from_pretrained(cls, path: str = None, config: OcrConfig = None,
                        device: str = "cuda", seed: int = 0) -> "OcrEngine":
        """Loads `<path>/{rec,det,cls}.safetensors` and `rec.charset.txt`
        (the repo's assets/ by default); a missing file gives random
        weights for that stage. Without `config`, the `config` metadata of
        rec and then det builds it."""
        path = path or ASSETS
        loaded = {}
        for name in ("rec", "det", "cls"):
            p = os.path.join(path, f"{name}.safetensors")
            loaded[name] = W.read_safetensors(p) if os.path.exists(p) \
                else (None, {})
        cs_p = os.path.join(path, "rec.charset.txt")
        charset = Charset.from_file(cs_p) if os.path.exists(cs_p) else None
        if config is None:
            config = asset_config(path, [loaded["rec"][1], loaded["det"][1]])
        return cls(config=config, charset=charset,
                   rec_weights=loaded["rec"][0], det_weights=loaded["det"][0],
                   cls_weights=loaded["cls"][0], device=device, seed=seed)

    @staticmethod
    def _refuse_beam(beam: bool) -> None:
        if beam:
            raise NotImplementedError("beam CTC is not ported yet "
                                      "(ROADMAP.md: beam CTC)")

    def _rec_step(self, batch_u8: torch.Tensor, widths: torch.Tensor):
        """normalize -> CRNN -> greedy CTC over a (N, H, W) uint8 batch."""
        from ocrjax_torch.api_det import rec_strips
        cfg = self.config
        with torch.inference_mode():
            x = preprocess.rec_normalize(batch_u8, cfg.rec_mean, cfg.rec_std)
        return rec_strips(self, x[:, 0], widths)

    def recognize_strips(self, strips: Sequence[np.ndarray],
                         beam: bool = False) -> List[RecResult]:
        """Batched recognition of pre-cropped uint8 line strips of any
        size: resized to the rec height on the host, zero-padded to one
        width bucket and the count bucket, one device call. (The
        reference's same_page / prior_ids arguments group strips for the
        orientation stage, which is not ported yet.)"""
        self._refuse_beam(beam)
        if len(strips) == 0:
            return []
        cfg = self.config
        resized = [preprocess.rec_resize(
            preprocess.to_gray(np.asarray(s)), cfg.rec_height)
            for s in strips]
        n = len(resized)
        batch, widths = preprocess.pad_strips_to_bucket(resized, cfg)
        nb = cfg.line_bucket_for_count(n)
        if nb > n:  # pad the batch axis to the count bucket
            batch = np.concatenate(
                [batch, np.zeros((nb - n,) + batch.shape[1:], batch.dtype)])
            widths = np.concatenate(
                [widths, np.full((nb - n,), batch.shape[2], np.int32)])
        from ocrjax_torch.api_det import upload
        tokens, n_tokens, conf = (t.cpu().numpy() for t in self._rec_step(
            upload(self, batch), upload(self, widths)))
        return [RecResult(self.charset.decode(tokens[i][: n_tokens[i]]),
                          float(conf[i])) for i in range(n)]

    def recognize(self, image: ImageLike, beam: bool = False) -> RecResult:
        """One pre-cropped text-line image -> one string."""
        img = preprocess.load_image(image,
                                    auto_invert=self.config.auto_invert)
        return self.recognize_strips([img], beam=beam)[0]

    def detect(self, image: ImageLike) -> List[DetBox]:
        """Full page -> boxes in original image coords, reading order."""
        from ocrjax_torch import api_det
        return api_det.detect(self, image)

    def ocr(self, image: ImageLike, beam: bool = False) -> OcrResult:
        """One page -> ordered text lines: the fused lane for a page that
        fits the canvas (cfg.ocr_single_fused), else the staged lane with
        full-resolution crops."""
        self._refuse_beam(beam)
        from ocrjax_torch import api_det
        return api_det.ocr(self, image)

    def ocr_batch(self, images: Sequence[ImageLike], beam: bool = False,
                  fused: bool = False) -> List[OcrResult]:
        """Batched page OCR: fused=True runs the fused lane (fixed line
        capacity per page, reroutes inside), else the pooled bucketed
        lane."""
        self._refuse_beam(beam)
        if fused:
            from ocrjax_torch import fused as F
            return F.ocr_pages_fused(self, images)
        from ocrjax_torch import api_det
        return api_det.ocr_batch(self, images)
