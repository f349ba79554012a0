"""Public API of the port: OcrEngine and its result types (port of
ocrjax/api.py): recognize / recognize_strips, detect, ocr and ocr_batch on
the fused, staged and bucketed lanes, the tiled lanes for high-resolution
pages (detect_tiled, ocr_tiled, ocr_tiled_batch), greedy or beam CTC, and
the orientation stage (rec_try_flip), and the opt-in paths: int8
detection (det_int8), curved-baseline dewarp (rec_dewarp_curl) and the
flat-band case gate (rec_flat_case_gate).

The engine runs on the card unless the caller asks for the CPU: the default
device is "cuda", and constructing it without CUDA raises.
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
from ocrjax_torch.models.svtr import create_svtr
from ocrjax_torch.utils.logging import get_logger, log_fields
from ocrjax_torch.utils.profiling import entry

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


def create_recognizer(config: OcrConfig, num_classes: int
                      ) -> torch.nn.Module:
    """The recognizer that config.rec_arch names: the CRNN or SVTR."""
    if config.rec_arch == "svtr":
        return create_svtr(config, num_classes)
    if config.rec_arch == "crnn":
        return create_crnn(config, num_classes)
    raise ValueError(f"unknown rec_arch {config.rec_arch!r}: 'crnn' or "
                     f"'svtr'")


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
    `seed`. The recognizer is the one config.rec_arch names (the CRNN or
    SVTR), built here and kept: a later config of another rec_arch is
    refused by the lanes (api_det.rec_decode), never run on this one.
    tile_det_weights with its tile_det_arch (the tile asset's `arch`
    metadata) builds the dedicated tile detector of the tiled lanes;
    without it they run the flagship detector.

    Every device program the engine runs is an entry of its one registry
    (graphs.engine_programs): a config change, thresholds aside, empties
    it, and resetting `_det` drops the programs that read the detector.
    """

    def __init__(self, config: Optional[OcrConfig] = None,
                 charset: Optional[Charset] = None,
                 rec_weights: Optional[Flat] = None,
                 det_weights: Optional[Flat] = None,
                 cls_weights: Optional[Flat] = None,
                 device: str = "cuda", seed: int = 0,
                 tile_det_weights: Optional[Flat] = None,
                 tile_det_arch: Optional[Mapping] = None):
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
        self.charset = charset or default_charset()
        cfg = self.config
        # the recognizer that cfg.rec_arch names; its flat weights in the
        # layout weights.rec_state_dict reads for that architecture
        self.rec_model = _build(
            create_recognizer(cfg, self.charset.num_classes),
            rec_weights and W.rec_state_dict(rec_weights, cfg.rec_arch)[0],
            seed, self.device)
        # the detectors are built from the config in force when they are
        # first needed (det_model, tile_det_model); their weights stay here
        self._det_weights = {"det": det_weights,
                             "tile_det": tile_det_weights}
        self._det_seeds = {"det": seed + 1, "tile_det": seed + 3}
        self._det_built = {"det": None, "tile_det": None}
        self._tile_det_cfg = None    # the config tile_det_model was built for
        self.cls_model = _build(
            create_cls(cfg), cls_weights and W.cls_state_dict(cls_weights)[0],
            seed + 2, self.device)
        self._cls_trained = cls_weights is not None
        self._cls_warned = False
        # set by from_pretrained when the cls asset carries the
        # antisymmetry certificate: single-pass margins (cls_single_pass)
        self.cls_antisym = False
        self.tile_det_arch = tile_det_arch
        # api_det.DetState, the flagship detector, built at its first use;
        # the engine's programs are in its registry (graphs.engine_programs)
        self._det = None
        # parallel.mesh.shard_tiled_serving: the tile lanes' dp mesh
        self.tile_mesh = None

    def build_detector(self, kind: str) -> torch.nn.Module:
        """A new DB of `kind` ("det", the flagship, or "tile_det") from the
        config in force, holding the weights of the one built before it
        (they stay on the engine across rebuilds, as ocrjax's det_variables
        do), else the loaded ones, else random ones from the seed."""
        prev = self._det_built[kind]
        model = create_db(self.config,
                          self.tile_det_arch if kind == "tile_det" else None)
        flat = (W.model_variables(prev) if prev is not None
                else self._det_weights[kind])
        if flat is None:
            W.init_random_(model, self._det_seeds[kind])
        else:
            W.load_model_variables(model, flat)
        self._det_built[kind] = model.to(self.device).eval()
        return self._det_built[kind]

    @property
    def det_model(self) -> torch.nn.Module:
        """The flagship detector of the staged and fused lanes. It is built
        from the config at the detector's first use and kept from then on
        (api_det.DetState, as ocrjax's _DetState); resetting `_det` builds
        it again from the config then in force, and the programs made over
        the old one are dropped. Callers may load weights into it
        (weights.load_model_variables)."""
        from ocrjax_torch.api_det import det_state
        return det_state(self).model

    @property
    def tile_det_model(self) -> Optional[torch.nn.Module]:
        """The dedicated tile detector (None when no tile asset was
        loaded), built from the config in force: a config change builds it
        again, as ocrjax's tile forward is rebuilt with its config."""
        if self._det_weights["tile_det"] is None:
            return None
        if self._tile_det_cfg != self.config:
            self.build_detector("tile_det")
            self._tile_det_cfg = self.config
        return self._det_built["tile_det"]

    def warn_untrained_cls(self) -> None:
        """Warns once when rec_try_flip runs on a random orientation
        classifier (no cls weights were loaded)."""
        if self._cls_trained or self._cls_warned:
            return
        self._cls_warned = True
        log_fields(get_logger("ocrjax_torch.api"), "warning",
                   "rec_try_flip is enabled but no trained orientation "
                   "classifier was loaded (assets/cls.safetensors) — flip "
                   "decisions come from a random-init net",
                   trained=False)

    @classmethod
    def from_pretrained(cls, path: str = None, config: OcrConfig = None,
                        device: str = "cuda", seed: int = 0) -> "OcrEngine":
        """Loads `<path>/{rec,det,cls,det_tile}.safetensors` and
        `rec.charset.txt` (the repo's assets/ by default); a missing file
        gives random weights for that stage (and no tile detector). Without
        `config`, the `config` metadata of rec and then det builds it; the
        tile asset's `arch` metadata describes only its own network and
        never feeds the config."""
        path = path or ASSETS
        loaded = {}
        for name in ("rec", "det", "cls", "det_tile"):
            p = os.path.join(path, f"{name}.safetensors")
            loaded[name] = W.read_safetensors(p) if os.path.exists(p) \
                else (None, {})
        cs_p = os.path.join(path, "rec.charset.txt")
        charset = Charset.from_file(cs_p) if os.path.exists(cs_p) else None
        if config is None:
            config = asset_config(path, [loaded["rec"][1], loaded["det"][1]])
        tile_arch = loaded["det_tile"][1].get("arch")
        eng = cls(config=config, charset=charset,
                  rec_weights=loaded["rec"][0], det_weights=loaded["det"][0],
                  cls_weights=loaded["cls"][0], device=device, seed=seed,
                  tile_det_weights=loaded["det_tile"][0],
                  tile_det_arch=json.loads(tile_arch) if tile_arch else None)
        eng.cls_antisym = loaded["cls"][1].get("antisym") == "1"
        return eng

    def _rec_step(self, batch_u8: torch.Tensor, widths: torch.Tensor,
                  beam: bool = False, seg_ids: torch.Tensor = None):
        """normalize -> [dewarp] -> recognizer -> CTC over a (N, H, W)
        uint8 batch; with seg_ids (rec_try_flip) the orientation stage runs
        after the dewarp, seg_ids grouping the strips for its page prior,
        and the flip decisions come back as a fourth tensor. The dewarp comes
        before the orientation stage here, as in the reference's C1
        programs (the staged lanes flip first). A program keyed per (N,
        bucket width), whose static outputs the next call of the same
        shape overwrites."""
        from ocrjax_torch import graphs
        from ocrjax_torch.api_det import count_rec
        count_rec(batch_u8.shape[0], batch_u8.shape[-1])
        return graphs.program(self, "rec_step", OcrEngine._rec_step_run)(
            self, batch_u8, widths, beam, seg_ids)

    def _rec_step_run(self, batch_u8, widths, beam, seg_ids):
        from ocrjax_torch.api_det import _cls_flip_strips, rec_decode
        from ocrjax_torch.ops.warp import maybe_dewarp_curl
        cfg = self.config
        with torch.inference_mode():
            x = preprocess.rec_normalize(batch_u8, cfg.rec_mean, cfg.rec_std)
            strips = maybe_dewarp_curl(x[:, 0], widths, cfg)
            if seg_ids is None:
                return rec_decode(self, strips, widths, beam)
            strips, flipped = _cls_flip_strips(self, strips, widths, seg_ids)
            return (*rec_decode(self, strips, widths, beam), flipped)

    @entry
    def recognize_strips(self, strips: Sequence[np.ndarray],
                         beam: bool = False, same_page: bool = False,
                         prior_ids: Sequence[int] = None) -> List[RecResult]:
        """Batched recognition of pre-cropped uint8 line strips of any
        size: resized to the rec height on the host, zero-padded to one
        width bucket and the count bucket, one device call. For
        rec_try_flip's page prior, same_page=True puts the strips in one
        group and prior_ids (one int a strip) in one group per id; by
        default every strip decides alone."""
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
        if cfg.rec_try_flip:
            self.warn_untrained_cls()
            total = batch.shape[0]    # below n when n passes every bucket
            if prior_ids is not None:
                # dense ids, as the page prior's scatter needs; each pad
                # row votes alone
                base = np.unique(np.asarray(prior_ids, np.int64),
                                 return_inverse=True)[1].reshape(-1)
                seg = np.concatenate([base, base.max(initial=0) + 1
                                      + np.arange(total - n)])
            elif same_page:
                seg = np.concatenate([np.zeros(n, np.int64),
                                      np.arange(1, total - n + 1)])
            else:
                seg = np.arange(total)
            out = self._rec_step(upload(self, batch), upload(self, widths),
                                 beam, upload(self, seg.astype(np.int64)))
        else:
            out = self._rec_step(upload(self, batch), upload(self, widths),
                                 beam)
        tokens, n_tokens, conf = (t.cpu().numpy() for t in out[:3])
        flipped = out[3].cpu().numpy() if cfg.rec_try_flip \
            else np.zeros(n, bool)
        return [RecResult(self.charset.decode(tokens[i][: n_tokens[i]]),
                          float(conf[i]), flipped=bool(flipped[i]))
                for i in range(n)]

    @entry
    def recognize(self, image: ImageLike, beam: bool = False) -> RecResult:
        """One pre-cropped text-line image -> one string."""
        img = preprocess.load_image(image,
                                    auto_invert=self.config.auto_invert)
        return self.recognize_strips([img], beam=beam)[0]

    @entry
    def detect(self, image: ImageLike) -> List[DetBox]:
        """Full page -> boxes in original image coords, reading order."""
        from ocrjax_torch import api_det
        return api_det.detect(self, image)

    @entry
    def ocr(self, image: ImageLike, beam: bool = False) -> OcrResult:
        """One page -> ordered text lines: the fused lane for a page that
        fits the canvas (cfg.ocr_single_fused), else the staged lane with
        full-resolution crops."""
        from ocrjax_torch import api_det
        return api_det.ocr(self, image, beam=beam)

    @entry
    def ocr_batch(self, images: Sequence[ImageLike], beam: bool = False,
                  fused: bool = False) -> List[OcrResult]:
        """Batched page OCR: fused=True runs the fused lane (fixed line
        capacity per page, reroutes inside), else the pooled bucketed
        lane."""
        if fused:
            from ocrjax_torch import fused as F
            return F.ocr_pages_fused(self, images, beam=beam)
        from ocrjax_torch import api_det
        return api_det.ocr_batch(self, images, beam=beam)

    @entry
    def detect_tiled(self, image: ImageLike) -> List[DetBox]:
        """High-resolution page -> boxes in original image coords, reading
        order: overlapping tiles of cfg.tile_size, seams merged."""
        from ocrjax_torch import api_det
        return api_det.detect_tiled(self, image)

    @entry
    def ocr_tiled(self, image: ImageLike, beam: bool = False) -> OcrResult:
        """High-resolution page -> ordered text lines: tiled detection and
        pooled recognition from the uploaded tiles."""
        from ocrjax_torch import tiling
        return tiling.ocr_tiled(self, image, beam=beam)

    @entry
    def ocr_tiled_batch(self, images: Sequence[ImageLike],
                        beam: bool = False) -> List[OcrResult]:
        """Many high-resolution pages in windows of tiles, detection of
        the next window issued before the current one is read; a page that
        fails to decode yields an empty result."""
        from ocrjax_torch import tiling
        return tiling.ocr_tiled_batch(self, images, beam=beam)


# ---------------------------------------------------------------------------
# Module-level convenience: one default engine, built on first use
# ---------------------------------------------------------------------------

_default_engine: Optional[OcrEngine] = None


def get_default_engine() -> OcrEngine:
    """The engine of detect / recognize / ocr: from_pretrained() on the
    card, built on the first call."""
    global _default_engine
    if _default_engine is None:
        _default_engine = OcrEngine.from_pretrained()
    return _default_engine


def recognize(image: ImageLike, beam: bool = False) -> RecResult:
    return get_default_engine().recognize(image, beam=beam)


def detect(image: ImageLike) -> List[DetBox]:
    return get_default_engine().detect(image)


def ocr(image: ImageLike, beam: bool = False) -> OcrResult:
    return get_default_engine().ocr(image, beam=beam)
