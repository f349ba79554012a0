"""Frozen pipeline configuration: the port's own copy of ocrjax.config.

Every field of ocrjax's OcrConfig is kept, with the same name, type and
default, so the `config` JSON in an asset's metadata parses the same way in
both packages. See ocrjax/config.py for the measurements behind each default.

The port acts on every field as the reference does. The transport fields
say how a lane's results leave the card (ops.bytepack); none of them
changes a result:
  * fetch_bytes: the fused and recognition payloads are packed as uint8
    rows (token ids, counts and flags as bytes, each float32 column as its
    four raw bytes) instead of float32 rows, about 3x fewer bytes to copy.
    Byte packing holds only for charsets of at most 255 classes and
    rec_max_tokens <= 255 (bytepack.use_byte_fetch); past that the
    float32 rows are kept.
  * fetch_max_tokens: the host first copies the first N token columns a
    line of a fused or pooled payload, and refetches the whole payload,
    still on the card, only for a chunk in which some line has more than
    N tokens. 0 copies every column.
  * det_fetch_candidates: the host first copies the first N candidate
    slots a page and the page's highest used slot (slots fill as a prefix
    in raster root order), and refetches the whole candidate rows of a
    chunk in which some page used a later slot; the tiled lanes keep a
    latch that fetches whole rows after an overflow until a sparse fetch.
    0 copies every slot.
  * upload_bits: 4 means the page is quantized to 16 levels with a Bayer
    dither before detection (preprocess.pack_nibbles), which changes the
    input itself.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OcrConfig:
    # --- detection preprocess ---
    det_max_side: int = 960          # square detection canvas side
    det_stride: int = 32
    det_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    det_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    auto_invert: bool = True         # light-ink-on-dark pages are inverted
                                     # at decode (median subsampled luma
                                     # below 128)
    det_head_stride: int = 1         # prob-map stride vs the canvas (1, 2, 4)
    det_int8: bool = False           # int8 DB backbone and FPN (opt-in)

    # --- DB postprocess ---
    det_thresh: float = 0.3
    det_box_thresh: float = 0.6
    det_unclip_ratio: float = 1.5
    det_max_candidates: int = 256
    det_min_box_size: int = 3
    det_cc_iters: int = 4            # CCL sweeps (fixed count)
    det_cc_downsample: int = 4       # CCL on an OR-pooled coarse grid

    # --- recognition preprocess ---
    rec_height: int = 32
    rec_width_buckets: Tuple[int, ...] = (64, 128, 192, 256, 320, 512)
    rec_mean: float = 0.5
    rec_std: float = 0.5

    # --- CRNN / CTC ---
    rec_snap_to_ink: bool = True     # two-pass warp: probe, ink refine, re-warp
    rec_crop_margin: float = 0.15    # probe-quad expansion, fraction of height
    rec_flat_band_frac: float = 0.46  # flat-band (x-height-aware) rescale
    rec_ink_x_margin_keep: float = 0.5
    rec_try_flip: bool = False       # 180-degree orientation stage
    rot90_tilt_deg: float = 60.0
    cls_page_prior: float = 2.0
    rec_flat_case_gate: bool = False
    rec_dewarp_curl: bool = False
    rec_dewarp_min_dev_px: float = 3.0
    rec_dewarp_max_px: float = 10.0
    cls_single_pass: bool = True
    rec_hidden: int = 256
    rec_conv_channels: Tuple[int, ...] = (64, 128, 256, 512)
    ctc_blank: int = 0
    ctc_beam_width: int = 8
    rec_max_tokens: int = 128

    # --- batching / tiling ---
    line_batch_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256)
    fused_lines_per_page: int = 32   # static per-page line capacity (K)
    ocr_single_fused: bool = True    # ocr() takes the fused lane
    fused_rotation_reroute_deg: float = 3.0
    fused_reroute_min_aspect: float = 1.7
    fused_reroute_noise_px: float = 6.0
    fused_color_reroute_frac: float = 0.005
    pooled_sep_warp: bool = True
    pooled_sep_tile_h: int = 128
    fused_chunk_pages: int = 16      # pages per fused call
    tile_size: int = 2048
    tile_overlap: int = 128
    tile_merge_iou: float = 0.3
    tile_pipeline_tiles: int = 4
    tile_window_hbm_mb: int = 1536
    tile_det_enable: bool = True
    tile_blank_skip: bool = True
    tile_max_candidates: int = 384

    # --- runtime ---
    compute_dtype: str = "bfloat16"  # conv compute dtype; params stay float32
    param_dtype: str = "float32"
    upload_bits: int = 4             # 4 = Bayer-dithered 16-level luma
    fetch_bytes: bool = True         # uint8 payload rows (ops.bytepack)
    fetch_max_tokens: int = 48       # token columns a line fetched first
    det_fetch_candidates: int = 64   # candidate slots a page fetched first

    def replace(self, **kw) -> "OcrConfig":
        return dataclasses.replace(self, **kw)

    def rec_bucket_for_width(self, w: int) -> int:
        """Smallest configured width bucket >= w (last bucket if wider)."""
        for b in self.rec_width_buckets:
            if w <= b:
                return b
        return self.rec_width_buckets[-1]

    def line_bucket_for_count(self, n: int) -> int:
        """Smallest configured line-count bucket >= n (last if larger)."""
        for b in self.line_batch_buckets:
            if n <= b:
                return b
        return self.line_batch_buckets[-1]


# A small config for unit tests on the CPU: tiny model dims, short buckets.
TINY = OcrConfig(
    det_max_side=256,
    rec_hidden=48,
    rec_conv_channels=(16, 32, 48, 64),
    rec_width_buckets=(64, 128),
    line_batch_buckets=(4, 8),
    det_max_candidates=64,
    tile_size=256,
    tile_overlap=32,
    tile_max_candidates=64,
    compute_dtype="float32",
)
