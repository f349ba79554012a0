"""Page preprocessing (port of the fused lane's half of ocrjax/preprocess.py).

Host (numpy, uint8): polarity canonicalization, 601 luma, the fit onto the
square detection canvas with replicate padding, and the 4-bit Bayer dither
packed two pixels a byte. Device (torch): the unpack and the detector's
normalization.

The reference's host path uses cv2 and a native C++ decoder; a machine with
a card may have neither, so the port computes their arithmetic itself, bit
for bit:
  * `to_gray` is cv2's fixed-point 601 luma, (9798 R + 19235 G + 3735 B +
    16384) >> 15;
  * `resize_linear_u8` is cv2.resize(..., INTER_LINEAR) for uint8: 11-bit
    fixed-point coefficients, an int32 intermediate row, and the 2x2 box
    average cv2 switches to at an exact 2:1 downscale. `rec_resize` and the
    RGB-first canvas (`det_resize_to_canvas`) use it;
  * `decode_canvas_luma_first` is the reference's native canvas decode (luma
    first, then a float32 bilinear resize), which its default-luma lanes
    take; colour (min-channel) pages and the full-resolution batch lane take
    the RGB-first canvas, as in the reference;
  * image paths are decoded by `imageio.read_image`: PNG by the port's own
    decoder (the result of cv2.imread), other formats by cv2 where present.
As in the reference, the host path takes the native C++ library
(postprocess.native_boxes) where it builds: `pack_nibbles` packs with
occ_pack_nibbles, `decode_chunk_to_gray` decodes default-luma pages with
occ_decode_canvas on a thread pool. The numpy routes above are their exact
twins (bit for bit) and run where the library does not build.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import os
import threading
from typing import Callable, Iterator, Sequence, Tuple, Union

import numpy as np
import torch

from ocrjax_torch import imageio
from ocrjax_torch.config import OcrConfig
from ocrjax_torch.postprocess import native_boxes
from ocrjax_torch.utils.logging import get_logger, log_fields
from ocrjax_torch.utils.profiling import carry, host_stage, stage

# what took the native library: "pack" calls and "decode" pages (counted
# on the calling thread, after the decode pool)
native_calls = collections.Counter()

# the form load_page kept each page in: "luma" for a 2-D or one-channel
# array, "rgb" for a colour one (a decoded file is RGB); the tiled lane's
# prep thread counts beside the caller's
page_forms = collections.Counter()
_page_forms_lock = threading.Lock()

ImageLike = Union[str, np.ndarray]


# ---------------------------------------------------------------------------
# Host
# ---------------------------------------------------------------------------

def is_inverted(img: np.ndarray, thresh: int = 128, stride: int = 4) -> bool:
    """True for light-ink-on-dark input: median of the subsampled
    (channel-mean) luma below `thresh`."""
    sub = img[::stride, ::stride]
    if sub.ndim == 3:
        sub = sub.mean(axis=2)
    return float(np.median(sub)) < thresh


def load_image(image: ImageLike, auto_invert: bool = True) -> np.ndarray:
    """Path or uint8 array -> uint8 RGB HWC, dark ink on light paper."""
    with stage("load_image", device=False):
        img = _load_page(image, auto_invert)
        return img if img.ndim == 3 else np.stack([img] * 3, axis=-1)


def load_page(image: ImageLike, auto_invert: bool = True) -> np.ndarray:
    """load_image without the RGB stack: a 2-D or one-channel array comes
    back as (H, W) luma, anything else as (H, W, 3) RGB, dark ink on light
    paper. The lanes that turn the page straight into luma take it so; a
    grey pixel's 601 luma is its value, so to_gray of either form is the
    same array."""
    with stage("load_image", device=False):
        img = _load_page(image, auto_invert)
    with _page_forms_lock:
        page_forms["luma" if img.ndim == 2 else "rgb"] += 1
    return img


def _load_page(image: ImageLike, auto_invert: bool) -> np.ndarray:
    if isinstance(image, str):
        img = imageio.read_image(image)
    else:
        img = np.asarray(image)
        if img.dtype != np.uint8:
            raise ValueError(f"expected uint8 image, got {img.dtype}")
        if img.ndim == 3 and img.shape[2] == 1:
            img = img[..., 0]
    if img.ndim != 2 and (img.ndim != 3 or img.shape[2] != 3):
        raise ValueError(f"expected HWC RGB, got shape {img.shape}")
    # on a 2-D page the median is of the uint8 samples themselves, the
    # value the mean of three equal channels gives exactly
    if auto_invert and is_inverted(img):
        img = np.asarray(255 - img, np.uint8)
        _log_inverted()
    return img


def _log_inverted() -> None:
    log_fields(get_logger("ocrjax_torch.preprocess"), "info",
               "inverted-polarity page: canonicalized to dark-on-light",
               inverted=True)


def native_inverted(img: np.ndarray, stride: int = 4) -> bool:
    """occ_decode_canvas's polarity test: the LOWER median of the
    subsampled channel sums below 384. is_inverted takes np.median of the
    channel means, which averages the two middle samples of an even count;
    the two differ only when those straddle 128."""
    sub = img[::stride, ::stride]
    sums = (sub.astype(np.int32).sum(axis=2) if sub.ndim == 3
            else 3 * sub.astype(np.int32)).ravel()
    k = (sums.size + 1) // 2 - 1
    return int(np.partition(sums, k)[k]) < 384


def to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 RGB HWC -> uint8 HW, cv2's fixed-point ITU-R 601 luma (the
    15-bit coefficients of cv2.cvtColor(..., COLOR_RGB2GRAY) for uint8)."""
    if img.ndim == 2:
        return img
    # the coefficients sum to 2**15, so a grey pixel keeps its value: a grey
    # page in RGB (load_image makes one of every 2-D page) skips the products
    if (img[..., 0] == img[..., 1]).all() and (img[..., 1] == img[..., 2]).all():
        return img[..., 0].copy()
    c = img.astype(np.uint32)
    y = (9798 * c[..., 0] + 19235 * c[..., 1] + 3735 * c[..., 2]
         + 16384) >> 15
    return y.astype(np.uint8)


def to_gray_minchannel(img: np.ndarray) -> np.ndarray:
    """uint8 RGB HWC -> uint8 HW, the per-pixel channel minimum: saturated
    coloured ink on a light page keeps its contrast where 601 luma washes it
    out. The projection of the colour reroute."""
    if img.ndim == 2:
        return img
    return img.min(axis=2)


def color_fraction(img: np.ndarray, chroma_thresh: int = 40,
                   stride: int = 4) -> float:
    """Fraction of (subsampled) pixels with strong chroma."""
    if img.ndim == 2:
        return 0.0
    sub = img[::stride, ::stride].astype(np.int16)
    chroma = sub.max(axis=2) - sub.min(axis=2)
    return float((chroma > chroma_thresh).mean())


def _cv2_axis(n_in: int, n_out: int):
    """cv2's source index and float32 fraction for each output index."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _fixed11(frac: np.ndarray):
    """The pair of 11-bit fixed-point weights of a float32 fraction."""
    one, k = np.float32(1.0), np.float32(2048.0)
    return (np.rint((one - frac) * k).astype(np.int32),
            np.rint(frac * k).astype(np.int32))


def resize_linear_u8(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> (h, w[, C]), bit-exact to
    cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)."""
    h, w = img.shape[:2]
    nh, nw = size_hw
    if (nh, nw) == (h, w):
        return img.copy()
    if h == 2 * nh and w == 2 * nw:       # cv2 takes INTER_AREA here
        a = img.astype(np.int32)
        return ((a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
                 + a[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    tail = (1,) * (img.ndim - 2)
    sx, fx = _cv2_axis(w, nw)
    lo, hi = sx < 0, sx >= w - 1
    fx = np.where(lo | hi, np.float32(0.0), fx)
    sx = np.where(lo, 0, np.where(hi, w - 1, sx))
    a0, a1 = (a.reshape((1, -1) + tail) for a in _fixed11(fx))
    sy, fy = _cv2_axis(h, nh)
    b0, b1 = (b.reshape((-1, 1) + tail) for b in _fixed11(fy))
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    src = img.astype(np.int32)
    rows = src[:, sx] * a0 + src[:, np.minimum(sx + 1, w - 1)] * a1
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
           + 2) >> 2
    return out.astype(np.uint8)


def rec_resize(img: np.ndarray, height: int = 32) -> np.ndarray:
    """Aspect-preserving resize of a grayscale strip to the rec height."""
    h, w = img.shape[:2]
    new_w = max(1, int(round(w * height / h)))
    return resize_linear_u8(img, (height, new_w))


def _replicate_pad(canvas: np.ndarray, nh: int, nw: int) -> None:
    canvas[nh:, :nw] = canvas[nh - 1:nh, :nw]
    canvas[:, nw:] = canvas[:, nw - 1:nw]


def decode_canvas_luma_first(img: np.ndarray, cfg: OcrConfig,
                             chroma_thresh: int = 40):
    """The reference's native canvas decode in numpy, bit for bit
    occ_decode_canvas (decode_canvas_native): uint8 RGB (H, W, 3) or luma
    (H, W), any polarity -> (gray (S, S) uint8, scale, (nh, nw), chroma
    fraction). Polarity is canonicalized (cfg.auto_invert, native_inverted's
    test) per channel before the luma; a page larger than the canvas is resized AFTER the
    luma with float32 bilinear weights (half-pixel centres); the chroma
    fraction samples the source at stride 4. Pages that fit the canvas come
    out equal to det_resize_to_canvas + to_gray."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    S = cfg.det_max_side
    h, w = img.shape[:2]
    frac = color_fraction(img, chroma_thresh)
    if cfg.auto_invert and native_inverted(img):
        img = np.asarray(255 - img, np.uint8)
        _log_inverted()
    luma = to_gray(img)
    # the native decode rounds the canvas size half away from zero
    scale = min(S / max(h, w), 1.0)
    nh = max(1, int(np.floor(h * scale + 0.5)))
    nw = max(1, int(np.floor(w * scale + 0.5)))
    if (nh, nw) != (h, w):
        def axis(n_in, n_out):
            f = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5,
                        0.0, n_in - 1.0)
            i0 = np.minimum(f.astype(np.int64), max(n_in - 2, 0))
            return i0, np.minimum(i0 + 1, n_in - 1), \
                (f - i0).astype(np.float32)
        x0, x1, wx = axis(w, nw)
        y0, y1, wy = axis(h, nh)
        lf = luma.astype(np.float32)
        r0, r1 = lf[y0], lf[y1]
        top = r0[:, x0] + wx * (r0[:, x1] - r0[:, x0])
        bot = r1[:, x0] + wx * (r1[:, x1] - r1[:, x0])
        luma = (top + wy[:, None] * (bot - top)
                + np.float32(0.5)).astype(np.uint8)
    canvas = np.empty((S, S), np.uint8)
    canvas[:nh, :nw] = luma
    _replicate_pad(canvas, nh, nw)
    return canvas, nh / h, (nh, nw), frac


def det_resize_to_canvas(img: np.ndarray, cfg: OcrConfig
                         ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Fit a page onto the (S, S, 3) detection canvas: downscale so the
    long side is S (never upscale), replicate the last row/column into the
    rest. Returns (canvas, scale, (valid_h, valid_w)); original coords =
    canvas coords / scale."""
    S = cfg.det_max_side
    h, w = img.shape[:2]
    if (h, w) == (S, S):
        return np.ascontiguousarray(img), 1.0, (h, w)
    scale = min(S / max(h, w), 1.0)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    resized = resize_linear_u8(img, (nh, nw)) if scale < 1.0 else img
    canvas = np.empty((S, S) + img.shape[2:], np.uint8)
    canvas[:nh, :nw] = resized
    _replicate_pad(canvas, nh, nw)
    return canvas, nh / h, (nh, nw)


def decode_canvas_native(img: np.ndarray, cfg: OcrConfig,
                         chroma_thresh: int = 40, out: np.ndarray = None):
    """decode_canvas_luma_first in one native call (occ_decode_canvas),
    writing into `out` ((S, S) uint8, C-contiguous) when given; -> (gray,
    scale, (nh, nw), chroma fraction), or None without the library or for
    an input it does not take (not uint8 HW or HWC with 1 or 3 channels)."""
    lib = native_boxes._load()
    if lib is None or img.dtype != np.uint8:
        return None
    if img.ndim == 2:
        (h, w), c = img.shape, 1
    elif img.ndim == 3 and img.shape[2] in (1, 3):
        h, w, c = img.shape
    else:
        return None
    img = np.ascontiguousarray(img)
    S = cfg.det_max_side
    if out is None:
        out = np.empty((S, S), np.uint8)
    elif not (out.shape == (S, S) and out.dtype == np.uint8
              and out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous ({S}, {S}) uint8 "
                         f"canvas, got {out.dtype} {out.shape}")
    meta = np.zeros((5,), np.int64)
    lib.occ_decode_canvas(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c, S,
        int(cfg.auto_invert), chroma_thresh,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    nh, nw = int(meta[0]), int(meta[1])
    return out, nh / h, (nh, nw), float(meta[3]) / max(int(meta[4]), 1)


_decode_pool = None


def _get_decode_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The chunk decode's threads, min(8, cpu_count): the native decode
    and numpy's array work release the GIL."""
    global _decode_pool
    if _decode_pool is None:
        _decode_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="ocrjax_torch-decode")
    return _decode_pool


_lookahead_pool = None


def lookahead(fn: Callable, items: Sequence, wait: str,
              submit: str = None) -> Iterator:
    """fn(item) of each item, in order, as a generator: each runs on the
    one lookahead thread, and item k + 1's is submitted as soon as item
    k's is taken, so that it runs while the caller handles item k (the
    lanes' host pipelines: a chunk's decode, a page's tile prep). The
    caller's wait for each result is the stage `wait`; each submit is
    the host step `submit` where given. The thread is apart from the
    decode pool: a chunk's task waits on that pool's per-page tasks and
    must never hold one of its workers."""
    global _lookahead_pool
    if _lookahead_pool is None:
        _lookahead_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ocrjax_torch-lookahead")
    items = list(items)

    def start(item):
        with (stage(submit, device=False) if submit
              else contextlib.nullcontext()):
            return _lookahead_pool.submit(carry(fn), item)
    pending = start(items[0]) if items else None
    for k in range(len(items)):
        with stage(wait):
            out = pending.result()
        if k + 1 < len(items):
            pending = start(items[k + 1])
        yield out


def decode_chunk_to_gray(images: Sequence[ImageLike], idxs, cfg: OcrConfig,
                         *, gray_fn=None, color_frac: float = 0.0,
                         originals_out=None):
    """Host decode of a chunk of pages onto luma detection canvases, a
    page a task on the decode pool (a chunk of one page runs inline).

    Returns (grays (n, S, S) u8, scales (n,), valid_hw (n, 2), ok (n,) bool,
    colorful list): a page that fails to decode gets ok=False and a zero
    canvas; colorful[j] is True when color_frac > 0 and the page's
    strong-chroma fraction exceeds it. Default-luma pages (gray_fn None)
    take the native decode (decode_canvas_native), or its numpy twin
    decode_canvas_luma_first without the library, as the reference takes
    its native decode; with a gray_fn the canvas is resized in RGB and then
    projected. originals_out: optional dict; downscaled pages (scale < 1)
    store their canonical full-resolution RGB original under their `idxs`
    key, for the full-resolution recognition lane. Each page's work is the
    host stage `decode` of the call that submitted the chunk.
    """
    idxs = list(idxs)
    n = len(idxs)
    S = cfg.det_max_side
    grays = np.zeros((n, S, S), np.uint8)
    scales = np.ones((n,), np.float64)
    valid_hw = np.zeros((n, 2), np.int64)
    ok = np.ones((n,), bool)
    colorful = [False] * n
    took_native = [False] * n

    def work(j):
        with host_stage("decode"):
            decode_page(j)

    def decode_page(j):
        i = idxs[j]
        try:
            im = images[i]
            if gray_fn is None:
                arr = im if isinstance(im, np.ndarray) else load_image(
                    im, auto_invert=False)
                if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
                        arr.ndim == 3 and arr.shape[2] not in (1, 3)):
                    raise ValueError(f"expected a uint8 HW or HWC image, "
                                     f"got {arr.dtype} {arr.shape}")
                got = decode_canvas_native(arr, cfg, out=grays[j])
                took_native[j] = got is not None
                if got is None:
                    got = decode_canvas_luma_first(arr, cfg)
                    grays[j] = got[0]
                _, scales[j], valid_hw[j], cfrac = got
                img = arr
            else:
                img = load_image(im, auto_invert=cfg.auto_invert)
                canvas, scales[j], valid_hw[j] = det_resize_to_canvas(
                    img, cfg)
                grays[j] = gray_fn(canvas)
                cfrac = color_fraction(canvas)
            if color_frac > 0 and cfrac > color_frac:
                colorful[j] = True
            if originals_out is not None and scales[j] < 0.999:
                # canonical as load_image makes it: RGB, dark on light
                rgb = load_image(img, auto_invert=False)
                if cfg.auto_invert and is_inverted(rgb):
                    rgb = np.asarray(255 - rgb, np.uint8)
                originals_out[i] = rgb
        except Exception as e:  # noqa: BLE001 - per-page isolation
            # as ocrjax's chunk decode: any failure empties this page only
            ok[j] = False
            log_fields(get_logger("ocrjax_torch.preprocess"), "warning",
                       "page decode failed (isolated)",
                       page=int(i), error=f"{type(e).__name__}: {e}")

    if n == 1:
        work(0)
    else:
        list(_get_decode_pool().map(carry(work), range(n)))
    native_calls["decode"] += sum(took_native)
    return grays, scales, valid_hw, ok, colorful


def pad_strips_to_bucket(strips: Sequence[np.ndarray], cfg: OcrConfig,
                         bucket_width: int = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-width (rec_height, w) uint8 strips into (N,
    rec_height, Wb) zero-padded, plus their widths (clipped to Wb)."""
    widths = np.array([s.shape[1] for s in strips], np.int32)
    if bucket_width is None:
        bucket_width = cfg.rec_bucket_for_width(int(widths.max(initial=1)))
    out = np.zeros((len(strips), cfg.rec_height, bucket_width), np.uint8)
    for i, s in enumerate(strips):
        w = min(s.shape[1], bucket_width)
        out[i, :, :w] = s[:, :w]
    return out, np.minimum(widths, bucket_width)


# Bayer 4x4 ordered-dither offsets in integer form: 34 * b + 17
_BAYER4_I = (np.array([[0, 8, 2, 10], [12, 4, 14, 6],
                       [3, 11, 1, 9], [15, 7, 13, 5]], np.uint16) * 34 + 17)


def _pack_nibbles_native(flat: np.ndarray):
    """occ_pack_nibbles: (R, W) uint8 rows -> (R, W/2), or None without
    the library. Rows take the dither phase of their absolute row number."""
    lib = native_boxes._load()
    if lib is None:
        return None
    R, W = flat.shape
    out = np.empty((R, W // 2), np.uint8)
    lib.occ_pack_nibbles(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         R, W,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    native_calls["pack"] += 1
    return out


def pack_nibbles(gray: np.ndarray) -> np.ndarray:
    """uint8 luma (..., H, W) -> (..., H, W/2): Bayer-4x4-dithered 4-bit
    levels, two a byte. q = floor(g/17 + (2b+1)/32) = (32g + 34b + 17) // 544,
    exact in integers. With H % 4 == 0 (a stack of pages keeps its dither
    phase) the native library packs; pack_nibbles_numpy is its twin."""
    if gray.shape[-1] % 2:
        raise ValueError(f"width must be even to pack, got {gray.shape}")
    H, W = gray.shape[-2:]
    if H % 4 == 0 and gray.dtype == np.uint8:
        out = _pack_nibbles_native(np.ascontiguousarray(gray).reshape(-1, W))
        if out is not None:
            return out.reshape(gray.shape[:-1] + (W // 2,))
    return pack_nibbles_numpy(gray)


def pack_nibbles_numpy(gray: np.ndarray) -> np.ndarray:
    """pack_nibbles in numpy, any H."""
    H, W = gray.shape[-2:]
    bay = np.tile(_BAYER4_I, (H // 4 + 1, W // 4 + 1))[:H, :W]
    q = (((gray.astype(np.uint16) << 5) + bay) // 544).astype(np.uint8)
    return (q[..., 0::2] << 4) | q[..., 1::2]


def unpack_nibbles_host(packed: np.ndarray) -> np.ndarray:
    """Host inverse of pack_nibbles: levels 0, 17, ..., 255."""
    hi = (packed >> 4) * np.uint8(17)
    lo = (packed & 0xF) * np.uint8(17)
    return np.stack([hi, lo], axis=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))


def pack_for_upload(gray: np.ndarray, cfg: OcrConfig) -> np.ndarray:
    with stage("pack", device=False):
        return pack_nibbles(gray) if cfg.upload_bits == 4 else gray


# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------

def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., W/2) uint8 -> (..., W) uint8 levels 0, 17, ..., 255."""
    hi = (packed >> 4) * 17
    lo = (packed & 0xF) * 17
    return torch.stack([hi, lo], dim=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))


def unpack_on_device(arr: torch.Tensor, cfg: OcrConfig) -> torch.Tensor:
    return unpack_nibbles(arr) if cfg.upload_bits == 4 else arr


def _scale_shift(u8: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(u8 / 255 - mean) / std in float32 as XLA evaluates it on the CPU,
    where the reference's numbers come from: u8 * f32(1/255) - mean
    contracted into ONE fused multiply-add, then a multiply by f32(1/std).
    The float64 product is exact and rounds once, so every device gives the
    fused result's bits."""
    c = float(np.float32(1.0 / 255.0))
    m = float(np.float32(mean))
    return (u8.double() * c - m).float() * (1.0 / std)


def rec_normalize(batch_u8: torch.Tensor, mean: float = 0.5,
                  std: float = 0.5) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, 1, H, W) float32, (x / 255 - mean) / std."""
    return _scale_shift(batch_u8, mean, std)[:, None]


def gray_normalize(gray_u8: torch.Tensor, mean: float, std: float
                   ) -> torch.Tensor:
    """(B, S, S) uint8 luma -> float32 pages for the warps,
    (g / 255 - mean) / std."""
    return _scale_shift(gray_u8, mean, std)


_channel_constants = {}


def channel_constants(mean, std, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-channel float32 mean and 1 / std as (1, C, 1, 1) tensors on
    `device`, made once per values and device (the reference closes over
    them as program constants). Filled element by element from Python
    floats: a torch.tensor(list, device=...) is a blocking copy, which
    would make the host wait for the card in every call."""
    key = (tuple(float(v) for v in mean), tuple(float(v) for v in std),
           torch.device(device))
    got = _channel_constants.get(key)
    if got is None:
        m = torch.empty((1, len(key[0]), 1, 1), dtype=torch.float32,
                        device=device)
        s = torch.empty_like(m)
        for i, (mv, sv) in enumerate(zip(*key[:2])):
            m[0, i].fill_(mv)
            s[0, i].fill_(sv)
        got = _channel_constants[key] = (m, 1.0 / s)
    return got


def det_normalize_gray(gray_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """(B, S, S) uint8 luma -> (B, 3, S, S) float32, ImageNet-normalized
    per channel (luma broadcast to RGB)."""
    m, inv_s = channel_constants(mean, std, gray_u8.device)
    x = gray_u8.float()[:, None] * (1.0 / 255.0)
    # XLA folds the division by a constant into a reciprocal multiply
    return (x - m) * inv_s


def det_normalize(canvas_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """(B, S, S, 3) uint8 RGB -> (B, 3, S, S) float32, ImageNet-normalized
    per channel in det_normalize_gray's arithmetic (the trainers' input)."""
    m, inv_s = channel_constants(mean, std, canvas_u8.device)
    x = canvas_u8.float().permute(0, 3, 1, 2) * (1.0 / 255.0)
    return (x - m) * inv_s
