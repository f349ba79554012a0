"""Synthetic text rendering for training, the bench and tests (the port's
own copy of ocrjax/train/synth.py, bit for bit the same output at the same
seeds).

PIL and cv2 are imported inside the functions that use them, so the module
imports where they are missing. The six DejaVu faces ship with the package
(ocrjax_torch/fonts/, under the Bitstream Vera licence in fonts/copyright):
a machine without system fonts renders the same glyphs, and no other path
is searched. Text layout is Pillow's: with libraqm (HarfBuzz shaping) where
Pillow has it, else its basic layout, which kerns otherwise, so the pixels
follow the layout engine (layout_engine()).


No datasets or network exist in this environment (SURVEY.md §0), so training
data is rendered: text-line strips for the CRNN (C1/C4) and full pages with
known line quads for the DB detector (C2/C3/C5). Ground truth is exact by
construction, which also makes end-to-end string tests meaningful
(SURVEY.md §7 step 3).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ocrjax_torch.charset import Charset

FONT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fonts")
FONTS = [os.path.join(FONT_DIR, name) for name in (
    "DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSerif.ttf",
    "DejaVuSerif-Bold.ttf", "DejaVuSansMono.ttf", "DejaVuSansMono-Bold.ttf")]

_font_cache = {}


def _font(path: str, size: int):
    from PIL import ImageFont
    key = (path, size)
    if key not in _font_cache:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"font file missing: {path}")
        _font_cache[key] = ImageFont.truetype(path, size)
    return _font_cache[key]


def layout_engine() -> str:
    """The text layout Pillow uses here: "raqm" or "basic"."""
    from PIL import features
    return "raqm" if features.check("raqm") else "basic"


def render_line(
    text: str,
    height: int = 32,
    font_path: str = FONTS[0],
    rng: Optional[np.random.RandomState] = None,
    noise: float = 0.0,
    pad: int = 4,
    supersample: int = 1,
) -> np.ndarray:
    """Render text as a dark-on-light grayscale strip of the given height.

    supersample > 1 is the HELD-OUT rasterization path (eval only, never
    training): glyphs render at N× size and downsample through Lanczos,
    giving different hinting, anti-aliasing and stroke-weight statistics
    than freetype's native rasterization at target size. Every quality
    number otherwise derives from the same renderer family the models
    trained on, so train/eval correlation inflates them by an unknown
    amount — this is the cheapest offline proxy for a second renderer."""
    from PIL import Image, ImageDraw
    ss = max(int(supersample), 1)
    h = height * ss
    font = _font(font_path, int(h * 0.72))
    dummy = Image.new("L", (8, 8))
    bbox = ImageDraw.Draw(dummy).textbbox((0, 0), text, font=font)
    w = max(bbox[2] - bbox[0], 1) + 2 * pad * ss
    img = Image.new("L", (w, h), 255)
    draw = ImageDraw.Draw(img)
    y = (h - (bbox[3] - bbox[1])) // 2 - bbox[1]
    draw.text((pad * ss - bbox[0], y), text, font=font, fill=0)
    if ss > 1:
        img = img.resize((max(w // ss, 1), height), Image.LANCZOS)
    arr = np.asarray(img, np.uint8)
    if noise > 0 and rng is not None:
        g = rng.randn(*arr.shape) * noise * 255
        arr = np.clip(arr.astype(np.float32) + g, 0, 255).astype(np.uint8)
    return arr


def random_text(rng: np.random.RandomState, charset: Charset,
                min_len: int = 1, max_len: int = 12,
                p_space: float = 0.0, char_weights=None) -> str:
    """Uniform random text. p_space > 0 makes each position a space with
    that probability (uniform charset otherwise): real text is ~15% spaces
    but a uniform draw over the 95-char set renders them 1%, leaving the
    recognizer space-blind under distortion (measured: e2e space drops on
    rotated pages). char_weights: optional {char: relative weight} tilting
    the draw — used to give visually-identical glyph pairs (l/I are both
    bare vertical strokes in DejaVu Sans) the real-text prior instead of a
    coin flip."""
    n = rng.randint(min_len, max_len + 1)
    chars = charset.chars
    if char_weights:
        w = np.array([char_weights.get(c, 1.0) for c in chars], np.float64)
        idx = rng.choice(len(chars), size=n, p=w / w.sum())
    else:
        idx = rng.randint(0, len(chars), size=n)
    text = "".join(chars[i] for i in idx)
    if p_space > 0 and " " in charset._char_to_id:
        mask = rng.rand(n) < p_space
        text = "".join(" " if m else c for c, m in zip(text, mask))
    # leading/trailing spaces are invisible to rendering -> unlearnable;
    # collapse runs (a double space renders identically to wide tracking)
    text = " ".join(text.split())
    return text or chars[rng.randint(0, len(chars))]


_WORD_SEPS = ["_", " ", "-", "."]
_WORD_SEP_P = [0.40, 0.40, 0.10, 0.10]


def word_text(rng: np.random.RandomState, charset: Charset,
              min_len: int = 2, max_len: int = 14) -> str:
    """Word-like text: lowercase runs joined by '_'/' '/'-'/'.', sometimes
    Capitalized or ALLCAPS. Uniform random_text almost never emits a
    multi-char x-height-only run (a tall glyph lands every 2-3 draws), so
    the detector never learns kernel continuity across baseline '_' joins
    of x-height words ('snake_case_name' split into three boxes at the
    underscores, measured r2) and the recognizer never sees word-shaped
    case patterns. Only emits characters present in the charset."""
    lowers = [c for c in "abcdefghijklmnopqrstuvwxyz"
              if c in charset._char_to_id]
    if not lowers:
        return random_text(rng, charset, min_len, max_len)
    seps = [s for s in _WORD_SEPS if s in charset._char_to_id]
    parts = []
    for _ in range(rng.randint(1, 4)):
        w = "".join(lowers[i] for i in
                    rng.randint(0, len(lowers), size=rng.randint(2, 8)))
        r = rng.rand()
        if r < 0.20:
            w = w.capitalize()
        elif r < 0.25:
            w = w.upper()
        parts.append(w)
    sep = (seps[rng.choice(len(seps), p=np.array(
        [_WORD_SEP_P[_WORD_SEPS.index(s)] for s in seps])
        / sum(_WORD_SEP_P[_WORD_SEPS.index(s)] for s in seps))]
        if seps else "")
    text = sep.join(parts)[:max_len].strip()
    while len(text) < min_len:
        text += lowers[rng.randint(len(lowers))]
    return text


@dataclasses.dataclass
class LineBatch:
    images: np.ndarray        # (B, 32, W) uint8
    widths: np.ndarray        # (B,) int32
    labels: np.ndarray        # (B, U) int32, 0-padded
    label_lengths: np.ndarray # (B,) int32
    texts: List[str]


def flat_snap_strip(strip: np.ndarray, frac: float,
                    ink_thresh: int = 128,
                    case_gate: bool = False) -> Optional[np.ndarray]:
    """Apply the SERVING flat-band geometry to a rendered strip
    (train/serve consistency for cfg.rec_flat_band_frac — DESIGN.md §4f):
    if the strip's ink band is ≤3 glyphs with uniform tops/bottoms (the
    same gate ops.warp.ink_boxes uses), crop the band and re-render it at
    `frac` of the strip height, centered. Returns None when the gate does
    not fire (ascenders/descenders, ≥4 glyphs, or no ink)."""
    import cv2

    H = strip.shape[0]
    ink = strip < ink_thresh
    rows = ink.sum(axis=1) >= 2
    if not rows.any():
        return None
    ys = np.where(rows)[0]
    a, b = int(ys.min()), int(ys.max())
    band = ink[a:b + 1]
    cols = band.sum(axis=0) >= 1
    if not cols.any():
        return None
    band_h = b - a + 1
    from ocrjax_torch.utils.flatband import flat_band_gate
    # case_gate mirrors cfg.rec_flat_case_gate (train/serve consistency):
    # line_h = the strip height — rendered training strips span the
    # font-metric line box, matching the serving gate's band/detector-box
    # ratio (utils.flatband)
    if not flat_band_gate(band, line_h=float(H) if case_gate else 0.0):
        return None
    xs = np.where(cols)[0]
    crop = strip[a:b + 1, int(xs.min()):int(xs.max()) + 1]
    target = max(2, int(round(frac * H)))
    new_w = max(1, int(round(crop.shape[1] * target / band_h)))
    small = cv2.resize(crop, (new_w, target),
                       interpolation=cv2.INTER_LINEAR)
    out = np.full((H, new_w + 6), 255, np.uint8)
    y0 = (H - target) // 2
    out[y0:y0 + target, 3:3 + new_w] = small
    return out


def make_line_batch(
    rng: np.random.RandomState,
    charset: Charset,
    batch_size: int,
    width: int,
    height: int = 32,
    max_label: int = 24,
    min_len: int = 1,
    max_len: int = 12,
    noise: float = 0.02,
    fonts: Sequence[str] = FONTS,
    p_space: float = 0.0,
    max_rotation: float = 0.0,
    char_weights=None,
    quantize_p: float = 0.0,
    p_word: float = 0.0,
    stretch: float = 0.0,
    font_weights=None,
    degrade: float = 0.0,
    flat_snap: float = 0.0,
) -> LineBatch:
    """Random rendered lines padded to a fixed (batch, height, width).

    p_space: see random_text. max_rotation > 0 rotates half the strips by a
    uniform angle in ±max_rotation degrees (white background fill) BEFORE
    margin jitter — the residual-rotation distribution the recognizer sees
    behind the separable (AABB-crop) warp and behind imperfect angle
    estimates on short lines. quantize_p: probability of pushing a strip
    through the 4-bit Bayer-dither transport round-trip
    (preprocess.pack_nibbles) — the noise distribution serving strips carry
    when warped off a packed-uploaded canvas (upload_bits=4).
    stretch > 0 rescales half the strips' WIDTH by a log-uniform factor in
    [1/(1+stretch), 1+stretch] — the aspect distortion the two-pass ink
    refinement introduces when it rescales a sub-full-height ink band to
    the full strip height (measured ~1.3x on serving crops; unaugmented
    weights read '0'→'O' from 1.2x on).
    font_weights: optional per-font sampling probabilities (len(fonts),
    normalized here) — concentrates training on the measured weak face
    (per-font e2e breakdown, DESIGN.md §4) instead of uniform fonts.
    degrade > 0: probability of scan-degradation augmentation per strip
    (degrade_image at a random level in [0.25, 1.0]) — blur, noise, JPEG,
    contrast squeeze, illumination texture. Applied AFTER the geometric
    augmentations, mirroring serving (a degraded scan is degraded before
    the warp crops it).
    flat_snap > 0: probability of applying the SERVING flat-band geometry
    (flat_snap_strip, frac drawn in [0.42, 0.52]) to eligible strips —
    train/serve consistency for cfg.rec_flat_band_frac (DESIGN.md §4f)."""
    images = np.zeros((batch_size, height, width), np.uint8)
    widths = np.zeros((batch_size,), np.int32)
    labels = np.zeros((batch_size, max_label), np.int32)
    label_lengths = np.zeros((batch_size,), np.int32)
    texts = []
    fw = None
    if font_weights is not None:
        fw = np.asarray(font_weights, np.float64)
        if fw.shape != (len(fonts),):
            raise ValueError(f"font_weights {fw.shape} != ({len(fonts)},)")
        if fw.sum() <= 0:
            raise ValueError("font_weights sum to zero — every font would "
                             "have probability NaN")
        fw = fw / fw.sum()
    for b in range(batch_size):
        while True:
            if p_word > 0 and rng.rand() < p_word:
                text = word_text(rng, charset, min_len, max_len)
            else:
                text = random_text(rng, charset, min_len, max_len,
                                   p_space=p_space,
                                   char_weights=char_weights)
            # scale augmentation: render at a random native height and
            # resize to the model height, so inference is robust to
            # upscaled/downscaled inputs (rec_resize does the same at
            # serving time for arbitrary crops). A third of samples stay at
            # the native height so the resize-free path is also sharp.
            render_h = (height if rng.rand() < 0.34
                        else int(rng.randint(height * 2 // 3, height * 2)))
            fidx = (rng.choice(len(fonts), p=fw) if fw is not None
                    else rng.randint(len(fonts)))
            strip = render_line(text, render_h, fonts[fidx], rng, noise)
            if max_rotation > 0 and rng.rand() < 0.5:
                import cv2
                ang = rng.uniform(-max_rotation, max_rotation)
                sh, sw = strip.shape
                M = cv2.getRotationMatrix2D((sw / 2.0, sh / 2.0), ang, 1.0)
                cs = np.array([[0, 0], [sw, 0], [sw, sh], [0, sh]],
                              np.float32) @ M[:, :2].T + M[:, 2]
                M[:, 2] -= cs.min(axis=0)
                ext = cs.max(axis=0) - cs.min(axis=0)
                strip = cv2.warpAffine(
                    strip, M, (int(np.ceil(ext[0])), int(np.ceil(ext[1]))),
                    flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                    borderValue=255)
                render_h = strip.shape[0]
            # margin/crop jitter: WIDE tolerance wins end-to-end. Serving
            # re-crops strips to the ink band via the two-pass refined warp
            # (ops.warp.refine_quads_to_ink), but refinement still leaves
            # residual margin wobble, and wide-jitter weights measure best:
            # e2e line-exact 0.85 (wide, below) vs 0.78 (tight -8..+12%
            # jitter) vs 0.64 (no-jitter-era weights) on refined crops —
            # even though CLEAN-strip exact-match ranks the other way
            # (0.938 vs 0.977). 30% of samples stay clean to preserve the
            # vertical-margin size cue for o/O-class pairs.
            if rng.rand() < 0.7:
                sh, sw = strip.shape
                m = np.array([
                    rng.randint(-sh * 15 // 100, sh * 50 // 100 + 1),
                    rng.randint(-sh * 15 // 100, sh * 25 // 100 + 1),
                    rng.randint(-sh * 15 // 100, sh * 30 // 100 + 1),
                    rng.randint(-sh * 15 // 100, sh * 30 // 100 + 1),
                ])  # top, bottom, left, right
                padded = np.full((sh + max(m[0], 0) + max(m[1], 0),
                                  sw + max(m[2], 0) + max(m[3], 0)),
                                 255, np.uint8)
                padded[max(m[0], 0):max(m[0], 0) + sh,
                       max(m[2], 0):max(m[2], 0) + sw] = strip
                y0 = max(-m[0], 0)
                x0 = max(-m[2], 0)
                y1 = padded.shape[0] - max(-m[1], 0)
                x1 = padded.shape[1] - max(-m[3], 0)
                if y1 - y0 >= 8 and x1 - x0 >= 4:
                    strip = padded[y0:y1, x0:x1]
                render_h = strip.shape[0]
            if render_h != height:
                import cv2
                new_w = max(1, int(round(strip.shape[1] * height / render_h)))
                strip = cv2.resize(strip, (new_w, height),
                                   interpolation=cv2.INTER_LINEAR)
            if stretch > 0 and rng.rand() < 0.5:
                import cv2
                f = (1.0 + stretch) ** rng.uniform(-1.0, 1.0)
                new_w = max(1, int(round(strip.shape[1] * f)))
                strip = cv2.resize(strip, (new_w, strip.shape[0]),
                                   interpolation=cv2.INTER_LINEAR)
            if flat_snap > 0 and rng.rand() < flat_snap:
                fs = flat_snap_strip(strip, rng.uniform(0.42, 0.52))
                if fs is not None and fs.shape[1] <= width:
                    strip = fs
            if strip.shape[1] <= width and len(text) <= max_label:
                break
        if degrade > 0 and rng.rand() < degrade:
            strip = degrade_image(strip, rng, level=rng.uniform(0.25, 1.0))
        if quantize_p > 0 and rng.rand() < quantize_p:
            from ocrjax_torch import preprocess as _P
            s = strip if strip.shape[1] % 2 == 0 else np.pad(
                strip, ((0, 0), (0, 1)), constant_values=255)
            strip = _P.unpack_nibbles_host(
                _P.pack_nibbles(s))[:, : strip.shape[1]]
        w = strip.shape[1]
        images[b, :, :w] = strip
        widths[b] = w
        ids = charset.encode(text)
        labels[b, : len(ids)] = ids
        label_lengths[b] = len(ids)
        texts.append(text)
    return LineBatch(images, widths, labels, label_lengths, texts)


# ---------------------------------------------------------------------------
# Scan degradation (BASELINE.json:5's bar is ICDAR-class photographs/scans;
# no datasets exist offline, so degraded synthetic renders are the closest
# buildable proxy — VERDICT r2 missing #2)
# ---------------------------------------------------------------------------

def degrade_image(img: np.ndarray, rng: np.random.RandomState,
                  level: float = 1.0) -> np.ndarray:
    """Apply scan/photo degradations to a grayscale uint8 image.

    level in (0, 1] scales every parameter range; each degradation fires
    independently so combinations occur (a JPEG-compressed blurry photo of
    textured paper). The menu models the ICDAR failure classes the clean
    PIL renders never show: defocus/motion blur, sensor noise, JPEG block
    artifacts, low-contrast scans, and uneven paper/illumination texture.
    Geometry is NEVER changed (ground-truth quads stay exact).
    """
    import cv2

    lv = float(level)
    out = img.astype(np.float32)
    h, w = out.shape

    # uneven illumination / paper texture: low-frequency multiplicative
    # field (bilinear-upsampled coarse noise), darkens or brightens patches
    if rng.rand() < 0.5 * lv + 0.2:
        gh, gw = max(2, h // 64), max(2, w // 64)
        field = rng.uniform(1.0 - 0.25 * lv, 1.0 + 0.10 * lv,
                            (gh, gw)).astype(np.float32)
        field = cv2.resize(field, (w, h), interpolation=cv2.INTER_LINEAR)
        out = out * field
    # contrast squeeze: gray paper, faint ink
    if rng.rand() < 0.5 * lv + 0.2:
        lo = rng.uniform(0.0, 70.0 * lv)
        hi = rng.uniform(255.0 - 80.0 * lv, 255.0)
        out = lo + out * ((hi - lo) / 255.0)
    # defocus blur
    if rng.rand() < 0.5 * lv + 0.2:
        sigma = rng.uniform(0.4, 0.5 + 1.0 * lv)
        out = cv2.GaussianBlur(out, (0, 0), sigma)
    # sensor noise
    if rng.rand() < 0.5 * lv + 0.2:
        out = out + rng.randn(h, w).astype(np.float32) \
            * rng.uniform(2.0, 14.0 * lv)
    out = np.clip(out, 0, 255).astype(np.uint8)
    # JPEG block artifacts
    if rng.rand() < 0.4 * lv + 0.1:
        q = int(rng.uniform(max(15.0, 75.0 - 55.0 * lv), 80.0))
        ok, enc = cv2.imencode(".jpg", out,
                               [cv2.IMWRITE_JPEG_QUALITY, q])
        if ok:
            out = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE)
    return out


# ---------------------------------------------------------------------------
# Pages (detection ground truth)
# ---------------------------------------------------------------------------

def render_page_dense(
    rng: np.random.RandomState,
    charset: Charset,
    size: Tuple[int, int] = (2048, 2048),
    n_lines: int = 200,
    text_height: Tuple[int, int] = (18, 30),
    max_len: int = 10,
    noise: float = 0.01,
    p_word: float = 0.0,
    fonts: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[np.ndarray], List[str]]:
    """A DENSE page: ~n_lines short text lines in a row/column layout.

    BASELINE.json:11's C5 scenario is "hundreds of lines/page" at 2048px;
    `render_page`'s rejection sampling can't place that many (it stops
    trying after 20 collisions per line), so this fills text rows top to
    bottom, several lines per row with random gaps — the layout of a dense
    table/index page. Returns (page uint8 (H, W), quads, texts) exactly
    like render_page; placement stops at n_lines or when the page is full,
    whichever first (the returned list's length is the ground truth).
    """
    H, W = size
    page = np.full((H, W), 255, np.uint8)
    quads, texts = [], []
    fs = FONTS if fonts is None else list(fonts)
    y = int(rng.randint(4, 16))
    while len(texts) < n_lines:
        th = int(rng.randint(text_height[0], text_height[1] + 1))
        row_h = th + int(rng.randint(6, 14))
        if y + row_h >= H - 4:
            break
        x = int(rng.randint(4, 24))
        while len(texts) < n_lines:
            if p_word > 0 and rng.rand() < p_word:
                text = word_text(rng, charset, 2, max_len)
            else:
                text = random_text(rng, charset, 2, max_len)
            strip = render_line(text, th, fs[rng.randint(len(fs))],
                                rng, noise, pad=2)
            sh, sw = strip.shape
            if x + sw >= W - 4:
                break
            page[y:y + sh, x:x + sw] = np.minimum(
                page[y:y + sh, x:x + sw], strip)
            quads.append(np.array(
                [[x, y], [x + sw, y], [x + sw, y + sh], [x, y + sh]],
                np.float32))
            texts.append(text)
            # inter-line gap within the row: wide enough that neighboring
            # components stay separable after DB's kernel shrink
            x += sw + int(rng.randint(max(12, th // 2), max(20, th)))
        y += row_h
    return page, quads, texts

def warp_page_projective(page: np.ndarray, quads, rng,
                         severity: float = 0.5, curl: float = 0.0):
    """Projective (keystone/perspective) page warp with EXACTLY
    transformed gt quads, plus optional mild page curl (VERDICT r3
    missing #2: real scans are never fronto-parallel; blur/noise/JPEG
    degradation never changed geometry).

    severity: each page corner displaces INWARD by an independent uniform
    draw within severity·8% of the page dims (covers keystone — a camera
    tilted about one axis — and general perspective; inward-only so no
    content leaves the frame and every gt line stays evaluable). curl:
    adds a vertical sinusoidal displacement of amplitude curl·1.5% of the
    page height across the width (the open-book/curled-scan bow); gt
    corners ride the same displacement field (text lines are short
    relative to the half-wavelength, so corner transport is exact to
    sub-pixel). Returns (warped_page, warped_quads) — white background
    fill.
    """
    import cv2

    H, W = page.shape[:2]
    out_q = [np.asarray(q, np.float32).copy() for q in quads]
    if severity > 0:
        d = 0.08 * severity
        src = np.float32([[0, 0], [W, 0], [W, H], [0, H]])
        sign = np.float32([[1, 1], [-1, 1], [-1, -1], [1, -1]])  # inward
        dst = src + sign * np.float32(
            [[rng.uniform(0, d) * W, rng.uniform(0, d) * H]
             for _ in range(4)])
        M = cv2.getPerspectiveTransform(src, dst)
        page = cv2.warpPerspective(
            page, M, (W, H), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=255)
        out_q = [cv2.perspectiveTransform(
            q.reshape(1, 4, 2).astype(np.float32), M)[0] for q in out_q]
    if curl > 0:
        amp = 0.015 * curl * H
        xs = np.arange(W, dtype=np.float32)
        dy = (amp * np.sin(np.pi * xs / W)).astype(np.float32)
        map_x = np.tile(xs, (H, 1))
        map_y = (np.arange(H, dtype=np.float32)[:, None] - dy[None, :])
        page = cv2.remap(page, map_x, map_y, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=255)
        out_q = [q + np.stack(
            [np.zeros(4, np.float32),
             amp * np.sin(np.pi * np.clip(q[:, 0], 0, W - 1) / W)], axis=1)
            for q in out_q]
    return page, out_q


def render_page(
    rng: np.random.RandomState,
    charset: Charset,
    size: Tuple[int, int] = (640, 640),
    n_lines: Tuple[int, int] = (3, 8),
    text_height: Tuple[int, int] = (18, 42),
    max_len: int = 14,
    noise: float = 0.01,
    max_rotation: float = 0.0,
    p_word: float = 0.0,
    fonts: Optional[Sequence[str]] = None,
    supersample: int = 1,
    min_len: int = 2,
) -> Tuple[np.ndarray, List[np.ndarray], List[str]]:
    """A page image with non-overlapping text lines at random positions.

    Returns (page uint8 (H, W), quads [(4,2) float32 clockwise from TL],
    texts). Quads are the tight ink bounding boxes. max_rotation > 0 rotates
    each line by a uniform angle in ±max_rotation degrees (quads follow —
    rotated rects, TL = the rendered strip's top-left corner). supersample:
    see render_line — the held-out rasterization path, eval only.
    """
    import cv2

    H, W = size
    page = np.full((H, W), 255, np.uint8)
    quads, texts = [], []
    occupied = np.zeros((H, W), bool)
    n = rng.randint(n_lines[0], n_lines[1] + 1)
    for _ in range(n):
        for _attempt in range(20):
            th = rng.randint(text_height[0], text_height[1] + 1)
            if p_word > 0 and rng.rand() < p_word:
                text = word_text(rng, charset, max(min_len, 2), max_len)
            else:
                text = random_text(rng, charset, min_len, max_len)
            fs = FONTS if fonts is None else list(fonts)
            strip = render_line(text, th, fs[rng.randint(len(fs))],
                                rng, noise, pad=2, supersample=supersample)
            sh, sw = strip.shape
            corners = np.array([[0, 0], [sw, 0], [sw, sh], [0, sh]],
                               np.float32)
            angle = (rng.uniform(-max_rotation, max_rotation)
                     if max_rotation > 0 else 0.0)
            if abs(angle) > 0.05:
                M = cv2.getRotationMatrix2D((sw / 2.0, sh / 2.0), angle, 1.0)
                rot = corners @ M[:, :2].T + M[:, 2]
                shift = rot.min(axis=0)
                M[:, 2] -= shift
                corners = rot - shift
                ext = corners.max(axis=0)
                sw, sh = int(np.ceil(ext[0])), int(np.ceil(ext[1]))
                strip = cv2.warpAffine(
                    strip, M, (sw, sh), flags=cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=255)
            if sw >= W - 4 or sh >= H - 4:
                continue
            x = rng.randint(2, W - sw - 2)
            y = rng.randint(2, H - sh - 2)
            # margin so neighboring boxes stay separable after binarization
            y0, y1 = max(0, y - 6), min(H, y + sh + 6)
            x0, x1 = max(0, x - 6), min(W, x + sw + 6)
            if occupied[y0:y1, x0:x1].any():
                continue
            page[y:y + sh, x:x + sw] = np.minimum(
                page[y:y + sh, x:x + sw], strip)
            occupied[y0:y1, x0:x1] = True
            quads.append(corners + np.array([x, y], np.float32))
            texts.append(text)
            break
    return page, quads, texts
