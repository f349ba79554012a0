"""Image files without cv2: a PNG decoder in zlib and numpy.

The machine with the card has neither cv2 nor PIL, so the port decodes the
PNGs its entry points are handed itself: 8-bit, non-interlaced, colour
types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA), all
five scanline filters. The result equals cv2.imread(path, IMREAD_COLOR)
followed by BGR -> RGB, byte for byte: grey is replicated to three
channels, a palette is looked up, alpha is dropped (not composited).

Any other file (another format, or a 16-bit, sub-byte or interlaced PNG) is
decoded with cv2 where it can be imported; without cv2 it raises
ImageDecodeError naming the format. Nothing is guessed: a malformed PNG (a
truncated or mis-sized chunk, a bad CRC, dimensions its data does not fill)
raises ImageDecodeError, an OSError, which every batch lane catches to
isolate the page as the reference isolates a file cv2 cannot read.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"), (b"GIF8", "GIF"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"P1", "PBM"),
          (b"P2", "PGM"), (b"P3", "PPM"), (b"P4", "PBM"), (b"P5", "PGM"),
          (b"P6", "PPM"))
# bytes a pixel for each colour type at bit depth 8
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class ImageDecodeError(OSError):
    """A file the port cannot decode: its format is named."""


def _format_name(data: bytes) -> str:
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown format"


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature; CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ImageDecodeError("PNG: truncated chunk header")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) < n or len(crc) < 4:
            raise ImageDecodeError(f"PNG: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ImageDecodeError(f"PNG: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters: rows (H, 1 + W * bpp) uint8 with each
    row's filter type first -> (H, W, bpp) uint8.

    Sub, Average and Paeth read the pixel to the left in the same row, so a
    row cannot be undone in one vector step. Pixel (y, x) needs (y, x-1),
    (y-1, x) and (y-1, x-1) only, so every anti-diagonal y + x = t is done
    at once, over all filter types, in H + W - 1 steps."""
    H = rows.shape[0]
    W = (rows.shape[1] - 1) // bpp
    ftype = rows[:, 0]
    if int(ftype.max(initial=0)) > 4:
        raise ImageDecodeError(f"PNG: unknown filter type {ftype.max()}")
    raw = rows[:, 1:].reshape(H, W, bpp).astype(np.int16)
    out = np.zeros((H + 1, W + 1, bpp), np.int16)   # zero row/column border
    for t in range(H + W - 1):
        y = np.arange(max(0, t - W + 1), min(H, t + 1))
        x = t - y
        a = out[y + 1, x]                 # left
        b = out[y, x + 1]                 # above
        c = out[y, x]                     # above left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        fy = ftype[y][:, None]
        pred = np.select([fy == 1, fy == 2, fy == 3, fy == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (raw[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes):
    """PNG bytes -> uint8 RGB (H, W, 3), as cv2.imread(IMREAD_COLOR) and
    BGR -> RGB give it; None for a PNG kind this decoder leaves to cv2
    (bit depth other than 8, interlaced)."""
    ihdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ImageDecodeError(
                    f"PNG: IHDR chunk of {len(body)} bytes, not 13")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3:
                raise ImageDecodeError(
                    f"PNG: PLTE chunk of {len(body)} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ImageDecodeError("PNG: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        return None
    if W == 0 or H == 0:
        raise ImageDecodeError(f"PNG: empty image {W}x{H} in IHDR")
    bpp = _CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ImageDecodeError(f"PNG: corrupt image data ({e})") from None
    if raw.size < H * (1 + W * bpp):
        raise ImageDecodeError("PNG: image data ends early")
    px = _unfilter(raw[:H * (1 + W * bpp)].reshape(H, 1 + W * bpp), bpp)
    if ctype == 3:
        if palette is None or int(px.max(initial=0)) >= len(palette):
            raise ImageDecodeError("PNG: palette index out of range")
        return palette[px[..., 0]]
    if ctype in (0, 4):                   # grey (+ alpha): replicate grey
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])   # RGB (+ alpha dropped)


def read_image(path: str) -> np.ndarray:
    """Image file -> uint8 RGB (H, W, 3). PNG by decode_png; anything else
    through cv2 when it can be imported, else ImageDecodeError naming the
    format. A missing file raises FileNotFoundError."""
    with open(path, "rb") as f:
        data = f.read()
    name = _format_name(data)
    if name == "PNG":
        img = decode_png(data)
        if img is not None:
            return img
        W, H, depth, ctype, _, _, interlace = struct.unpack(
            ">IIBBBBB", data[16:29])
        name = (f"PNG with bit depth {depth}, colour type {ctype}"
                f"{', interlaced' if interlace else ''}")
    try:
        import cv2
    except ImportError:
        raise ImageDecodeError(
            f"{path}: {name} is not decoded without cv2 (the port decodes "
            f"8-bit non-interlaced PNG itself)") from None
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise ImageDecodeError(f"{path}: cv2 could not decode this {name}")
    return np.ascontiguousarray(bgr[..., ::-1])
