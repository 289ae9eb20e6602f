"""Image files read through PIL, and PNG read and written with the standard
library and numpy.

The loaders read images through :func:`imread`. It opens a file with PIL
(Pillow), which decodes JPEG and every kind of PNG in native code and is what
``imageio.v2`` itself reads these formats with, so the arrays are the ones the
JAX package's loaders get. Where PIL is not installed, an 8-bit PNG without a
palette and without interlacing (grey, grey + alpha, RGB, RGBA) is decoded
here: ``zlib`` inflates the image data and numpy undoes the five row filters
of the PNG specification (None, Sub and Up over whole rows; Average and
Paeth, whose predictor reads the pixel just decoded, pixel by pixel, which
takes about half a second for a 411x618 view). Every other file then goes to
``imageio``, imported when one is met; without it the error names it.
:func:`write_png` writes what :func:`read_png` reads, each row with a chosen
filter; :func:`encode_png` and :func:`imdecode` do the same in memory.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (0 grey, 2 RGB, 4 grey + alpha, 6 RGBA)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def imread(path: str) -> np.ndarray:
    """An image file as a uint8 array: [H, W] for grey, else [H, W, C]."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        return _pil_read(Image, path)
    if path.lower().endswith(".png"):
        try:
            return read_png(path)
        except NotImplementedError:
            pass  # a kind of PNG decoded by imageio only
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise RuntimeError(
            f"{path}: without PIL or imageio only 8-bit PNG files without a palette "
            "or interlacing can be read; install Pillow for this file") from e
    return np.asarray(imageio.imread(path))


# PIL modes whose pixels numpy takes as they are; the others are converted as
# imageio converts them: a palette to RGB (RGBA where it has a transparent
# entry), bilevel to grey, the remaining colour spaces to RGB or RGBA
_PIL_AS_IS = ("L", "LA", "RGB", "RGBA", "I", "I;16", "F")


def _pil_read(Image, path) -> np.ndarray:
    with Image.open(path) as im:
        if im.mode in _PIL_AS_IS:
            return np.asarray(im)
        if im.mode == "1":
            target = "L"
        elif im.mode == "P":
            target = "RGBA" if "transparency" in im.info else "RGB"
        else:
            target = "RGBA" if "A" in im.mode or "a" in im.mode else "RGB"
        return np.asarray(im.convert(target))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


def imdecode(data: bytes, name: str = "image") -> np.ndarray:
    """An encoded image (the bytes of a PNG or JPEG file) as :func:`imread`
    gives the file: through PIL, else a PNG through :func:`decode_png`."""
    try:
        from PIL import Image
    except ImportError:
        return decode_png(data, name)
    return _pil_read(Image, io.BytesIO(data))


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced, palette-free PNG file. Raises
    ``NotImplementedError`` for other PNG kinds."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "image") -> np.ndarray:
    """:func:`read_png` of a PNG file's bytes; ``path`` names it in errors."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: a PNG file without IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {color}, interlace {interlace}")
    bpp = CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, row = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:
            cur = np.cumsum(row.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = row + prior
        elif kind in (3, 4):
            cur = _unfilter_sequential(int(kind), row, prior, bpp)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    img = out.reshape(height, width, bpp)
    return img[..., 0] if bpp == 1 else img


def _unfilter_sequential(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte's predictor reads the byte ``bpp``
    before it as decoded, so the row is walked byte by byte."""
    raw, up = row.tolist(), prior.tolist()
    cur = [0] * len(raw)
    for i, r in enumerate(raw):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            cur[i] = (r + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (r + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def write_png(path: str, img, filters=1) -> None:
    """Write a uint8 image ([H, W] grey, or [H, W, C] with C of 1-4) as an
    8-bit PNG. ``filters``: one filter type (0-4) for every row, or one per
    row."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(encode_png(img, filters))
    os.replace(tmp, path)


def encode_png(img, filters=1) -> bytes:
    """The bytes of :func:`write_png`'s file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    height, width, bpp = img.shape
    color = {v: k for k, v in CHANNELS.items()}[bpp]
    kinds = np.broadcast_to(np.asarray(filters, np.uint8), (height,))
    x = img.reshape(height, width * bpp).astype(np.int16)
    up = np.vstack([np.zeros((1, x.shape[1]), np.int16), x[:-1]])
    left = np.hstack([np.zeros((height, bpp), np.int16), x[:, :-bpp]])
    up_left = np.hstack([np.zeros((height, bpp), np.int16), up[:, :-bpp]])
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    rows = (x - pred[kinds, np.arange(height)]).astype(np.uint8)
    scan = np.hstack([kinds[:, None], rows])

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(scan.tobytes()))
            + chunk(b"IEND", b""))
