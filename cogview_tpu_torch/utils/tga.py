"""TGA (Targa) decoder on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``TgaImagePlugin``: image types 1/9 (colour-mapped, or
gray where the file has no colour map), 2/10 (true colour) and 3/11 (gray),
raw or run-length encoded; depths 1 (gray), 8, 15/16 (5-5-5 with an
alpha bit), 24 and 32 (BGR(A)); colour maps of 16, 24 and 32 bits, whose
entries before the map's first index are black, as are the indices past
its end, and which Pillow applies to a gray image too (a 32-bit map, or
a map beside true colour or a bitmap, fails to load there); the four
origins.  The RLE decoder is Pillow's ``TgaRleDecode``:
a literal packet may run into the next row, a run packet may not.

A header Pillow's plugin does not take (a colour-map type other than 0
or 1, a size of 0, a depth outside 1/8/16/24/32, an unknown image type or
map depth) raises :class:`NotThisFormat`, so ``Image.open``'s order goes
on to the next plugin; a type and depth it has no raw mode for, RLE at one
bit a pixel and short data raise a ``ValueError``, as Pillow fails to load
them.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels

# (image type & 7, depth) -> bytes a pixel in the file; Pillow's raw modes
# "P"/"L" (1 byte), "LA", "BGRA;15Z", "BGR", "BGRA" and "1"
_RAW = {(1, 8): 1, (3, 1): 0, (3, 8): 1, (3, 16): 2, (2, 16): 2, (2, 24): 3, (2, 32): 4}


def _bgr15(v: np.ndarray) -> np.ndarray:
    """Little-endian 5-5-5 words -> [..., 3] uint8, each channel v * 255 // 31."""
    v = v.astype(np.int64)
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)], -1).astype(np.uint8)


def _rle(data: bytes, pos: int, rows: int, row_bytes: int, px: int) -> bytes:
    """Pillow's TgaRleDecode from ``pos`` -> ``rows`` rows of ``row_bytes``."""
    out = bytearray()
    need = rows * row_bytes
    n_data = len(data)
    while len(out) < need:
        if pos >= n_data:
            raise ValueError("corrupt TGA: image file is truncated")
        head = data[pos]
        n = px * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + px > n_data:
                raise ValueError("corrupt TGA: image file is truncated")
            if len(out) % row_bytes + n > row_bytes:
                raise ValueError("corrupt TGA: buffer overrun (a run crosses a row)")
            out += data[pos + 1:pos + 1 + px] * (n // px)
            pos += 1 + px
        else:
            if pos + 1 + n > n_data:
                raise ValueError("corrupt TGA: image file is truncated")
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
    return bytes(out[:need])


def decode_tga(data: bytes) -> np.ndarray:
    """The bytes of a TGA file -> [h, w, 3] uint8."""
    if len(data) < 18:
        raise NotThisFormat("not a TGA file: short header")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    if itype not in (1, 2, 3, 9, 10, 11):
        raise NotThisFormat("unknown TGA mode")
    orient = flags & 0x30
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start, size, mdepth = struct.unpack_from("<HHB", data, 3)
        if mdepth not in (16, 24, 32):
            raise NotThisFormat("unknown TGA map depth")
        k = mdepth // 8
        raw = bytes(k * start) + data[pos:pos + k * size]
        pos = min(pos + k * size, len(data))
        ents = np.frombuffer(raw[:len(raw) // k * k], np.uint8).reshape(-1, k)[:256]
        palette = np.zeros((256, 3), np.uint8)
        if k == 2:
            palette[:len(ents)] = _bgr15(ents[:, 0] | (ents[:, 1].astype(np.int64) << 8))
        else:
            palette[:len(ents)] = ents[:, 2::-1]
    check_pixels(w, h)
    key = (itype & 7, depth)
    if key not in _RAW:
        raise ValueError(f"TGA image type {itype} at depth {depth}: Pillow cannot load it")
    if key == (1, 8) and palette is None:
        raise ValueError("TGA: Pillow cannot load a colour-mapped image without its map")
    if palette is not None and (mdepth == 32 or itype & 7 == 2 or depth == 1):
        raise ValueError("TGA: Pillow cannot load a colour map of 32 bits, or one beside "
                         "true colour or a bitmap")
    px = _RAW[key]
    row_bytes = -(-w // 8) if px == 0 else w * px
    if itype & 8:
        if px == 0:
            raise ValueError("TGA: Pillow cannot load a run-length encoded bitmap")
        body = _rle(data, pos, h, row_bytes, px)
    else:
        body = data[pos:pos + h * row_bytes]
        if len(body) < h * row_bytes:
            raise ValueError("corrupt TGA: image file is truncated")
    rows = np.frombuffer(body, np.uint8).reshape(h, row_bytes)
    if orient in (0x00, 0x10):  # bottom-up
        rows = rows[::-1]
    if px == 0:
        gray = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        out = np.repeat(gray[..., None], 3, axis=2)
    elif palette is not None:  # Pillow applies a colour map to gray too
        out = palette[rows.reshape(h, w, px)[..., 0]]
    elif px == 1 or key == (3, 16):
        out = np.repeat(rows.reshape(h, w, px)[..., :1], 3, axis=2)
    elif px == 2:
        p = rows.reshape(h, w, 2).astype(np.int64)
        out = _bgr15(p[..., 0] | (p[..., 1] << 8))
    else:
        out = rows.reshape(h, w, px)[..., 2::-1]
    if orient in (0x10, 0x30):
        out = out[:, ::-1]
    return np.ascontiguousarray(out)
