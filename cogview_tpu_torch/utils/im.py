"""IFUNC image (IM) decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``ImImagePlugin``: a text header of ``Key: value`` lines
(``Image type``, ``Image size (x*y)``, ``Lut``, ...; at least one known
key) ending at a 0x1A byte, then, where ``Lut`` is given, a planar
256-entry RGB colour map, then the first frame bottom-up.  The types read
here: bitmaps, gray, RGB, RGBA and RGBX, LA, CMYK (line-interleaved
planes), palette images (``B2``/``B4`` and any gray type whose map is no
gray ramp), the older planar ``RGB3`` and ``RYB3`` (green, red, blue),
16-bit and 32-bit integer and float gray (``L 16``, ``L 32S``, ``L 32F``,
``L 8`` ...), each converted to RGB as Pillow converts its mode (clipped,
floats truncated); YCC (``YCbCr;L`` planes, converted by Pillow's own
YCbCr tables, :data:`YCBCR_TABLES`, not libjpeg's); and the ``L*n``
depths other than 8, 16 and 32, which Pillow reads through its ``bit``
decoder (:func:`_bit_rows`) into float gray.  A header Pillow's plugin
refuses raises :class:`NotThisFormat`; an unknown type (the older ``RLB``
and ``RYB``, whose raw mode Pillow lacks) or short data a ``ValueError``.
"""

from __future__ import annotations

import re

import numpy as np

from .image_errors import NotThisFormat, check_pixels
from .jpeg import cmyk_to_rgb
from .raw_formats import gray_to_rgb
from .tiff_rgba import ycbcr_to_rgb

_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_TAGS = {b"Comment", b"Date", b"Digitalization equipment", b"File size (no of images)",
         b"Lut", b"Name", b"Scale (x,y)", b"Image size (x*y)", b"Image type"}
# Image type -> (mode, raw mode), as Pillow's OPEN table
_TYPES = {
    b"0 1 image": ("1", "1"), b"L 1 image": ("1", "1"), b"B1 image": ("1", "1"),
    b"Greyscale image": ("L", "L"), b"Grayscale image": ("L", "L"),
    b"RGB image": ("RGB", "RGB;L"), b"X 24 image": ("RGB", "RGB"),
    b"B2 image": ("P", "P;2"), b"B4 image": ("P", "P;4"),
    b"LA image": ("LA", "LA;L"), b"PA image": ("LA", "PA;L"),
    b"RGBA image": ("RGBA", "RGBA;L"), b"RGBX image": ("RGB", "RGBX;L"),
    b"CMYK image": ("CMYK", "CMYK;L"),
    b"L 32 S image": ("I", "<i4"), b"L 32 F image": ("F", "<f4"),
    b"L 8 image": ("F", "u1"), b"L*8 image": ("F", "u1"), b"L 8S image": ("F", "i1"),
    b"L*8S image": ("F", "i1"), b"L 16S image": ("F", "<i2"), b"L*16S image": ("F", "<i2"),
    b"L 32 image": ("F", "<u4"), b"L*32 image": ("F", "<u4"), b"L 32F image": ("F", "<f4"),
    b"L*32F image": ("F", "<f4"), b"L 16 image": ("I;16", "<u2"),
    b"L*16 image": ("I;16", "<u2"), b"L 16L image": ("I;16", "<u2"),
    b"L*16L image": ("I;16", "<u2"), b"L 16B image": ("I;16", ">u2"),
    b"L*16B image": ("I;16", ">u2"), b"L 32S image": ("I", "<i4"),
    b"L*32S image": ("I", "<i4"), b"RGB3 image": ("RGB", "RGB;T"),
    b"RYB3 image": ("RGB", "RGB;T"), b"YCC image": ("YCbCr", "YCbCr;L")}
# the depths Pillow's bit decoder reads: L*2 ... L*31 but 8 and 16 (32 is
# in the table, and the bit decoder refuses 32 bits)
_BITS = re.compile(rb"L\*([2-9]|[12][0-9]|3[01]) image")


def _ycbcr_table(k: float) -> np.ndarray:
    """One of ConvertYCbCr.c's tables: (c - 128) * k in 6-bit fixed point,
    each entry C's ``(int)(x + 0.5)``."""
    return np.trunc((np.arange(256) - 128) * k * 64 + 0.5).astype(np.int64)


# Pillow's convert("RGB") of YCbCr (ImagingConvertYCbCr2RGB: Y plus each
# table shifted right by 6, G's two summed first), as the tables
# tiff_rgba.ycbcr_to_rgb takes: Y, R of Cr, B of Cb, then G of Cr and of Cb
# in its 16-bit fixed point
YCBCR_TABLES = (np.arange(256), _ycbcr_table(1.402) >> 6, _ycbcr_table(1.772) >> 6,
                _ycbcr_table(-0.71414) << 10, _ycbcr_table(-0.34414) << 10)


def _bit_rows(data: bytes, pos: int, w: int, h: int, bits: int) -> np.ndarray:
    """Pillow's bit decoder with ImImagePlugin's arguments (``bits``, pad 8,
    fill 3, unsigned, bottom-up) -> [h, w] float32: each row from a byte
    boundary, its pixels taken from the low bits of the bytes up.  At a
    new row the decoder clears its bit count but not its bit buffer, so the
    bits left over from the last byte of the row before are OR-ed into the
    first byte of the next."""
    k = (w * bits + 7) // 8
    body = data[pos:pos + h * k]
    if len(body) < h * k:
        raise ValueError("corrupt IM: image file is truncated")
    rows = np.frombuffer(body, np.uint8).reshape(h, k).copy()
    left = 8 * k - w * bits
    if left and k > 1:
        rows[1:, 0] |= rows[:-1, -1] >> (8 - left)
    elif left:  # a row of one byte: the bits left over come from the byte just changed
        for r in range(1, h):
            rows[r, 0] |= rows[r - 1, 0] >> (8 - left)
    v = np.unpackbits(rows, axis=1, bitorder="little")[:, :w * bits].reshape(h, w, bits)
    v = v.astype(np.int64) @ (np.int64(1) << np.arange(bits, dtype=np.int64))
    return v[::-1].astype(np.float32)


def _header(data: bytes):
    """ImImagePlugin's _open up to the pixels -> (its keys, the pixels' offset)."""
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    info, pos, tags = {}, 0, 0
    while True:
        c = data[pos:pos + 1]
        pos += 1
        if c == b"\r":
            continue
        if not c or c in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        line = c + data[pos:end]
        pos = end
        if len(line) > 100:
            raise NotThisFormat("not an IM file")
        if line.endswith(b"\r\n"):
            line = line[:-2]
        elif line.endswith(b"\n"):
            line = line[:-1]
        m = _LINE.match(line)
        if not m:
            raise NotThisFormat("syntax error in IM header")
        info[m.group(1)] = m.group(2)
        tags += m.group(1) in _TAGS
    if not tags:
        raise NotThisFormat("not an IM file")
    end = data.find(b"\x1a", pos - 1)
    if end < 0:
        raise NotThisFormat("IM file truncated")
    return info, end + 1




def _number(v: bytes):
    try:
        return int(v)
    except ValueError:
        return float(v)


def decode_im(data: bytes) -> np.ndarray:
    """The bytes of an IM file -> [h, w, 3] uint8."""
    info, pos = _header(data)
    kind = info.get(b"Image type", b"Greyscale image")
    try:  # Pillow parses these three keys' numbers while it opens the file
        size, _, _ = (tuple(_number(t) for t in info.get(k, b"512*512").replace(b"*", b",")
                            .split(b",")) for k in (b"Image size (x*y)",
                                                    b"File size (no of images)", b"Scale (x,y)"))
    except ValueError:
        raise ValueError("IM: a number Pillow cannot parse") from None
    bits = kind not in _TYPES and _BITS.fullmatch(kind)
    if kind not in _TYPES and not bits:
        raise ValueError(f"IM image type {kind!r}: Pillow cannot load it")
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ValueError("IM: a size Pillow cannot use")
    w, h = size
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    mode, raw = _TYPES[kind] if not bits else ("F", "bit")
    palette = None
    if b"Lut" in info:
        pal = np.frombuffer(data[pos:pos + 768].ljust(768, b"\0"), np.uint8).reshape(3, 256)
        pos += 768
        gray = (pal[0] == pal[1]).all() and (pal[1] == pal[2]).all()
        if mode in ("L", "LA", "P") and not gray:
            palette, mode = np.ascontiguousarray(pal.T), "P"
            raw = "P" if raw in ("L", "P;2", "P;4") else "PA;L"
    if raw == "bit":
        return gray_to_rgb(_bit_rows(data, pos, w, h, int(bits.group(1))))
    if raw == "RGB;T":  # three planes, G, R and B, each bottom-up
        body = data[pos:pos + 3 * w * h]
        if len(body) < 3 * w * h:
            raise ValueError("corrupt IM: image file is truncated")
        g, r, b = np.frombuffer(body, np.uint8).reshape(3, h, w)[:, ::-1]
        return np.stack([r, g, b], -1)
    if raw in ("1", "P;2", "P;4"):
        bits = {"1": 1, "P;2": 2, "P;4": 4}[raw]
        row = (w * bits + 7) // 8
    elif raw.endswith(";L") or raw == "RGB":
        bands = 3 if raw == "YCbCr;L" else len(raw.split(";")[0])
        row = w * bands
    elif raw in ("L", "P"):
        row = w
    else:
        row = w * np.dtype(raw).itemsize
    body = data[pos:pos + row * h]
    if len(body) < row * h:
        raise ValueError("corrupt IM: image file is truncated")
    rows = np.frombuffer(body, np.uint8).reshape(h, row)[::-1]  # bottom-up
    if raw in ("1", "P;2", "P;4"):
        v = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
        v = (v * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(-1)[:, :w]
        if raw == "1":
            return np.repeat((v * 255).astype(np.uint8)[..., None], 3, axis=2)
        return np.zeros((h, w, 3), np.uint8)  # a palette image with no palette: black
    if raw.endswith(";L"):  # each row's planes one after another
        planes = rows.reshape(h, -1, w)
        first = planes[:, 0]
        if mode == "P":
            return palette[first]
        if raw in ("LA;L", "PA;L"):
            return np.repeat(first[..., None], 3, axis=2)
        if raw == "CMYK;L":
            return cmyk_to_rgb(np.moveaxis(planes[:, :3], 1, -1), planes[:, 3])
        if raw == "YCbCr;L":
            return ycbcr_to_rgb(YCBCR_TABLES, *(planes[:, i] for i in range(3)))
        return np.ascontiguousarray(np.moveaxis(planes[:, :3], 1, -1))
    if raw == "RGB":
        return rows.reshape(h, w, 3).copy()
    if raw in ("L", "P"):
        return palette[rows] if mode == "P" else np.repeat(rows[..., None], 3, axis=2)
    v = rows.copy().view(raw).reshape(h, w)
    return gray_to_rgb(v.astype(np.float32) if mode == "F" else v)
