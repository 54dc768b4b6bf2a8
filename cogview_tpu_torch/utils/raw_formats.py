"""Decoders of the formats whose pixels are one raw block after a header,
equal to Pillow 12.1's ``Image.open(...).convert("RGB")``: XV thumbnails
(3-3-2 palette indices), PIXAR (RGB), McIDAS areas (8, 16 or 32-bit gray,
clipped to 8 bits as ``convert`` clips them) and IMT (8-bit gray); and :func:`gray_to_rgb`, which the gray readers
of other modules share.  Each
follows Pillow's plugin; a header it refuses raises
:class:`NotThisFormat`, short pixel data a ``ValueError``.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels


def gray_to_rgb(v: np.ndarray) -> np.ndarray:
    """[h, w] gray of any dtype -> [h, w, 3] uint8, as Pillow's
    ``convert("RGB")`` of an "I", "I;16" or "F" image: clipped to [0, 255],
    floats truncated and NaN 0."""
    if v.dtype.kind == "f":
        v = np.nan_to_num(v, nan=0.0)
    return np.repeat(np.clip(v, 0, 255).astype(np.uint8)[..., None], 3, axis=2)


def _block(data: bytes, pos: int, n: int) -> bytes:
    body = data[pos:pos + n]
    if pos < 0 or len(body) < n:
        raise ValueError("image file is truncated")
    return body


# XV's thumbnail palette: r, g in 8 levels and b in 4, index = r << 5 | g << 2 | b
_XV = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def decode_xvthumb(data: bytes) -> np.ndarray:
    """An XV thumbnail: ``P7 332``, comment lines, ``w h maxval``, then
    w x h palette indices."""
    end = data.find(b"\n", 6)
    pos = len(data) if end < 0 else end + 1
    while True:
        if pos >= len(data):
            raise NotThisFormat("unexpected EOF reading XV thumbnail file")
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        line, pos = data[pos:end], end
        if line[0] != ord("#"):
            break
    w, h = (int(t) for t in line.strip().split(maxsplit=2)[:2])
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    return _XV[np.frombuffer(_block(data, pos, w * h), np.uint8).reshape(h, w)]


def decode_pixar(data: bytes) -> np.ndarray:
    """A PIXAR file: the size at bytes 416 and 418, RGB (the mode words 14
    and 2) at byte 1024."""
    if len(data) < 428:
        raise NotThisFormat("not a PIXAR file")
    h, w = struct.unpack_from("<HH", data, 416)
    if struct.unpack_from("<HH", data, 424) != (14, 2) or w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    return np.frombuffer(_block(data, 1024, w * h * 3), np.uint8).reshape(h, w, 3).copy()


def decode_mcidas(data: bytes) -> np.ndarray:
    """A McIdas area: 64 big-endian words; rows of words[10] samples of
    words[11] bytes, words[15] prefix bytes a row, words[14] bands."""
    if len(data) < 256:
        raise NotThisFormat("not an McIdas area file")
    wd = (0,) + struct.unpack_from(">64i", data)
    size = wd[11]
    if size not in (1, 2, 4):
        raise NotThisFormat("unsupported McIdas format")
    w, h = wd[10], wd[9]
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    offset, stride = wd[34] + wd[15], wd[15] + wd[10] * wd[11] * wd[14]
    stride = stride or w * size  # Pillow's raw decoder: 0 means rows back to back
    if stride < w * size:
        raise ValueError("McIdas: a row stride shorter than its samples")
    body = _block(data, offset, stride * (h - 1) + w * size)
    rows = np.frombuffer(body + bytes(stride - w * size), np.uint8).reshape(h, stride)
    v = rows[:, :w * size].copy().view({1: "u1", 2: ">u2", 4: ">i4"}[size])
    return gray_to_rgb(v)


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def decode_imt(data: bytes) -> np.ndarray:
    """An IMT file: ``width``, ``height`` and ``pixel n8`` lines, then 8-bit
    gray after a form feed (ImtImagePlugin's _open, line by line)."""
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    w = h = 0
    gray, pos, at = False, None, 0
    for line in data.split(b"\n"):
        start, at = at, at + len(line) + 1
        if line[:1] == b"\x0c":
            pos = start + 1
            break
        if len(line) <= 1 or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = _IMT_FIELD.match(line)
        if not m:
            break
        k, v = m.group(1, 2)
        if k in (b"width", b"height"):
            try:
                n = int(v)
            except ValueError:
                raise ValueError(f"IMT: bad {k.decode()} {v!r}") from None
            w, h = (n, h) if k == b"width" else (w, n)
        elif k == b"pixel" and v == b"n8":
            gray = True
    if not gray or w <= 0 or h <= 0:
        raise NotThisFormat("not an IMT file")
    check_pixels(w, h)
    if pos is None:
        raise ValueError("IMT: Pillow opens it but cannot load it (no image data)")
    return gray_to_rgb(np.frombuffer(_block(data, pos, w * h), np.uint8).reshape(h, w))
