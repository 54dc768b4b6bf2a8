"""ICO and CUR decoders on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``IcoImagePlugin`` and ``CurImagePlugin``.  An icon's
frame is the entry Pillow opens: the largest by its directory's width x
height (0 meaning 256), the smallest colour depth among equals.  A PNG
entry goes through ``utils/png.py``; any other is a DIB
(``utils/bmp.py::decode_dib``) whose height counts the AND mask, of which
the top half is the picture.  The AND mask (or, at 32 bits, the alpha
bytes) becomes the alpha that ``convert("RGB")`` drops, but Pillow still
reads it and fails where it is cut short, so the reader does too.  A
cursor's frame is the first entry that is wider and taller than every
one before it, read as a DIB.

A directory that is cut short raises :class:`NotThisFormat`, as Pillow's
plugins fail to open it (a cursor file with no entries is how Pillow's own
TGA files begin: ``Image.open`` goes on and reads them as TGA).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .bmp import decode_dib
from .image_errors import NotThisFormat
from .png import decode_png

_PNG = b"\x89PNG\r\n\x1a\n"


def _entries(data: bytes):
    if len(data) < 6:
        raise NotThisFormat("not an icon: short header")
    n = struct.unpack_from("<H", data, 4)[0]
    out = []
    for i in range(n):
        e = data[6 + 16 * i:22 + 16 * i]
        if len(e) < 16:
            raise NotThisFormat("icon directory cut short")
        out.append(e)
    return out


def decode_ico(data: bytes) -> np.ndarray:
    """The bytes of an ICO file -> [h, w, 3] uint8."""
    entries = []
    for e in _entries(data):
        w, h, colors = e[0] or 256, e[1] or 256, e[2]
        planes, bpp, size, offset = struct.unpack_from("<HHII", e, 4)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    if not entries:
        raise NotThisFormat("an icon with no entries")
    entries.sort(key=lambda x: x[1])
    entries.sort(key=lambda x: x[0], reverse=True)
    _, _, bpp, size, offset = entries[0]
    if data[offset:offset + 8] == _PNG:
        return decode_png(data[offset:])
    if len(data) < offset + 4:
        raise NotThisFormat("an icon entry past the end of the file")
    img = decode_dib(data, offset, halve=True, icon=True)
    h, w = img.shape[:2]
    if bpp == 32:
        header_size = struct.unpack_from("<I", data, offset)[0]
        start = offset + header_size  # no palette at 32 bits
        if len(data[start:start + 4 * w * h]) // 4 < w * h:
            raise ValueError("corrupt icon: not enough image data for the alpha")
    else:
        row = -(-w // 32) * 4
        and_start = offset + size - row * h
        if and_start < 0:
            raise ValueError("corrupt icon: negative seek to the AND mask")
        if len(data[and_start:and_start + row * h]) < row * h:
            raise ValueError("corrupt icon: not enough image data for the AND mask")
    return img


def decode_cur(data: bytes) -> np.ndarray:
    """The bytes of a CUR file -> [h, w, 3] uint8."""
    best = b""
    for e in _entries(data):
        if not best or (e[0] > best[0] and e[1] > best[1]):
            best = e
    if not best:
        raise NotThisFormat("no cursors were found")
    return decode_dib(data, struct.unpack_from("<I", best, 12)[0], halve=True)
