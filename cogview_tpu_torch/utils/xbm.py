"""X11 bitmap (XBM) decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``XbmImagePlugin`` and its C ``XbmDecode``: the header
(``#define ..._width``, ``..._height``, an optional hot spot, then text up
to ``_bits[]``) is matched in the file's first 512 bytes; each pixel byte
is the two characters after the next ``x`` (a character that is no hex
digit counts as 0), rows of (w + 7) // 8 bytes, the first pixel in the
lowest bit, a set bit white (Pillow's raw mode ``1;R``).  A header that
does not match raises :class:`NotThisFormat`; too few bytes raise a
``ValueError``.
"""

from __future__ import annotations

import re

import numpy as np

from .image_errors import NotThisFormat, check_pixels

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _i
for _i, _c in enumerate(b"ABCDEF"):
    _HEX[_c] = 10 + _i


def decode_xbm(data: bytes) -> np.ndarray:
    """The bytes of an XBM file -> [h, w, 3] uint8."""
    m = _HEAD.match(data[:512])
    if not m:
        raise NotThisFormat("not an XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    row = (w + 7) // 8
    need = row * h
    body = np.frombuffer(data, np.uint8)
    xs = np.flatnonzero(body[m.end():] == ord("x")) + m.end()
    picked, last = [], -3  # each 'x' after the two characters of the last one
    for x in xs:
        if x >= last + 3:
            if x + 3 > len(data):
                break
            picked.append(x)
            last = x
            if len(picked) == need:
                break
    if len(picked) < need:
        raise ValueError("corrupt XBM: image file is truncated")
    at = np.asarray(picked)
    vals = (_HEX[body[at + 1]] << 4) + _HEX[body[at + 2]]
    bits = np.unpackbits(vals.astype(np.uint8).reshape(h, row), axis=1, bitorder="little")
    gray = bits[:, :w] * np.uint8(255)
    return np.repeat(gray[..., None], 3, axis=2)
