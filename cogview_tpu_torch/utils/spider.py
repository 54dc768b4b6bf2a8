"""SPIDER image decoder on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``SpiderImagePlugin``: a header of float32 values, big-
or little-endian (big tried first), whose values 1, 2, 5, 12, 13, 22 and
23 are integers, with ``iform`` in {1, 3, -11, -12, -21, -22} and the
header's byte count equal to its records x their length; Pillow opens a
2-D image (``iform`` 1), alone or the first of a stack.  The pixels are
float32 ("F"), which ``convert`` clips to [0, 255] and truncates (NaN to
0).  A header Pillow's plugin refuses raises :class:`NotThisFormat` (the
format has no magic bytes: ``Image.open`` tries it on every file that
reaches it); data cut short raises a ``ValueError``.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels
from .raw_formats import gray_to_rgb

_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    return math.isfinite(f) and f == int(f)


def _header_length(t) -> int:
    """isSpiderHeader: the header's byte count, 0 where it is no header."""
    h = (99,) + t  # the header's values count from 1
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def decode_spider(data: bytes) -> np.ndarray:
    """The bytes of a SPIDER file -> [h, w, 3] uint8."""
    if len(data) < 27 * 4:
        raise NotThisFormat("not a valid Spider file")
    for order in (">", "<"):
        t = struct.unpack_from(f"{order}27f", data)
        hdrlen = _header_length(t)
        if hdrlen:
            break
    else:
        raise NotThisFormat("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat("not a Spider 2D image")
    w, ht = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen
    else:
        raise ValueError("SPIDER: a stack header Pillow does not open")
    if w <= 0 or ht <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, ht)
    body = data[offset:offset + 4 * w * ht]
    if len(body) < 4 * w * ht:
        raise ValueError("corrupt SPIDER: image file is truncated")
    v = np.frombuffer(body, f"{order}f4").reshape(ht, w)
    return gray_to_rgb(v)
