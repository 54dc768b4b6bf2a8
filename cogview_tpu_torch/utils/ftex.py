"""FTEX (Independence War 2 texture) decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``FtexImagePlugin``: a little-endian header (version,
width, height, mipmaps, one format), the format and where its first
mipmap lies, that mipmap's byte count and its bytes: BC1 blocks (format
0, ``utils/dds.py``'s decoder) or raw RGB (format 1).  A header cut
short raises :class:`NotThisFormat`; another format count or format,
and short data, a ``ValueError``, as Pillow fails on them.
"""

from __future__ import annotations

import struct

import numpy as np

from .dds import bcn_decode
from .image_errors import NotThisFormat, check_pixels


def decode_ftex(data: bytes) -> np.ndarray:
    """The bytes of an FTEX file -> [h, w, 3] uint8."""
    if len(data) < 32:
        raise NotThisFormat("not an FTEX file")
    w, h, _, nformats, fmt, where = struct.unpack_from("<6i", data, 8)
    if nformats != 1:
        raise ValueError("FTEX with more than one format: Pillow fails on it")
    if where < 0:
        raise ValueError("FTEX: a negative mipmap offset")
    if len(data[where:where + 4]) < 4:
        raise NotThisFormat("an FTEX mipmap past the end of the file")
    size = struct.unpack_from("<i", data, where)[0]
    mip = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"invalid FTEX texture compression format {fmt}")
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    if fmt == 0:
        return bcn_decode(mip, 0, w, h, 1)
    if len(mip) < w * h * 3:
        raise ValueError("corrupt FTEX: image file is truncated")
    return np.frombuffer(mip[:w * h * 3], np.uint8).reshape(h, w, 3).copy()
