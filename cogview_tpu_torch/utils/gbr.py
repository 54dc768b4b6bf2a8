"""GIMP brush (GBR) decoder on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``GbrImagePlugin``: a big-endian header of at least 20
bytes, version 1 or 2 (version 2 with the "GIMP" magic and a spacing),
then the pixels at the header's end, gray (1 byte) or RGBA (4 bytes, the
alpha dropped).  A header the plugin refuses raises
:class:`NotThisFormat`; pixels cut short raise a ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels


def decode_gbr(data: bytes) -> np.ndarray:
    """The bytes of a GBR file -> [h, w, 3] uint8."""
    if len(data) < 20:
        raise NotThisFormat("not a GIMP brush: short header")
    header_size, version, w, h, depth = struct.unpack_from(">5I", data)
    if header_size < 20 or version not in (1, 2) or w == 0 or h == 0 or depth not in (1, 4):
        raise NotThisFormat("not a GIMP brush")
    if version == 2 and data[20:24] != b"GIMP":
        raise NotThisFormat("not a GIMP brush, bad magic number")
    check_pixels(w, h)
    body = data[header_size:header_size + w * h * depth]
    if len(body) < w * h * depth:
        raise ValueError("corrupt GBR: not enough image data")
    px = np.frombuffer(body, np.uint8).reshape(h, w, depth)
    return np.repeat(px, 3, axis=2) if depth == 1 else np.ascontiguousarray(px[..., :3])
