"""Kodak PhotoCD (PCD) decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``PcdImagePlugin``, which has no ``_accept``: a file
whose sector 1 (byte 2048) starts ``PCD_`` and holds at least 1539 bytes.
Pillow reads only the 768 x 512 base image, at sector 96 (byte 96 * 2048),
through its ``pcd`` decoder: each chunk of 3 * 768 bytes holds two rows of
luma and then one row each of the two chromas at half width, which the
pair of rows shares.  The ``YCC;P`` unpacker turns each (Y, C1, C2) into
RGB with PhotoYCC tables (:data:`YCC_TABLES`).  The orientation in
the low 2 bits of sector 1's byte 1538 rotates the image: 1 by 90 degrees
and 3 by 270, counter-clockwise, into 512 x 768.  A file cut inside the
base image raises a ``ValueError``, as Pillow fails to load it.
"""

from __future__ import annotations

import numpy as np

from .image_errors import NotThisFormat, check_pixels
from .tiff_rgba import ycbcr_to_rgb

W, H = 768, 512  # the base image
_BASE = 96 * 2048  # its offset
_CHUNK = 3 * W  # two luma rows and one row of each chroma


def _table(k: float, centre: int) -> np.ndarray:
    """One of UnpackYCC.c's tables: k * (v - centre), each entry C's
    ``(int)(x + 0.5)``."""
    return np.trunc(k * (np.arange(256) - centre) + 0.5).astype(np.int64)


# UnpackYCC.c's tables (Y; R of C2, B of C1; G of C2 and of C1), in the form
# tiff_rgba.ycbcr_to_rgb takes (G's in 16-bit fixed point): each channel
# the sum of its tables, clipped to 0..255
YCC_TABLES = (_table(1.3584, 0), _table(1.8215, 137), _table(2.2179, 156),
              _table(-0.9271, 137) << 16, _table(-0.4303, 156) << 16)


def decode_pcd(data: bytes) -> np.ndarray:
    """The bytes of a PCD file -> [512, 768, 3] or, rotated, [768, 512, 3]
    uint8."""
    if len(data) < 2048 + 1539 or data[2048:2052] != b"PCD_":
        raise NotThisFormat("not a PCD file")
    orientation = data[2048 + 1538] & 3
    check_pixels(W, H)
    body = data[_BASE:_BASE + H // 2 * _CHUNK]
    if len(body) < H // 2 * _CHUNK:
        raise ValueError("PCD: image file is truncated")
    chunks = np.frombuffer(body, np.uint8).reshape(H // 2, _CHUNK)
    y = chunks[:, :2 * W].reshape(H, W)

    def chroma(start: int) -> np.ndarray:  # each sample for 2 x 2 pixels
        return np.repeat(np.repeat(chunks[:, start:start + W // 2], 2, 0), 2, 1)

    img = ycbcr_to_rgb(YCC_TABLES, y, chroma(2 * W), chroma(2 * W + W // 2))
    if orientation in (1, 3):  # Image.rotate(90 or 270, expand=True)
        img = np.rot90(img, 1 if orientation == 1 else 3)
    return np.ascontiguousarray(img)
