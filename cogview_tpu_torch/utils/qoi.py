"""QOI decoder: equal to Pillow 12.1's ``Image.open(...).convert("RGB")``.

Follows Pillow's ``QoiImagePlugin``: a 14-byte header ("qoif", width and
height big-endian, channels: 3 is RGB and any other value RGBA, the colour
space ignored), then the ops from the previous pixel, which starts as
(0, 0, 0, 255): RGB (0xfe, the alpha kept), RGBA (0xff), INDEX (an empty
slot of the 64-entry table gives (0, 0, 0, 0)), DIFF, LUMA and RUN.  Every
op but RUN stores its pixel at (r * 3 + g * 5 + b * 7 + a * 11) % 64.  The
alpha is dropped, as ``convert("RGB")`` drops it.  A file that ends before
its pixels raises a ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import check_pixels

def decode_qoi(data: bytes) -> np.ndarray:
    """The bytes of a QOI file -> [h, w, 3] uint8."""
    if data[:4] != b"qoif" or len(data) < 14:
        raise ValueError("not a QOI file")
    w, h = struct.unpack(">II", data[4:12])
    check_pixels(w, h)
    bands = 3 if data[12] == 3 else 4
    total = w * h
    out = bytearray()
    index = {}
    prev = (0, 0, 0, 255)
    pos, n = 14, len(data)
    try:
        while len(out) < total * bands:
            byte = data[pos]
            pos += 1
            if byte == 0xFE:
                value = (data[pos], data[pos + 1], data[pos + 2], prev[3])
                pos += 3
            elif byte == 0xFF:
                if pos + 4 > n:
                    raise IndexError
                value = tuple(data[pos:pos + 4])
                pos += 4
            else:
                op = byte >> 6
                if op == 0:
                    value = index.get(byte & 0x3F, (0, 0, 0, 0))
                elif op == 1:
                    value = ((prev[0] + ((byte >> 4) & 3) - 2) % 256,
                             (prev[1] + ((byte >> 2) & 3) - 2) % 256,
                             (prev[2] + (byte & 3) - 2) % 256, prev[3])
                elif op == 2:
                    second = data[pos]
                    pos += 1
                    dg = (byte & 0x3F) - 32
                    value = ((prev[0] + dg + (second >> 4) - 8) % 256, (prev[1] + dg) % 256,
                             (prev[2] + dg + (second & 0x0F) - 8) % 256, prev[3])
                else:  # RUN: the previous pixel again, not stored in the table
                    out += bytes(prev[:bands]) * ((byte & 0x3F) + 1)
                    continue
            prev = value
            r, g, b, a = value
            index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = value
            out += bytes(value[:bands])
    except IndexError:
        raise ValueError("corrupt QOI: the file ends in its pixels") from None
    pix = np.frombuffer(bytes(out[:total * bands]), np.uint8).reshape(h, w, bands)
    return np.ascontiguousarray(pix[..., :3])
