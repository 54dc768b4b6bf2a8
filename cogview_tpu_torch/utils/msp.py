"""Windows Paint (MSP) decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``MspImagePlugin``: a 32-byte header whose 16-bit words
XOR to 0; version 1 (``DanM``) holds raw rows of (w + 7) // 8 bytes,
version 2 (``LinS``) a table of each row's byte count and then the rows,
each a run (0, count, byte) or a literal (count, bytes) at a time, an
empty row white.  A set bit is white.  A header Pillow's plugin refuses
raises :class:`NotThisFormat`; short or corrupt rows raise a
``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels


def decode_msp(data: bytes) -> np.ndarray:
    """The bytes of an MSP file -> [h, w, 3] uint8."""
    if len(data) < 32:
        raise NotThisFormat("not an MSP file")
    words = struct.unpack_from("<16H", data)
    check = 0
    for v in words:
        check ^= v
    if check:
        raise NotThisFormat("bad MSP checksum")
    w, h = words[2], words[3]
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    row = (w + 7) // 8
    if data[:4] == b"DanM":
        body = data[32:32 + row * h]
    else:
        table = data[32:32 + 2 * h]
        if len(table) < 2 * h:
            raise ValueError("truncated MSP file in row map")
        pos, out = 32 + 2 * h, bytearray()
        for y, length in enumerate(struct.unpack(f"<{h}H", table)):
            if length == 0:
                out += b"\xff" * row
                continue
            rec = data[pos:pos + length]
            pos += length
            if len(rec) != length:
                raise ValueError(f"truncated MSP file on row {y}")
            i = 0
            while i < length:
                kind = rec[i]
                i += 1
                if kind == 0:
                    if i + 2 > length:
                        raise ValueError(f"corrupted MSP file in row {y}")
                    out += rec[i + 1:i + 2] * rec[i]
                    i += 2
                else:
                    out += rec[i:i + kind]
                    i += kind
        body = bytes(out)
    if len(body) < row * h:
        raise ValueError("corrupt MSP: not enough image data")
    rows = np.frombuffer(body[:row * h], np.uint8).reshape(h, row)
    gray = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    return np.repeat(gray[..., None], 3, axis=2)
