"""SGI image decoder on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``SgiImagePlugin``, its ``SGI16Decoder`` and its C
``SgiRleDecode``: 1 or 2 bytes a channel, and the layouts Pillow opens
(dimension 1 or 2 with one channel, gray; dimension 3 with 3 or 4, RGB and
RGBA); raw planes one after another, or RLE rows through the offset
table after the 512-byte header, decoded as Pillow's C decoder does, its
quirks included (a row's byte count taken as a packet count, a row that
ends early keeping the row before's tail, decoding stopped without an
error at a row whose last packet is no end).  Rows are stored bottom-up; at 2 bytes a
sample Pillow keeps the high byte of each big-endian sample.  Another
layout, RLE that runs past its row and data cut short raise a
``ValueError``, as Pillow fails on them.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels

_CHANNELS = {(1, 1): 1, (2, 1): 1, (3, 3): 3, (3, 4): 4}


def _expand(buf: bytes, start: int, n: int, out: np.ndarray, w: int, bpc: int) -> int:
    """Pillow's ``expandrow`` (1 byte) or ``expandrow2`` (2 bytes, the low
    byte of each word holding the count) of one channel's row into ``out``
    (the high byte at 2 bytes a sample), ``n`` the row's byte count taken
    as a count of packets, ``buf`` everything after the header -> 0, or 1
    where the row's last packet is no end (Pillow stops decoding there
    without an error); reading past the buffer's last byte but one raises."""
    end = len(buf) - 1  # Pillow's end_of_buffer: the last byte
    src, x = start, 0
    for k in range(n, 0, -1):
        if src + bpc - 1 > end:
            raise ValueError("corrupt SGI: RLE row overrun")
        pixel = buf[src + bpc - 1]
        src += bpc
        if k == 1 and pixel:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > w:
            raise ValueError("corrupt SGI: RLE row overrun")
        if pixel & 0x80:
            if src + bpc * count > end:
                raise ValueError("corrupt SGI: RLE row overrun")
            out[x:x + count] = np.frombuffer(buf[src:src + bpc * count], np.uint8)[::bpc]
            src += bpc * count
        else:
            if src + bpc > end + (bpc == 1):
                raise ValueError("corrupt SGI: RLE row overrun")
            out[x:x + count] = buf[src]
            src += bpc
        x += count
    return 0


def decode_sgi(data: bytes) -> np.ndarray:
    """The bytes of an SGI file -> [h, w, 3] uint8."""
    if len(data) < 12:
        raise NotThisFormat("corrupt SGI: short header")
    compression, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">HHHH", data, 4)
    if bpc not in (1, 2) or (dim, z) not in _CHANNELS:
        raise ValueError("unsupported SGI image mode")
    if w <= 0 or h <= 0:  # Pillow's "not identified by this driver"
        raise NotThisFormat(f"corrupt SGI: size {w} x {h}")
    check_pixels(w, h)
    bands = _CHANNELS[(dim, z)]
    if compression == 0:
        page = w * h * bpc
        body = data[512:512 + bands * page]
        if len(body) < bands * page:
            raise ValueError("corrupt SGI: image file is truncated")
        planes = np.frombuffer(body, np.uint8).reshape(bands, h, w, bpc)[..., 0]
    elif compression == 1:
        buf = data[512:]
        if len(buf) < 8 * h * bands:
            raise ValueError("corrupt SGI: the RLE table is cut short")
        starts = struct.unpack_from(f">{h * bands}I", buf)
        # Pillow keeps a row's length in an int: past 2**31 it is negative, no packet
        lengths = struct.unpack_from(f">{h * bands}i", buf, 4 * h * bands)
        planes = np.zeros((bands, h, w), np.uint8)
        row = np.zeros((bands, w), np.uint8)  # Pillow's line buffer: not cleared between rows
        for y in range(h):
            for c in range(bands):
                start = starts[c * h + y]
                if start < 512:
                    raise ValueError("corrupt SGI: an RLE row inside the header")
                if _expand(buf, start - 512, lengths[c * h + y], row[c], w, bpc):
                    break
            else:
                planes[:, y] = row
                continue
            break  # Pillow stops there; the rows left stay black
    else:
        raise ValueError(f"SGI compression {compression}: Pillow cannot load it")
    planes = planes[:, ::-1]
    if bands == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    return np.ascontiguousarray(np.moveaxis(planes[:3], 0, -1))
