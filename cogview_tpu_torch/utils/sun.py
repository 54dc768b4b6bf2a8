"""Sun raster decoder on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``SunImagePlugin`` and its C ``SunRleDecode``: depths 1
(a set bit black), 4 and 8 (gray, or indices into a planar RGB colour map
of at most 1,024 bytes), 24 and 32 (BGR(X), or RGB(X) for file type 3);
raw rows padded to 16 bits, or type 2's run-length rows, which Pillow
reads unpadded: 0x80 0x00 is a literal 0x80, 0x80 n v a run of n + 1
bytes v, which may run on into the next row.  A header Pillow's plugin refuses raises
:class:`NotThisFormat`; a colour map beside true colour or a bitmap and short
data raise a ``ValueError``, as Pillow fails on them.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels


def _rle(data: bytes, pos: int, h: int, row: int) -> np.ndarray:
    out = bytearray()
    need, n = h * row, len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError("corrupt Sun raster: image file is truncated")
        b = data[pos]
        if b != 0x80:
            out.append(b)
            pos += 1
            continue
        if pos + 1 >= n:
            raise ValueError("corrupt Sun raster: image file is truncated")
        if data[pos + 1] == 0:
            out.append(0x80)
            pos += 2
            continue
        if pos + 2 >= n:
            raise ValueError("corrupt Sun raster: image file is truncated")
        out += bytes([data[pos + 2]]) * (data[pos + 1] + 1)
        pos += 3
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, row)


def decode_sun(data: bytes) -> np.ndarray:
    """The bytes of a Sun raster file -> [h, w, 3] uint8."""
    if len(data) < 32:
        raise NotThisFormat("not a Sun raster file")
    _, w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">8I", data)
    if depth not in (1, 4, 8, 24, 32):
        raise NotThisFormat("unsupported Sun raster depth")
    palette = None
    if plen:
        if plen > 1024 or ptype != 1:
            raise NotThisFormat("unsupported Sun raster colour map")
        pal = np.frombuffer(data[32:32 + plen], np.uint8)
        k = len(pal) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:k] = pal[:3 * k].reshape(3, k).T
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("unsupported Sun raster file type")
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    if palette is not None and depth not in (4, 8):
        raise ValueError("Sun raster: Pillow cannot load a colour map beside true colour "
                         "or a bitmap")
    pos = 32 + plen
    row = (w * depth + 7) // 8
    if ftype == 2:
        rows = _rle(data, pos, h, row)
    else:
        stride = ((w * depth + 15) // 16) * 2
        body = data[pos:pos + stride * h]
        if len(body) < stride * (h - 1) + row:  # the last row needs no padding
            raise ValueError("corrupt Sun raster: image file is truncated")
        rows = np.frombuffer(body.ljust(stride * h, b"\0"), np.uint8).reshape(h, stride)[:, :row]
    if depth == 1:
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return np.repeat(((1 - bits) * 255).astype(np.uint8)[..., None], 3, axis=2)
    if depth == 4:
        v = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
    elif depth == 8:
        v = rows[:, :w]
    else:
        px = rows.reshape(h, w, depth // 8)
        return np.ascontiguousarray(px[..., :3] if ftype == 3 else px[..., 2::-1])
    if palette is not None:
        return palette[v]
    gray = (v * 17).astype(np.uint8) if depth == 4 else v
    return np.repeat(gray[..., None], 3, axis=2)
