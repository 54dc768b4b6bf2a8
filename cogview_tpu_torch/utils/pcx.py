"""PCX and DCX decoders on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``PcxImagePlugin`` and its C ``PcxDecode``: the layouts
Pillow opens are 1 bit in 1 plane (a bitmap), 1 bit in 2 or 4 planes (a
palette of 4 or 16 from the header), and at version 5, 8 bits in 1 plane
(gray, or a palette of 256 from the 769 bytes that end the file when
they start with 12 and are no gray ramp) or in 3 planes (RGB).  Rows
decode run by run (a byte of the form 11xxxxxx repeats the next byte
xxxxxx times), a run may not cross a row, and the planes of a row are
moved together and unpacked as Pillow's decoder does, padding included.
A DCX file is read as its first PCX page.

Another layout raises a ``ValueError``, as Pillow fails on it; a box
whose far corner is not beyond the near one raises
:class:`NotThisFormat`.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels


def _rows(data: bytes, pos: int, h: int, row_bytes: int) -> np.ndarray:
    """Pillow's PcxDecode from ``pos`` -> [h, row_bytes] uint8."""
    out = bytearray()
    x = 0
    n = len(data)
    need = h * row_bytes
    while len(out) < need:
        if pos >= n:
            raise ValueError("corrupt PCX: image file is truncated")
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise ValueError("corrupt PCX: image file is truncated")
            count = b & 0x3F
            if x + count > row_bytes:
                raise ValueError("corrupt PCX: buffer overrun (a run crosses a row)")
            out += bytes([data[pos + 1]]) * count
            x += count
            pos += 2
        else:
            out.append(b)
            x += 1
            pos += 1
        if x >= row_bytes:
            x = 0
    return np.frombuffer(bytes(out), np.uint8).reshape(h, row_bytes)


def _compact(rows: np.ndarray, w: int, planar: int) -> np.ndarray:
    """PcxDecode's move of a row's planes together: for the 1-bit planar
    modes (``planar`` planes) ``planar`` bands of (w + 7) // 8 bytes, for
    the rest ``count // w`` bands of w bytes, each band i taken from
    i * (count // bands) where that exceeds the band's size."""
    count = rows.shape[1]
    if planar:
        size, bands = (w + 7) // 8, planar
        stride = count // planar
    else:
        size, bands = w, count // w
        stride = count // bands if bands else 0
    if stride > size:
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * size:(i + 1) * size] = rows[:, i * stride:i * stride + size].copy()
    return rows


def decode_pcx(data: bytes, start: int = 0) -> np.ndarray:
    """The PCX image whose header starts at ``start`` -> [h, w, 3] uint8."""
    s = data[start:start + 68]
    if len(s) < 68 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        raise NotThisFormat("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise NotThisFormat("bad PCX image size")
    check_pixels(w, h)
    version, bits, planes = s[1], s[3], s[65]
    given_stride = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:] if len(data) >= 769 else b""
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if (pal != np.arange(256, dtype=np.uint8)[:, None]).any():
                mode, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"unknown PCX mode ({bits} bits, {planes} planes)")
    stride = (w * bits + 7) // 8
    if given_stride != stride:
        stride += stride % 2
    rows = _compact(_rows(data, start + 128, h, planes * stride), w,
                    planes if mode == "P" and bits == 1 else 0)
    if mode == "1":
        gray = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        return np.repeat(gray[..., None], 3, axis=2)
    if mode == "RGB":
        return np.stack([rows[:, i * w:(i + 1) * w] for i in range(3)], axis=-1)
    if bits == 1:  # P;2L / P;4L: bit planes (w + 7) // 8 bytes apart
        s8 = (w + 7) // 8
        idx = np.zeros((h, w), np.uint8)
        for p in range(planes):
            idx |= np.unpackbits(rows[:, p * s8:(p + 1) * s8], axis=1)[:, :w] << p
        return palette[idx]
    idx = rows[:, :w]
    return palette[idx] if mode == "P" else np.repeat(idx[..., None], 3, axis=2)


def decode_dcx(data: bytes) -> np.ndarray:
    """The bytes of a DCX file -> its first page, [h, w, 3] uint8."""
    if len(data) < 8:
        raise NotThisFormat("not a DCX file: short header")
    first = struct.unpack_from("<I", data, 4)[0]
    if not first:
        raise NotThisFormat("a DCX file with no pages")
    return decode_pcx(data, first)
