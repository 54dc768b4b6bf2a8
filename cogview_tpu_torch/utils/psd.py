"""PSD (Photoshop) decoder on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``PsdImagePlugin``: the image it opens is the merged
composite at the end of the file (its ``_min_frame``), never a layer.
Pillow reads 8-bit files only, in the modes bitmap (1 bit), gray,
multichannel and duotone (read as gray), indexed (with a 768-byte planar
colour table), RGB (with a fourth channel as alpha), CMYK (each channel
inverted, then Pillow's ``cmyk2rgb``) and Lab (the three planes' bytes, a
and b offset by 128 as Pillow's LAB bands hold them, converted as
LittleCMS converts them: ``utils/lab.py``); channels past those are
ignored.
The composite is raw or PackBits (each channel's rows after a table of
row byte counts).  A 16- or 32-bit file, or another mode, is one Pillow's
plugin refuses while opening (:class:`NotThisFormat`); too few
channels, another compression or short data raise a ``ValueError``, as
Pillow fails on them.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels
from .jpeg import cmyk_to_rgb
from .lab import lab_to_rgb

# (Photoshop mode, bits) -> (Pillow's mode, channels it reads)
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
          (9, 8): ("LAB", 3)}


def _u32(data: bytes, pos: int) -> int:
    if pos + 4 > len(data):
        raise NotThisFormat("corrupt PSD: a section length past the end of the file")
    return struct.unpack_from(">I", data, pos)[0]


def _packbits(data: bytes, pos: int, h: int, row: int) -> np.ndarray:
    """Pillow's PackBits decoder from ``pos`` -> [h, row] uint8: a packet
    that runs past the end of its row is cut there."""
    out = np.zeros((h, row), np.uint8)
    n = len(data)
    for y in range(h):
        x = 0
        while x < row:
            if pos >= n:
                raise ValueError("corrupt PSD: image file is truncated")
            c = data[pos]
            if c == 0x80:  # a no-op
                pos += 1
                continue
            if c & 0x80:
                if pos + 1 >= n:
                    raise ValueError("corrupt PSD: image file is truncated")
                k = min(257 - c, row - x)
                out[y, x:x + k] = data[pos + 1]
                pos += 2
            else:
                if pos + 2 + c > n:
                    raise ValueError("corrupt PSD: image file is truncated")
                k = min(c + 1, row - x)
                out[y, x:x + k] = np.frombuffer(data[pos + 1:pos + 1 + k], np.uint8)
                pos += 2 + c
            x += k
    return out


def decode_psd(data: bytes) -> np.ndarray:
    """The bytes of a PSD file -> its composite, [h, w, 3] uint8."""
    if len(data) < 26 or data[:4] != b"8BPS" or struct.unpack_from(">H", data, 4)[0] != 1:
        raise NotThisFormat("not a PSD file")
    n_channels, h, w, bits, psd_mode = struct.unpack_from(">HIIHH", data, 12)
    if (psd_mode, bits) not in _MODES:
        raise NotThisFormat(f"PSD mode {psd_mode} at {bits} bits: Pillow's plugin refuses it")
    mode, channels = _MODES[(psd_mode, bits)]
    if channels > n_channels:
        raise ValueError("corrupt PSD: not enough channels")
    if mode == "RGB" and n_channels == 4:  # Pillow reads RGBA; RGB beside more
        channels = 4
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"corrupt PSD: size {w} x {h}")
    pos = 26
    size = _u32(data, pos)  # the colour mode data
    palette = None
    if mode == "P" and size == 768:
        palette = np.frombuffer(data[pos + 4:pos + 4 + 768], np.uint8)
        if len(palette) == 768:
            palette = np.ascontiguousarray(palette.reshape(3, 256).T)
        else:
            palette = None
    pos += 4 + size
    size = _u32(data, pos)  # the image resources, walked as Pillow walks them
    pos += 4
    end = pos + size
    while pos < end:
        pos += 6  # signature, id
        if pos >= len(data):
            raise NotThisFormat("corrupt PSD: image resources past the end of the file")
        name = data[pos]
        pos += 1 + name + (not (name & 1))
        length = _u32(data, pos)
        pos += 4 + length + (length & 1)
    size = _u32(data, pos)  # the layer and mask information
    pos += 4
    if size:
        _u32(data, pos)
        pos += size
    if pos + 2 > len(data):
        raise NotThisFormat("corrupt PSD: no composite image")
    compression = struct.unpack_from(">H", data, pos)[0]
    pos += 2
    check_pixels(w, h)  # before the composite is allocated
    row = -(-w // 8) if mode == "1" else w
    if compression == 0:
        body = data[pos:pos + channels * h * row]
        if len(body) < channels * h * row:
            raise ValueError("corrupt PSD: image file is truncated")
        planes = np.frombuffer(body, np.uint8).reshape(channels, h, row)
    elif compression == 1:
        counts_end = pos + 2 * channels * h
        if counts_end > len(data):
            raise NotThisFormat("corrupt PSD: the row byte counts are cut short")
        counts = np.frombuffer(data[pos:counts_end], ">u2").astype(np.int64)
        starts = counts_end + np.concatenate([[0], np.cumsum(counts)])[::h][:channels]
        planes = np.stack([_packbits(data, int(s), h, row) for s in starts])
    else:
        raise ValueError(f"PSD compression {compression}: Pillow cannot load it")
    if mode == "1":
        gray = np.unpackbits(planes[0], axis=1)[:, :w] * np.uint8(255)
        return np.repeat(gray[..., None], 3, axis=2)
    if mode == "L":
        return np.repeat(planes[0][..., None], 3, axis=2)
    if mode == "P":  # without a colour table every index is black, as in Pillow
        return palette[planes[0]] if palette is not None else np.zeros((h, w, 3), np.uint8)
    if mode == "CMYK":
        inv = 255 - planes.astype(np.int64)
        return cmyk_to_rgb(np.moveaxis(inv[:3], 0, -1), inv[3])
    if mode == "LAB":
        return lab_to_rgb(np.moveaxis(planes[:3], 0, -1))
    return np.ascontiguousarray(np.moveaxis(planes[:3], 0, -1))
