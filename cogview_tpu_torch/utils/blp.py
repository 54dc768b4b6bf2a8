"""Blizzard texture (BLP) decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``BlpImagePlugin``, which decodes BLP in Python: after the
header, 16 mipmap offsets and 16 lengths; the first mipmap is read.
BLP1 holds a JPEG (a shared header, then the mipmap's bytes; Pillow hands
its RGB on as BGR, so red and blue trade places; four components it
decodes as CMYK whatever the Adobe marker says, so a YCCK JPEG's three
colour components are read as C, M and Y, inverted like any CMYK JPEG's)
or 8-bit indices into a 256-entry BGRA palette (encodings 4 and 5).
BLP2 holds palette indices or DXT1, DXT3 or DXT5 blocks decoded by the
plugin's own code (5-6-5 colours shifted, not replicated, into 8 bits),
whose rows of whole blocks Pillow then reads as rows of the image's width,
and whose RGBA pixels it reads as RGB where the header says no alpha: the
reader keeps both.  A header cut short raises
:class:`NotThisFormat`; another compression or encoding, an index past
the palette and short data raise a ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels
from .jpeg import decode_jpeg


def _565(c: np.ndarray) -> np.ndarray:
    """BlpImagePlugin.unpack_565: [..., 3] int64, each field shifted left."""
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _dxt(body: bytes, w: int, h: int, kind: int, alpha: bool) -> bytes:
    """decode_dxt1/3/5 over every block row -> the bytes Pillow hands to its
    raw decoder: for each block row its 4 pixel rows, each ceil(w / 4) * 4
    pixels of RGB (DXT1 without alpha) or RGBA."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    size = 8 if kind == 0 else 16
    if len(body) < bw * bh * size:
        raise ValueError("corrupt BLP: image file is truncated")
    b = np.frombuffer(body[:bw * bh * size], np.uint8).reshape(bh * bw, size).astype(np.int64)
    col = b[:, size - 8:]
    c0, c1 = col[:, 0] | (col[:, 1] << 8), col[:, 2] | (col[:, 3] << 8)
    code = col[:, 4] | (col[:, 5] << 8) | (col[:, 6] << 16) | (col[:, 7] << 24)
    p0, p1 = _565(c0), _565(c1)
    three = (c0 > c1)[:, None] if kind == 0 else np.ones((len(b), 1), bool)
    p2 = np.where(three, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(three, (2 * p1 + p0) // 3, 0)
    idx = (code[:, None] >> (2 * np.arange(16))) & 3
    rgb = np.take_along_axis(np.stack([p0, p1, p2, p3], 1), idx[..., None], 1)  # [n, 16, 3]
    if kind == 0:
        a = np.where((idx == 3) & ~three, 0, 255)
    elif kind == 1:
        nib = np.stack([b[:, :8] & 15, b[:, :8] >> 4], -1).reshape(-1, 16)
        a = nib * 17
    else:
        a0, a1 = b[:, 0:1], b[:, 1:2]
        bits = b[:, 2] | (b[:, 3] << 8) | (b[:, 4] << 16) | (b[:, 5] << 24) | (b[:, 6] << 32) \
            | (b[:, 7] << 40)
        code3 = (bits[:, None] >> (3 * np.arange(16))) & 7
        k = code3
        a = np.where(k == 0, a0, np.where(k == 1, a1, np.where(
            a0 > a1, ((8 - k) * a0 + (k - 1) * a1) // 7,
            np.where(k == 6, 0, np.where(k == 7, 255, ((6 - k) * a0 + (k - 1) * a1) // 5)))))
    px = np.concatenate([rgb, a[..., None]], -1) if (alpha or kind) else rgb
    c = px.shape[-1]
    rows = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4 * c)
    return rows.astype(np.uint8).tobytes()


def _raw(data: bytes, w: int, h: int, c: int) -> np.ndarray:
    """Pillow's set_as_raw in the image's mode -> [h, w, 3]."""
    if len(data) < w * h * c:
        raise ValueError("corrupt BLP: not enough image data")
    return np.frombuffer(data[:w * h * c], np.uint8).reshape(h, w, c)[..., :3].copy()


def decode_blp(data: bytes) -> np.ndarray:
    """The bytes of a BLP file -> [h, w, 3] uint8."""
    v1 = data[:4] == b"BLP1"
    try:
        compression = struct.unpack_from("<i", data, 4)[0]
        if v1:
            alpha = struct.unpack_from("<I", data, 8)[0] != 0
            w, h, encoding = struct.unpack_from("<IIi", data, 12)
            if len(data) < 28:
                raise struct.error
            pos = 28
        else:
            encoding, alpha, alpha_enc = struct.unpack_from("<bbb", data, 8)
            alpha = alpha != 0
            w, h = struct.unpack_from("<II", data, 12)
            pos = 20
    except struct.error:
        raise NotThisFormat("not a BLP file: short header") from None
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    c = 4 if alpha else 3
    if len(data) < pos + 128:
        raise ValueError("corrupt BLP: truncated mipmap table")
    offsets = struct.unpack_from("<16I", data, pos)
    lengths = struct.unpack_from("<16I", data, pos + 64)
    pos += 128
    if v1 and compression == 0:
        if len(data) < pos + 4:
            raise ValueError("truncated BLP file")
        size = struct.unpack_from("<I", data, pos)[0]
        head = data[pos + 4:pos + 4 + size]
        at = max(offsets[0], pos + 4 + size)  # Pillow skips forward to the mipmap only
        body = data[at:at + lengths[0]]
        if len(head) < size or len(body) < lengths[0]:
            raise ValueError("truncated BLP file")
        # Pillow decodes a CMYK JPEG with the JPEG mode "CMYK" (no YCCK
        # conversion), and hands the RGB bytes to a BGR raw decoder of the
        # texture's size
        return _raw(decode_jpeg(head + body, cmyk=True).tobytes(), w, h, 3)[..., ::-1].copy()
    n_pal = min(256, (len(data) - pos) // 4)
    pal = np.frombuffer(data[pos:pos + 4 * n_pal], np.uint8).reshape(-1, 4)
    rgba = pal[:, [2, 1, 0, 3]]
    if v1:
        if compression != 1 or encoding not in (4, 5):
            raise ValueError(f"unsupported BLP compression {compression}, encoding {encoding}")
        pos += 4 * n_pal
        start = pos
    else:
        if compression != 1 or encoding not in (1, 2):
            raise ValueError(f"unknown BLP compression {compression}, encoding {encoding}")
        start = offsets[0]
    if not v1 and encoding == 2:
        if alpha_enc not in (0, 1, 7):
            raise ValueError(f"unsupported BLP alpha encoding {alpha_enc}")
        kind = {0: 0, 1: 1, 7: 2}[alpha_enc]
        return _raw(_dxt(data[start:], w, h, kind, alpha), w, h, c)
    idx = np.frombuffer(data[start:start + lengths[0]], np.uint8)
    if len(idx) < lengths[0]:
        raise ValueError("truncated BLP file")
    if idx.size and idx.max() >= len(rgba):
        raise ValueError("BLP: a palette index past the palette")
    return _raw(rgba[idx][:, :c].tobytes(), w, h, c)
