"""BMP decoder on numpy, equal to Pillow 12.1's ``Image.open(...).convert("RGB")``.

Follows Pillow's ``BmpImagePlugin``: the core (12-byte) header and the
40/52/56/64/108/124-byte info headers; uncompressed 1, 4 and 8 bits through
a palette, 16 bits as 5-5-5, 24 and 32 bits as BGR(X); BI_BITFIELDS with
the masks Pillow accepts (5-6-5 and 5-5-5 at 16 bits, the byte-aligned
layouts at 24 and 32); RLE8 and RLE4 as Pillow's ``BmpRleDecoder`` runs
them (its delta escape reads two bytes it drops and then two more, as
there); bottom-up rows, and top-down where the height is negative.
:func:`decode_dib` reads the bitmap of a headerless DIB file or of an
icon or cursor entry.  What Pillow refuses (another header size or depth,
a bitfield layout it does not know, too little pixel data) raises a
``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3

# the bitfield masks Pillow accepts -> (bytes per pixel, how to unpack)
_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _i32(b: bytes, at: int) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _i16(b: bytes, at: int) -> int:
    return struct.unpack_from("<H", b, at)[0]


def _scale(v: np.ndarray, bits: int) -> np.ndarray:
    """An n-bit channel -> 8 bits as Pillow's unpackers: v * 255 / max."""
    return (v.astype(np.int64) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _unpack_rows(rows: np.ndarray, raw: str, w: int) -> np.ndarray:
    """[h, stride] bytes -> [h, w, 3] uint8 by Pillow's raw mode."""
    h = rows.shape[0]
    if raw in ("BGR;15", "BGR;16"):
        px = rows[:, :2 * w].reshape(h, w, 2).astype(np.int64)
        v = px[..., 0] | (px[..., 1] << 8)
        if raw == "BGR;15":
            r, g, b = _scale((v >> 10) & 31, 5), _scale((v >> 5) & 31, 5), _scale(v & 31, 5)
        else:
            r, g, b = _scale((v >> 11) & 31, 5), _scale((v >> 5) & 63, 6), _scale(v & 31, 5)
        return np.stack([r, g, b], axis=-1)
    n = 3 if raw == "BGR" else 4
    px = rows[:, :n * w].reshape(h, w, n)
    return np.stack([px[..., raw.index(c)] for c in "RGB"], axis=-1)


def _unpack_indices(rows: np.ndarray, bits: int, w: int) -> np.ndarray:
    """[h, stride] bytes of 1, 4 or 8-bit indices, most significant first
    -> [h, w] indices."""
    if bits == 8:
        return rows[:, :w]
    shifts = np.arange(8 - bits, -1, -bits)
    idx = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return idx.reshape(rows.shape[0], -1)[:, :w]


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """Pillow's BmpRleDecoder from ``pos`` -> [h * w] indices in stream
    order (the bottom row first for a bottom-up file)."""
    out = bytearray()
    x = 0
    dest = w * h
    n = len(data)
    while len(out) < dest:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded run
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow drops two bytes, then reads two more
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError("corrupt BMP: RLE delta past the end of the file")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute run
            if rle4:
                take = byte // 2
                chunk = data[pos:pos + take]
                for b in chunk:
                    out += bytes((b >> 4, b & 15))
            else:
                take = byte
                chunk = data[pos:pos + take]
                out += chunk
            pos += len(chunk)
            if len(chunk) < take:
                break
            x += byte
            if pos % 2:  # word alignment, on the file offset
                pos += 1
    if len(out) < dest:
        raise ValueError("corrupt BMP: not enough image data")
    return np.frombuffer(bytes(out[:dest]), np.uint8)


def decode_bmp(data: bytes) -> np.ndarray:
    """The bytes of a BMP file -> [h, w, 3] uint8."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    if len(data) < 18:
        raise NotThisFormat("corrupt BMP: truncated header")
    return decode_dib(data, 14, _i32(data, 10))


def decode_dib(data: bytes, start: int = 0, offset: int = 0, halve: bool = False,
               icon: bool = False) -> np.ndarray:
    """The bitmap whose info header starts at ``start`` -> [h, w, 3] uint8,
    as Pillow's ``BmpImageFile._bitmap``: ``offset`` is where the pixels
    start (0: right after the header, masks and palette, as in a DIB file
    or an icon).  ``halve`` reads the top half of the height, as an icon's
    bitmap, whose height counts its AND mask too, is read.  Pillow's
    decompression-bomb check sees the halved height of a cursor and the
    whole height of an ``icon`` entry."""
    if len(data) < start + 4:
        raise NotThisFormat("corrupt BMP: truncated header")
    header_size = _i32(data, start)
    hd = data[start + 4:start + header_size]
    if len(hd) < header_size - 4:
        raise ValueError("corrupt BMP: truncated header")
    at = start + header_size  # the file position after the header
    direction = -1
    if header_size == 12:
        w, h, bits = _i16(hd, 0), _i16(hd, 2), _i16(hd, 6)
        compression, colors, padding = _RAW, 0, 3
    elif header_size in (40, 52, 56, 64, 108, 124):
        y_flip = hd[7] == 0xFF
        direction = 1 if y_flip else -1
        w = _i32(hd, 0)
        h = 2 ** 32 - _i32(hd, 4) if y_flip else _i32(hd, 4)
        bits, compression, colors = _i16(hd, 10), _i32(hd, 12), _i32(hd, 28)
        padding = 4
        if compression == _BITFIELDS:
            if len(hd) >= 48:
                masks = [_i32(hd, 36 + 4 * i) for i in range(4 if len(hd) >= 52 else 3)]
            else:  # a 40-byte header: the three masks follow it
                if at + 12 > len(data):
                    raise ValueError("corrupt BMP: truncated bitfield masks")
                masks = [_i32(data, at + 4 * i) for i in range(3)]
                at += 12
            masks += [0] * (4 - len(masks))
    else:
        raise ValueError(f"unsupported BMP header type ({header_size})")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    full_h = h
    if halve:
        h //= 2
    raw = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}.get(bits)
    if raw is None:
        raise ValueError(f"unsupported BMP pixel depth ({bits})")
    if compression == _BITFIELDS:
        key = (bits, tuple(masks)) if bits == 32 else (bits, tuple(masks[:3]))
        if key not in _MASKS:
            raise ValueError("unsupported BMP bitfields layout")
        raw = _MASKS[key]
    elif compression not in (_RAW, _RLE8, _RLE4):
        raise ValueError(f"unsupported BMP compression ({compression})")
    if w <= 0 or h <= 0:  # Pillow's "not identified by this driver"
        raise NotThisFormat(f"corrupt BMP: size {w} x {h}")
    check_pixels(w, full_h if icon else h)

    palette = None
    unpack_bits = bits  # what Pillow's unpacker reads a pixel as
    if raw.startswith("P"):
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette size ({colors})")
        pal = data[at:at + padding * colors]
        at += len(pal)
        entries = (0, 255) if colors == 2 else range(colors)
        gray = all(pal[i * padding:i * padding + 3] == bytes([v]) * 3
                   for i, v in enumerate(entries))
        if gray:
            # Pillow drops a gray palette: mode "1" (two colours) or "L",
            # unpacked at 1 or 8 bits a pixel whatever the file's depth
            unpack_bits = 1 if colors == 2 else 8
            palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
            if colors == 2:
                palette[1] = 255
        else:
            k = min(len(pal) // padding, 256)
            p = np.frombuffer(pal[:k * padding], np.uint8).reshape(k, padding)
            palette = np.zeros((256, 3), np.uint8)
            palette[:k] = p[:, 2::-1]  # BGR(X) -> RGB

    offset = offset or at
    if compression in (_RLE8, _RLE4):
        if unpack_bits == 1:
            raise ValueError("BMP: Pillow cannot read a two-colour gray RLE bitmap")
        idx = _rle(data, offset, w, h, compression == _RLE4).reshape(h, w)
        if direction == -1:
            idx = idx[::-1]
        return palette[idx]

    stride = ((w * bits + 31) >> 3) & ~3
    if (w * unpack_bits + 7) // 8 > stride:
        raise ValueError("BMP: Pillow cannot read a gray-palette bitmap at this depth")
    body = data[offset:offset + stride * h]
    # Pillow's raw decoder needs no padding after the last row
    if len(body) < stride * (h - 1) + (w * unpack_bits + 7) // 8:
        raise ValueError("corrupt BMP: image file is truncated")
    rows = np.frombuffer(body.ljust(stride * h, b"\0"), np.uint8).reshape(h, stride)
    if direction == -1:
        rows = rows[::-1]
    if palette is not None:
        return palette[_unpack_indices(rows, unpack_bits, w)]
    return _unpack_rows(rows, raw, w)
