"""Minimal PNG writer and reader on the standard library (zlib + struct).

The writer emits 8-bit RGB, no interlace, filter type 0 on every row.  The
reader takes 8-bit non-interlaced RGB and RGBA with any of the five row
filters, which covers the writer's output and what Pillow writes for such
images; alpha is dropped, as Pillow's ``convert("RGB")`` does.  Other
formats raise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> bytes per pixel at 8 bits: RGB, RGBA


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """img: [h, w, 3] uint8."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png wants [h, w, 3] uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[h, 1 + stride] filtered scanlines -> [h, stride] raw bytes (PNG
    spec section 9: filters 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype, line = int(rows[r, 0]), rows[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 2:
            cur = line + prev  # uint8 arithmetic wraps mod 256
        elif ftype == 1:
            # running sum along each channel: Recon(x) = Filt(x) + Recon(a)
            px = line.reshape(-1, bpp).astype(np.int64)
            cur = (np.cumsum(px, axis=0) % 256).astype(np.uint8).reshape(-1)
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[r] = cur
        prev = out[r]
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced RGB or RGBA PNG -> [h, w, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or ctype not in _CHANNELS or interlace != 0:
                raise ValueError(f"{path}: only 8-bit RGB or RGBA, non-interlaced "
                                 f"(depth {depth}, colour type {ctype}, interlace {interlace})")
            size = (h, w, _CHANNELS[ctype])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    if size is None:
        raise ValueError(f"{path}: no IHDR chunk")
    h, w, bpp = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + bpp * w)
    return _unfilter(rows, bpp).reshape(h, w, bpp)[..., :3].copy()
