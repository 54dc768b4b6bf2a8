"""Minimal PNG writer and reader on the standard library (zlib + struct).

The writer emits 8-bit RGB, no interlace, filter type 0 on every row.  The
reader takes every PNG the specification allows: colour types 0 (gray), 2
(RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA), every legal depth (1, 2,
4, 8, 16), with or without Adam7 interlace, any of the five row filters.
It returns what Pillow 12.1's ``Image.open(path).convert("RGB")`` returns,
byte for byte:

- alpha and ``tRNS`` are dropped;
- gray at 1, 2 and 4 bits scales to 8 bits (2-bit 0..3 reads 0, 85, 170,
  255);
- 16-bit gray saturates at 255 (Pillow opens it as ``I;16``), while 16-bit
  RGB, RGBA and gray + alpha take the high byte of each sample;
- a palette index past the end of ``PLTE`` reads black.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, legal depths)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """img: [h, w, 3] uint8 -> the bytes of a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png wants [h, w, 3] uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """img: [h, w, 3] uint8."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[h, 1 + stride] filtered scanlines -> [h, stride] raw bytes (PNG
    spec section 9: filters 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).
    ``bpp`` is the bytes per complete pixel, at least 1."""
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
            # running sum along each byte of a pixel: Recon(x) = Filt(x) +
            # Recon(a); a row of sub-byte pixels sums byte by byte (bpp 1)
            px = np.zeros(-(-stride // bpp) * bpp, np.int64)
            px[:stride] = line
            cur = (np.cumsum(px.reshape(-1, bpp), axis=0) % 256).astype(np.uint8)
            cur = cur.reshape(-1)[:stride]
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


def _samples(raw: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, width, channels] (uint8,
    or uint16 at 16 bits); sub-byte samples unpack MSB first."""
    h = raw.shape[0]
    if depth == 8:
        return raw[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        return (raw[:, :2 * width * channels].reshape(h, -1).view(">u2").astype(np.uint16)
                .reshape(h, width, channels))
    bits = np.unpackbits(raw, axis=1)  # MSB first
    n = width * channels
    bits = bits[:, :n * depth].reshape(h, n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8).reshape(h, width, channels)


def _decode_pass(data: memoryview, pos: int, width: int, height: int, channels: int,
                 depth: int):
    """One image (or one Adam7 pass) from the inflated stream at ``pos`` ->
    (samples [height, width, channels], next position)."""
    stride = -(-width * channels * depth // 8)
    n = height * (1 + stride)
    if len(data) < pos + n:
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(data[pos:pos + n], np.uint8).reshape(height, 1 + stride)
    raw = _unfilter(rows, max(1, channels * depth // 8))
    return _samples(raw, width, channels, depth), pos + n


def _to_rgb(s: np.ndarray, ctype: int, depth: int, palette: np.ndarray) -> np.ndarray:
    """Samples [h, w, channels] -> [h, w, 3] uint8 as Pillow's
    ``convert("RGB")``."""
    if ctype == 3:
        # Pillow's palette holds 256 entries, black past PLTE's end
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette
        return lut[s[..., 0]]
    if depth == 16:
        # gray opens as I;16 and saturates; colour and alpha take the high byte
        s = np.minimum(s, 255) if ctype == 0 else s >> 8
        s = s.astype(np.uint8)
    elif depth < 8:  # gray only: 1, 2, 4 bits scaled to 8
        s = s * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG file -> [h, w, 3] uint8."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, idat, header, palette = 8, [], None, np.zeros((0, 3), np.uint8)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[ctype][1]:
        raise ValueError(f"PNG colour type {ctype} at depth {depth} is not a legal PNG")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is not a legal PNG")
    channels = _COLOUR_TYPES[ctype][0]
    stream = memoryview(zlib.decompress(b"".join(idat)))
    if interlace == 0:
        samples, _ = _decode_pass(stream, 0, w, h, channels, depth)
    else:
        samples = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for y0, x0, dy, dx in _ADAM7:
            pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
            if pw == 0 or ph == 0:  # an empty pass holds no bytes at all
                continue
            part, at = _decode_pass(stream, at, pw, ph, channels, depth)
            samples[y0::dy, x0::dx] = part
    return _to_rgb(samples, ctype, depth, palette)


def read_png(path: str) -> np.ndarray:
    """Read any PNG -> [h, w, 3] uint8, as Pillow's ``convert("RGB")``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
