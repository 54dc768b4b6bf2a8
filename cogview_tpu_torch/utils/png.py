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

Damaged files end as in Pillow: :func:`_pillow_chunks` walks the chunks up
to the first IDAT as ``PngImagePlugin``'s ``_open`` does (chunk types of
four word characters, every chunk's CRC, the checks of its IHDR, tRNS,
gAMA, sRGB, pHYs, iCCP and zTXt handlers), and the image data are the run
of IDAT chunks from there, as its ``load_read`` reads them.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from .image_errors import check_pixels

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


_IS_CID = re.compile(rb"\w\w\w\w").match
# the (depth, colour type) pairs Pillow opens, and those it opens as "P"
_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3), (4, 3),
          (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)}


def _short(s: bytes, n: int) -> None:
    if len(s) < n:
        raise ValueError("PNG: a chunk too short for Pillow's handler")


def _zlib_text(s: bytes) -> None:
    """Pillow's ``_safe_zlib_decompress`` of a text or profile chunk: a
    broken stream is let pass, one that inflates past MAX_TEXT_CHUNK is an
    error."""
    obj = zlib.decompressobj()
    try:
        obj.decompress(s, 1 << 20)
    except zlib.error:
        return
    if obj.unconsumed_tail:
        raise ValueError("PNG: a compressed chunk past Pillow's MAX_TEXT_CHUNK")


def _pillow_chunks(data: bytes):
    """The chunks before the first IDAT as Pillow's ``_open`` reads them ->
    (IHDR fields, PLTE bytes, where the first IDAT's data start); every
    failure of its walk raises a ValueError."""
    pos, header, palette, ctype = 8, None, None, None
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: the file ends before its image data")
        (n,), cid = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if not _IS_CID(cid):
            raise ValueError(f"broken PNG file (chunk {cid!r})")
        if cid == b"IDAT":
            if header is None:
                raise ValueError("PNG without an IHDR chunk")
            return header, palette, pos
        if cid == b"IEND":
            raise ValueError("PNG: no image data before IEND")
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError("PNG: a chunk runs past the end of the file")
        if cid == b"IHDR":
            _short(body, 13)
            header = struct.unpack(">IIBBBBB", body[:13])
            ctype = header[3] if header[2:4] in _MODES else None
            if header[5]:
                raise ValueError("PNG: unknown filter category")
        elif cid == b"PLTE" and ctype == 3:
            palette = body
        elif cid == b"tRNS" and ctype in (0, 2):
            _short(body, 6 if ctype == 2 else 2)
        elif cid == b"gAMA":
            _short(body, 4)
        elif cid == b"sRGB":
            _short(body, 1)
        elif cid == b"pHYs":
            _short(body, 9)
        elif cid == b"iCCP":  # a name, its NUL, the method (0), the profile
            i = body.find(b"\0")
            if i + 1 >= len(body) or body[i + 1]:
                raise ValueError("PNG: an iCCP chunk Pillow cannot parse")
            _zlib_text(body[i + 2:])
        elif cid == b"zTXt" and b"\0" in body:
            i = body.find(b"\0")
            if i + 1 < len(body) and body[i + 1]:
                raise ValueError("PNG: a zTXt chunk of an unknown compression method")
            _zlib_text(body[i + 2:])
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(cid + body) & 0xFFFFFFFF:
            raise ValueError(f"broken PNG file (bad header checksum in {cid!r})")
        pos += 12 + n


def _idat_run(data: bytes, pos: int) -> bytes:
    """The data of the IDAT chunks from ``pos`` up to the first other (or
    broken) chunk."""
    parts = []
    while pos + 8 <= len(data) and data[pos + 4:pos + 8] == b"IDAT":
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        parts.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return b"".join(parts)


def _inflate(z: bytes, need: int) -> bytes:
    """The IDAT stream inflated as Pillow's decoder inflates it: zlib stops
    once the image's ``need`` bytes are out, so what follows them (the
    Adler-32 among it) is checked only as far as that last call reads; a
    stream cut short gives what it holds (too little fails later)."""
    return zlib.decompressobj().decompress(z, need)


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG file -> [h, w, 3] uint8."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    header, plte, pos = _pillow_chunks(data)
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[ctype][1]:
        raise ValueError(f"PNG colour type {ctype} at depth {depth} is not a legal PNG")
    if not w or not h:
        raise ValueError(f"PNG of {w} x {h} pixels: Pillow opens no empty image")
    check_pixels(w, h)
    palette = np.zeros((0, 3), np.uint8)
    if plte is not None:
        palette = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
    interlace = int(bool(interlace))  # Pillow reads any nonzero method as Adam7
    channels = _COLOUR_TYPES[ctype][0]
    passes = [(w, h)] if interlace == 0 else [
        (max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))) for y0, x0, dy, dx in _ADAM7]
    need = sum(ph * (1 + -(-pw * channels * depth // 8)) for pw, ph in passes if pw and ph)
    stream = memoryview(_inflate(_idat_run(data, pos), need))
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
