"""PNM decoder on numpy (P1-P6 and the extensions Pillow opens): equal to
Pillow 12.1's ``Image.open(...).convert("RGB")``.

Follows Pillow's ``PpmImagePlugin``: the magic is read up to the first
whitespace (6 bytes at most); header tokens are separated by whitespace,
with ``#`` comments to the end of the line, and the one whitespace byte
after the last token is the last of the header.

* P4 (raw bitmap): rows of packed bits, a set bit black; P1 (plain): the
  bytes ``0`` and ``1``, whitespace optional, ``1`` black.
* P5/P6 (raw): at maxval 255 the bytes as they are; a gray file at maxval
  65535 is 16-bit big-endian ("I"); any other maxval is scaled as
  ``min(out_max, round(v / maxval * out_max))`` from one byte (maxval <
  256) or two, with out_max 65535 for a gray file above maxval 255 ("I")
  and 255 otherwise.
* P2/P3 (plain): decimal tokens, comments allowed between them, each
  ``round(v / maxval * out_max)`` with the same out_max; a value above
  maxval raises.

* The extensions, raw like P5/P6: P0CMYK and PyCMYK (CMYK, through
  Pillow's ``cmyk2rgb``), PyRGBA (the alpha dropped), PyP (a palette image
  with no palette: black) and Pf (PFM gray float32, little-endian where
  the scale is negative, rows bottom-up; ``convert`` clips each value to
  [0, 255] and truncates it, NaN to 0).  Pillow's plugin does not open a
  colour PFM (``PF``).

``round`` is Python's (half to even), on float64.  An "I" image converts to
RGB by clipping each value to 255, a bitmap to 0 and 255.  A file that
ends before its pixels raises a ``ValueError``.
"""

from __future__ import annotations

import io
import math

import numpy as np

from .image_errors import NotThisFormat, check_pixels
from .jpeg import cmyk_to_rgb
from .raw_formats import gray_to_rgb

_WS = b"\x20\x09\x0a\x0b\x0c\x0d"
# magic -> (Pillow's mode, bands): P1-P6 and the extensions Pillow opens
_MODES = {b"P1": ("1", 1), b"P2": ("L", 1), b"P3": ("RGB", 3), b"P4": ("1", 1),
          b"P5": ("L", 1), b"P6": ("RGB", 3), b"P0CMYK": ("CMYK", 4), b"Pf": ("F", 1),
          b"PyP": ("P", 1), b"PyRGBA": ("RGBA", 4), b"PyCMYK": ("CMYK", 4)}
_BLOCK = 1 << 20  # Pillow's ImageFile.SAFEBLOCK: the plain decoder's read size


def _magic(fp) -> bytes:
    magic = b""
    for _ in range(6):
        c = fp.read(1)
        if not c or c in _WS:
            break
        magic += c
    return magic


def _token(fp) -> bytes:
    token = b""
    while len(token) <= 10:
        c = fp.read(1)
        if not c:
            break
        if c in _WS:
            if not token:
                continue
            break
        if c == b"#":
            while fp.read(1) not in b"\r\n":  # b"" (the end) stops it too
                pass
            continue
        token += c
    if not token:
        raise ValueError("corrupt PNM: the file ends in its header")
    if len(token) > 10:
        raise ValueError(f"corrupt PNM: header token too long: {token!r}")
    return token


class _PlainReader:
    """Pillow's PpmPlainDecoder: blocks of the data with comments removed,
    a comment that spans blocks carried over."""

    def __init__(self, fp):
        self.fp = fp
        self.spans = False

    def _comment_end(self, block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def block(self) -> bytes:
        block = self.fp.read(_BLOCK)
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.fp.read(_BLOCK)
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int) -> bytes:
        data = b""
        while len(data) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(block.split())
            if tokens.strip(b"01"):
                raise ValueError("corrupt PNM: a bitmap value other than 0 or 1")
            data = (data + tokens)[:total]
        return data

    def values(self, total: int, maxval: int, out_max: int) -> list:
        out = []
        half = b""
        while len(out) != total:
            block = self.block()
            if not block:
                if not half:
                    break
                block = b" "  # flush the token the last block ended in
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError("corrupt PNM: data token too long")
            for tok in tokens:
                if len(tok) > 10:
                    raise ValueError("corrupt PNM: data token too long")
                v = int(tok)
                if v < 0 or v > maxval:
                    raise ValueError(f"corrupt PNM: value {v} outside [0, {maxval}]")
                out.append(round(v / maxval * out_max))
                if len(out) == total:
                    break
        return out


def decode_pnm(data: bytes) -> np.ndarray:
    """The bytes of a PNM file (P1-P6 or an extension) -> [h, w, 3] uint8."""
    fp = io.BytesIO(data)
    magic = _magic(fp)
    if magic not in _MODES:
        raise NotThisFormat(f"not a PNM file: magic {magic!r}")
    w, h = int(_token(fp)), int(_token(fp))
    mode, bands = _MODES[magic]
    if mode == "F":
        scale = float(_token(fp))
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("corrupt PFM: scale must be finite and non-zero")
    if w <= 0 or h <= 0:  # Pillow's "not identified by this driver"
        raise NotThisFormat(f"corrupt PNM: size {w} x {h}")
    check_pixels(w, h)
    if mode == "F":
        raw = fp.read(4 * w * h)
        if len(raw) < 4 * w * h:
            raise ValueError("corrupt PFM: the file ends in its pixels")
        v = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(h, w)[::-1]
        return gray_to_rgb(v)
    if magic in (b"P1", b"P4"):
        if magic == b"P1":
            bits = _PlainReader(fp).bitonal(w * h)
            if len(bits) < w * h:
                raise ValueError("corrupt PNM: the file ends in its pixels")
            gray = np.where(np.frombuffer(bits, np.uint8) == ord("1"), 0, 255)
            gray = gray.astype(np.uint8).reshape(h, w)
        else:
            stride = -(-w // 8)
            raw = fp.read(stride * h)
            if len(raw) < stride * h:
                raise ValueError("corrupt PNM: the file ends in its pixels")
            rows = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride), axis=1)
            gray = np.where(rows[:, :w] == 1, 0, 255).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2)
    maxval = int(_token(fp))
    if not 0 < maxval < 65536:
        raise ValueError("corrupt PNM: maxval must be greater than 0 and less than 65536")
    wide = mode == "L" and maxval > 255  # Pillow's mode "I"
    out_max = 65535 if wide else 255
    n = w * h * bands
    if magic in (b"P2", b"P3"):
        vals = _PlainReader(fp).values(n, maxval, out_max)
        if len(vals) < n:
            raise ValueError("corrupt PNM: the file ends in its pixels")
        v = np.asarray(vals, np.int64)
    else:
        nbytes = 1 if maxval < 256 else 2
        raw = fp.read(n * nbytes)
        if len(raw) < n * nbytes:
            raise ValueError("corrupt PNM: the file ends in its pixels")
        v = np.frombuffer(raw, np.uint8 if nbytes == 1 else ">u2").astype(np.int64)
        if not (maxval == 255 or wide and maxval == 65535):  # else the raw values
            v = np.minimum(out_max, np.round(v / maxval * out_max)).astype(np.int64)
    v = np.minimum(v, 255).astype(np.uint8).reshape(h, w, bands)  # "I" clips to 8 bits
    if mode == "P":  # no palette: every index is black, as in Pillow
        return np.zeros((h, w, 3), np.uint8)
    if mode == "CMYK":
        return cmyk_to_rgb(v[..., :3], v[..., 3])
    return np.repeat(v, 3, axis=2) if bands == 1 else np.ascontiguousarray(v[..., :3])
