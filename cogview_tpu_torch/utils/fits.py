"""FITS decoder, equal to Pillow 12.1's ``Image.open(...).convert("RGB")``.

Follows Pillow's ``FitsImagePlugin``: 80-byte header cards from ``SIMPLE =
T`` to ``END`` (padded to 2,880 bytes), extension headers after it where
the primary one holds no image, and the first image's first plane:
``BITPIX`` 8, 16, 32, -32 or -64 read as Pillow's raw modes ``L``,
``I;16``, ``I`` and ``F`` read them (little-endian, whatever the standard
says, and float32 for -64), rows bottom-up, ``BZERO`` and ``BSCALE``
ignored; or a ``GZIP_1`` tile-compressed image of a binary table, each
value's low bytes of four.  The values then convert to RGB as Pillow's
modes do (clipped; floats truncated).  The pixels start 80 bytes before
where Pillow's header loop stopped reading, so where less than a card
follows the header they start inside it, as in Pillow.  A header Pillow's plugin refuses
raises :class:`NotThisFormat`; a file with no image, a ``BITPIX`` it
cannot read in a compressed table and short data raise a ``ValueError``.
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from .image_errors import NotThisFormat, check_pixels
from .raw_formats import gray_to_rgb

_MODES = {8: "u1", 16: "<u2", 32: "<i4", -32: "<f4", -64: "<f4"}


def _size(headers: dict, prefix: bytes):
    try:
        naxis = int(headers[prefix + b"NAXIS"])
        if naxis == 0:
            return None
        if naxis == 1:
            return 1, int(headers[prefix + b"NAXIS1"])
        return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])
    except KeyError:
        raise NotThisFormat("a FITS header without its axes") from None


def decode_fits(data: bytes) -> np.ndarray:
    """The bytes of a FITS file -> [h, w, 3] uint8."""
    headers, in_header, found, pos = {}, False, None, 0
    while True:
        card = data[pos:pos + 80]
        pos = min(pos + 80, len(data))  # the file position after the read
        if not card:
            raise ValueError("truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:
                found = _parse(headers)
            in_header = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise NotThisFormat("not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("FITS: no image data")
    kind, offset, size, bits = found
    w, h = size
    check_pixels(w, h)
    start = offset + pos - 80  # Pillow's tell() - 80, even after a short read
    if kind == "gzip":
        try:
            raw = gzip.decompress(data[start:])
        except (OSError, EOFError, zlib.error):
            raise ValueError("corrupt FITS: bad gzip stream") from None
        nb = min(bits // 8, 4)
        if nb <= 0:
            raise ValueError("FITS: Pillow reads no floating-point compressed image")
        groups = np.frombuffer(raw[:len(raw) // 4 * 4], np.uint8).reshape(-1, 4)[:, 4 - nb:]
        if len(groups) < w * h:
            raise ValueError("corrupt FITS: not enough image data")
        body = groups[:w * h].reshape(h, w * nb)[::-1].tobytes()
        dtype = _MODES[bits]
    else:
        dtype = _MODES[bits]
        body = data[start:start + w * h * np.dtype(dtype).itemsize]
        if len(body) < w * h * np.dtype(dtype).itemsize:
            raise ValueError("corrupt FITS: image file is truncated")
    v = np.frombuffer(body, dtype).reshape(h, w)
    if kind == "raw":
        v = v[::-1]
    return gray_to_rgb(v)


def _parse(headers: dict):
    """_parse_headers -> (decoder, offset, size, BITPIX), or None where the
    header holds no image."""
    prefix, kind, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers.get(b"ZCMPTYPE", None) == b"'GZIP_1  '"):
        tw, th = _size(headers, b"") or (0, 0)
        offset = tw * th * (int(headers[b"BITPIX"]) // 8)
        prefix, kind = b"Z", "gzip"
    elif (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
          and b"ZCMPTYPE" not in headers):
        raise NotThisFormat("a FITS table without its compression type")
    size = _size(headers, prefix)
    if not size:
        return None
    try:
        bits = int(headers[prefix + b"BITPIX"])
    except KeyError:
        raise NotThisFormat("a FITS header without BITPIX") from None
    if bits not in _MODES:
        raise NotThisFormat(f"FITS BITPIX {bits}: no mode")
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("not identified by this driver")
    return kind, offset, size, bits
