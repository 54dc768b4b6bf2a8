"""Apple icon (ICNS) decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``IcnsImagePlugin``: the file's blocks by their type;
the size read is the largest (width, height, scale) that any block
holds; at that size a PNG member (``ic07``-``ic14``, ``icp4``-``icp6``)
is read through ``utils/png.py``, else the 24-bit RGB member (``is32``,
``il32``, ``ih32``, ``it32`` after its 4 zero bytes): raw when it holds
exactly w x h x 3 bytes, else each channel in turn in Apple's PackBits
(a byte under 128 copies that many plus one bytes, one above repeats the
next byte 125 fewer times).  The mask members are alpha, which
``convert("RGB")`` drops.  A JPEG 2000 member raises
``UnsupportedImageError`` where Pillow opens it (``utils/jpeg2000.py``);
a file with no icon Pillow knows, or whose blocks Pillow cannot walk,
raises :class:`NotThisFormat`; a channel that does not decode to its
size, another member and short data raise a ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, UnsupportedImageError
from .jpeg2000 import CODESTREAM, JP2_SIGNATURE, check_jpeg2000
from .png import decode_png

# (width, height, scale) -> its members, as Pillow's IcnsFile.SIZES
# lists them ("png": PNG or JPEG 2000, "rgb", "rgb-t": RGB after 4 zero
# bytes, "mask": alpha)
_SIZES = {
    (512, 512, 2): [(b"ic10", "png")],
    (512, 512, 1): [(b"ic09", "png")],
    (256, 256, 2): [(b"ic14", "png")],
    (256, 256, 1): [(b"ic08", "png")],
    (128, 128, 2): [(b"ic13", "png")],
    (128, 128, 1): [(b"ic07", "png"), (b"it32", "rgb-t"), (b"t8mk", "mask")],
    (64, 64, 1): [(b"icp6", "png")],
    (32, 32, 2): [(b"ic12", "png")],
    (48, 48, 1): [(b"ih32", "rgb"), (b"h8mk", "mask")],
    (32, 32, 1): [(b"icp5", "png"), (b"il32", "rgb"), (b"l8mk", "mask")],
    (16, 16, 2): [(b"ic11", "png")],
    (16, 16, 1): [(b"icp4", "png"), (b"is32", "rgb"), (b"s8mk", "mask")],
}


def _rgb(data: bytes, start: int, length: int, side: tuple) -> np.ndarray:
    """read_32: [h, w, 3] from ``length`` bytes at ``start``."""
    w, h = side
    n = w * h
    if length == n * 3:
        body = data[start:start + length]
        if len(body) < length:
            raise ValueError("corrupt ICNS: not enough image data")
        return np.frombuffer(body, np.uint8).reshape(h, w, 3).copy()
    pos, bands = start, []
    for _ in range(3):
        out = bytearray()
        left = n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                out += data[pos:pos + 1] * count
                pos += 1
            else:
                count = b + 1
                out += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"corrupt ICNS: error reading channel [{left} left]")
        if len(out) < n:
            raise ValueError("corrupt ICNS: not enough image data")
        bands.append(np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w))
    return np.stack(bands, -1)


def decode_icns(data: bytes) -> np.ndarray:
    """The bytes of an ICNS file -> [h, w, 3] uint8."""
    if len(data) < 8:
        raise NotThisFormat("not an icns file")
    filesize = struct.unpack_from(">I", data, 4)[0]
    blocks, i = {}, 8
    while i < filesize:
        if i + 8 > len(data):
            raise NotThisFormat("icns blocks past the end of the file")
        sig, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise NotThisFormat("invalid block header")
        blocks[sig] = (i + 8, size - 8)
        i += size
    sizes = [s for s, members in _SIZES.items() if any(m in blocks for m, _ in members)]
    if not sizes:
        raise NotThisFormat("no 32-bit icon resources found")
    best = max(sizes)
    side = (best[0] * best[2], best[1] * best[2])
    rgb = None
    for sig, kind in _SIZES[best]:
        if sig not in blocks:
            continue
        start, length = blocks[sig]
        if kind == "png":
            head = data[start:start + 12]
            if head[:8] == b"\x89PNG\r\n\x1a\n":
                img = decode_png(data[start:])
            elif head[:4] in (CODESTREAM, b"\x0d\x0a\x87\x0a") or head == JP2_SIGNATURE:
                try:  # Pillow opens the member itself: a refused header fails the load
                    check_jpeg2000(data[start:start + length])
                except NotThisFormat as e:
                    raise ValueError(f"ICNS: a JPEG 2000 member Pillow cannot open ({e})") \
                        from None
                raise UnsupportedImageError("ICNS with a JPEG 2000 member is not read by "
                                            "this package")
            else:
                raise ValueError("unsupported icon subimage format")
            h, w = img.shape[:2]
            # Pillow keeps the member's size only where a listed size is a
            # whole multiple of it
            if not any(s[0] * s[2] // w == s[1] * s[2] / h for s in sizes):
                raise ValueError("ICNS: a member of a size Pillow does not allow")
            return img
        if kind == "rgb-t":
            if data[start:start + 4] != b"\0\0\0\0":
                raise ValueError("ICNS: unknown signature, expecting 0x00000000")
            start, length = start + 4, length - 4
        if kind in ("rgb", "rgb-t"):
            rgb = _rgb(data, start, length, side)
    if rgb is None:
        raise ValueError("ICNS: a mask without its picture")
    return rgb
