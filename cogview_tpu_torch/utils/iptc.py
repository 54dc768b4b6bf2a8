"""IPTC/NAA image decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``IptcImagePlugin``, which has no ``_accept`` and tries
every file that reaches it: 5-byte field headers (0x1C, record, dataset,
a 15-bit length or an extended length of up to 4 bytes) with their data,
up to the image record (8, 10).  (3, 60) gives the layers and whether
they are components, (3, 20) and (3, 30) the width and height, (3, 65)
the band one layer fills, (3, 120) the compression: 1 for raw bytes, which
Pillow reads as a PGM of the header's size, or 5 for a file of its own
(a JPEG), which it opens as any image.  The image record's data, and the
data of every (8, 10) record straight after it, are the image.  A gray
file is that image converted to RGB; an RGB or CMYK file holds it in its
one band with the others zero, so its image must be gray.

Where Pillow's ``_open`` refuses the fields (a missing or short field, a
repeated one, no mode or size) the reader raises :class:`NotThisFormat`
and the next format is tried; an unknown compression, an oversized field
length, a file with no image record, image data cut short or a field
after it that is no field raise a ``ValueError``, as Pillow fails on them.
A band's image is read only where it is a JPEG of one component: Pillow
would merge any gray image it opens, a gray PNG too.
"""

from __future__ import annotations

import numpy as np

from .image_errors import NotThisFormat, check_pixels
from .jpeg import _pillow_open, cmyk_to_rgb, decode_jpeg

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _int(value) -> int:
    """IptcImagePlugin._i: the last 4 bytes, big-endian (a TypeError for a
    field that is missing its data or repeated)."""
    return int.from_bytes((b"\0\0\0\0" + value)[-4:], "big")


def _field(data: bytes, pos: int, opening: bool) -> tuple:
    """IptcImageFile.field at ``pos`` -> (tag or None, size, the position
    after the header).  Its IndexError, struct.error and SyntaxError end
    ``_open`` (``opening``: NotThisFormat) or fail ``load`` (ValueError);
    its OSError fails both."""
    bad = NotThisFormat if opening else ValueError
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    if len(s) < 4:
        raise bad("IPTC: a field header cut short")
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _RECORDS:
        raise bad("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        more = data[pos:pos + size - 128]
        pos += len(more)
        size = _int(more)
    elif len(s) < 5:
        raise bad("IPTC: a field length cut short")
    else:
        size = (s[3] << 8) | s[4]
    return tag, size, pos


def _header(data: bytes) -> tuple:
    """IptcImageFile._open -> (mode, band or None, w, h, compression, the
    offset of the image record or None)."""
    pos, info = 0, {}
    while True:
        offset = pos
        tag, size, pos = _field(data, pos, True)
        if not tag or tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos += size
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [value]
        else:
            info[tag] = value
    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode = band = None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        w, h = _int(info[(3, 20)]), _int(info[(3, 30)])
        try:
            compression = _int(info[(3, 120)])
        except KeyError:
            compression = None
    except (IndexError, TypeError, KeyError):
        raise NotThisFormat("not an IPTC image") from None
    if compression not in (1, 5):
        raise ValueError("unknown IPTC image compression")
    if mode is None or w <= 0 or h <= 0:
        raise NotThisFormat("not an IPTC image")
    return mode, band, w, h, compression, offset if tag == (8, 10) else None


def decode_iptc(data: bytes) -> np.ndarray:
    """The bytes of an IPTC/NAA file -> [h, w, 3] uint8."""
    mode, band, w, h, compression, pos = _header(data)
    check_pixels(w, h)
    if pos is None:
        raise ValueError("IPTC: Pillow opens it but cannot load it (no image record)")
    parts = []
    while True:  # IptcImageFile.load: the (8, 10) records in a row
        tag, size, pos = _field(data, pos, False)
        if tag != (8, 10):
            break
        parts.append(data[pos:pos + size])
        pos += size
    inner = b"".join(parts)
    if compression == 1:  # a PGM of the header's size, whose data may run short
        if len(inner) < w * h:
            raise ValueError("IPTC: image file is truncated")
        gray = np.frombuffer(inner[:w * h], np.uint8).reshape(h, w)
    elif band is None:  # the file's image as it is, converted to RGB
        from .image_formats import decode_image

        return decode_image(inner)
    else:
        try:
            one = inner[:3] == b"\xff\xd8\xff" and _pillow_open(inner) == 1
        except NotThisFormat:
            one = False
        if not one:
            raise ValueError("IPTC: a band whose image is not a JPEG of one component "
                             "(Pillow's merge refuses any image but a gray one)")
        gray = decode_jpeg(inner)[..., 0]
    if band is None:
        return np.repeat(gray[..., None], 3, axis=2)
    bands = 3 if mode == "RGB" else 4
    if not -bands <= band < bands:
        raise ValueError(f"IPTC: band {band + 1} of a {mode} image")
    planes = np.zeros(gray.shape + (bands,), np.uint8)
    planes[..., band] = gray
    if mode == "RGB":
        return planes
    return cmyk_to_rgb(planes[..., :3], planes[..., 3])
