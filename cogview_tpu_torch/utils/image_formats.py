"""Which reader an image file goes to: the order and the tests of Pillow
12.1's ``Image.open``, so that the port reads what the JAX package reads.

The JAX package opens every image through ``Image.open``, whatever its
name says.  ``Image.open`` reads 16 bytes and walks its plugins in the
order a fresh process registers them: first the five ``preinit`` loads
(BMP, DIB, GIF, JPEG, PPM, PNG), then the rest in ``Image.ID`` order.
Each plugin has an ``_accept`` test on those 16 bytes (six have none and
try every file), and its ``_open`` reads the header; where ``_open``
refuses the header with a ``SyntaxError`` (or an ``IndexError``,
``TypeError``, ``KeyError``, ``EOFError`` or ``struct.error``, or leaves
no mode or size), ``Image.open`` goes on to the next plugin.  A CUR
test, for example, takes every file that starts ``00 00 02 00``, which
is how Pillow's own true-colour TGA files start; CUR's ``_open`` finds no
cursor there and ``Image.open`` reads the file as TGA.

:data:`FORMATS` holds one row per plugin in that order: the format's
name, its ``_accept`` (the logic of Pillow's, on the first 16 bytes; None
where the plugin has none) and what the port does with a file it
accepts.  That is the port's reader, which raises ``NotThisFormat`` where
Pillow's ``_open`` refuses the header; or, for a format the port does not
read, a check of the header ``_open`` reads and then
``UnsupportedImageError`` naming the format; or, for a format Pillow
opens but cannot load here (EPS without Ghostscript, WMF off Windows, the
BUFR, GRIB and HDF5 stubs, MPEG), a plain ``ValueError``.
:func:`decode_image` walks the rows.  Every file ends in one of the three
outcomes of ``utils/image_errors.py``.

The header checks of the two named formats (AVIF as far as libavif's
parse goes, JPEG 2000 in ``utils/jpeg2000.py``) end with Pillow's
decompression-bomb check, and skip a file cut short where Pillow fails to
load it.  They cannot see damage inside the compressed
data, which Pillow finds only as it decodes: such a file is named where
Pillow would skip it.
"""

from __future__ import annotations

import struct
from typing import Callable, NamedTuple, Optional

import numpy as np

from .blp import decode_blp
from .bmp import decode_bmp, decode_dib
from .dds import decode_dds
from .fits import decode_fits
from .fli import decode_fli
from .ftex import decode_ftex
from .gbr import decode_gbr
from .gif import decode_gif
from .icns import decode_icns
from .ico import decode_cur, decode_ico
from .im import decode_im
from .image_errors import NotThisFormat, UnsupportedImageError, check_pixels
from .iptc import decode_iptc
from .jpeg import decode_jpeg
from .jpeg2000 import check_jpeg2000
from .msp import decode_msp
from .pcd import decode_pcd
from .pcx import decode_dcx, decode_pcx
from .png import decode_png
from .pnm import decode_pnm
from .psd import decode_psd
from .qoi import decode_qoi
from .raw_formats import decode_imt, decode_mcidas, decode_pixar, decode_xvthumb
from .sgi import decode_sgi
from .spider import decode_spider
from .sun import decode_sun
from .tga import decode_tga
from .tiff import decode_tiff
from .webp import decode_webp
from .xbm import decode_xbm
from .xpm import decode_xpm

READ_FORMATS = (
    "PNG (every colour type, depth and interlace), BMP and DIB, GIF, PNM (P1-P6, PFM and "
    "Pillow's P0CMYK and Py extensions), QOI, WebP (lossy, lossless, alpha, an animation's "
    "first frame), TIFF and BigTIFF (none, PackBits, LZW, Deflate, LZMA, Zstandard, "
    "ThunderScan, CCITT RLE, Group 3 and 4, JPEG, old-style JPEG; every sample "
    "layout Pillow reads, YCbCr and CIELab), ICO and CUR, TGA, PSD (8-bit composite, "
    "also Lab), DDS (uncompressed, BC1-BC7, BC6H signed and unsigned), "
    "PCX and DCX, SGI, SUN, XBM, XPM, MSP, ICNS (PNG and RGB members), IM (also YCC and "
    "L*n bit depths), FITS, BLP (also BLP1 with a CMYK JPEG), SPIDER, GBR, FTEX, McIdas, "
    "PIXAR, IMT, XV thumbnails, FLI and FLC (the first frame), IPTC/NAA (raw and JPEG), "
    "Kodak PhotoCD (the 768 x 512 base image) or baseline JPEG, progressive, "
    "arithmetic-coded and 8-bit lossless JPEG (also CMYK and YCCK)")


class Format(NamedTuple):
    name: str  # Pillow's format name
    accept: Optional[Callable[[bytes], bool]]  # Pillow's _accept on 16 bytes; None: all
    read: Callable[[bytes], np.ndarray]


def _u32le(prefix: bytes) -> int:
    if len(prefix) < 4:
        raise NotThisFormat("fewer than 4 bytes")
    return struct.unpack_from("<I", prefix)[0]


def _named(name: str, check: Callable[[bytes], None]):
    """A format Pillow reads and the port does not: ``check`` (the header
    tests of Pillow's ``_open``, raising NotThisFormat or ValueError),
    then ``UnsupportedImageError`` naming it."""
    def read(data: bytes) -> np.ndarray:
        check(data)
        raise UnsupportedImageError(f"{name} is not an image this package reads: "
                                    f"{READ_FORMATS}")
    return read


def _unloadable(name: str, why: str):
    """A format Pillow opens and cannot load here: outcome (c)."""
    def read(data: bytes) -> np.ndarray:
        raise ValueError(f"{name}: Pillow opens it but cannot load it ({why})")
    return read


def _avif_boxes(data: bytes, start: int, end: int, top: bool = False):
    """ISO-BMFF boxes in data[start:end] -> (type, body start, body end);
    a box that runs past ``end`` raises NotThisFormat.  At the file's top
    level, as libavif parses it, fewer than 8 bytes after the last box are
    no box, and a box other than ftyp and meta may run past the end (its
    body then ends with the file)."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            if top:
                return
            raise NotThisFormat("AVIF: a box header cut short")
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise NotThisFormat("AVIF: a box header cut short")
            size, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < head or (pos + size > end and (not top or kind in (b"ftyp", b"meta"))):
            raise NotThisFormat(f"AVIF: a {kind!r} box past its parent's end")
        yield kind, pos + head, min(pos + size, end)
        pos += size


def _uint(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise IndexError("AVIF: a field cut short")
    return int.from_bytes(data[pos:pos + n], "big")


def _avif_item(data: bytes, meta: dict, item: int) -> tuple:
    """The item's ispe (width, height) and the end of its bytes in the
    file (0 where they lie in an idat box), from the meta box's iprp and
    iloc boxes."""
    props, ispe = [], None
    for kind, a, b in _avif_boxes(data, *meta[b"iprp"]):
        if kind == b"ipco":
            props = list(_avif_boxes(data, a, b))
        elif kind == b"ipma":
            version, flags = data[a], _uint(data, a + 1, 3)
            idw = 2 if version < 1 else 4
            pos = a + 8
            for _ in range(_uint(data, a + 4, 4)):
                owner, count = _uint(data, pos, idw), _uint(data, pos + idw, 1)
                pos += idw + 1
                for _ in range(count):
                    width = 2 if flags & 1 else 1
                    index = _uint(data, pos, width) & ((1 << (8 * width - 1)) - 1)
                    pos += width
                    if owner == item and index and props[index - 1][0] == b"ispe":
                        ispe = (_uint(data, props[index - 1][1] + 4, 4),
                                _uint(data, props[index - 1][1] + 8, 4))
    a, _ = meta[b"iloc"]
    version, sizes = data[a], _uint(data, a + 4, 2)
    off_w, len_w, base_w = sizes >> 12, (sizes >> 8) & 15, (sizes >> 4) & 15
    index_w = sizes & 15 if version in (1, 2) else 0
    idw = 4 if version == 2 else 2
    pos = a + 6 + idw
    last = 0
    for _ in range(_uint(data, a + 6, idw)):
        owner = _uint(data, pos, idw)
        pos += idw
        method = 0
        if version in (1, 2):
            method = _uint(data, pos, 2) & 15
            pos += 2
        base = _uint(data, pos + 2, base_w)
        count = _uint(data, pos + 2 + base_w, 2)
        pos += 4 + base_w
        for _ in range(count):
            offset = _uint(data, pos + index_w, off_w)
            length = _uint(data, pos + index_w + off_w, len_w)
            pos += index_w + off_w + len_w
            if owner == item and method == 0:
                last = max(last, base + offset + length)
    return ispe, last


def _check_avif(data: bytes) -> None:
    """What libavif's parse, which Pillow's AVIF _open runs, needs of a
    file's header, in part: an ftyp box with the brand avif or avis, a
    meta box that starts with a "pict" handler, its primary item and that
    item's ispe size, inside libavif's limits (32,768 a side, 16,384^2
    pixels).  Where the item's bytes run past the end of the file Pillow
    fails to load it: a ValueError."""
    brands, meta = None, None
    for kind, a, b in _avif_boxes(data, 0, len(data), top=True):
        if kind == b"ftyp":
            brands = [data[i:i + 4] for i in range(a, b - 3, 4) if i != a + 4]
        elif kind == b"meta" and meta is None:
            meta = {}
            for i, (child, c, d) in enumerate(_avif_boxes(data, a + 4, b)):
                if i == 0 and (child != b"hdlr" or data[c + 8:c + 12] != b"pict"):
                    raise NotThisFormat("AVIF: the meta box has no picture handler")
                meta.setdefault(child, (c, d))
    if not brands or not {b"avif", b"avis"} & set(brands) or not meta:
        raise NotThisFormat("not an AVIF file this Pillow opens")
    try:
        a, _ = meta[b"pitm"]
        ispe, last = _avif_item(data, meta, _uint(data, a + 4, 2 if data[a] == 0 else 4))
    except (KeyError, IndexError):
        raise NotThisFormat("AVIF: no primary item libavif can parse") from None
    if ispe is None:
        raise NotThisFormat("AVIF: the primary item has no ispe size")
    w, h = ispe
    if not (0 < w <= 32768 and 0 < h <= 32768) or w * h > 16384 * 16384:
        raise NotThisFormat(f"AVIF: a size of {w} x {h} libavif refuses")
    check_pixels(w, h)
    if last > len(data):
        raise ValueError("AVIF: the image's bytes run past the end of the file")


FORMATS = (
    # preinit: BMP, GIF, JPEG, PPM and PNG, in that order (DIB with BMP)
    Format("BMP", lambda p: p[:2] == b"BM", decode_bmp),
    Format("DIB", lambda p: _u32le(p) in (12, 40, 52, 56, 64, 108, 124), decode_dib),
    Format("GIF", lambda p: p[:6] in (b"GIF87a", b"GIF89a"), decode_gif),
    Format("JPEG", lambda p: p[:3] == b"\xff\xd8\xff", decode_jpeg),
    Format("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy",
           decode_pnm),
    Format("PNG", lambda p: p[:8] == b"\x89PNG\r\n\x1a\n", decode_png),
    # Image.ID after init()
    Format("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                                                b"msf1"),
           _named("AVIF", _check_avif)),
    Format("BLP", lambda p: p[:4] in (b"BLP1", b"BLP2"), decode_blp),
    Format("BUFR", lambda p: p[:4] in (b"BUFR", b"ZCZC"), _unloadable("BUFR", "a stub")),
    Format("CUR", lambda p: p[:4] == b"\0\0\2\0", decode_cur),
    Format("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5), decode_pcx),
    Format("DCX", lambda p: _u32le(p) == 0x3ADE68B1, decode_dcx),
    Format("DDS", lambda p: p[:4] == b"DDS ", decode_dds),
    Format("EPS", lambda p: p[:4] == b"%!PS" or (len(p) >= 4 and _u32le(p) == 0xC6D3D0C5),
           _unloadable("EPS", "it needs Ghostscript")),
    Format("FITS", lambda p: p[:6] == b"SIMPLE", decode_fits),
    Format("FLI", lambda p: (len(p) >= 16 and struct.unpack_from("<H", p, 4)[0] in
                             (0xAF11, 0xAF12) and struct.unpack_from("<H", p, 14)[0] in (0, 3)),
           decode_fli),
    Format("FTEX", lambda p: p[:4] == b"FTEX", decode_ftex),
    Format("GBR", lambda p: (len(p) >= 8 and struct.unpack_from(">I", p)[0] >= 20
                             and struct.unpack_from(">I", p, 4)[0] in (1, 2)), decode_gbr),
    Format("GRIB", lambda p: len(p) >= 8 and p[:4] == b"GRIB" and p[7] == 1,
           _unloadable("GRIB", "a stub")),
    Format("HDF5", lambda p: p[:8] == b"\x89HDF\r\n\x1a\n", _unloadable("HDF5", "a stub")),
    Format("JPEG2000", lambda p: p[:4] == b"\xff\x4f\xff\x51"
           or p[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n", _named("JPEG 2000", check_jpeg2000)),
    Format("ICNS", lambda p: p[:4] == b"icns", decode_icns),
    Format("ICO", lambda p: p[:4] == b"\0\0\1\0", decode_ico),
    Format("IM", None, decode_im),
    Format("IMT", None, decode_imt),
    Format("IPTC", None, decode_iptc),
    Format("MCIDAS", lambda p: p[:8] == b"\0\0\0\0\0\0\0\4", decode_mcidas),
    Format("MPEG", lambda p: p[:4] == b"\0\0\1\xb3",
           _unloadable("MPEG", "Pillow identifies MPEG and decodes no frame")),
    Format("TIFF", lambda p: p[:4] in (b"MM\0*", b"II*\0", b"MM*\0", b"II\0*", b"MM\0+",
                                       b"II+\0"), decode_tiff),
    Format("MSP", lambda p: p[:4] in (b"DanM", b"LinS"), decode_msp),
    Format("PCD", None, decode_pcd),
    Format("PIXAR", lambda p: p[:4] == b"\x80\xe8\0\0", decode_pixar),
    Format("PSD", lambda p: p[:4] == b"8BPS", decode_psd),
    Format("QOI", lambda p: p[:4] == b"qoif", decode_qoi),
    Format("SGI", lambda p: len(p) >= 2 and p[:2] == b"\x01\xda", decode_sgi),
    Format("SPIDER", None, decode_spider),
    Format("SUN", lambda p: len(p) >= 4 and p[:4] == b"\x59\xa6\x6a\x95", decode_sun),
    Format("TGA", None, decode_tga),
    Format("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP"
           and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"), decode_webp),
    Format("WMF", lambda p: p[:6] == b"\xd7\xcd\xc6\x9a\0\0" or p[:4] == b"\1\0\0\0",
           _unloadable("WMF", "Pillow renders WMF on Windows only")),
    Format("XBM", lambda p: p.lstrip()[:7] == b"#define", decode_xbm),
    Format("XPM", lambda p: p[:9] == b"/* XPM */", decode_xpm),
    Format("XVTHUMB", lambda p: p[:6] == b"P7 332", decode_xvthumb),
)


def decode_image(data: bytes) -> np.ndarray:
    """The bytes of an image file -> [h, w, 3] uint8, as Pillow's
    ``Image.open(...).convert("RGB")``, the format chosen as ``Image.open``
    chooses it (:data:`FORMATS`), never by a file name.  A format Pillow
    reads and the port does not raises ``UnsupportedImageError`` naming it;
    bytes Pillow cannot open or load raise another ``ValueError``."""
    prefix = bytes(data[:16])
    for fmt in FORMATS:
        try:
            if fmt.accept is not None and not fmt.accept(prefix):
                continue
            return fmt.read(data)
        except NotThisFormat:
            continue
    raise ValueError(f"not an image this package reads: {READ_FORMATS}")
