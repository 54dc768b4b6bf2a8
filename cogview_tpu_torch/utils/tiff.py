"""TIFF reader on the standard library (zlib, lzma, struct) and numpy.

It reads the first image of a classic TIFF or a BigTIFF, little- or
big-endian, and returns what Pillow 12.1's ``Image.open(...)
.convert("RGB")`` returns, byte for byte.  Pillow reads a TIFF twice:

- its own directory reader (``ImageFileDirectory_v2``) and ``_setup``
  decide the mode, the size and the Orientation from the tags as Python
  values (a BYTE-typed tag is one ``bytes`` object, a tag Pillow knows to
  hold one value keeps the first, a directory the file's end cuts short
  keeps the tags before the cut); a layout missing from its ``OPEN_INFO``
  table, or a tag of a type ``_setup`` cannot use, fails the open;
- uncompressed data it decodes itself, from each strip's or tile's
  offset (StripByteCounts unread), with its raw unpackers, FillOrder 2
  included; every other compression goes to libtiff 4.7, which reads the
  directory again by its own rules (``TIFFReadDirectory``: the counts and
  types each tag must have, PlanarConfiguration 1 or 2, a missing or bad
  StripByteCounts estimated, a short strip table padded with zeros) and
  decodes whole strips or tiles, which Pillow's ``TiffDecode.c``
  unpacks with its raw mode (libtiff's samples in the machine's order).
  ``TiffDecode.c`` checks its buffer before it reads anything: a tile's
  is TileWidth times the bytes of a TileLength-pixel column, at most
  2**31 - 1 bytes and no smaller than libtiff's tile; a strip's holds at
  most the image's height, its RowsPerStrip below 2**31.  A decoder's -1
  fails a strip and not a tile (``TIFFReadEncodedTile`` tests for zero).

Compressions: none, PackBits, LZW (libtiff's old-style bit order too),
Deflate (8 and 32946), LZMA (an ``.xz`` stream, ``xz.py`` where the
stream is damaged), Zstandard (``zstd.py``), ThunderScan, CCITT RLE,
RLEW, Group 3 (1-D and 2-D) and Group 4 (``ccitt.py``) and JPEG (7: each
strip or tile an abbreviated stream decoded with the JPEGTables tag's
tables, YCbCr converted to RGB by libjpeg as Pillow asks libtiff to).
Predictor 2 at 8, 16 and 32 bits and predictor 3 (floating point) where
libtiff applies them (LZW, Deflate, LZMA, Zstandard).  Layouts: every key
of Pillow's ``OPEN_INFO``: bilevel, grayscale at 2, 4, 8, 12, 16 and 32
bits (signed, unsigned and floating point, ``convert`` clipping or
truncating them to 8 bits as Pillow does), palettes at 1-8 bits, RGB and
RGBA at 8 and 16 bits, CMYK at 8 and 16 bits, FillOrder 2, planar
configuration 1 and 2; YCbCr without JPEG compression, or JPEG in planes,
through libtiff's RGBA interface as Pillow reads it (``tiff_rgba.py``);
the Orientation tag, which Pillow's load applies (``exif_transpose``).

Old-style JPEG (6) in strips, tiles and planes (``ojpeg.py``) and CIELab
(``lab.py``: Pillow converts LAB to RGB through LittleCMS) are read too.
What Pillow reads and this reader does not raises ``UnsupportedImageError``
naming it: old-style JPEG in planes whose second scan's SOS marker is
corrupt, in more than one strip (``ojpeg.py``).  Only the first image is
read.  Bytes
Pillow cannot open or load raise a plain ``ValueError`` (``NotThisFormat``
where Pillow's TIFF plugin refuses the header and ``Image.open`` goes on
to its next plugin).
"""

from __future__ import annotations

import struct
import zlib
from fractions import Fraction

import numpy as np

from . import xz, zstd
from .image_errors import NotThisFormat, check_pixels
from .jpeg import cmyk_to_rgb

(_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC, _FILL_ORDER, _STRIP_OFFSETS,
 _ORIENTATION, _SAMPLES, _ROWS_PER_STRIP, _STRIP_COUNTS, _X_RES, _Y_RES, _PLANAR, _T4, _T6,
 _RES_UNIT, _PREDICTOR, _COLOR_MAP, _TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS,
 _EXTRA_SAMPLES, _SAMPLE_FORMAT, _JPEG_TABLES, _YCBCR_COEFFICIENTS, _YCBCR_SUBSAMPLING,
 _REFERENCE_BW) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 282, 283, 284, 292, 293, 296, 317,
    320, 322, 323, 324, 325, 338, 339, 347, 529, 530, 532)

# ---------------------------------------------------------------------------
# Pillow's side: ImageFileDirectory_v2 and TiffImageFile._setup
# ---------------------------------------------------------------------------

# field type -> (bytes a value, struct code) of the types Pillow loads
_PIL_TYPES = {1: (1, None), 2: (1, None), 3: (2, "H"), 4: (4, "L"), 5: (8, None),
              6: (1, "b"), 7: (1, None), 8: (2, "h"), 9: (4, "l"), 10: (8, None),
              11: (4, "f"), 12: (8, "d"), 13: (4, "L"), 16: (8, "Q")}
# TiffTags' lengths of the tags _setup reads: 1 keeps one value, 0 a tuple
_PIL_LENGTH = {**dict.fromkeys((256, 257, 259, 262, 266, 274, 277, 278, 282, 283, 284, 292,
                                293, 296, 317, 322, 323, 347), 1),
               **dict.fromkeys((258, 273, 279, 320, 324, 325, 338, 339), 0), 530: 2}

_PIL_COMPRESSION = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
                    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
                    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
                    50000: "zstd", 50001: "webp"}


def _open_info() -> dict:
    """Pillow 12.1's ``OPEN_INFO``: (byte order, photometric, sample format,
    fill order, bits, extra samples) -> (mode, raw mode)."""
    both = [(0, 1, 1, (1,), (), "1", "1;I"), (0, 1, 2, (1,), (), "1", "1;IR"),
            (1, 1, 1, (1,), (), "1", "1"), (1, 1, 2, (1,), (), "1", "1;R")]
    for b in (2, 4, 8):
        s = "" if b == 8 else str(b)
        both += [(0, 1, 1, (b,), (), "L", f"L;{s}I"), (0, 1, 2, (b,), (), "L", f"L;{s}IR"),
                 (1, 1, 1, (b,), (), "L", f"L;{s}" if s else "L"),
                 (1, 1, 2, (b,), (), "L", f"L;{s}R")]
        both += [(3, 1, 1, (b,), (), "P", f"P;{s}" if s else "P"),
                 (3, 1, 2, (b,), (), "P", f"P;{s}R")]
    both += [(3, 1, 1, (1,), (), "P", "P;1"), (3, 1, 2, (1,), (), "P", "P;1R"),
             (1, 2, 1, (8,), (), "L", "L"), (1, 1, 1, (8, 8), (2,), "LA", "LA"),
             (2, 1, 1, (8,) * 3, (), "RGB", "RGB"), (2, 1, 2, (8,) * 3, (), "RGB", "RGB;R"),
             (2, 1, 1, (8,) * 4, (), "RGBA", "RGBA"), (2, 1, 1, (8,) * 4, (0,), "RGB", "RGBX"),
             (2, 1, 1, (8,) * 5, (0, 0), "RGB", "RGBXX"),
             (2, 1, 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX"),
             (2, 1, 1, (8,) * 4, (1,), "RGBA", "RGBa"),
             (2, 1, 1, (8,) * 5, (1, 0), "RGBA", "RGBaX"),
             (2, 1, 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX"),
             (2, 1, 1, (8,) * 4, (2,), "RGBA", "RGBA"),
             (2, 1, 1, (8,) * 5, (2, 0), "RGBA", "RGBAX"),
             (2, 1, 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX"),
             (2, 1, 1, (8,) * 4, (999,), "RGBA", "RGBA"),
             (3, 1, 1, (8, 8), (0,), "P", "PX"), (3, 1, 1, (8, 8), (2,), "PA", "PA"),
             (5, 1, 1, (8,) * 4, (), "CMYK", "CMYK"), (5, 1, 1, (8,) * 5, (0,), "CMYK", "CMYKX"),
             (5, 1, 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"),
             (6, 1, 1, (8,), (), "L", "L"), (6, 1, 1, (8,) * 3, (), "RGB", "RGBX"),
             (8, 1, 1, (8,) * 3, (), "LAB", "LAB")]
    table = {}
    for photo, fmt, fill, bits, extra, mode, raw in both:
        for bo in ("II", "MM"):
            table[bo, photo, (fmt,), fill, bits, extra] = (mode, raw)
    for bo, e in (("II", "L"), ("MM", "B")):
        table[bo, 2, (1,), 1, (16,) * 3, ()] = ("RGB", f"RGB;16{e}")
        table[bo, 2, (1,), 1, (16,) * 4, ()] = ("RGBA", f"RGBA;16{e}")
        table[bo, 2, (1,), 1, (16,) * 4, (0,)] = ("RGB", f"RGBX;16{e}")
        table[bo, 2, (1,), 1, (16,) * 4, (1,)] = ("RGBA", f"RGBa;16{e}")
        table[bo, 2, (1,), 1, (16,) * 4, (2,)] = ("RGBA", f"RGBA;16{e}")
        table[bo, 5, (1,), 1, (16,) * 4, ()] = ("CMYK", f"CMYK;16{e}")
    table.update({
        ("II", 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
        ("II", 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
        ("II", 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
        ("MM", 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
        ("II", 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
        ("II", 1, (2,), 1, (16,), ()): ("I", "I;16S"),
        ("MM", 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
        ("II", 0, (3,), 1, (32,), ()): ("F", "F;32F"),
        ("MM", 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
        ("II", 1, (1,), 1, (32,), ()): ("I", "I;32N"),
        ("II", 1, (2,), 1, (32,), ()): ("I", "I;32S"),
        ("MM", 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
        ("II", 1, (3,), 1, (32,), ()): ("F", "F;32F"),
        ("MM", 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
    })
    return table


_OPEN_INFO = _open_info()
_MAX_SAMPLES = max(len(k[4]) for k in _OPEN_INFO)
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1, "LA": 2, "PA": 2,
          "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}


def _rational(a: int, b: int):
    """IFDRational: a Fraction, NaN where the denominator is 0."""
    return float("nan") if b == 0 else Fraction(a, b)


def _pil_value(tag: int, typ: int, raw: bytes, bo: str):
    """A tag's value as ``tag_v2`` gives it."""
    if typ in (1, 7):
        value = raw
    elif typ == 2:
        value = (raw[:-1] if raw.endswith(b"\0") else raw).decode("latin-1")
    elif typ in (5, 10):
        ints = struct.unpack(bo + ("L" if typ == 5 else "l") * (len(raw) // 4), raw)
        value = tuple(_rational(a, b) for a, b in zip(ints[::2], ints[1::2]))
    else:
        value = struct.unpack(bo + _PIL_TYPES[typ][1] * (len(raw) // _PIL_TYPES[typ][0]), raw)
    values = (value,) if isinstance(value, (int, float, bytes, str, Fraction)) else value
    length = _PIL_LENGTH.get(tag)
    if length == 1 or typ == 1 or (length is None and len(values) == 1):
        return values[0]
    return tuple(values)


def _pil_directory(data: bytes, bo: str, big: bool) -> dict:
    """ImageFileDirectory_v2.load of the first IFD -> {tag: (type, raw
    bytes)}: an entry, or a value outside it, that the end of the file cuts
    short ends the directory there, the tags before it kept; a tag of no
    bytes or of a type Pillow has no loader for is skipped; a later tag
    replaces an earlier one of the same number."""
    off, inline = ("Q", 8) if big else ("L", 4)
    entry = bo + ("HHQ8s" if big else "HHL4s")
    tags = {}
    try:
        at = struct.unpack_from(bo + off, data, 8 if big else 4)[0]
        if at >= 2 ** 63:
            raise ValueError("TIFF: Pillow is unable to seek to the first frame")
        if at == 0:
            raise NotThisFormat("TIFF without an image")
        n = struct.unpack_from(bo + ("Q" if big else "H"), data, at)[0]
        pos = at + (8 if big else 2)
        for _ in range(n):
            tag, typ, count, value = struct.unpack_from(entry, data, pos)
            pos += struct.calcsize(entry)
            if typ not in _PIL_TYPES:
                continue
            size = count * _PIL_TYPES[typ][0]
            if size > inline:
                start = struct.unpack(bo + off, value)[0]
                if start + size > len(data):
                    break  # _safe_read raises OSError, which ends the directory
                value = data[start:start + size]
            else:
                value = value[:size]
            if value:
                tags[tag] = (typ, value)
    except struct.error:
        pass
    return {tag: _pil_value(tag, typ, raw, bo) for tag, (typ, raw) in tags.items()}


class _Open:
    """What ``TiffImageFile._setup`` leaves: size, mode, raw mode, the
    compression, and the tiles of its own raw decoder."""
    tiles = ()
    palette = None


def _pil_setup(tags: dict, prefix: str) -> _Open:
    """TiffImageFile._setup on Pillow's tag values, its errors as
    ``Image.open`` ends them: the ones ImageFile turns into a SyntaxError
    -> NotThisFormat, the others -> ValueError."""
    try:
        return _setup(tags, prefix)
    except (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error) as e:
        raise NotThisFormat(f"Pillow's TIFF plugin refuses the header: {e!r}") from None


def _setup(tags: dict, prefix: str) -> _Open:
    o = _Open()
    if 0xBC01 in tags:
        raise ValueError("Windows Media Photo in TIFF: Pillow cannot read it")
    o.compression = _PIL_COMPRESSION[tags.get(_COMPRESSION, 1)]
    o.planar = tags.get(_PLANAR, 1)
    photo = tags.get(_PHOTOMETRIC, 0)
    if o.compression == "tiff_jpeg":
        photo = 6
    fill = tags.get(_FILL_ORDER, 1)
    xsize, ysize = tags[_WIDTH], tags[_LENGTH]
    if type(xsize) is not int or type(ysize) is not int:
        raise ValueError("TIFF of invalid dimensions: Pillow cannot open it")
    o.tile_size = (xsize, ysize)
    o.orientation = tags.get(_ORIENTATION)
    o.size = (ysize, xsize) if o.orientation in (5, 6, 7, 8) else (xsize, ysize)
    fmt = tags.get(_SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(_BITS, (1,))
    extra = tags.get(_EXTRA_SAMPLES, ())
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
    spp = tags.get(_SAMPLES, 3 if o.compression == "tiff_jpeg" and photo in (2, 6) else 1)
    if spp > _MAX_SAMPLES:
        raise SyntaxError("Invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise SyntaxError("unknown data organization")
    key = (prefix, photo, fmt, fill, bps, extra)
    o.mode, rawmode = _OPEN_INFO[key]
    xres, yres = tags.get(_X_RES, 1), tags.get(_Y_RES, 1)
    if xres and yres and tags.get(_RES_UNIT) == 3:
        o.dpi = (xres * 2.54, yres * 2.54)  # Pillow's info["dpi"]: a TypeError on a bad type
    o.libtiff = o.compression != "raw"
    if o.libtiff:
        if fill == 2:
            o.mode, rawmode = _OPEN_INFO[key[:3] + (1,) + key[4:]]
        if photo == 6 and o.compression == "jpeg" and o.planar == 1:
            rawmode = "RGB"
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    elif _STRIP_OFFSETS in tags or _TILE_OFFSETS in tags:
        o.tiles = _raw_tiles(tags, o, rawmode, bps, bps_count)
    else:
        raise SyntaxError("unknown data organization")
    o.rawmode = rawmode
    if o.mode in ("P", "PA"):
        o.palette = bytes(b // 256 & 255 for b in tags[_COLOR_MAP])
    if o.size[0] <= 0 or o.size[1] <= 0:
        raise SyntaxError("TIFF of no pixels: Pillow's plugin leaves no size")
    return o


def _raw_tiles(tags: dict, o: _Open, rawmode: str, bps, bps_count: int) -> list:
    """The tiles of Pillow's own raw decoder: (extents, offset, raw mode,
    stride)."""
    xsize, ysize = o.tile_size
    if _STRIP_OFFSETS in tags:
        offsets = tags[_STRIP_OFFSETS]
        h, w = tags.get(_ROWS_PER_STRIP, ysize), xsize
    else:
        offsets = tags[_TILE_OFFSETS]
        w, h = tags.get(_TILE_WIDTH), tags.get(_TILE_LENGTH)
        if type(w) is not int or type(h) is not int:
            raise ValueError("TIFF of invalid tile dimensions: Pillow cannot open it")
    if w == xsize and h == ysize and o.planar != 2:
        offsets = offsets[-1:]
    x = y = layer = 0
    tiles = []
    for offset in offsets:
        stride = w * sum(bps) / 8 if x + w > xsize else 0
        tile_rawmode = rawmode
        if o.planar == 2:
            tile_rawmode = rawmode[layer]
            stride /= bps_count
        tiles.append(((x, y, min(x + w, xsize), min(y + h, ysize)), offset, tile_rawmode,
                      int(stride)))
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y = 0
                layer += 1
    return tiles


# ---------------------------------------------------------------------------
# Pillow's unpackers and convert("RGB")
# ---------------------------------------------------------------------------

_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _raw_bits(mode: str, rawmode: str) -> int:
    """The bits a pixel of Pillow's unpacker for ``rawmode``."""
    if len(rawmode) == 1:  # one band of a planar file
        return {"I": 32, "F": 32}.get(mode, 1 if mode == "1" else 8)
    base, _, suffix = rawmode.partition(";")
    if base == "1":
        return 1
    if base in ("L", "P") and suffix[:1] in ("1", "2", "4"):
        return int(suffix[0])
    if base in ("I", "F"):
        return int("".join(c for c in suffix if c.isdigit()))
    return len(base) * (16 if "16" in suffix else 8)


def _unpack(rows: np.ndarray, width: int, mode: str, rawmode: str) -> np.ndarray:
    """Pillow's unpacker of ``rawmode`` into ``mode`` on byte rows [r, n] ->
    the image's pixels: [r, w] (one band: uint8; uint16 for I;16; int32
    for I; float32 for F) or [r, w, bands] uint8."""
    r = len(rows)
    if len(rawmode) == 1 and rawmode not in "1LP":  # a band of a planar file, Pillow's decoder
        if mode in ("I", "F"):
            return np.ascontiguousarray(rows[:, :4 * width]).view(
                "<i4" if mode == "I" else "<f4").reshape(r, width)
        return rows[:, :width]
    base, _, suffix = rawmode.partition(";")
    if suffix.endswith("R"):
        rows = _REVERSE[rows]
        suffix = suffix[:-1]
    if base == "1":
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return np.where((bits != 0) ^ ("I" in suffix), 255, 0).astype(np.uint8)
    if base in ("L", "P") and suffix.rstrip("I") in ("1", "2", "4"):
        b = int(suffix[0])
        shifts = np.arange(8 - b, -1, -b, dtype=np.uint8)
        v = ((rows[:, :, None] >> shifts) & ((1 << b) - 1)).reshape(r, -1)[:, :width]
        if base == "P":
            return v.astype(np.uint8)
        v = (v * (255 // ((1 << b) - 1))).astype(np.uint8)
        return 255 - v if "I" in suffix else v
    if base in ("L", "P") and suffix in ("", "I"):
        v = rows[:, :width]
        return 255 - v if suffix == "I" else v
    if base in ("PX", "PA", "LA"):
        v = rows[:, :2 * width].reshape(r, width, 2)
        return v[..., 0] if base == "PX" else v
    if base == "I" and suffix == "12":
        v = rows[:, :(3 * width + 1) // 2].astype(np.uint16)
        v = np.pad(v, ((0, 0), (0, (-v.shape[1]) % 3))).reshape(r, -1, 3)
        pair = np.stack([(v[..., 0] << 4) | (v[..., 1] >> 4),
                         ((v[..., 1] & 15) << 8) | v[..., 2]], -1)
        return pair.reshape(r, -1)[:, :width]
    if base in ("I", "F"):
        dt = {"16": "<u2", "16N": "<u2", "16B": ">u2", "16S": "<i2", "16BS": ">i2",
              "32N": "<u4", "32S": "<i4", "32BS": ">i4", "32F": "<f4", "32BF": ">f4"}[suffix]
        n = np.dtype(dt).itemsize
        v = np.ascontiguousarray(rows[:, :n * width]).view(dt).reshape(r, width)
        if mode in ("I;16", "I;16B"):
            return v.astype(np.uint16)
        if mode == "F":
            return v.astype(np.float32)
        return v.astype(np.uint32).view(np.int32) if dt == "<u4" else v.astype(np.int32)
    n = len(base)
    if base == "LAB":  # unpackLAB: a and b from signed to offset by 128
        return rows[:, :3 * width].reshape(r, width, 3) ^ np.array([0, 128, 128], np.uint8)
    if "16" in suffix:  # the high byte of each 16-bit sample
        v = rows[:, :2 * n * width].reshape(r, width, n, 2)[..., 0 if suffix == "16B" else 1]
    else:
        v = rows[:, :n * width].reshape(r, width, n)
    if base.startswith("RGBa"):  # Pillow's unpackRGBa: divide the alpha out
        a = v[..., 3:4].astype(np.int64)
        rgb = v[..., :3].astype(np.int64)
        div = np.minimum(rgb * 255 // np.maximum(a, 1), 255)
        return np.concatenate([np.where(a == 0, 0, np.where(a == 255, rgb, div)), a],
                              -1).astype(np.uint8)
    return v[..., :_BANDS[mode]]


def _to_rgb(img: np.ndarray, mode: str, palette) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of an image in ``mode``."""
    if mode in ("I;16", "I;16B"):
        g = np.minimum(img, 255).astype(np.uint8)
    elif mode == "I":
        g = np.clip(img, 0, 255).astype(np.uint8)
    elif mode == "F":
        with np.errstate(invalid="ignore"):
            g = np.where(np.isnan(img), 0, np.clip(img, 0, 255)).astype(np.uint8)
    elif mode in ("1", "L", "LA"):
        g = img if img.ndim == 2 else img[..., 0]
    elif mode in ("P", "PA"):
        n = len(palette) // 3
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(n, 256)] = np.frombuffer(palette[:3 * n], np.uint8).reshape(3, n).T[:256]
        return pal[img if img.ndim == 2 else img[..., 0]]
    elif mode == "CMYK":
        return cmyk_to_rgb(img[..., :3], img[..., 3])
    elif mode == "LAB":
        from .lab import lab_to_rgb
        return lab_to_rgb(img)
    else:
        return np.ascontiguousarray(img[..., :3])
    return np.repeat(g[..., None], 3, axis=2)


def _orient(img: np.ndarray, orientation) -> np.ndarray:
    """Pillow's ``ImageOps.exif_transpose`` of an Orientation value."""
    try:
        o = {2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 8: 8}.get(orientation)
    except TypeError:
        o = None
    if o == 2:
        return img[:, ::-1]
    if o == 3:
        return img[::-1, ::-1]
    if o == 4:
        return img[::-1]
    if o == 5:
        return img.transpose(1, 0, 2)
    if o == 6:
        return np.rot90(img, -1)
    if o == 7:
        return np.rot90(img, 2).transpose(1, 0, 2)
    if o == 8:
        return np.rot90(img, 1)
    return img


def _image(o: _Open) -> np.ndarray:
    w, h = o.tile_size
    if o.mode in ("I;16", "I;16B"):
        return np.zeros((h, w), np.uint16)
    if o.mode in ("I", "F"):
        return np.zeros((h, w), np.int32 if o.mode == "I" else np.float32)
    bands = _BANDS[o.mode]
    return np.zeros((h, w) if bands == 1 else (h, w, bands), np.uint8)


def _raw_decode(data: bytes, o: _Open) -> np.ndarray:
    """Pillow's own raw decoder over its tiles, in file order: each reads
    its rows from its offset (``stride`` bytes apart where it is set), and
    a tile the file holds only part of fails the load."""
    img = _image(o)
    planar = o.planar == 2
    for (x0, y0, x1, y1), offset, rawmode, stride in sorted(o.tiles, key=lambda t: t[1]):
        w, rows = x1 - x0, y1 - y0
        if w <= 0 or rows <= 0:
            continue
        bits = _raw_bits(o.mode, rawmode)
        nbytes = (w * bits + 7) // 8
        step = stride or nbytes
        if step < nbytes:
            raise ValueError("TIFF tile stride below its row: Pillow's raw decoder refuses it")
        need = (rows - 1) * step + nbytes
        if offset < 0 or offset + need > len(data):
            raise ValueError("TIFF cut short: Pillow raises 'image file is truncated'")
        buf = np.frombuffer(data, np.uint8, (rows - 1) * step + nbytes, offset)
        buf = np.lib.stride_tricks.as_strided(buf, (rows, nbytes), (step, 1))
        band = None
        if planar:
            band = "RGBA".find(rawmode) if o.mode in ("RGB", "RGBA") else (
                "CMYK".find(rawmode) if o.mode == "CMYK" else "LAB".find(rawmode)
                if o.mode == "LAB" else "LA".find(rawmode)
                if o.mode == "LA" else "PA".find(rawmode) if o.mode == "PA" else 0)
            if band < 0 or (_BANDS[o.mode] == 1 and rawmode != o.mode):
                raise ValueError(f"TIFF raw mode {rawmode} in {o.mode}: Pillow has no unpacker")
        px = _unpack(buf, w, o.mode, rawmode)
        if band is not None and _BANDS[o.mode] > 1:
            img[y0:y1, x0:x1, band] = px
        else:
            img[y0:y1, x0:x1] = px
    return img


# ---------------------------------------------------------------------------
# libtiff's side: TIFFReadDirectory
# ---------------------------------------------------------------------------

_WIDTHS = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
           16: 8, 17: 8, 18: 8}
_INTS = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 13: "L", 16: "Q", 17: "q", 18: "Q"}


class _Bad(Exception):
    """A TIFFReadDirEntry error: the tag is refused (fatally or not)."""


class _Entry:
    __slots__ = ("tag", "typ", "count", "value", "ignore")

    def __init__(self, tag, typ, count, value):
        self.tag, self.typ, self.count, self.value, self.ignore = tag, typ, count, value, False


class _LibTiff:
    """libtiff 4.7's reading of the first directory (``TIFFReadDirectory``
    as Pillow's decoder opens the file): the fields the decoders use, or a
    ValueError where libtiff refuses the directory and Pillow's load
    fails."""

    def __init__(self, data: bytes, bo: str, big: bool):
        self.data, self.bo, self.big = data, bo, big
        n = len(data)
        if big:
            if struct.unpack_from(bo + "HH", data, 4) != (8, 0):
                raise ValueError("BigTIFF header of a bad offset size: libtiff refuses it")
            at = struct.unpack_from(bo + "Q", data, 8)[0]
            if at + 8 > n:
                raise ValueError("libtiff cannot read the TIFF directory count")
            count, head, size = struct.unpack_from(bo + "Q", data, at)[0], 8, 20
        else:
            if struct.unpack_from(bo + "H", data, 2)[0] != 42:
                raise ValueError("TIFF of a bad version number: libtiff refuses it")
            at = struct.unpack_from(bo + "L", data, 4)[0]
            if at + 2 > n:
                raise ValueError("libtiff cannot read the TIFF directory count")
            count, head, size = struct.unpack_from(bo + "H", data, at)[0], 2, 12
        if count > 4096 or count == 0:
            raise ValueError("TIFF directory of no or too many entries: libtiff refuses it")
        if at + head + count * size > n:
            raise ValueError("libtiff cannot read the TIFF directory")
        fmt = bo + ("HHQ8s" if big else "HHL4s")
        self.entries = [_Entry(*struct.unpack_from(fmt, data, at + head + size * i))
                        for i in range(count)]
        seen = set()
        for e in self.entries:  # a later duplicate of a tag is ignored
            e.ignore = e.tag in seen
            seen.add(e.tag)
        self._read()

    # ---- TIFFReadDirEntry* ------------------------------------------------

    def _raw(self, e: _Entry, limit=None) -> bytes:
        width = _WIDTHS[e.typ]
        count = e.count if limit is None else min(e.count, limit)
        size = count * width
        inline = 8 if self.big else 4
        if e.count * width <= inline:
            return e.value[:size]
        if count > 2 ** 31 // width:
            raise _Bad("too large a tag")
        at = struct.unpack(self.bo + ("Q" if self.big else "L"), e.value)[0]
        if at + size > len(self.data):
            raise _Bad("a tag's values past the end of the file")
        return self.data[at:at + size]

    def _ints(self, e: _Entry, top: int, limit=None) -> list:
        """An integer array (ShortArray, LongArray, Long8Array): the
        integer types, each value in [0, top]."""
        if e.typ not in _INTS:
            raise _Bad("incompatible type")
        if e.count == 0:
            return []
        raw = self._raw(e, limit)
        vals = struct.unpack(self.bo + _INTS[e.typ] * (len(raw) // _WIDTHS[e.typ]), raw)
        if any(v < 0 or v > top for v in vals):
            raise _Bad("a value out of range")
        return list(vals)

    def _short(self, e: _Entry) -> int:
        if e.count != 1:
            raise _Bad("incorrect count")
        return self._ints(e, 0xFFFF)[0]

    def _long(self, e: _Entry) -> int:
        if e.count != 1:
            raise _Bad("incorrect count")
        return self._ints(e, 0xFFFFFFFF)[0]

    def _persample_short(self, e: _Entry) -> int:
        """A per-sample tag of one value: one value, or SamplesPerPixel of
        them all equal."""
        try:
            return self._short(e)
        except _Bad as err:
            if str(err) != "incorrect count":
                raise
        if e.count < self.spp:
            raise _Bad("incorrect count")
        vals = self._ints(e, 0xFFFF, self.spp)
        if any(v != vals[0] for v in vals):
            raise _Bad("per-sample values differ")
        return vals[0]

    # ---- TIFFReadDirectory -----------------------------------------------

    def _find(self, tag: int):
        return next((e for e in self.entries if e.tag == tag and not e.ignore), None)

    def _fatal(self, fn, e: _Entry, what: str):
        try:
            return fn(e)
        except _Bad as err:
            raise ValueError(f"libtiff refuses the TIFF directory's {what} ({err})") from None

    def _read(self) -> None:
        self.spp, self.compression, self.width, self.length = 1, 1, 0, 0
        self.planar, self.rps, self.bps, self.fmt, self.photometric = 1, 2 ** 32 - 1, 1, 1, 0
        self.fill, self.predictor, self.extra, self.tiled = 1, 1, [], False
        self.tw = self.th = 0
        self.t4 = self.t6 = 0
        self.jpeg_tables = None
        self.subsampling, self.subsampling_set = (2, 2), False
        self.luma = self.refbw = None  # YCbCrCoefficients, ReferenceBlackWhite
        # old-style JPEG: JPEGInterchangeFormat and its length, the tables'
        # offsets, JPEGRestartInterval
        self.jif_offset = self.jif_length = self.ojpeg_restart = 0
        self.qtables = self.dctables = self.actables = ()
        self.colormap = False
        have = set()
        e = self._find(_SAMPLES)
        if e:
            self.spp = self._fatal(self._short, e, "SamplesPerPixel")
            if self.spp == 0:
                raise ValueError("libtiff refuses SamplesPerPixel 0")
            e.ignore = True
        e = self._find(_COMPRESSION)
        if e:
            self.compression = self._fatal(self._persample_short, e, "Compression")
            e.ignore = True
        first = {_WIDTH: "width", _LENGTH: "length", _TILE_WIDTH: "tw", _TILE_LENGTH: "th",
                 _ROWS_PER_STRIP: "rps"}
        for e in self.entries:
            if e.ignore:
                continue
            if e.tag in (_STRIP_OFFSETS, _TILE_OFFSETS, _STRIP_COUNTS, _TILE_COUNTS):
                have.add(e.tag)
            elif e.tag in first:
                setattr(self, first[e.tag], self._fatal(self._long, e, "dimensions"))
                have.add(e.tag)
                e.ignore = True
            elif e.tag == _PLANAR:
                self.planar = self._fatal(self._short, e, "PlanarConfiguration")
                if self.planar not in (1, 2):
                    raise ValueError(f"libtiff refuses PlanarConfiguration {self.planar}")
                e.ignore = True
            elif e.tag == _EXTRA_SAMPLES:
                if e.count > 0xFFFF:
                    raise ValueError("libtiff refuses the ExtraSamples count")
                vals = self._fatal(lambda x: self._ints(x, 0xFFFF), e, "ExtraSamples")
                if len(vals) > self.spp or any(v > 2 and v != 999 for v in vals):
                    raise ValueError("libtiff refuses the ExtraSamples")
                self.extra = [2 if v == 999 else v for v in vals]
                e.ignore = True
        if _ROWS_PER_STRIP in have and self.rps == 0:
            raise ValueError("libtiff refuses RowsPerStrip 0")
        if _WIDTH not in have and _LENGTH not in have:
            raise ValueError("TIFF without ImageLength: libtiff refuses it")
        self.tiled = _TILE_WIDTH in have or _TILE_LENGTH in have
        sep = self.planar == 2
        if self.tiled:
            dx, dy = self.tw, self.th
            n = 0 if not dx or not dy else -(-self.width // dx) * -(-self.length // dy)
        else:
            self.tw, self.th = self.width, self.rps
            n = 1 if self.rps == 2 ** 32 - 1 else -(-self.length // self.rps)
        self.nstrips = n * (self.spp if sep else 1)
        if not self.nstrips:
            raise ValueError("TIFF of no strips or tiles: libtiff refuses it")
        self.per_image = self.nstrips // self.spp if sep else self.nstrips
        if not have & {_STRIP_OFFSETS, _TILE_OFFSETS}:
            raise ValueError("TIFF without strip offsets: libtiff refuses it")
        offsets_entry = counts_entry = None
        for e in self.entries:
            if e.ignore:
                continue
            t = e.tag
            if t in (_BITS, _SAMPLE_FORMAT, 280, 281, 32996):
                v = self._fatal(self._persample_short, e, f"tag {t}")
                if t == _BITS:
                    self.bps = v
                elif t == _SAMPLE_FORMAT:
                    if not 1 <= v <= 6:
                        raise ValueError(f"libtiff refuses SampleFormat {v}")
                    self.fmt = v
                elif t == 32996:
                    if v not in (0, 1, 2, 3):
                        raise ValueError(f"libtiff refuses DataType {v}")
                    self.fmt = (4, 2, 1, 3)[v]
            elif t in (340, 341):
                self._fatal(self._persample_double, e, f"tag {t}")
            elif t in (_STRIP_OFFSETS, _TILE_OFFSETS):
                offsets_entry = e
            elif t in (_STRIP_COUNTS, _TILE_COUNTS):
                counts_entry = e
            elif t == _COLOR_MAP:
                if e.count == 3 << self.bps and e.typ in _INTS:
                    try:
                        self._ints(e, 0xFFFF)
                        self.colormap = True
                    except _Bad:
                        pass
            else:
                self._normal(e)
        if self.compression == 6:  # TIFFReadDirectory's OJPEG hack
            present = {e.tag for e in self.entries}
            if _PHOTOMETRIC not in present or self.photometric == 2:
                self.photometric = 6
            if _BITS not in present:
                self.bps = 8
            if _SAMPLES not in present and self.photometric in (0, 1):
                self.spp = 1
            elif _SAMPLES not in present and self.photometric == 6:
                self.spp = 3
        colours = {0: 1, 1: 1, 3: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 32845: 3, 5: 4,
                   4: 4}.get(self.photometric, 0)
        if colours and self.spp - len(self.extra) > colours:  # the other channels are extra
            self.extra += [0] * (self.spp - colours - len(self.extra))
        if self.photometric == 3 and not self.colormap:
            if self.bps >= 8 and self.spp == 3:
                self.photometric = 2
            elif self.bps >= 8:
                self.photometric = 1
            else:
                raise ValueError("TIFF palette image without a colour map: libtiff refuses it")
        self.offsets = self._strile(offsets_entry)
        if counts_entry is None:
            if (not sep and self.nstrips > 1) or (sep and self.nstrips != self.spp):
                raise ValueError("TIFF without StripByteCounts: libtiff refuses it")
            self.counts = self._estimate()
        else:
            self.counts = self._strile(counts_entry)
            if (self.nstrips == 1 and not self.tiled and self.offsets[0]
                    and self.counts[0] == 0):
                self.counts = self._estimate()
        if (self.compression == 7 and self.photometric == 6 and self.planar == 1
                and self.spp == 3 and not self.subsampling_set and self.offsets[0]):
            self._fixup_subsampling()
        if self.scanline() == 0:
            raise ValueError("TIFF of a zero scanline size: libtiff refuses it")

    def _fixup_subsampling(self) -> None:
        """JPEGFixupTagsSubsampling: without a YCbCrSubsampling tag, the
        first strip's frame header gives the first component's sampling
        factors, where the others are 1 x 1 and the factors 1, 2 or 4."""
        at = self.offsets[0]
        seg = self.data[at:at + self.counts[0]]
        i, n = 0, len(seg)
        while True:
            while i < n and seg[i] != 0xFF:
                i += 1
            while i < n and seg[i] == 0xFF:
                i += 1
            if i >= n:
                return
            m = seg[i]
            i += 1
            if m == 0xD8:
                continue
            if i + 2 > n:
                return
            length = seg[i] << 8 | seg[i + 1]
            if m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF:
                if length < 2:
                    return
                i += length
                continue
            if m not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA) or length != 8 + 3 * self.spp:
                return
            body = seg[i + 2:i + length]
            if len(body) < 6 + 3 * self.spp:
                return
            ph, pv = body[7] >> 4, body[7] & 15
            if any(body[7 + 3 * k] != 0x11 for k in range(1, self.spp)):
                return
            if ph in (1, 2, 4) and pv in (1, 2, 4):
                self.subsampling = (ph, pv)
            return

    def _persample_double(self, e: _Entry) -> None:
        if e.typ not in _WIDTHS or e.typ in (2, 7):
            raise _Bad("incompatible type")
        if e.count != 1 and e.count < self.spp:
            raise _Bad("incorrect count")
        self._raw(e, 1 if e.count == 1 else self.spp)

    def _normal(self, e: _Entry) -> None:
        """TIFFFetchNormalTag with recovery: a value libtiff cannot take is
        not set, and the read goes on."""
        try:
            t = e.tag
            if t == _PHOTOMETRIC:
                self.photometric = self._short(e)
            elif t == _FILL_ORDER:
                v = self._short(e)
                if v in (1, 2):
                    self.fill = v
            elif t == _PREDICTOR and self.compression in (5, 8, 32946, 34925, 50000):
                self.predictor = self._short(e)
            elif t == _T4 and self.compression == 3:
                self.t4 = self._long(e)
            elif t == _T6 and self.compression == 4:
                self.t6 = self._long(e)
            elif t == _JPEG_TABLES and self.compression == 7:
                if e.typ != 7:
                    raise _Bad("incompatible type")
                self.jpeg_tables = self._raw(e) if e.count else None
            elif t in (513, 514, 515) and self.compression == 6:
                if e.count != 1:
                    raise _Bad("incorrect count")
                v = self._ints(e, 2 ** 64)[0]
                if t == 515:
                    self.ojpeg_restart = v & 0xFFFF
                else:
                    setattr(self, "jif_offset" if t == 513 else "jif_length", v)
            elif t in (519, 520, 521) and self.compression == 6:
                if not 1 <= e.count <= 3:
                    raise _Bad("incorrect count")
                setattr(self, {519: "qtables", 520: "dctables", 521: "actables"}[t],
                        tuple(self._ints(e, 2 ** 64)))
            elif t in (_YCBCR_COEFFICIENTS, _REFERENCE_BW):
                want = 3 if t == _YCBCR_COEFFICIENTS else 6
                if e.count != want:
                    raise _Bad("incorrect count")
                vals = self._floats(e)
                if t == _YCBCR_COEFFICIENTS:
                    self.luma = vals
                else:
                    self.refbw = vals
            elif t == _YCBCR_SUBSAMPLING:
                if e.count < 2:
                    raise _Bad("incorrect count")
                vals = self._ints(e, 0xFFFF, 2)
                self.subsampling, self.subsampling_set = tuple(vals), True
        except _Bad:
            pass

    def _floats(self, e: _Entry) -> list:
        """TIFFReadDirEntryFloatArray: each value as a C float (a rational
        as float over float, 0 where its denominator is 0)."""
        if e.typ in (5, 10):
            ints = struct.unpack(self.bo + ("L" if e.typ == 5 else "l") * (2 * e.count),
                                 self._raw(e))
            return [0.0 if b == 0 else float(np.float32(a) / np.float32(b))
                    for a, b in zip(ints[::2], ints[1::2])]
        if e.typ in (11, 12):
            vals = struct.unpack(self.bo + ("f" if e.typ == 11 else "d") * e.count, self._raw(e))
            return [float(np.float32(v)) for v in vals]
        if e.typ in _INTS:
            return [float(np.float32(v)) for v in self._ints(e, 2 ** 64)]
        raise _Bad("incompatible type")

    def _strile(self, e: _Entry) -> list:
        """TIFFFetchStripThing: the strip or tile table, padded with zeros
        to the number of strips."""
        if e is None:
            return [0] * self.nstrips
        try:
            vals = self._ints(e, 2 ** 64, self.nstrips)
        except _Bad as err:
            raise ValueError(f"libtiff refuses the TIFF strip table ({err})") from None
        return vals + [0] * (self.nstrips - len(vals))

    def _estimate(self) -> list:
        """EstimateStripByteCounts for compressed data: the file's bytes
        outside the header and directory, shared by the strips, the last
        cut at the end of the file."""
        size = len(self.data)
        space = (16 + 8 + 20 * len(self.entries) + 8) if self.big else (
            8 + 2 + 12 * len(self.entries) + 4)
        for e in self.entries:
            if e.typ not in _WIDTHS:
                raise ValueError("TIFF tag of an unknown type: libtiff cannot estimate the "
                                 "strip sizes")
            n = e.count * _WIDTHS[e.typ]
            space += n if n > (8 if self.big else 4) else 0
        space = size if size < space else size - space
        if self.planar == 2:
            space //= self.spp
        counts = [space] * self.nstrips
        last = self.offsets[-1]
        if last + counts[-1] > size:
            counts[-1] = 0 if last >= size else size - last
        if not self.tiled and self.rps == 2 ** 32 - 1:
            self.rps = self.th = self.length
        return counts

    # ---- sizes -----------------------------------------------------------

    def scanline(self, upsampled: bool = False) -> int:
        """TIFFScanlineSize (of a tile row where tiled)."""
        width = self.tw if self.tiled else self.width
        if self.planar == 1 and self.photometric == 6 and not upsampled:
            if self.spp != 3:
                return 0
            sh, sv = self.subsampling
            if sh not in (1, 2, 4) or sv not in (1, 2, 4):
                return 0
            blocks = -(-width // sh)
            return -(-(blocks * (sh * sv + 2) * self.bps) // 8) // sv
        spp = self.spp if self.planar == 1 else 1
        return -(-(width * spp * self.bps) // 8)


# ---------------------------------------------------------------------------
# libtiff's codecs
# ---------------------------------------------------------------------------

def _packbits(src: bytes, size: int, partial: bool = False) -> bytes:
    """libtiff's PackBitsDecode into ``size`` bytes (``partial``: the bytes
    before it ran out, where it fails)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < size:
        c = src[i]
        i += 1
        if c > 128:  # the next byte 257 - c times
            if i >= n:
                break
            out += bytes([src[i]]) * min(257 - c, size - len(out))
            i += 1
        elif c < 128:  # the next c + 1 bytes
            k = min(c + 1, size - len(out))
            if n - i < k:
                break
            out += src[i:i + k]
            i += c + 1
    if len(out) < size and not partial:
        raise ValueError("TIFF PackBits strip ends early")
    return bytes(out)


def _lzw(src: bytes, size: int, partial: bool = False) -> bytes:
    """libtiff's LZWDecode into ``size`` bytes: codes MSB first whose width
    grows one code early, or, where the strip starts as libtiff's
    old-style (compat) streams do, LSB first with no early change.  Where
    it fails libtiff zeroes the rest of the buffer: ``partial`` returns
    the bytes before that instead of raising."""
    old = len(src) >= 2 and src[0] == 0 and src[1] & 1
    early = 0 if old else 1
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    nbits, buf, nbuf, pos, n, prev = 9, 0, 0, 0, len(src), None
    while len(out) < size:
        while nbuf < nbits and pos < n:
            if old:
                buf |= src[pos] << nbuf
            else:
                buf = (buf << 8) | src[pos]
            pos += 1
            nbuf += 8
        if nbuf < nbits:
            break  # no EOI: libtiff stops here
        nbuf -= nbits
        if old:
            code = buf & ((1 << nbits) - 1)
            buf >>= nbits
        else:
            code = buf >> nbuf
            buf &= (1 << nbuf) - 1
        if code == 256:
            del table[258:]
            nbits, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                if partial:
                    break
                raise ValueError("corrupt TIFF LZW strip")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(table[prev] + entry[:1])
        elif code == len(table):
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            if partial:
                break
            raise ValueError("corrupt TIFF LZW strip")
        out += entry
        prev = code
        if len(table) + early >= (1 << nbits) and nbits < 12:
            nbits += 1
    if len(out) < size:
        if partial:
            return bytes(out)
        raise ValueError("TIFF LZW strip ends early")
    return bytes(out[:size])


def _inflate(src: bytes, size: int) -> bytes:
    try:
        out = zlib.decompressobj().decompress(src, size)
    except zlib.error as e:
        raise ValueError(f"corrupt TIFF Deflate strip: {e}") from None
    if len(out) < size:
        raise ValueError("TIFF Deflate strip ends early")
    return out


def _inflate_partial(src: bytes, size: int) -> bytes:
    """The bytes libtiff's ZIPDecode leaves in its buffer where zlib fails:
    every byte inflated before the error (the input fed a byte at a time,
    the byte that fails an output byte at a time)."""
    d, out = zlib.decompressobj(), bytearray()
    for k in range(len(src)):
        keep = d.copy()
        try:
            out += d.decompress(src[k:k + 1], size - len(out))
        except zlib.error:
            d, tail = keep, src[k:k + 1]
            try:
                while len(out) < size:
                    got = d.decompress(tail, 1)
                    tail = d.unconsumed_tail
                    if not got:
                        break
                    out += got
            except zlib.error:
                pass
            break
        if len(out) >= size or d.eof:
            break
    return bytes(out)


def _thunder(src: bytes, rows: int, width: int, row_bytes: int, buf: np.ndarray) -> None:
    """libtiff's ThunderDecodeRow (``tif_thunder.c``) into ``buf`` [rows,
    row_bytes], 4-bit samples, a row of ``width`` pixels at a time from one
    stream: a code's top two bits pick a run of the last pixel (its low six
    bits the count), three 2-bit deltas, two 3-bit deltas (a delta of 2,
    resp. 4, skips) or one raw pixel.  A run past the row's end writes
    nothing, and a row that ends short or long zeroes the rest of its bytes
    and fails the strip."""
    twobit, threebit = (0, 1, 0, -1), (0, 1, 2, 3, 0, -3, -2, -1)
    data, cc, at = src, len(src), 0
    for r in range(rows):
        row = buf[r]
        npix, last, op = 0, 0, 0

        def put(v):
            nonlocal npix, last, op
            last = v & 0xF
            if npix < width:
                if npix & 1:
                    row[op] |= last
                    op += 1
                else:
                    row[op] = last << 4
                npix += 1

        while at < cc and npix < width:
            n = data[at]
            at += 1
            code = n & 0xC0
            if code == 0x00:  # a run
                n &= 0x3F
                if npix & 1:
                    row[op] |= last
                    last = int(row[op])
                    op += 1
                    npix += 1
                    n -= 1
                else:
                    last |= last << 4
                npix += n
                if npix <= width:
                    while n > 0:
                        row[op] = last
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    row[op] &= 0xF0
                last &= 0xF
            elif code == 0x40:
                for shift in (4, 2, 0):
                    d = (n >> shift) & 3
                    if d != 2:
                        put(last + twobit[d])
            elif code == 0x80:
                for shift in (3, 0):
                    d = (n >> shift) & 7
                    if d != 4:
                        put(last + threebit[d])
            else:
                put(n)
        if npix != width:
            row[op:(width + 1) // 2] = 0
            raise ValueError(f"TIFF ThunderScan row of {npix} pixels, not {width}: libtiff fails "
                             "the strip")


_DECODERS = {5: _lzw, 8: _inflate, 32946: _inflate, 32773: _packbits, 34925: xz.tiff_decode,
             50000: zstd.tiff_decode}
_PREDICTED = (5, 8, 32946, 34925, 50000)
_INT_MAX = 2 ** 31 - 1  # TiffDecode.c's bound on a strip's or tile's buffer
_FAILS = {50001: "WebP-compressed TIFF: Pillow's libtiff has no WebP codec",
          34676: "SGILog TIFF: libtiff's codec takes only LogL and LogLuv, which Pillow "
                 "cannot open",
          34677: "SGILog TIFF: libtiff's codec takes only LogL and LogLuv, which Pillow "
                 "cannot open"}


def _predict(seg: bytes, rows: int, lt: _LibTiff) -> bytes:
    """libtiff's predictor on decoded rows (``PredictorDecodeTile``):
    horizontal differencing of 8-, 16- and 32-bit samples in the machine's
    order (``horAcc*``), or floating point (``fpAcc``: the row's bytes,
    differenced, then its byte planes, the most significant first, put
    back together)."""
    p, bps = lt.predictor, lt.bps
    if p == 1:
        return seg
    _predictor_setup(lt)
    stride = lt.spp if lt.planar == 1 else 1
    rowsize = lt.scanline(upsampled=True)
    n = bps // 8
    if p == 2:
        if rowsize % (stride * n):
            raise ValueError("libtiff: a predictor row of partial samples")
        dt = {1: np.uint8, 2: "<u2", 4: "<u4", 8: "<u8"}[n]
        v = np.frombuffer(seg, np.uint8).reshape(rows, rowsize)
        if n > 1 and lt.bo == ">":
            v = v.reshape(rows, -1, n)[..., ::-1].reshape(rows, rowsize)
        v = np.ascontiguousarray(v).view(dt).reshape(rows, -1, stride)
        return np.cumsum(v, axis=1, dtype=v.dtype).tobytes()
    if rowsize % (n * stride):
        raise ValueError("libtiff: a floating-point predictor row of partial samples")
    v = np.frombuffer(seg, np.uint8).reshape(rows, rowsize)
    lanes = v.reshape(rows, -1, stride)
    lanes = np.cumsum(lanes, axis=1, dtype=np.uint8).reshape(rows, rowsize)
    planes = lanes.reshape(rows, n, rowsize // n)  # plane k: byte n-1-k of each value
    return np.ascontiguousarray(planes[:, ::-1].transpose(0, 2, 1)).tobytes()


def _predictor_setup(lt: _LibTiff) -> None:
    """PredictorSetup's checks, made before the first strip is read."""
    p, bps = lt.predictor, lt.bps
    if p == 2 and bps not in (8, 16, 32, 64):
        raise ValueError(f"libtiff: predictor 2 on {bps}-bit samples")
    if p == 3 and lt.fmt != 3:
        raise ValueError(f"libtiff: predictor 3 on sample format {lt.fmt}")
    if p == 3 and bps not in (16, 24, 32, 64):
        raise ValueError(f"libtiff: predictor 3 on {bps}-bit samples")
    if p not in (1, 2, 3):
        raise ValueError(f"libtiff: predictor {p} is not supported")


def _swab(seg: bytes, lt: _LibTiff) -> bytes:
    """libtiff's postdecode byte swap of 16-, 24-, 32- and 64-bit samples
    of a big-endian file into the machine's (little-endian) order."""
    n = {16: 2, 24: 3, 32: 4, 64: 8, 128: 8}.get(lt.bps)
    if lt.bo == "<" or n is None or lt.predictor in (2, 3):
        return seg
    v = np.frombuffer(seg, np.uint8)
    k = len(v) - len(v) % n
    return v[:k].reshape(-1, n)[:, ::-1].tobytes() + seg[k:]


class _Codec:
    """libtiff's codec for the image: ``decode`` is TIFFReadEncodedStrip or
    TIFFReadEncodedTile into Pillow's buffer, which keeps what a strip
    leaves unwritten from the strip before (a Group 4 strip that ends
    early, a JPEG stream smaller than its strip)."""

    def __init__(self, data: bytes, lt: _LibTiff, jpeg_rgb: bool):
        self.data, self.lt, self.jpeg_rgb = data, lt, jpeg_rgb
        comp = lt.compression
        if comp in _FAILS:
            raise ValueError(_FAILS[comp])
        if comp not in _DECODERS and comp not in (2, 3, 4, 7, 32771, 32809):
            raise ValueError(f"TIFF compression {comp}: libtiff has no codec for it")
        if comp in _PREDICTED:
            _predictor_setup(lt)
        if comp == 32809 and lt.bps != 4:
            raise ValueError("ThunderScan TIFF of other than 4 bits a sample: libtiff refuses it")
        self.fax = None
        if comp in (2, 3, 4, 32771):
            from .ccitt import FaxDecoder
            if lt.bps != 1:
                raise ValueError("CCITT TIFF of other than 1 bit a sample: libtiff refuses it")
            self.fax = FaxDecoder(comp, lt.t4 if comp == 3 else 0,
                                  lt.tw if lt.tiled else lt.width, lt.scanline())

    def raw(self, i: int) -> bytes:
        """TIFFFillStrip / TIFFFillTile: the counted bytes, bit-reversed
        under FillOrder 2."""
        lt = self.lt
        if i >= lt.nstrips:
            raise ValueError("TIFF strip out of range: libtiff refuses it")
        off, count = lt.offsets[i], lt.counts[i]
        if count == 0:
            raise ValueError("TIFF strip of no bytes: libtiff refuses it")
        if count > 1024 * 1024:
            full = lt.scanline(True) * (lt.th if lt.tiled else min(lt.rps, lt.length))
            if full and (count - 4096) // 10 > full:
                count = full * 10 + 4096
        if count > len(self.data) or off > len(self.data) - count:
            raise ValueError("TIFF strip or tile past the end of the file")
        src = self.data[off:off + count]
        if lt.fill == 2:
            src = _REVERSE[np.frombuffer(src, np.uint8)].tobytes()
        return src

    def decode(self, i: int, rows: int, width: int, row_bytes: int, buf: np.ndarray,
               plane: int = 0, last: bool = False) -> None:
        """Strip or tile ``i`` of ``rows`` rows into ``buf`` [rows, row_bytes]."""
        lt, comp = self.lt, self.lt.compression
        src = self.raw(i)
        if self.fax is not None:
            seg, n, err = self.fax.decode(src, rows, bool(lt.offsets[i] & 1) and lt.fill == 1)
            if err and not lt.tiled:  # TIFFReadEncodedStrip fails on -1, TIFFReadEncodedTile not
                raise ValueError(err)
            buf[:n] = np.frombuffer(seg, np.uint8).reshape(n, -1)[:, :row_bytes]
        elif comp == 7:
            from .jpeg import decode_tiff_jpeg
            sh, sv = lt.subsampling if lt.photometric == 6 else (1, 1)
            if lt.planar == 2 and plane > 0:
                width, rows = -(-width // sh), -(-rows // sv)
            px = decode_tiff_jpeg(src, lt.jpeg_tables, width, rows,
                                  lt.spp if lt.planar == 1 else 1, lt.bps,
                                  (sh, sv) if lt.planar == 1 else (1, 1), self.jpeg_rgb,
                                  last and not lt.tiled)
            n = min(len(buf), len(px))
            buf[:n, :px.shape[1]] = px[:n, :row_bytes]
        elif comp == 32809:
            scan = lt.scanline()
            if (rows * row_bytes) % scan:
                raise ValueError("libtiff: fractional ThunderScan scanlines")
            _thunder(src, rows, lt.width, row_bytes, buf)
        else:
            seg = _DECODERS[comp](src, rows * row_bytes)
            if comp in _PREDICTED:
                seg = _predict(seg, rows, lt)
            buf[:rows] = np.frombuffer(_swab(seg, lt), np.uint8).reshape(rows, row_bytes)


def _libtiff_decode(data: bytes, o: _Open, bo: str, big: bool) -> np.ndarray:
    """Pillow's ``ImagingLibTiffDecode``: libtiff opens the file, its width
    and length must be Pillow's, and whole strips or tiles are decoded and
    unpacked with Pillow's raw mode."""
    lt = _LibTiff(data, bo, big)
    xsize, ysize = o.tile_size
    if (lt.width, lt.length) != (xsize, ysize):
        raise ValueError("TIFF whose libtiff size is not Pillow's: the decoder refuses it")
    if lt.compression == 6:
        from .ojpeg import decode_ojpeg
        return decode_ojpeg(data, lt, xsize, ysize)
    jpeg_rgb = False
    if lt.photometric == 6:
        if lt.compression == 7 and lt.planar == 1:
            jpeg_rgb = True
        else:  # libtiff's RGBA interface, no buffer of Pillow's
            from .tiff_rgba import decode_ycbcr
            return decode_ycbcr(_Codec(data, lt, False), lt, xsize, ysize)
    bands = _BANDS[o.mode]
    planes = 1
    if lt.planar == 2 and bands > 1:
        if lt.bps not in (8, 16):
            raise ValueError(f"planar TIFF of {lt.bps}-bit samples: Pillow's decoder refuses it")
        planes = bands
    bits = _raw_bits(o.mode, o.rawmode) if planes == 1 else lt.bps * bands
    # Pillow's buffer for a strip or tile, checked before anything is read
    if lt.tiled:
        tw, th = lt.tw, lt.th
        row_bytes = (tw * bits // planes + 7) // 8
        # TiffDecode.c sizes its buffer from a column's bytes, not a row's
        column_bytes = (th * bits // planes + 7) // 8
        if _INT_MAX // column_bytes < tw:
            raise ValueError("TIFF tiles too large for Pillow's buffer: the decoder refuses them")
        if lt.scanline(jpeg_rgb) * th > column_bytes * tw:
            raise ValueError("TIFF tiles larger than Pillow's buffer: the decoder refuses them")
    else:
        rps = ysize if lt.rps == 2 ** 32 - 1 else lt.rps
        if rps > _INT_MAX:
            raise ValueError("TIFF rows per strip past 2**31 - 1: Pillow's decoder refuses them")
        row_bytes = lt.scanline(jpeg_rgb)
        if (xsize * bits // planes + 7) // 8 != row_bytes:
            raise ValueError("TIFF rows of another size than Pillow's mode: the decoder refuses "
                             "them")
        if _INT_MAX // row_bytes < min(rps, ysize):
            raise ValueError("TIFF strips too large for Pillow's buffer: the decoder refuses "
                             "them")
    codec = _Codec(data, lt, jpeg_rgb)
    img = _image(o)
    if lt.tiled:
        buf = np.zeros((th, row_bytes), np.uint8)
        across = -(-lt.width // tw)
        for y in range(0, ysize, th):
            for plane in range(planes):
                for x in range(0, xsize, tw):
                    i = (y // th) * across + x // tw + plane * lt.per_image
                    codec.decode(i, th, tw, lt.scanline(jpeg_rgb), buf, plane)
                    w, h = min(tw, xsize - x), min(th, ysize - y)
                    _put(img, buf[:h], y, x, w, o, planes, plane, lt)
    else:
        per = min(lt.rps, lt.length)  # TIFFReadEncodedStrip's rows a strip
        buf = np.zeros((min(rps, ysize), row_bytes), np.uint8)
        for y in range(0, ysize, rps):
            for plane in range(planes):
                i = (y // lt.rps if lt.rps != 2 ** 32 - 1 else 0) + plane * lt.per_image
                k = i % -(-lt.length // per)
                rows = lt.length - k * per if k == -(-lt.length // per) - 1 else per
                codec.decode(i, rows, lt.width, row_bytes, buf, plane, rows < per or
                             k == -(-lt.length // per) - 1)
                _put(img, buf[:min(rps, ysize - y)], y, 0, xsize, o, planes, plane, lt)
    if planes > 3 and o.mode == "RGBA" and lt.extra and lt.extra[0] in (0, 1):
        img = _unpack(img.reshape(ysize, -1), xsize, "RGBA", "RGBa")  # TiffDecode.c's fix-up
    return img


def _put(img, rows, y, x, w, o: _Open, planes: int, plane: int, lt: _LibTiff) -> None:
    h = len(rows)
    if planes == 1:
        img[y:y + h, x:x + w] = _unpack(rows, w, o.mode, o.rawmode)
    elif lt.bps == 8:
        img[y:y + h, x:x + w, plane] = rows[:, :w]
    else:  # Pillow's "R;16N": the high byte of each native sample
        img[y:y + h, x:x + w, plane] = rows[:, :2 * w].reshape(h, w, 2)[..., 1]


def decode_tiff(data: bytes) -> np.ndarray:
    """The bytes of a TIFF file -> [h, w, 3] uint8 of its first image, as
    Pillow's ``Image.open(...).convert("RGB")``."""
    if len(data) < 8 or (data[2] == 43 and len(data) < 16):
        raise NotThisFormat("TIFF header cut short")
    prefix = data[:2].decode("latin-1")
    if prefix not in ("II", "MM"):
        raise NotThisFormat("not a TIFF IFD")
    bo = "<" if prefix == "II" else ">"
    big = data[2] == 43
    tags = _pil_directory(data, bo, big)
    o = _pil_setup(tags, prefix)
    check_pixels(*o.size)
    if o.libtiff:
        img = _libtiff_decode(data, o, bo, big)
    else:
        img = _raw_decode(data, o)
    return np.ascontiguousarray(_orient(_to_rgb(img, o.mode, o.palette), o.orientation))
