"""Baseline TIFF reader on the standard library (zlib + struct) and numpy.

It reads the first IFD of a classic TIFF, little- or big-endian, and
returns what Pillow 12.1's ``Image.open(...).convert("RGB")`` returns, byte
for byte:

- strips and tiles, planar configuration 1 (chunky) and 2 (one plane a
  sample);
- compression 1 (none), 32773 (PackBits), 5 (LZW, libtiff's old-style bit
  order too) and 8 or 32946 (Deflate);
- predictor 2, horizontal differencing of 8-bit samples, which libtiff's
  LZW and Deflate codecs undo; the uncompressed and PackBits paths ignore
  the tag, as Pillow's do;
- bilevel at 1 bit (photometric 0 and 1), grayscale at 8 bits (0 inverts,
  an alpha is dropped), palette at 1, 2, 4 and 8 bits (each 16-bit colour
  map entry divided by 256), RGB at 8 bits with or without extra samples
  (an associated alpha is divided out as Pillow's ``RGBa`` unpacker does,
  then every alpha is dropped), and CMYK at 8 bits through Pillow's
  ``cmyk2rgb``;
- the Orientation tag, which Pillow's load applies (``exif_transpose``).

Pillow decodes uncompressed data itself and hands every other compression
to libtiff; the two differ in what they read (Pillow reads the rows of a
strip from its offset and ignores StripByteCounts, libtiff reads the
counted bytes and decodes whole tiles), and the reader follows each.

What Pillow reads and this reader does not raises ``UnsupportedImageError``
naming it: BigTIFF, CCITT (2, 3, 4), JPEG (6, 7) and the other libtiff
codecs, samples of other widths, floating-point samples, grayscale at 2
or 4 bits, YCbCr, CIELab, FillOrder 2.  Signed 8-bit grayscale reads as
unsigned, as Pillow reads it.  Bytes that are no
valid TIFF raise a plain ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .image_errors import UnsupportedImageError, check_pixels
from .jpeg import cmyk_to_rgb

# field type -> struct code of the integer types (the others are not read)
_INT_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 13: "I", 16: "Q"}
# the bytes of a value of each type Pillow loads
_UNITS = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
          16: 8}

(_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC, _FILL_ORDER, _STRIP_OFFSETS,
 _ORIENTATION, _SAMPLES, _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR,
 _COLOR_MAP, _TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS, _EXTRA_SAMPLES,
 _SAMPLE_FORMAT) = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317,
                    320, 322, 323, 324, 325, 338, 339)

_READ = {1: "none", 5: "LZW", 8: "Deflate", 32773: "PackBits", 32946: "Deflate"}
# compressions Pillow reads through libtiff and this reader does not
_OTHER_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                       6: "old-style JPEG", 7: "JPEG", 32771: "CCITT RLEW",
                       32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24",
                       34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA", 50000: "Zstandard",
                       50001: "WebP"}
_PHOTOMETRICS = {4: "transparency mask", 6: "YCbCr", 8: "CIELab", 9: "ICCLab",
                 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}

_B3, _B4, _B5, _B6 = (8,) * 3, (8,) * 4, (8,) * 5, (8,) * 6
# (photometric, bits per sample, extra samples) -> Pillow's raw mode
# (TiffImagePlugin.OPEN_INFO at fill order 1 and unsigned samples)
_MODES = {
    (0, (1,), ()): "1;I", (1, (1,), ()): "1",
    (0, (8,), ()): "L;I", (1, (8,), ()): "L", (1, (8, 8), (2,)): "LA",
    (3, (1,), ()): "P;1", (3, (2,), ()): "P;2", (3, (4,), ()): "P;4", (3, (8,), ()): "P",
    (3, (8, 8), (0,)): "PX", (3, (8, 8), (2,)): "PA",
    (2, _B3, ()): "RGB", (2, _B4, ()): "RGBA", (2, _B4, (0,)): "RGBX",
    (2, _B4, (1,)): "RGBa", (2, _B4, (2,)): "RGBA", (2, _B4, (999,)): "RGBA",
    (2, _B5, (0, 0)): "RGBXX", (2, _B5, (1, 0)): "RGBaX", (2, _B5, (2, 0)): "RGBAX",
    (2, _B6, (0, 0, 0)): "RGBXXX", (2, _B6, (1, 0, 0)): "RGBaXX",
    (2, _B6, (2, 0, 0)): "RGBAXX",
    (5, _B4, ()): "CMYK", (5, _B5, (0,)): "CMYKX", (5, _B6, (0, 0)): "CMYKXX",
}


def _read_ifd(data: bytes, bo: str, big: bool = False) -> tuple:
    """The first IFD -> ({tag: tuple of ints} for the integer-typed fields,
    whether the file's end cut it short), of a BigTIFF file where ``big``
    (8-byte offsets and counts), read as Pillow reads it: an entry, or a
    value outside it, that the end of the file cuts short ends the
    directory there, the tags before it kept; a tag of no values or of a
    type Pillow has no loader for is skipped."""
    off, head, entry, inline = ("Q", 8, 20, 8) if big else ("I", 4, 12, 4)
    tags = {}
    try:
        at = struct.unpack_from(bo + off, data, head)[0]
        n = struct.unpack_from(bo + ("Q" if big else "H"), data, at)[0]
        for i in range(n):
            e = at + (8 if big else 2) + entry * i
            if e + entry > len(data):
                return tags, True
            tag, typ, count = struct.unpack_from(bo + "HH" + off, data, e)
            if typ not in _UNITS:
                continue
            size = _UNITS[typ] * count
            value = e + 4 + inline
            pos = value if size <= inline else struct.unpack_from(bo + off, data, value)[0]
            if pos + size > len(data):
                return tags, True
            if count and typ in _INT_TYPES:
                tags[tag] = struct.unpack_from(bo + _INT_TYPES[typ] * count, data, pos)
    except struct.error:
        return tags, True
    return tags, False


def _one(tags: dict, tag: int, default: int) -> int:
    v = tags.get(tag)
    return default if not v else v[0]


def _raw_mode(tags: dict, photo: int) -> str:
    """Pillow's mode checks -> the raw mode, or a named refusal."""
    fill = _one(tags, _FILL_ORDER, 1)
    fmt = tags.get(_SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bits = tags.get(_BITS, (1,))
    extra = tags.get(_EXTRA_SAMPLES, ())
    spp = _one(tags, _SAMPLES, 1)
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError("TIFF BitsPerSample does not match SamplesPerPixel")
    mode = _MODES.get((photo, bits, extra))
    if fmt == (2,) and (photo, bits, extra) == (1, (8,), ()):
        fmt = (1,)  # Pillow reads signed 8-bit grayscale as unsigned
    if mode is not None and fmt == (1,) and fill == 1:
        return mode
    if photo in _PHOTOMETRICS:
        raise UnsupportedImageError(f"TIFF with {_PHOTOMETRICS[photo]} photometric "
                                    "interpretation is not read by this package")
    if fill != 1:
        raise UnsupportedImageError(f"TIFF with FillOrder {fill} is not read by this package")
    if 3 in fmt:
        raise UnsupportedImageError("TIFF with floating-point samples is not read by this "
                                    "package")
    if any(b not in (1, 2, 4, 8) for b in bits):
        raise UnsupportedImageError(f"TIFF with {max(bits)}-bit samples is not read by this "
                                    "package (8-bit, and 1-bit bilevel or palette)")
    if photo in (0, 1) and bits in ((2,), (4,)) and fmt == (1,):
        raise UnsupportedImageError(f"TIFF grayscale at {bits[0]} bits is not read by "
                                    "this package")
    raise ValueError(f"unknown TIFF pixel layout: photometric {photo}, sample format {fmt}, "
                     f"bits {bits}, extra samples {extra}")


def _packbits(src: bytes, size: int) -> bytes:
    """libtiff's PackBitsDecode into ``size`` bytes."""
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
    if len(out) < size:
        raise ValueError("TIFF PackBits strip ends early")
    return bytes(out)


def _lzw(src: bytes, size: int) -> bytes:
    """libtiff's LZWDecode into ``size`` bytes: codes MSB first whose width
    grows one code early, or, where the strip starts as libtiff's
    old-style (compat) streams do, LSB first with no early change."""
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
                raise ValueError("corrupt TIFF LZW strip")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(table[prev] + entry[:1])
        elif code == len(table):
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            raise ValueError("corrupt TIFF LZW strip")
        out += entry
        prev = code
        if len(table) + early >= (1 << nbits) and nbits < 12:
            nbits += 1
    if len(out) < size:
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


_DECODERS = {5: _lzw, 8: _inflate, 32946: _inflate, 32773: _packbits}


def _samples(rows: np.ndarray, width: int, nsamples: int, bits: int) -> np.ndarray:
    """Byte rows [r, row bytes] -> samples [r, width, nsamples]: 8-bit
    samples as they are, 1, 2 and 4 bits MSB first within each byte."""
    if bits == 8:
        return rows[:, :width * nsamples].reshape(len(rows), width, nsamples)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    s = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return s.reshape(len(rows), -1)[:, :width * nsamples].reshape(len(rows), width, nsamples)


def _to_rgb(s: np.ndarray, mode: str, tags: dict) -> np.ndarray:
    """Samples [h, w, spp] in ``mode`` -> [h, w, 3] uint8 as Pillow's
    ``convert("RGB")``."""
    if mode in ("1", "1;I"):
        on = (s[..., 0] != 0) ^ (mode == "1;I")
        return np.repeat(np.where(on, 255, 0).astype(np.uint8)[..., None], 3, axis=2)
    if mode[0] == "L":
        g = 255 - s[..., 0] if mode == "L;I" else s[..., 0]
        return np.repeat(g[..., None], 3, axis=2)
    if mode[0] == "P":
        cmap = tags.get(_COLOR_MAP)
        if not cmap or len(cmap) % 3:
            raise ValueError("TIFF palette image without a colour map")
        pal = np.zeros((256, 3), np.uint8)
        n = len(cmap) // 3
        pal[:min(n, 256)] = (np.asarray(cmap, np.int64).reshape(3, n).T >> 8)[:256]
        return pal[s[..., 0]]
    if mode.startswith("CMYK"):
        return cmyk_to_rgb(s[..., :3], s[..., 3])
    rgb = s[..., :3]
    if mode.startswith("RGBa"):  # Pillow's unpackRGBa: divide the alpha out
        a = s[..., 3:4].astype(np.int64)
        div = np.minimum(rgb.astype(np.int64) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, div)).astype(np.uint8)
    return np.ascontiguousarray(rgb)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """Pillow's ``ImageOps.exif_transpose`` of an Orientation value."""
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1]
    if orientation == 5:
        return img.transpose(1, 0, 2)
    if orientation == 6:
        return np.rot90(img, -1)
    if orientation == 7:
        return np.rot90(img, 2).transpose(1, 0, 2)
    if orientation == 8:
        return np.rot90(img, 1)
    return img


def decode_tiff(data: bytes) -> np.ndarray:
    """The bytes of a TIFF file -> [h, w, 3] uint8 of its first image, as
    Pillow's ``Image.open(...).convert("RGB")``."""
    big = data[:4] in (b"II+\x00", b"MM\x00+")
    if not big and data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    tags, cut = _read_ifd(data, bo, big)
    if _WIDTH not in tags or _LENGTH not in tags:
        raise ValueError("TIFF without ImageWidth or ImageLength")
    w, h = tags[_WIDTH][0], tags[_LENGTH][0]
    if w <= 0 or h <= 0:
        raise ValueError("TIFF of no pixels")
    check_pixels(w, h)
    if big:
        raise UnsupportedImageError("BigTIFF is not read by this package (classic TIFF)")
    comp = _one(tags, _COMPRESSION, 1)
    if comp not in _READ:
        if comp in _OTHER_COMPRESSIONS:
            raise UnsupportedImageError(f"TIFF with {_OTHER_COMPRESSIONS[comp]} compression "
                                        f"({comp}) is not read by this package")
        raise ValueError(f"unknown TIFF compression {comp}")
    photo = _one(tags, _PHOTOMETRIC, 0)
    mode = _raw_mode(tags, photo)
    bits = tags.get(_BITS, (1,))[0]
    spp = _one(tags, _SAMPLES, 1)
    planar = _one(tags, _PLANAR, 1)
    planes = spp if planar == 2 else 1
    if planes > 1 and comp == 1 and spp == 1:
        raise UnsupportedImageError("uncompressed TIFF with PlanarConfiguration 2 and one "
                                    "sample a pixel is not read by this package")
    nsamp = spp // planes  # samples a pixel in a plane
    predictor = _one(tags, _PREDICTOR, 1)
    if comp in (5, 8, 32946) and predictor != 1 and not (predictor == 2 and bits == 8):
        raise ValueError(f"TIFF predictor {predictor} on {bits}-bit samples")
    if _TILE_OFFSETS in tags or _TILE_WIDTH in tags:
        tw, th = _one(tags, _TILE_WIDTH, 0), _one(tags, _TILE_LENGTH, 0)
        offsets, counts = tags.get(_TILE_OFFSETS, ()), tags.get(_TILE_COUNTS, ())
        tiled = True
    else:
        tw, th = w, min(_one(tags, _ROWS_PER_STRIP, 2 ** 32 - 1), h)
        offsets, counts = tags.get(_STRIP_OFFSETS, ()), tags.get(_STRIP_COUNTS, ())
        tiled = False
    if tw <= 0 or th <= 0:
        raise ValueError("TIFF tiles or strips of no size")
    across, down = -(-w // tw), -(-h // th)
    nseg = planes * across * down
    if comp == 1 and not tiled and th == h and planes == 1:
        offsets = offsets[-1:]  # Pillow reads one strip covering the image at the last offset
    if not offsets:
        raise ValueError("TIFF without strip or tile offsets: Pillow cannot open it")
    if cut and comp != 1:
        raise ValueError("TIFF whose directory the file's end cuts short: libtiff, which "
                         "Pillow decodes compressed TIFF with, fails on it")
    if comp != 1 and (len(offsets) < nseg or len(counts) < nseg):
        raise ValueError("TIFF with fewer strip or tile offsets than its layout needs")
    row_bytes = -(-tw * nsamp * bits // 8)
    img = np.zeros((planes, h, w, nsamp), np.uint8)
    # Pillow's own raw decoder reads the strips that have an offset; the rest stay black
    for i in range(min(nseg, len(offsets))):
        plane, rest = divmod(i, across * down)
        y0, x0 = (rest // across) * th, (rest % across) * tw
        # libtiff decodes whole tiles and a strip's rows; Pillow's own raw
        # decoder reads only the rows inside the image
        rows = min(th, h - y0) if comp == 1 or not tiled else th
        off = offsets[i]
        if comp == 1:
            raw = data[off:off + rows * row_bytes]
        else:
            src = data[off:off + counts[i]]
            if off + counts[i] > len(data):
                raise ValueError("TIFF strip or tile past the end of the file")
            raw = _DECODERS[comp](src, rows * row_bytes)
        if len(raw) < rows * row_bytes:
            raise ValueError("truncated TIFF strip or tile")
        seg = _samples(np.frombuffer(raw, np.uint8).reshape(rows, row_bytes), tw, nsamp, bits)
        if predictor == 2 and comp != 1 and comp != 32773:
            seg = np.cumsum(seg, axis=1, dtype=np.uint8)
        part = img[plane, y0:y0 + rows, x0:x0 + tw]  # a tile's part inside the image
        part[...] = seg[:part.shape[0], :part.shape[1]]
    s = np.concatenate(list(img), axis=-1) if planes > 1 else img[0]
    return np.ascontiguousarray(_orient(_to_rgb(s, mode, tags), _one(tags, _ORIENTATION, 1)))
