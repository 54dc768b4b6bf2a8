"""The port's choice of an image's reader and its newer readers, held
against Pillow 12.1 (``Image.open(...).convert("RGB")``), which the JAX
package decodes every image with.

Every file ends in one of three outcomes (utils/image_errors.py): read
byte-equal to Pillow; ``UnsupportedImageError`` naming a format Pillow reads
and the port does not; or another ``ValueError`` where Pillow cannot open
or load it.  ``test_every_pillow_format`` holds one file for each entry of
``Image.ID``; the reader tests hold ICO/CUR, DIB, TGA, PSD, DDS, PCX/DCX,
SGI, SPIDER, the PNM extensions and JPEG sampling factors of 3 and 4 over
their variants, from Pillow's writers where it has them and from small
writers here where it has none (or writes only some variants).  Pillow is
the oracle: the writers need not make valid files, only files Pillow and
the port agree on.
"""

import gzip
import io
import math
import os
import struct
import sys
import time
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))

from cogview_tpu.preprocess import raw_datasets as jraw  # noqa: E402
from cogview_tpu_torch.models import vqvae  # noqa: E402
from cogview_tpu_torch.preprocess import raw_datasets as raw  # noqa: E402
from cogview_tpu_torch.utils import image_formats  # noqa: E402
from cogview_tpu_torch.utils.image_errors import UnsupportedImageError  # noqa: E402
from cogview_tpu_torch.utils.jpeg import _ARITAB, _ZIGZAG  # noqa: E402
from test_torch_image_io import JFIF, _adobe, _encode_jpeg, _tiff  # noqa: E402

decode_image = vqvae.decode_image


def _pillow(data: bytes):
    """Pillow's (format, RGB array), or None where it cannot open or load."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(io.BytesIO(data))
            return im.format, np.asarray(im.convert("RGB"))
    except Exception:
        return None


def _check(data: bytes, fmt=None, named=False) -> str:
    """The port's outcome on ``data`` against Pillow's -> "read", "named" or
    "skipped".  Where Pillow reads the file the port reads it byte-equal
    (or, with ``named``, raises an UnsupportedImageError); where Pillow
    fails the port raises an error the dataset sources skip
    (``DECODE_ERRORS``), and no UnsupportedImageError.
    ``fmt``: the format Pillow must have opened the file as."""
    want = _pillow(data)
    if want is None:
        with pytest.raises(raw.DECODE_ERRORS) as err:
            decode_image(data)
        assert not isinstance(err.value, UnsupportedImageError), err.value
        return "skipped"
    if fmt is not None:
        assert want[0] == fmt
    if named:
        with pytest.raises(UnsupportedImageError):
            decode_image(data)
        return "named"
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want[1].shape
    np.testing.assert_array_equal(got, want[1])
    return "read"


def _picture(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _saved(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _modes(arr: np.ndarray, modes=("RGB", "RGBA", "L", "LA", "1", "P")):
    for mode in modes:
        im = Image.fromarray(arr)
        yield mode, (im.quantize(16) if mode == "P" else im.convert(mode))


SIZES = ((1, 1), (3, 5), (16, 16), (13, 31))


# --------------------------------------------------------------------- #
# TGA
# --------------------------------------------------------------------- #


def _tga(itype, depth, w, h, body, cmap=None, flags=0, ident=b""):
    """A TGA file: ``cmap`` = (first index, entries, entry bits, bytes)."""
    start, n, bits, pal = cmap or (0, 0, 0, b"")
    head = bytes([len(ident), int(cmap is not None), itype]) + struct.pack(
        "<HHBHHHHBB", start, n, bits, 0, 0, w, h, depth, flags)
    return head + ident + pal + body


def _tga_rle(raw: bytes, w: int, h: int, px: int, rng) -> bytes:
    """Packets over ``raw``: runs that stay in their row (of a pixel
    repeated, which the raw bytes are rewritten to hold) and literals that
    may cross rows -> (the packets, the raw bytes they decode to)."""
    out, dec = bytearray(), bytearray()
    total, i = w * h, 0
    while i < total:
        left_in_row = w - i % w
        if rng.rand() < 0.5:
            n = int(rng.randint(1, min(128, left_in_row) + 1))
            pixel = raw[i * px:(i + 1) * px]
            out += bytes([0x80 | (n - 1)]) + pixel
            dec += pixel * n
        else:
            n = int(rng.randint(1, min(128, total - i) + 1))
            out += bytes([n - 1]) + raw[i * px:(i + n) * px]
            dec += raw[i * px:(i + n) * px]
        i += n
    return bytes(out)


TGA_LAYOUTS = [  # image type, depth, colour map entry bits
    (1, 8, 24), (1, 8, 32), (1, 8, 16), (1, 8, None), (2, 16, None), (2, 24, None),
    (2, 32, None), (2, 24, 24), (3, 1, None), (3, 8, None), (3, 16, None), (3, 8, 24),
    (3, 16, 16)]


@pytest.mark.parametrize("layout", TGA_LAYOUTS, ids=str)
@pytest.mark.parametrize("orientation", [0x00, 0x10, 0x20, 0x30])
def test_tga_layouts_and_origins(layout, orientation):
    """Raw and run-length files of every type and depth Pillow reads, colour
    maps of 16, 24 and 32 bits (with a first index past 0 and indices past
    the map; Pillow fails on a 32-bit map and on a map beside true colour,
    and applies one to gray), an ID field, all four origins; literal
    packets cross rows."""
    itype, depth, cbits = layout
    rng = np.random.RandomState(depth + itype + orientation)
    for h, w in SIZES:
        px = max(1, depth // 8)
        row = -(-w // 8) if depth == 1 else w * px
        raw = rng.randint(0, 256, h * row).astype(np.uint8).tobytes()
        cmap = None
        if cbits:
            n = int(rng.randint(1, 40))
            cmap = (int(rng.randint(0, 5)), n, cbits,
                    rng.randint(0, 256, n * cbits // 8).astype(np.uint8).tobytes())
        ident = b"made by hand" if w % 2 else b""
        _check(_tga(itype, depth, w, h, raw, cmap, orientation, ident), "TGA")
        if depth == 1:  # Pillow fails on a run-length encoded bitmap
            assert _check(_tga(itype | 8, depth, w, h, raw, cmap, orientation)) == "skipped"
            continue
        _check(_tga(itype | 8, depth, w, h, _tga_rle(raw, w, h, px, rng), cmap, orientation,
                    ident), "TGA")


def test_tga_pillow_files_and_refusals():
    """Pillow's own TGA files (RLE or not, both origins, every mode it
    writes), a run packet that crosses a row and short data (Pillow fails:
    skipped), and layouts Pillow opens and cannot load."""
    for mode, im in _modes(_picture(13, 17, 3)):
        for kw in ({}, {"compression": "tga_rle"}, {"orientation": 1},
                   {"compression": "tga_rle", "orientation": 1}):
            if mode == "1" and kw.get("compression"):
                continue
            assert _check(_saved(im, "TGA", **kw), "TGA") == "read"
    crossing = _tga(11, 8, 2, 2, bytes([0x82, 7, 0x00, 9]))
    assert _check(crossing) == "skipped"
    good = _saved(Image.fromarray(_picture(5, 6, 1)), "TGA")
    for cut in (len(good) - 27, 30, 17):  # 26 bytes of footer end the file
        assert _check(good[:cut]) == "skipped"
    for itype, depth in ((2, 8), (1, 16), (3, 24)):  # no raw mode in Pillow
        assert _check(_tga(itype, depth, 2, 2, bytes(16))) == "skipped"


def test_tga_that_starts_like_a_cursor_reads_as_tga():
    """Pillow's uncompressed true-colour TGA starts 00 00 02 00, CUR's magic:
    ``Image.open`` finds no cursor there and reads the file as TGA, and so
    does the port (it once raised "ICO/CUR is not an image this package
    reads")."""
    data = _saved(Image.fromarray(_picture(9, 11, 5)), "TGA")
    assert data[:4] == b"\x00\x00\x02\x00"
    assert _check(data, "TGA") == "read"
    assert _check(_saved(Image.fromarray(_picture(9, 11, 5)).convert("RGBA"), "TGA"),
                  "TGA") == "read"


# --------------------------------------------------------------------- #
# ICO, CUR and DIB
# --------------------------------------------------------------------- #


def _dib(im: Image.Image) -> bytes:
    """A BMP of ``im`` without its 14-byte file header."""
    return _saved(im, "BMP")[14:]


def _icon(entries, magic=b"\x00\x00\x01\x00") -> bytes:
    """An icon or cursor file: ``entries`` = (width byte, height byte,
    colours, bpp, payload)."""
    head = magic + struct.pack("<H", len(entries))
    offset = 6 + 16 * len(entries)
    dirs, body = b"", b""
    for w, h, colors, bpp, payload in entries:
        dirs += bytes([w, h, colors, 0]) + struct.pack("<HHII", 1, bpp, len(payload),
                                                       offset + len(body))
        body += payload
    return head + dirs + body


def _icon_bitmap(arr: np.ndarray, mode: str) -> tuple:
    """(bpp, DIB of the picture over a zero AND mask: twice as tall, the
    picture in its top half)."""
    h, w = arr.shape[:2]
    im = Image.fromarray(np.concatenate([arr, np.zeros_like(arr)]))
    im = im.quantize(200) if mode == "P" else im.convert(mode)
    return {"1": 1, "P": 8, "L": 8, "RGB": 24, "RGBA": 32}[mode], _dib(im)


def test_ico_pillow_files():
    """Pillow's ICO files: PNG entries and BMP entries (bitmap_format="bmp")
    of every mode, one size or several."""
    for mode, im in _modes(_picture(32, 32, 4), ("RGB", "RGBA", "L", "1", "P")):
        for kw in ({}, {"bitmap_format": "bmp"}, {"sizes": [(16, 16), (32, 32), (24, 24)]},
                   {"bitmap_format": "bmp", "sizes": [(16, 16), (32, 32)]}):
            assert _check(_saved(im, "ICO", **kw), "ICO") == "read"


@pytest.mark.parametrize("mode", ["1", "P", "L", "RGB", "RGBA"])
def test_ico_and_cur_bitmap_entries(mode):
    """Hand-built icons: the largest entry is the one read, the smallest
    colour depth among equals, 0 in the directory meaning 256; a PNG entry
    among BMP ones; a cursor's first entry that is wider and taller than
    the ones before it; the AND mask cut short (Pillow fails)."""
    rng = np.random.RandomState(len(mode))
    for h, w in ((4, 4), (7, 5), (16, 16)):
        a, b = rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8)
        bpp_a, dib_a = _icon_bitmap(a, mode)
        _, dib_b = _icon_bitmap(b, "RGB")
        small = _icon_bitmap(a[:2, :2], mode)[1]
        _check(_icon([(w, h, 0, bpp_a, dib_a), (2, 2, 0, bpp_a, small)]), "ICO")
        _check(_icon([(w, h, 0, 24, dib_b), (w, h, 0, bpp_a, dib_a)]), "ICO")
        png = _saved(Image.fromarray(b), "PNG")
        _check(_icon([(2, 2, 0, bpp_a, small), (w, h, 0, 32, png)]), "ICO")
        cur = _icon([(2, 2, 0, bpp_a, small), (w, h, 0, bpp_a, dib_a)], b"\x00\x00\x02\x00")
        _check(cur, "CUR")
        if bpp_a < 32:
            _check(_icon([(w, h, 0, bpp_a, dib_a[:-1])]))
    big = _icon_bitmap(_picture(256, 256, 1), "RGB")[1]
    _check(_icon([(0, 0, 0, 24, big), (16, 16, 0, 24, _icon_bitmap(_picture(16, 16, 2),
                                                                       "RGB")[1])]), "ICO")


def test_dib_files():
    """Headerless BMP (DIB) as Pillow writes it in every mode, and the
    12-byte core header."""
    for mode, im in _modes(_picture(13, 17, 6), ("RGB", "RGBA", "L", "1", "P")):
        assert _check(_saved(im, "DIB"), "DIB") == "read"
    core = struct.pack("<IHHHH", 12, 3, 2, 1, 24) + bytes(range(24))
    assert _check(core, "DIB") == "read"


# --------------------------------------------------------------------- #
# PCX and DCX
# --------------------------------------------------------------------- #


def _pcx_rle(raw: bytes, row_bytes: int, rng) -> bytes:
    """PCX packets over ``raw``: runs (11xxxxxx, value) inside a row and
    single bytes below 0xC0."""
    out = bytearray()
    i = 0
    while i < len(raw):
        left = row_bytes - i % row_bytes
        b = raw[i]
        if b >= 0xC0 or rng.rand() < 0.4:
            n = 1 if b >= 0xC0 else int(rng.randint(1, min(63, left) + 1))
            out += bytes([0xC0 | n, b])
            i += n
        else:
            out.append(b)
            i += 1
    return bytes(out)


def _pcx(version, bits, planes, w, h, body, stride, palette16=b"", tail=b""):
    head = bytes([10, version, 1, bits]) + struct.pack("<HHHHHH", 0, 0, w - 1, h - 1, 72, 72)
    head += (palette16 + bytes(48))[:48] + bytes([0, planes]) + struct.pack("<H", stride)
    return head + bytes(128 - len(head)) + body + tail


@pytest.mark.parametrize("layout", [(5, 1, 1), (5, 1, 2), (5, 1, 4), (5, 8, 1), (5, 8, 3),
                                    (2, 1, 4), (5, 2, 1), (5, 4, 1), (5, 8, 4)], ids=str)
def test_pcx_layouts(layout):
    """PCX's RLE at 1, 2, 4 and 8 bits in 1-4 planes, at odd widths, with
    the header's stride equal to the row's or padded (where Pillow moves
    the planes, or reads them where they are not): the layouts Pillow reads
    byte-equal, the others (2 or 4 bits in one plane, 8 bits in four)
    skipped as Pillow fails on them.  8 bits in one plane with a palette at
    the end, a gray ramp there, or none."""
    version, bits, planes = layout
    rng = np.random.RandomState(bits * 10 + planes)
    for h, w in ((1, 1), (2, 3), (5, 8), (7, 13), (4, 17)):
        stride = (w * bits + 7) // 8
        for given in (stride, stride + stride % 2):
            padded = given + given % 2 if given != stride else stride
            rows = rng.randint(0, 256, (h, planes * padded)).astype(np.uint8).tobytes()
            body = _pcx_rle(rows, planes * padded, rng)
            pal16 = rng.randint(0, 256, 48).astype(np.uint8).tobytes()
            tails = [b""]
            if (bits, planes) == (8, 1):
                ramp = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
                tails += [b"\x0c" + rng.randint(0, 256, 768).astype(np.uint8).tobytes(),
                          b"\x0c" + ramp]
            for tail in tails:
                _check(_pcx(version, bits, planes, w, h, body, given, pal16, tail))


def test_pcx_pillow_files_dcx_and_refusals():
    """Pillow's PCX files in every mode it writes, a DCX of two pages (the
    first is read), a run across a row and a cut file (skipped)."""
    for mode, im in _modes(_picture(13, 17, 8), ("RGB", "L", "1", "P")):
        assert _check(_saved(im, "PCX"), "PCX") == "read"
    a = _saved(Image.fromarray(_picture(5, 7, 1)), "PCX")
    b = _saved(Image.fromarray(_picture(3, 9, 2)).convert("L"), "PCX")
    dcx = struct.pack("<IIII", 0x3ADE68B1, 16, 16 + len(a), 0) + a + b
    assert _check(dcx, "DCX") == "read"
    assert _check(_pcx(5, 8, 1, 2, 2, bytes([0xC3, 7, 1]), 2)) == "skipped"
    assert _check(a[:len(a) // 2]) == "skipped"


# --------------------------------------------------------------------- #
# SGI
# --------------------------------------------------------------------- #


def _sgi(planes: np.ndarray, bpc: int, dim: int, rle: bool, rng) -> bytes:
    """An SGI file of ``planes`` [z, h, w] (uint8 at bpc 1, uint16 at 2),
    rows bottom-up; RLE rows from random copy and repeat packets."""
    z, h, w = planes.shape
    head = struct.pack(">HBBHHHH", 474, int(rle), bpc, dim, w, h, z) + bytes(500)
    rows = planes[:, ::-1].astype(">u1" if bpc == 1 else ">u2")
    if not rle:
        return head + rows.tobytes()
    starts, lengths, body = [], [], b""
    base = 512 + 8 * h * z
    word = ">B" if bpc == 1 else ">H"  # a count with its copy flag
    for c in range(z):
        for y in range(h):
            row, out, x = rows[c, y], b"", 0
            while x < w:
                n = int(rng.randint(1, min(127, w - x) + 1))
                if rng.rand() < 0.5:
                    out += struct.pack(word, 0x80 | n) + row[x:x + n].tobytes()
                else:
                    out += struct.pack(word, n) + row[x:x + 1].tobytes()
                    rows[c, y, x:x + n] = row[x]
                x += n
            out += bytes(bpc)
            starts.append(base + len(body))
            lengths.append(len(out))
            body += out
    table = struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *lengths)
    return head + table + body


@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("layout", [(1, 1), (2, 1), (3, 3), (3, 4), (3, 1), (3, 2)], ids=str)
def test_sgi_raw_and_rle(bpc, layout):
    """Raw and RLE files at 1 and 2 bytes a sample, gray, RGB and RGBA,
    at odd sizes; dimension 3 with one or two channels is a layout Pillow
    refuses (skipped)."""
    dim, z = layout
    rng = np.random.RandomState(bpc * 10 + z)
    for h, w in SIZES:
        planes = rng.randint(0, 256 ** bpc, (z, h, w))
        for rle in (False, True):
            _check(_sgi(planes, bpc, dim, rle, rng))


def test_sgi_pillow_files_and_cuts():
    for mode, im in _modes(_picture(13, 17, 9), ("RGB", "RGBA", "L")):
        for bpc in (1, 2):
            data = _saved(im, "SGI", bpc=bpc)
            assert _check(data, "SGI") == "read"
            assert _check(data[:600]) == "skipped"


# --------------------------------------------------------------------- #
# PSD
# --------------------------------------------------------------------- #


def _packbits_row(row: bytes, rng) -> bytes:
    """PackBits packets over one row: literals, and runs of the byte at
    their start (what the row decodes to differs; Pillow is the oracle)."""
    out, i = bytearray(), 0
    while i < len(row):
        n = int(rng.randint(1, min(128, len(row) - i) + 1))
        if n > 1 and rng.rand() < 0.5:
            out += bytes([257 - n]) + row[i:i + 1]
        else:
            out += bytes([n - 1]) + row[i:i + n]
        i += n
    return bytes(out)


def _psd(mode: int, bits: int, channels: np.ndarray, packbits: bool, rng, color=b"",
         n_channels=None, layers=b"") -> bytes:
    """A PSD whose composite holds ``channels`` [c, h, row bytes]."""
    c, h, row = channels.shape
    w = row * 8 if bits == 1 else row
    head = b"8BPS" + struct.pack(">H", 1) + bytes(6) + struct.pack(
        ">HIIHH", n_channels or c, h, w, bits, mode)
    out = head + struct.pack(">I", len(color)) + color
    res = b"8BIM" + struct.pack(">H", 1005) + b"\x00\x00" + struct.pack(">I", 4) + bytes(4)
    out += struct.pack(">I", len(res)) + res + struct.pack(">I", len(layers)) + layers
    if not packbits:
        return out + struct.pack(">H", 0) + channels.tobytes()
    # each run of the packed rows: the repeat packets hold their row's byte
    packed = []
    for ch in channels:
        for r in ch:
            packed.append(_packbits_row(r.tobytes(), rng))
    counts = struct.pack(f">{len(packed)}H", *map(len, packed))
    return out + struct.pack(">H", 1) + counts + b"".join(packed)


PSD_MODES = [(0, 1, 1), (0, 8, 1), (1, 8, 1), (1, 8, 2), (2, 8, 1), (3, 8, 3), (3, 8, 4),
             (3, 8, 5), (4, 8, 4), (4, 8, 5), (7, 8, 3), (8, 8, 1), (1, 16, 1), (3, 16, 3)]


@pytest.mark.parametrize("layout", PSD_MODES, ids=str)
def test_psd_modes_raw_and_packbits(layout):
    """The composite of bitmap, gray, indexed (with and without its colour
    table), RGB (and RGBA), CMYK, multichannel and duotone files at 8
    bits, raw and PackBits, extra channels ignored; 16 bits, which Pillow's
    plugin refuses, skipped."""
    mode, bits, c = layout
    rng = np.random.RandomState(mode * 100 + bits + c)
    for h, w in SIZES:
        row = -(-w // 8) if bits == 1 else w * bits // 8
        ch = rng.randint(0, 256, (c, h, row)).astype(np.uint8)
        colors = [b""]
        if mode == 2:
            colors.append(rng.randint(0, 256, 768).astype(np.uint8).tobytes())
        for color in colors:
            for pb in (False, True):
                _check(_psd(mode, bits, ch, pb, rng, color))


def test_psd_lab_named_and_cuts():
    """Lab (Pillow converts it through LittleCMS) is read, raw and
    PackBits; too few channels, a cut composite, an unknown compression
    skipped."""
    rng = np.random.RandomState(3)
    ch = rng.randint(0, 256, (3, 4, 5)).astype(np.uint8)
    assert _check(_psd(9, 8, ch, False, rng), "PSD") == "read"
    assert _check(_psd(9, 8, ch, True, rng), "PSD") == "read"
    assert _check(_psd(3, 8, ch[:2], False, rng)) == "skipped"
    data = _psd(3, 8, ch, True, rng)
    assert _check(data[:-3]) == "skipped"
    raw = bytearray(_psd(3, 8, ch, False, rng))
    at = len(raw) - ch.size - 2
    raw[at:at + 2] = struct.pack(">H", 2)
    assert _check(bytes(raw)) == "skipped"


# --------------------------------------------------------------------- #
# DDS
# --------------------------------------------------------------------- #


def _dds(w, h, pfflags, fourcc=b"\0\0\0\0", bitcount=0, masks=(0, 0, 0, 0), extra=b"",
         body=b""):
    head = struct.pack("<4sI", b"DDS ", 124) + struct.pack("<IIIIII", 0x1007, h, w, 0, 0, 0)
    head += bytes(44) + struct.pack("<II4sI4I", 32, pfflags, fourcc, bitcount, *masks)
    head += bytes(128 - len(head))
    return head + extra + body


def _dx10(fmt: int) -> bytes:
    return struct.pack("<IIIII", fmt, 3, 0, 1, 0)


@pytest.mark.parametrize("fourcc", [b"DXT1", b"DXT3", b"DXT5", b"ATI1", b"BC4U", b"ATI2",
                                    b"BC5U", b"BC5S"], ids=lambda f: f.decode())
def test_dds_block_compression(fourcc):
    """BC1-BC5 by FourCC on random blocks (both BC1 colour modes, both BC3
    alpha modes), at sizes the 4 x 4 blocks do not divide."""
    rng = np.random.RandomState(sum(fourcc))
    size = 8 if fourcc in (b"DXT1", b"ATI1", b"BC4U") else 16
    for h, w in SIZES + ((4, 8), (9, 6)):
        n = -(-w // 4) * -(-h // 4)
        body = rng.randint(0, 256, n * size).astype(np.uint8).tobytes()
        assert _check(_dds(w, h, 0x4, fourcc, body=body), "DDS") == "read"
    assert _check(_dds(8, 8, 0x4, fourcc, body=body[:4])) == "skipped"


@pytest.mark.parametrize("fmt", [70, 71, 73, 74, 76, 77, 79, 80, 82, 83, 84, 27, 28, 29, 98])
def test_dds_dx10_formats(fmt):
    rng = np.random.RandomState(fmt)
    for h, w in ((3, 5), (8, 12)):
        body = rng.randint(0, 256, 4 * 16 * w * h).astype(np.uint8).tobytes()
        assert _check(_dds(w, h, 0x4, b"DX10", extra=_dx10(fmt), body=body), "DDS") == "read"


@pytest.mark.parametrize("fmt", [97, 98, 99])
def test_dds_bc7_every_mode(fmt):
    """BC7 (DX10 formats 97-99) on random blocks of each of its eight modes
    and of a first byte with no mode bit (black), at sizes the blocks do
    not divide."""
    rng = np.random.RandomState(fmt)
    for h, w in ((4, 4), (9, 14), (16, 28)):
        n = -(-w // 4) * -(-h // 4)
        for mode in range(9):
            blk = rng.randint(0, 256, (n, 16)).astype(np.uint8)
            keep = np.uint8(~((2 << mode) - 1) & 0xFF)  # the bits above the mode bit
            blk[:, 0] = (blk[:, 0] & keep) | np.uint8(1 << mode if mode < 8 else 0)
            assert _check(_dds(w, h, 0x4, b"DX10", extra=_dx10(fmt), body=blk.tobytes()),
                          "DDS") == "read"


def test_dds_uncompressed_and_named():
    """Channel masks at 16, 24 and 32 bits (5-6-5, BGR, BGRA, odd masks,
    and data cut short, which Pillow reads as zeros), luminance, luminance
    and alpha, 8-bit palettes, Pillow's own files; BC6H unsigned and signed
    read."""
    rng = np.random.RandomState(11)
    w, h = 5, 3
    for bits, masks, flags in ((16, (0xF800, 0x7E0, 0x1F, 0), 0x40),
                               (16, (0x7C00, 0x3E0, 0x1F, 0x8000), 0x41),
                               (24, (0xFF0000, 0xFF00, 0xFF, 0), 0x40),
                               (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 0x41),
                               (32, (0xFF, 0xFF00, 0xFF0000, 0), 0x40),
                               (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), 0x41),
                               (16, (0xA0A0, 0x0505, 0, 0), 0x40)):
        body = rng.randint(0, 256, w * h * bits // 8).astype(np.uint8).tobytes()
        for cut in (len(body), len(body) // 2):
            assert _check(_dds(w, h, flags, bitcount=bits, masks=masks, body=body[:cut]),
                          "DDS") == "read"
    body = rng.randint(0, 256, 2 * w * h).astype(np.uint8).tobytes()
    assert _check(_dds(w, h, 0x20000, bitcount=8, body=body), "DDS") == "read"
    assert _check(_dds(w, h, 0x20001, bitcount=16, body=body), "DDS") == "read"
    assert _check(_dds(w, h, 0x20000, bitcount=16, body=body)) == "skipped"
    pal = rng.randint(0, 256, 1024).astype(np.uint8).tobytes()
    assert _check(_dds(w, h, 0x20, extra=pal, body=body[:w * h]), "DDS") == "read"
    for mode, im in _modes(_picture(13, 17, 12), ("RGB", "RGBA", "L", "LA")):
        assert _check(_saved(im, "DDS"), "DDS") == "read"
        for pf in ("DXT1", "DXT3", "DXT5", "BC5"):
            if pf == "BC5" and mode != "RGB":
                continue
            assert _check(_saved(im, "DDS", pixel_format=pf), "DDS") == "read"
    for fmt in (95, 96):
        blocks = rng.randint(0, 256, 16 * 4).astype(np.uint8).tobytes()
        assert _check(_dds(8, 8, 0x4, b"DX10", extra=_dx10(fmt), body=blocks),
                      "DDS") == "read"
    assert _check(_dds(4, 4, 0x4, b"DX10", extra=_dx10(2), body=bytes(64))) == "skipped"
    assert _check(_dds(4, 4, 0x4, b"XXXX", body=bytes(64))) == "skipped"


@pytest.mark.parametrize("bits", [40, 64, 2_701_131_800])
def test_dds_masked_pixels_wider_than_their_masks(bits):
    """Channel-mask pixels of more than 4 bytes, up to a bit count past the
    whole file: Pillow reads each pixel's bytes and masks them with 32-bit
    masks, and reads zeros past the data; the port reads each pixel's first
    4 bytes, byte-equal and in no more time than the data takes."""
    rng = np.random.RandomState(bits % 1000)
    body = rng.randint(0, 256, 5 * 3 * 8).astype(np.uint8).tobytes()
    data = _dds(5, 3, 0x41, bitcount=bits, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), body=body)
    t0 = time.perf_counter()
    assert _check(data, "DDS") == "read"
    assert time.perf_counter() - t0 < 5


# --------------------------------------------------------------------- #
# SPIDER and the PNM extensions
# --------------------------------------------------------------------- #


def test_spider_files():
    """Pillow's SPIDER files (float32 little-endian, of every mode) and a
    big-endian one built here; values outside [0, 255] clip."""
    for mode, im in _modes(_picture(13, 17, 13)):
        assert _check(_saved(im, "SPIDER"), "SPIDER") == "read"
    data = _saved(Image.fromarray(_picture(6, 5, 1)[..., 0]), "SPIDER")
    hdr = struct.unpack("<27f", data[:108])
    hdrlen = int(hdr[21])
    vals = np.random.RandomState(2).uniform(-50, 300, (6, 5)).astype(np.float32)
    vals[0, 0], vals[1, 1] = np.nan, np.inf
    big = (struct.pack(">27f", *hdr) + data[108:hdrlen]) + vals.astype(">f4").tobytes()
    assert _check(big, "SPIDER") == "read"


def test_pnm_extensions():
    """PFM gray (``Pf``) in both byte orders with values outside [0, 255],
    NaN and infinities; P0CMYK and the ``Py`` extensions at maxval 255 and
    others; a colour PFM (``PF``), which Pillow does not open, skipped."""
    rng = np.random.RandomState(14)
    for h, w in SIZES:
        vals = rng.uniform(-100, 400, (h, w)).astype(np.float32)
        vals.flat[0] = np.nan
        vals.flat[-1] = np.inf
        for scale, order in ((-1.0, "<f4"), (1.0, ">f4"), (-0.5, "<f4")):
            data = b"Pf\n%d %d\n%r\n" % (w, h, scale) + vals.astype(order).tobytes()
            assert _check(data, "PPM") == "read"
        for magic, bands in ((b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyRGBA", 4), (b"PyP", 1)):
            for maxval in (255, 100, 1000):
                v = rng.randint(0, maxval + 1, h * w * bands)
                body = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
                assert _check(b"%s\n%d %d\n%d\n" % (magic, w, h, maxval) + body,
                              "PPM") == "read"
    assert _check(b"PF\n2 1\n-1.0\n" + bytes(24)) == "skipped"
    assert _check(b"Pf\n2 1\n0.0\n" + bytes(8)) == "skipped"


# --------------------------------------------------------------------- #
# JPEG sampling factors of 3 and 4
# --------------------------------------------------------------------- #


JPEG_SAMPLINGS = [((4, 1), (1, 1), (1, 1)), ((1, 4), (1, 1), (1, 1)), ((3, 1), (1, 1), (1, 1)),
                  ((1, 3), (1, 1), (1, 1)), ((3, 3), (1, 1), (1, 1)), ((4, 2), (1, 1), (1, 1)),
                  ((4, 2), (2, 1), (2, 2)), ((2, 4), (1, 2), (2, 1)), ((4, 1), (2, 1), (1, 1)),
                  ((3, 2), (1, 1), (3, 1)), ((4, 4), (1, 1), (1, 1)), ((1, 1), (4, 1), (4, 1)),
                  ((2, 2), (4, 4), (1, 1)), ((3, 1), (2, 1), (1, 1)), ((4, 1), (3, 1), (1, 1))]


@pytest.mark.parametrize("sampling", JPEG_SAMPLINGS, ids=str)
def test_jpeg_sampling_factors_3_and_4(sampling):
    """libjpeg-turbo upsamples the ratios h2v1, h1v2 and h2v2 with its fancy
    filters and every other whole ratio (3, 4, and 2 beside them) by
    replication; a fractional ratio (3 beside 2, 4 beside 3) fails in
    Pillow (skipped) and in the port."""
    hs = [s for s, _ in sampling]
    vs = [v for _, v in sampling]
    fractional = any(max(hs) % s for s in hs) or any(max(vs) % v for v in vs)
    for h, w in ((1, 1), (5, 3), (9, 7), (17, 33), (37, 53)):
        planes = list(_picture(h, w, h + w).transpose(2, 0, 1))
        data = _encode_jpeg(planes, sampling, app=JFIF,
                            separate_scans=sum(u * v for u, v in sampling) > 10)
        assert _check(data, "JPEG") == ("skipped" if fractional else "read")


# --------------------------------------------------------------------- #
# arithmetic-coded and lossless JPEG, from the encoders below
# --------------------------------------------------------------------- #


def _seg(m, body):
    return b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body


_ZZ = list(_ZIGZAG)


class _QMEncoder:
    """jcarith.c's arith_encode and finish_pass (T.81 D.1), the encoder the
    decoder is held against through Pillow."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        """The stacked zero bytes, before a byte that is no zero."""
        self.out += bytes(self.zc)
        self.zc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)


def _dct_matrix():
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * math.pi / 16) / 2
    c[0] /= math.sqrt(2)
    return c


def _quantized_blocks(planes, sampling, quant):
    """per component [bh, bw, 64] (natural order) int coefficient blocks."""
    h, w = planes[0].shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    dct = _dct_matrix()
    out = []
    for plane, (hs, vs) in zip(planes, sampling):
        dh, dw = -(-h * vs // vmax), -(-w * hs // hmax)
        sub = plane[::vmax // vs, ::hmax // hs][:dh, :dw].astype(np.float64)
        bh, bw = mcuy * vs, mcux * hs
        full = np.pad(sub, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode="edge") - 128.0
        tiles = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ij,abjk,lk->abil", dct, tiles, dct)
        out.append(np.round(coef / quant).astype(np.int64).reshape(bh, bw, 64))
    return out


def _scan_units(blocks, sampling, comps, w, h):
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    if len(comps) == 1:
        c = comps[0]
        hs, vs = sampling[c]
        dh, dw = -(-h * vs // vmax), -(-w * hs // hmax)
        return [[(c, blocks[c][by, bx])] for by in range(-(-dh // 8)) for bx in range(-(-dw // 8))]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    return [[(c, blocks[c][my * sampling[c][1] + v, mx * sampling[c][0] + u])
             for c in comps for v in range(sampling[c][1]) for u in range(sampling[c][0])]
            for my in range(mcuy) for mx in range(mcux)]


def _arith_jpeg(planes, sampling, progressive=False, ids=(1, 2, 3, 4), app=b"", restart=0,
                dac=None, quality_step=6):
    """An arithmetic-coded JPEG of ``planes``: SOF9 with one interleaved
    scan, or SOF10 with libjpeg's kind of script (DC first at Al 1, AC
    bands first at Al 2, AC refinement to 1, DC refinement, AC refinement
    to 0); ``dac`` = {(Tc, Tb): value}; every component on tables 0."""
    h, w = planes[0].shape
    quant = 2 + (np.add.outer(np.arange(8), np.arange(8)) * quality_step) // 4
    blocks = _quantized_blocks(planes, sampling, quant)
    nc = len(planes)
    out = [b"\xff\xd8", app]
    out.append(_seg(0xDB, bytes([0]) + bytes(quant.reshape(-1)[_ZZ].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([ids[i], (s[0] << 4) | s[1], 0]) for i, s in enumerate(sampling))
    out.append(_seg(0xCA if progressive else 0xC9, sof))
    L = {0: 0}
    U = {0: 1}
    K = {0: 5}
    if dac:
        body = b""
        for (tc, tb), val in dac.items():
            body += bytes([(tc << 4) | tb, val])
            if tc:
                K[tb] = val
            else:
                L[tb], U[tb] = val & 15, val >> 4
        out.append(_seg(0xCC, body))
    if restart:
        out.append(_seg(0xDD, struct.pack(">H", restart)))
    comps = list(range(nc))
    script = [(comps, 0, 63, 0, 0)]
    if progressive:
        script = ([(comps, 0, 0, 0, 1)] + [([c], 1, 5, 0, 2) for c in comps]
                  + [([c], 6, 63, 0, 2) for c in comps] + [([c], 1, 63, 2, 1) for c in comps]
                  + [(comps, 0, 0, 1, 0)] + [([c], 1, 63, 1, 0) for c in comps])
    tb = 0
    for scomps, ss, se, ah, al in script:
        out.append(_seg(0xDA, bytes([len(scomps)]) + b"".join(bytes([ids[c], 0]) for c in scomps)
                        + bytes([ss, se, (ah << 4) | al])))
        enc = _QMEncoder()
        units = _scan_units(blocks, sampling, scomps, w, h)

        def fresh():
            return ({c: 0 for c in scomps}, {c: 0 for c in scomps}, bytearray(64), bytearray(256))
        last, ctx, dcs, acs = fresh()
        fixed = bytearray([113])
        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                enc.finish()
                enc.out += b"\xff" + bytes([0xD0 + (n // restart - 1) % 8])
                enc.reset()
                last, ctx, dcs, acs = fresh()
            for c, blk in unit:
                zzb = [int(blk[_ZZ[k]]) for k in range(64)]  # zigzag order
                if not progressive or (ss == 0 and ah == 0):
                    if ss == 0:
                        dc = zzb[0] >> al if progressive else zzb[0]
                        _dc_encode(enc, dcs, c, dc, last, ctx, L[tb], U[tb])
                if not progressive:
                    _ac_seq(enc, acs, fixed, zzb, 1, 63, 0, K[tb])
                elif ss == 0 and ah:
                    enc.encode(fixed, 0, (zzb[0] >> al) & 1)
                elif ss and not ah:
                    _ac_seq(enc, acs, fixed, zzb, ss, se, al, K[tb])
                elif ss:
                    _ac_refine(enc, acs, fixed, zzb, ss, se, ah, al)
        enc.finish()
        out.append(bytes(enc.out))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _magnitude(enc, st, i, v, kx_bins):
    """F.8 and F.9 from bin i: v >= 1; kx_bins: the X1 bin for the categories."""
    m = 0
    v -= 1
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v
        if kx_bins == 20:  # DC
            i = 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(st, i, 1)
                m <<= 1
                i = kx_bins
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
    enc.encode(st, i, 0)
    return m, v, i


def _dc_encode(enc, st, c, dc, last, ctx, lo, hi):
    i = ctx[c]
    v = dc - last[c]
    if v == 0:
        enc.encode(st, i, 0)
        ctx[c] = 0
        return
    last[c] = dc
    enc.encode(st, i, 1)
    if v > 0:
        enc.encode(st, i + 1, 0)
        i += 2
        ctx[c] = 4
    else:
        v = -v
        enc.encode(st, i + 1, 1)
        i += 3
        ctx[c] = 8
    m, vv, i = _magnitude(enc, st, i, v, 20)
    if m < (1 << lo) >> 1:
        ctx[c] = 0
    elif m > (1 << hi) >> 1:
        ctx[c] += 8
    i += 14
    while m >> 1:
        m >>= 1
        enc.encode(st, i, 1 if m & vv else 0)


def _shifted(v, al):
    return (v >> al) if v >= 0 else -((-v) >> al)


def _ac_seq(enc, st, fixed, zzb, ss, se, al, kx):
    ke = se
    while ke > 0 and _shifted(zzb[ke], al) == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)
        while _shifted(zzb[k], al) == 0:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        v = _shifted(zzb[k], al)
        enc.encode(st, i + 1, 1)
        enc.encode(fixed, 0, 1 if v < 0 else 0)
        v = abs(v)
        i += 2
        m, vv, i = _magnitude(enc, st, i, v, 189 if k <= kx else 217)
        i += 14
        while m >> 1:
            m >>= 1
            enc.encode(st, i, 1 if m & vv else 0)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _ac_refine(enc, st, fixed, zzb, ss, se, ah, al):
    ke = se
    while ke > 0 and _shifted(zzb[ke], al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and _shifted(zzb[kex], ah) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            v = _shifted(zzb[k], al)
            if v:
                a = abs(v)
                if a >> 1:
                    enc.encode(st, i + 2, a & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(fixed, 0, 1 if v < 0 else 0)
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _lossless_jpeg(planes, sampling, predictor=1, pt=0, ids=(1, 2, 3, 4), app=b"",
                   restart_rows=0, separate=False):
    """A lossless JPEG (SOF3) of ``planes``: one Huffman table of 5-bit codes
    for the 17 difference categories, differences from ``predictor`` with
    point transform ``pt`` and libjpeg's rules for the first row of an
    iMCU row where a restart interval (``restart_rows`` MCU rows) starts."""
    h, w = planes[0].shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    out = [b"\xff\xd8", app]
    nc = len(planes)
    sofb = struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([ids[i], (s[0] << 4) | s[1], 0]) for i, s in enumerate(sampling))
    out.append(_seg(0xC3, sofb))
    counts = [0] * 16
    counts[4] = 17
    out.append(_seg(0xC4, bytes([0]) + bytes(counts) + bytes(range(17))))
    scans = [[i] for i in range(nc)] if separate else [list(range(nc))]
    for scan in scans:
        if len(scan) == 1:
            c = scan[0]
            hs, vs = sampling[c]
            dh, dw = -(-h * vs // vmax), -(-w * hs // hmax)
            mcux, mcuy, units = dw, dh, [(c, 1, 1)]
        else:
            mcux, mcuy = -(-w // hmax), -(-h // vmax)
            units = [(c, sampling[c][0], sampling[c][1]) for c in scan]
        grids = {}
        for c, H, V in units:
            hs, vs = sampling[c]
            dh, dw = -(-h * vs // vmax), -(-w * hs // hmax)
            sub = planes[c][::vmax // vs, ::hmax // hs][:dh, :dw].astype(np.int64) >> pt
            gh, gw = mcuy * V, mcux * H
            g = np.pad(sub, ((0, gh - dh), (0, gw - dw)), mode="edge")
            # the differences, by the decoder's rules for an interval's first row
            diff = np.zeros_like(g)
            per = restart_rows or 1 << 30
            vc = sampling[c][1]
            for y in range(gh):
                first = y % vc == 0 and any(k % per == 0 for k in range(y // V, (y + vc) // V))
                for x in range(gw):
                    if first:
                        p = (1 << (8 - pt - 1)) if x == 0 else g[y, x - 1]
                    elif x == 0:
                        p = g[y - 1, 0]
                    else:
                        a, b, cc = g[y, x - 1], g[y - 1, x], g[y - 1, x - 1]
                        p = {1: a, 2: b, 3: cc, 4: a + b - cc, 5: a + ((b - cc) >> 1),
                             6: b + ((a - cc) >> 1), 7: (a + b) >> 1}[predictor]
                    diff[y, x] = ((g[y, x] - p + 32768) & 0xFFFF) - 32768
            grids[c] = diff
        if restart_rows:
            out.append(_seg(0xDD, struct.pack(">H", restart_rows * mcux)))
        sos = (bytes([len(scan)]) + b"".join(bytes([ids[c], 0]) for c in scan)
               + bytes([predictor, 0, pt]))
        out.append(_seg(0xDA, sos))
        bits = []
        data = bytearray()

        def flush():
            bits.extend([1] * (-len(bits) % 8))
            for i in range(0, len(bits), 8):
                byte = int("".join(map(str, bits[i:i + 8])), 2)
                data.extend(bytes([byte, 0]) if byte == 0xFF else bytes([byte]))
            bits.clear()

        for my in range(mcuy):
            if restart_rows and my and my % restart_rows == 0:
                flush()
                data.extend(b"\xff" + bytes([0xD0 + (my // restart_rows - 1) % 8]))
            for mx in range(mcux):
                for c, H, V in units:
                    for v in range(V):
                        for u in range(H):
                            d = int(grids[c][my * V + v, mx * H + u])
                            s = abs(d).bit_length()  # 8-bit samples: never 16
                            bits.extend((s >> (4 - i)) & 1 for i in range(5))
                            if 0 < s < 16:
                                val = d if d >= 0 else d + (1 << s) - 1
                                bits.extend((val >> (s - 1 - i)) & 1 for i in range(s))
        flush()
        out.append(bytes(data))
    out.append(b"\xff\xd9")
    return b"".join(out)


def test_arithmetic_table_is_libjpegs():
    """The port's T.81 Table D.2 equals ``jpeg_aritab`` of the libjpeg-turbo
    that Pillow links."""
    import ctypes
    import glob

    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                  "libjpeg*.so*"))
    assert libs, "Pillow's libjpeg-turbo"
    table = (ctypes.c_long * len(_ARITAB)).in_dll(ctypes.CDLL(libs[0]), "jpeg_aritab")
    assert list(table) == list(_ARITAB)


ARITH_SAMPLINGS = [((1, 1),), ((1, 1), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)),
                   ((2, 1), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1))]


@pytest.mark.parametrize("sampling", ARITH_SAMPLINGS, ids=str)
@pytest.mark.parametrize("progressive", [False, True])
def test_arithmetic_coded_jpeg(sampling, progressive):
    """SOF9 and SOF10 (DC first and refinement, AC first and refinement
    scans) from the QM encoder here: restart intervals, DAC conditioning
    (L, U and K at their defaults and at the ends of their ranges) and
    coarse and fine quantization, at odd sizes, byte-equal to Pillow."""
    for h, w in ((1, 1), (9, 7), (37, 53)):
        planes = list(_picture(h, w, h + w).transpose(2, 0, 1))[:len(sampling)]
        for restart, dac, q in ((0, None, 6), (2, {(0, 0): 0x52, (1, 0): 2}, 1),
                                (1, {(0, 0): 0x00, (1, 0): 63}, 20),
                                (3, {(0, 0): 0xF5, (1, 0): 0}, 6)):
            data = _arith_jpeg(planes, sampling, progressive, app=JFIF, restart=restart,
                               dac=dac, quality_step=q)
            assert _check(data, "JPEG") == "read"


def test_arithmetic_coded_jpeg_cmyk_and_fidelity():
    """Four components (CMYK, Adobe CMYK and YCCK); the encoder is right:
    Pillow's pixels of a smooth picture at fine quantization are within 1
    of the source."""
    planes4 = list(_picture(9, 11, 4).transpose(2, 0, 1)) + [np.full((9, 11), 40, np.uint8)]
    for app in (b"", _adobe(0), _adobe(2)):
        for progressive in (False, True):
            assert _check(_arith_jpeg(planes4, ((1, 1),) * 4, progressive, app=app),
                          "JPEG") == "read"
    yy, xx = np.mgrid[0:40, 0:56]
    smooth = np.stack([(yy * 5) % 256, (xx * 4) % 256, (yy + xx) * 3 % 256], -1)
    data = _arith_jpeg(list(smooth.astype(np.uint8).transpose(2, 0, 1)), ((1, 1),) * 3,
                       True, app=_adobe(0), quality_step=1)
    assert np.abs(decode_image(data).astype(int) - smooth).mean() < 1


LOSSLESS_SAMPLINGS = [((1, 1),), ((1, 1), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)),
                      ((2, 2), (1, 1), (2, 1)), ((1, 1),) * 4, ((1, 3), (1, 1), (1, 1))]


@pytest.mark.parametrize("sampling", LOSSLESS_SAMPLINGS, ids=str)
def test_lossless_jpeg(sampling):
    """SOF3 from the encoder here: the seven predictors, point transforms
    0 and 2, restart intervals of 1 and 2 MCU rows, interleaved and one
    scan a component, at odd sizes: byte-equal to Pillow (and, at Pt 0, to
    the source: no colour conversion, plain upsampling)."""
    for h, w in ((1, 1), (5, 3), (17, 20)):
        arr = _picture(h, w, h + w)
        planes = list(arr.transpose(2, 0, 1)) + [arr[..., 0]]
        for predictor in range(1, 8):
            for pt, restart, separate in ((0, 0, False), (2, 1, True), (0, 2, True)):
                if separate and len(sampling) == 1:
                    separate = False
                data = _lossless_jpeg(planes[:len(sampling)], sampling, predictor, pt=pt,
                                      restart_rows=restart, separate=separate)
                assert _check(data, "JPEG") == "read"
                if pt == 0 and set(sampling) == {(1, 1)} and len(sampling) in (1, 3):
                    want = arr if len(sampling) == 3 else np.repeat(arr[..., :1], 3, 2)
                    np.testing.assert_array_equal(decode_image(data), want)


def test_jpeg_frames_pillow_cannot_read_are_skipped():
    """What libjpeg-turbo (and so Pillow) refuses ends as a skip, never as a
    named error: lossless YCbCr (JFIF, Adobe transform 1) and YCCK, 12-bit
    frames (Pillow's plugin refuses them), hierarchical frames, arithmetic
    lossless (SOF11), interleaved MCUs of more than 10 blocks."""
    planes = list(_picture(9, 7, 3).transpose(2, 0, 1))
    for app in (JFIF, _adobe(1)):
        assert _check(_lossless_jpeg(planes, ((1, 1),) * 3, 1, app=app)) == "skipped"
    assert _check(_lossless_jpeg(planes + planes[:1], ((1, 1),) * 4, 1,
                                 app=_adobe(2))) == "skipped"
    assert _check(_lossless_jpeg(planes, ((2, 2),) * 3, 1)) == "skipped"
    base = _encode_jpeg(planes, ((1, 1),) * 3, app=JFIF)
    at = base.index(b"\xff\xc0")
    for sof in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF):
        assert _check(base[:at + 1] + bytes([sof]) + base[at + 2:]) == "skipped"
    twelve = bytearray(base)
    twelve[at + 4] = 12
    assert _check(bytes(twelve)) == "skipped"


# --------------------------------------------------------------------- #
# SUN, XBM, XPM, MSP, ICNS, FTEX and the raw-block formats
# --------------------------------------------------------------------- #


def _sun_raster(w, h, depth, ftype, body, palette=b""):
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       1 if palette else 0, len(palette)) + palette + body


def _sun_rle(raw: bytes, rng) -> bytes:
    """Sun RLE: runs (0x80, n - 1, v) that may cross rows, 0x80 0x00 for a
    literal 0x80, other bytes as they are."""
    out, i = bytearray(), 0
    while i < len(raw):
        if rng.rand() < 0.4:
            n = int(rng.randint(2, 40))
            out += bytes([0x80, n - 1, raw[i]])
            i += n
        else:
            out += b"\x80\x00" if raw[i] == 0x80 else raw[i:i + 1]
            i += 1
    return bytes(out)


@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
def test_sun_raster(depth):
    """Raw (types 1 and 3, rows padded to 16 bits) and RLE (type 2, runs
    across rows) files at every depth, with and without a planar colour map
    (Pillow fails on a map beside a bitmap or true colour), and cut
    short; Pillow's writer has no Sun raster."""
    rng = np.random.RandomState(depth)
    for w, h in ((1, 1), (5, 3), (17, 9)):
        stride = ((w * depth + 15) // 16) * 2
        row = (w * depth + 7) // 8
        for ftype in (1, 2, 3):
            if ftype == 2:
                body = _sun_rle(rng.randint(0, 256, row * h).astype(np.uint8).tobytes(), rng)
            else:
                body = rng.randint(0, 256, stride * h).astype(np.uint8).tobytes()
            for pal in (b"", rng.randint(0, 256, 48).astype(np.uint8).tobytes()):
                _check(_sun_raster(w, h, depth, ftype, body, pal))
                _check(_sun_raster(w, h, depth, ftype, body[:len(body) // 2], pal))


def test_xbm_and_xpm():
    """Pillow's XBM files, a hand-made one with characters that are no hex
    digits, cut files; XPM files of 1 and 2 characters a pixel, above 256
    colours (Pillow's RGB mode), a ``None`` colour used (Pillow fails), a
    colour by name (Pillow fails), cut files."""
    rng = np.random.RandomState(16)
    for w, h in ((1, 1), (5, 3), (17, 9)):
        data = _saved(Image.fromarray(_picture(h, w, 1)[..., 0]).convert("1"), "XBM")
        assert _check(data, "XBM") == "read"
        assert _check(data[:-10]) == "skipped"
    assert _check(b"#define t_width 3\n#define t_height 2\nstatic char t_bits[] = {\n"
                  b" 0x05, 0xzz, xx3\n};\n", "XBM") == "read"
    chars = b"abcdefghijklmnopqrstuvwxyz.#+@ABCDEFGHIJ"
    for w, h, ncol, bpp in ((1, 1, 1, 1), (5, 3, 4, 1), (7, 4, 300, 2), (9, 5, 40, 2)):
        keys = [bytes([chars[i % 40], chars[i // 40]])[:bpp] for i in range(ncol)]
        data = (b"/* XPM */\nstatic char *x[] = {\n/* columns rows colors chars */\n"
                + b'"%d %d %d %d",\n' % (w, h, ncol, bpp)
                + b"".join(b'"' + k + b' c #%06X",\n' % rng.randint(0, 1 << 24) for k in keys)
                + b"/* pixels */\n"
                + b"".join(b'"' + b"".join(keys[rng.randint(0, ncol)] for _ in range(w))
                           + b'",\n' for _ in range(h)) + b"};\n")
        assert _check(data, "XPM") == "read"
        assert _check(data[:-30]) == "skipped"
    for pixels, colour in ((b"ab", b"None"), (b"bb", b"red"), (b"aa", b"#00FF00")):
        _check(b'/* XPM */\n"2 1 2 1",\n"a c ' + colour + b'",\n"b c #FF0000",\n"'
               + pixels + b'"\n')


def _msp_header(magic: bytes, w: int, h: int) -> bytes:
    words = list(struct.unpack("<2H", magic)) + [w, h] + [0] * 12
    check = 0
    for v in words[:-1]:
        check ^= v
    return struct.pack("<16H", *words[:-1], check)


def test_msp_versions_1_and_2():
    """Pillow's MSP files (version 1, raw) and version 2 files built here
    (runs, literals, an empty row), each cut short."""
    rng = np.random.RandomState(17)
    for w, h in ((1, 1), (5, 3), (17, 9)):
        data = _saved(Image.fromarray(_picture(h, w, 2)[..., 0]).convert("1"), "MSP")
        assert _check(data, "MSP") == "read"
        _check(data[:-3])
        row, rows = (w + 7) // 8, []
        for y in range(h):
            r, x = b"", 0
            while x < row and y != 1:
                n = int(rng.randint(1, row - x + 1))
                r += (bytes([0, n, rng.randint(256)]) if rng.rand() < 0.5 else
                      bytes([n]) + rng.randint(0, 256, n).astype(np.uint8).tobytes())
                x += n
            rows.append(r)
        data = (_msp_header(b"LinS", w, h) + struct.pack(f"<{h}H", *map(len, rows))
                + b"".join(rows))
        assert _check(data, "MSP") == "read"
        _check(data[:-2])


def _icns(blocks) -> bytes:
    body = b"".join(sig + struct.pack(">I", len(b) + 8) + b for sig, b in blocks)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def _icns_packbits(chan: bytes, rng) -> bytes:
    out, i = b"", 0
    while i < len(chan):
        n = int(rng.randint(1, min(128, len(chan) - i) + 1))
        if n >= 3 and rng.rand() < 0.5:
            out += bytes([n + 125, chan[i]])
        else:
            out += bytes([n - 1]) + chan[i:i + n]
        i += n
    return out


def test_icns_members():
    """Pillow's ICNS files of every size it writes (PNG members), and the
    24-bit members built here, raw and in Apple's PackBits, with a mask,
    cut short; a PNG member of a size Pillow does not allow."""
    rng = np.random.RandomState(18)
    for mode, im in _modes(_picture(64, 64, 3), ("RGB", "RGBA", "L", "P")):
        assert _check(_saved(im, "ICNS"), "ICNS") == "read"
    for sig, side, pre in ((b"is32", 16, b""), (b"il32", 32, b""), (b"ih32", 48, b""),
                           (b"it32", 128, b"\0\0\0\0")):
        px = _picture(side, side, side)
        rle = b"".join(_icns_packbits(px[..., c].tobytes(), rng) for c in range(3))
        assert _check(_icns([(sig, pre + px.tobytes())]), "ICNS") == "read"
        assert _check(_icns([(sig, pre + rle), (b"s8mk", bytes(256))]), "ICNS") == "read"
        assert _check(_icns([(sig, pre + rle[:-5])])) == "skipped"
    odd = _saved(Image.fromarray(_picture(20, 20, 4)), "PNG")
    assert _check(_icns([(b"ic07", odd)])) == "skipped"


def _im(kind: bytes, w: int, h: int, body: bytes, lut: bytes = b"", size=True) -> bytes:
    head = b"Image type: " + kind + b"\r\n"
    if size:
        head += b"Image size (x*y): %d*%d\r\n" % (w, h)
    if lut:
        head += b"Lut: 1\r\n"
    return head.ljust(511, b"\0") + b"\x1a" + lut + body


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA", "PA", "RGBX", "CMYK",
                                  "YCbCr", "I", "F", "I;16", "I;16B"])
def test_im_pillow_files(mode):
    """Pillow's IM files of every mode it writes (YCC through Pillow's own
    YCbCr conversion), and cut short."""
    for h, w in SIZES:
        arr = _picture(h, w, h + w)
        im = Image.fromarray(arr)
        if mode in ("I", "F"):
            im = Image.fromarray((arr[..., 0].astype(np.int32) * 3 - 200).astype(
                np.int32 if mode == "I" else np.float32))
        elif mode in ("I;16", "I;16B"):
            im = Image.fromarray(arr[..., 0].astype(np.uint16) * 300).convert(mode)
        elif mode in ("P", "PA"):
            im = im.quantize(16).convert(mode)
        else:
            im = im.convert(mode)
        data = _saved(im, "IM")
        assert _check(data, "IM") == "read"
        assert _check(data[:len(data) - 1]) == "skipped"


def test_im_built_here():
    """The IM types Pillow does not write: 2- and 4-bit palette images with
    and without a colour map, 8-bit unsigned and signed, 16-bit signed and
    32-bit integer floats, RGB pixel-interleaved, a gray map (kept gray), a
    missing size line (512 x 512), the older RGB types (two Pillow reads,
    two it fails on); a 12-bit depth (Pillow's bit decoder) read."""
    rng = np.random.RandomState(20)
    w, h = 7, 3
    raw = rng.randint(0, 256, 512 * 512 * 4).astype(np.uint8).tobytes()
    colour = rng.randint(0, 256, 768).astype(np.uint8).tobytes()
    ramp = bytes(range(256)) * 3
    for kind in (b"B2 image", b"B4 image", b"L 8 image", b"L 8S image", b"L*16S image",
                 b"L 32 image", b"X 24 image", b"Greyscale image", b"L 16 image"):
        for lut in (b"", colour, ramp):
            _check(_im(kind, w, h, raw, lut))
    assert _check(_im(b"Greyscale image", w, h, raw, size=False), "IM") == "read"
    for kind in (b"RGB3 image", b"RYB3 image", b"RLB image", b"RYB image"):
        _check(_im(kind, w, h, raw))
    assert _check(_im(b"L*12 image", w, h, raw), "IM") == "read"


def _fits_cards(*cards: bytes) -> bytes:
    out = b"".join(c.ljust(80) for c in cards) + b"END".ljust(80)
    return out.ljust(-(-len(out) // 2880) * 2880)


@pytest.mark.parametrize("bits,dtype", [(8, "u1"), (16, "<u2"), (32, "<i4"), (-32, "<f4"),
                                        (-64, "<f4"), (16, ">i2"), (64, "<i8")])
def test_fits(bits, dtype):
    """Every BITPIX (Pillow reads the values little-endian, -64 as float32,
    and has no mode for 64), one to three axes, images shorter than a card
    (Pillow's pixels then start inside the header), cut files; an image in
    an extension after an empty primary header; GZIP_1 tile-compressed
    tables at every ZBITPIX."""
    rng = np.random.RandomState(abs(bits))
    for w, h, naxis in ((3, 2, 2), (1, 5, 1), (4, 3, 3), (20, 9, 2)):
        cards = [b"SIMPLE  = T", b"BITPIX  = %d" % bits, b"NAXIS   = %d" % naxis,
                 b"NAXIS1  = %d" % (w if naxis > 1 else h)]
        cards += [b"NAXIS2  = %d" % h] if naxis > 1 else []
        cards += [b"NAXIS3  = 2"] if naxis > 2 else []
        body = rng.uniform(-50, 400, w * h * 2).astype(dtype).tobytes()
        for cut in (len(body), len(body) // 2, 3):
            _check(_fits_cards(*cards) + body[:cut])
    primary = _fits_cards(b"SIMPLE  = T", b"BITPIX  = 8", b"NAXIS   = 0")
    assert _check(primary + _fits_cards(b"XTENSION= 'IMAGE   '", b"BITPIX  = 8",
                                        b"NAXIS   = 2", b"NAXIS1  = 3", b"NAXIS2  = 2")
                  + bytes(range(6)), "FITS") == "read"
    if bits in (8, 16, 32, -32):
        table = _fits_cards(b"XTENSION= 'BINTABLE'", b"BITPIX  = 8", b"NAXIS   = 2",
                            b"NAXIS1  = 8", b"NAXIS2  = 1", b"ZIMAGE  = T",
                            b"ZCMPTYPE= 'GZIP_1  '", b"ZBITPIX = %d" % bits, b"ZNAXIS  = 2",
                            b"ZNAXIS1 = 5", b"ZNAXIS2 = 4")
        packed = gzip.compress(rng.randint(0, 256, (4, 5)).astype(">i4").tobytes())
        _check(primary + table + bytes(8) + packed)
    assert _check(primary) == "skipped"  # no image data


def _blp2(w, h, encoding, alpha, alpha_encoding, body, rng) -> bytes:
    palette = rng.randint(0, 256, 1024).astype(np.uint8).tobytes()
    head = b"BLP2" + struct.pack("<ibbbbII", 1, encoding, alpha, alpha_encoding, 0, w, h)
    at = 20 + 128 + len(palette)
    return (head + struct.pack("<16I", at, *[0] * 15) + struct.pack("<16I", len(body), *[0] * 15)
            + palette + body)


def test_blp():
    """Pillow's BLP1 and BLP2 files (palette), and BLP2 files built here
    with DXT1, DXT3 and DXT5 blocks (Pillow's own Python decoders) with and
    without alpha at sizes the blocks do not divide, raw indices, BLP1
    holding a JPEG (its colours read as BGR), each cut short."""
    rng = np.random.RandomState(21)
    for h, w in SIZES:
        im = Image.fromarray(_picture(h, w, 5)).quantize(16)
        for kw in ({}, {"blp_version": "BLP1"}):
            assert _check(_saved(im, "BLP", **kw), "BLP") == "read"
    for h, w in ((4, 4), (9, 7), (5, 13)):
        nb = ((w + 3) // 4) * ((h + 3) // 4)
        for alpha_encoding, size in ((0, 8), (1, 16), (7, 16)):
            for alpha in (0, 8):
                body = rng.randint(0, 256, nb * size).astype(np.uint8).tobytes()
                data = _blp2(w, h, 2, alpha, alpha_encoding, body, rng)
                assert _check(data, "BLP") == "read"
                assert _check(data[:-3]) == "skipped"
        indices = rng.randint(0, 256, w * h).astype(np.uint8).tobytes()
        assert _check(_blp2(w, h, 1, 8, 0, indices, rng), "BLP") == "read"
        jpeg = _encode_jpeg(list(_picture(h, w, 6).transpose(2, 0, 1)), ((1, 1),) * 3, app=JFIF)
        cut = jpeg.index(b"\xff\xda")
        at = 28 + 128 + 4 + cut
        data = (b"BLP1" + struct.pack("<iIIIiI", 0, 0, w, h, 5, 0)
                + struct.pack("<16I", at, *[0] * 15)
                + struct.pack("<16I", len(jpeg) - cut, *[0] * 15)
                + struct.pack("<I", cut) + jpeg)
        assert _check(data, "BLP") == "read"
        assert _check(data[:-5]) == "skipped"


def test_raw_block_formats():
    """XV thumbnails, PIXAR, McIdas areas at 1, 2 and 4 bytes a sample with
    row prefixes, IMT and FTEX (raw and BC1) built here, each cut short."""
    rng = np.random.RandomState(19)
    for w, h in ((1, 1), (5, 3), (17, 9)):
        px = rng.randint(0, 256, w * h * 3).astype(np.uint8).tobytes()
        cases = [b"P7 332\n#XVVERSION\n#END_OF_COMMENTS\n%d %d 255\n" % (w, h) + px[:w * h],
                 b"\x80\xe8\x00\x00".ljust(416, b"\0") + struct.pack("<HHHHHH", h, w, 0, 0, 14, 2)
                 .ljust(608, b"\0") + px,
                 b"width %d\nheight %d\npixel n8\n\x0c" % (w, h) + px[:w * h]]
        for size in (1, 2, 4):
            words = [0] * 65  # 1-based, as McIdasImagePlugin counts them
            words[2], words[9], words[10], words[11] = 4, h, w, size
            words[14], words[15], words[34] = 1, 3, 256  # bands, row prefix, data
            cases.append(struct.pack(">64i", *words[1:]) + rng.randint(
                0, 256, 3 + h * (3 + w * size)).astype(np.uint8).tobytes())
        blocks = rng.randint(0, 256, 8 * -(-w // 4) * -(-h // 4)).astype(np.uint8).tobytes()
        for fmt, mip in ((1, px), (0, blocks)):
            cases.append(b"FTEX" + struct.pack("<iiiiiii", 0, w, h, 1, 1, fmt, 32)
                         + struct.pack("<i", len(mip)) + mip)
        for data in cases:
            assert _check(data) == "read"
            _check(data[:-2])
            assert _check(data[:len(data) // 2]) == "skipped"


# --------------------------------------------------------------------- #
# the format table: one file for each of Pillow's formats
# --------------------------------------------------------------------- #


def _fli() -> bytes:
    """An FLI of one 4 x 2 frame: a 64-colour palette chunk, then a
    byte-run (BRUN) chunk."""
    pal = struct.pack("<HBB", 1, 0, 4) + bytes(range(12))
    pal_chunk = struct.pack("<IH", 6 + len(pal), 11) + pal
    brun = bytes([1, 4, 3]) * 2  # each row: one packet, 4 pixels of colour 3
    brun += bytes(-len(brun) % 2)
    brun_chunk = struct.pack("<IH", 6 + len(brun), 15) + brun
    frame = pal_chunk + brun_chunk
    frame = struct.pack("<IHH", 16 + len(frame), 0xF1FA, 2) + bytes(8) + frame
    head = struct.pack("<IHHHHHH", 128 + len(frame), 0xAF11, 1, 4, 2, 8, 0)
    head += struct.pack("<I", 5) + bytes(128 - len(head) - 4)
    return head + frame


def _fits() -> bytes:
    cards = [b"SIMPLE  =                    T", b"BITPIX  =                    8",
             b"NAXIS   =                    2", b"NAXIS1  =                    3",
             b"NAXIS2  =                    2", b"END"]
    head = b"".join(c.ljust(80) for c in cards)
    return head.ljust(2880) + bytes(range(6)).ljust(2880, b"\0")


def _ftex() -> bytes:
    return (b"FTEX" + struct.pack("<iiiii", 0x3F800000, 4, 4, 1, 1)
            + struct.pack("<ii", 1, 0) + struct.pack("<ii", 48, 16) + bytes(8)
            + bytes(range(16)) * 1)


def _gbr() -> bytes:
    name = b"brush\0"
    return struct.pack(">IIIIII", 28 + len(name), 2, 3, 2, 1, 0x47494D50) + struct.pack(
        ">I", 10) + name + bytes(range(6))


def _mcidas() -> bytes:
    w = [0] * 64
    w[1], w[8], w[9], w[10], w[11], w[13], w[14], w[33], w[34] = 4, 2, 3, 1, 0, 0, 0, 256, 0
    head = b"\0\0\0\0\0\0\0\x04" + struct.pack(">62i", *w[2:])
    return head + bytes(256 - len(head)) + bytes(range(6))


def _pixar() -> bytes:
    head = b"\x80\xe8\x00\x00" + bytes(412) + struct.pack("<HH", 3, 2) + bytes(4)
    head += struct.pack("<HH", 14, 2)
    return head.ljust(1024, b"\0") + bytes(range(24))


def _sun() -> bytes:
    return struct.pack(">8I", 0x59A66A95, 3, 2, 8, 6, 1, 0, 0) + bytes(range(4)) * 2


def _xvthumb() -> bytes:
    return b"P7 332\n#END_OF_COMMENTS\n3 2 255\n" + bytes(range(6))


def _xpm() -> bytes:
    return (b'/* XPM */\nstatic char *x[] = {\n"2 2 2 1",\n"a c #FF0000",\n'
            b'"b c #00FF00",\n"ab",\n"ba"\n};\n')


def _imt() -> bytes:
    return b"width 3\nheight 2\npixel n8\n\x0c" + bytes(range(6))


def _iptc() -> bytes:
    def field(rec, tag, value):
        return bytes([0x1C, rec, tag]) + struct.pack(">H", len(value)) + value
    return (field(3, 60, bytes([1, 0])) + field(3, 20, struct.pack(">H", 3))
            + field(3, 30, struct.pack(">H", 2)) + field(3, 120, bytes([1]))
            + field(8, 10, bytes(range(6))) + bytes(5))


def _pcd() -> bytes:
    head = bytearray(2048 + 1539)
    head[2048:2055] = b"PCD_IPI"
    return bytes(head).ljust(96 * 2048 + 768 * 512 * 3 // 2, b"\x40")


def _cur() -> bytes:
    bpp, dib = _icon_bitmap(_picture(4, 4, 1), "RGB")
    return _icon([(4, 4, 0, bpp, dib)], b"\x00\x00\x02\x00")


def _dcx() -> bytes:
    a = _saved(Image.fromarray(_picture(5, 7, 1)), "PCX")
    return struct.pack("<III", 0x3ADE68B1, 12, 0) + a


def _psd_file() -> bytes:
    return _psd(3, 8, _picture(4, 5, 1).transpose(2, 0, 1).copy(), True,
                np.random.RandomState(0))


def _from_pillow(fmt, mode="RGB", **kw):
    def make():
        im = Image.fromarray(_picture(16, 16, 1))
        return _saved(im.quantize(16) if mode == "P" else im.convert(mode), fmt, **kw)
    return make


# Pillow's format -> (the file, the port's outcome)
TABLE = {
    "BMP": (_from_pillow("BMP"), "read"),
    "DIB": (_from_pillow("DIB"), "read"),
    "GIF": (_from_pillow("GIF"), "read"),
    "JPEG": (_from_pillow("JPEG"), "read"),
    "PPM": (_from_pillow("PPM"), "read"),
    "PNG": (_from_pillow("PNG"), "read"),
    "AVIF": (_from_pillow("AVIF"), "named"),
    "BLP": (_from_pillow("BLP", "P"), "read"),
    "BUFR": (lambda: b"BUFR" + bytes(60), "skipped"),
    "CUR": (_cur, "read"),
    "PCX": (_from_pillow("PCX"), "read"),
    "DCX": (_dcx, "read"),
    "DDS": (_from_pillow("DDS"), "read"),
    "EPS": (_from_pillow("EPS"), "skipped"),
    "FITS": (_fits, "read"),
    "FLI": (_fli, "read"),
    "FTEX": (_ftex, "read"),
    "GBR": (_gbr, "read"),
    "GRIB": (lambda: b"GRIB\0\0\1\1" + bytes(60), "skipped"),  # GBR refuses it
    "HDF5": (lambda: b"\x89HDF\r\n\x1a\n" + bytes(60), "skipped"),
    "JPEG2000": (_from_pillow("JPEG2000"), "named"),
    "ICNS": (_from_pillow("ICNS"), "read"),
    "ICO": (_from_pillow("ICO"), "read"),
    "IM": (_from_pillow("IM"), "read"),
    "IMT": (_imt, "read"),
    "IPTC": (_iptc, "read"),
    "MCIDAS": (_mcidas, "read"),
    "MPEG": (lambda: b"\x00\x00\x01\xb3" + struct.pack(">HB", 0x0100, 0x80) + bytes(60),
             "skipped"),
    "TIFF": (_from_pillow("TIFF"), "read"),
    "MSP": (_from_pillow("MSP", "1"), "read"),
    "PCD": (_pcd, "read"),
    "PIXAR": (_pixar, "read"),
    "PSD": (_psd_file, "read"),
    "QOI": (_from_pillow("QOI"), "read"),
    "SGI": (_from_pillow("SGI"), "read"),
    "SPIDER": (_from_pillow("SPIDER"), "read"),
    "SUN": (_sun, "read"),
    "TGA": (_from_pillow("TGA"), "read"),
    "WEBP": (_from_pillow("WEBP"), "read"),
    "WMF": (lambda: b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<hhhhH", 0, 0, 100, 100, 1440)
            + bytes(6) + b"\x01\x00\x09\x00" + bytes(40), "skipped"),
    "XBM": (_from_pillow("XBM", "1"), "read"),
    "XPM": (_xpm, "read"),
    "XVTHUMB": (_xvthumb, "read"),
}


def test_the_table_is_image_open_order():
    """The port's rows are Pillow's plugins in the order a fresh process's
    ``Image.open`` tries them: preinit's, then ``Image.ID``'s."""
    from PIL import Image as I  # noqa: N812

    I.init()
    preinit = ["BMP", "DIB", "GIF", "JPEG", "PPM", "PNG"]
    rest = [f for f in I.ID if f not in preinit]
    assert [f.name for f in image_formats.FORMATS] == preinit + rest
    assert set(TABLE) == set(I.ID)


@pytest.mark.parametrize("fmt", sorted(TABLE))
def test_every_pillow_format(fmt):
    """One file for each entry of ``Image.ID``: Pillow opens it as that
    format, and the port's outcome is the table's: read byte-equal where
    the port has a reader, named where Pillow reads and the port does
    not, skipped only where Pillow cannot load the file."""
    make, outcome = TABLE[fmt]
    data = make()
    want = _pillow(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert Image.open(io.BytesIO(data)).format.upper() == fmt
    assert (want is None) == (outcome == "skipped")
    assert _check(data, named=outcome == "named") == outcome


CORRUPTED = ["BLP", "CUR", "DCX", "DDS", "DIB", "FITS", "FLI", "FTEX", "GBR", "ICNS", "ICO", "IM",
             "IMT", "IPTC", "MCIDAS", "MSP", "PCD", "PCX", "PIXAR", "PPM", "PSD", "SGI", "SPIDER",
             "SUN", "TGA", "XBM", "XPM", "XVTHUMB"]


@pytest.mark.parametrize("fmt", CORRUPTED)
def test_corrupted_files_end_as_in_pillow(fmt):
    """Each newer reader's table file with random bytes overwritten or cut
    short, 40 times from a seed: where Pillow reads the bytes the port
    reads them byte-equal, and where Pillow fails the port skips them (no
    other exception, nothing named)."""
    rng = np.random.RandomState(sum(fmt.encode()))
    base = TABLE[fmt][0]()
    for _ in range(40):
        data = bytearray(base)
        if rng.randint(4) == 0:
            data = data[:rng.randint(1, len(data))]
        else:
            for _ in range(rng.randint(1, 6)):
                data[rng.randint(len(data))] = rng.randint(256)
        _check(bytes(data))


# --------------------------------------------------------------------- #
# the header checks of the formats the port names
# --------------------------------------------------------------------- #


def _put(data: bytes, at: int, fmt: str, *values) -> bytes:
    out = bytearray(data)
    struct.pack_into(fmt, out, at, *values)
    return bytes(out)


def _jp2_boxes(data: bytes) -> dict:
    """A JP2 file's top-level boxes and those in its header -> {type: offset}."""
    out, pos = {}, 0
    while pos + 8 <= len(data):
        size, kind = struct.unpack_from(">I4s", data, pos)
        out.setdefault(kind, pos)
        pos = pos + 8 if kind == b"jp2h" else pos + (size or len(data) - pos)
    return out


def _refused_headers():
    """Files of each format the port names whose header Pillow's plugin
    refuses or cannot load, or that are cut short -> (name, bytes)."""
    pic = Image.fromarray(_picture(16, 16, 1))
    avif, jp2 = _saved(pic, "AVIF"), _saved(pic, "JPEG2000")
    j2k = _saved(pic, "JPEG2000", no_jp2=True)
    fli = _fli()
    at = _jp2_boxes(jp2)
    ihdr, jp2c = at[b"ihdr"], at[b"jp2c"]
    meta = avif.index(b"meta") - 4
    yield "AVIF without the avif brand", avif[:8] + b"mif1" + avif[12:16] + b"mif1" * 4 + avif[32:]
    yield "AVIF cut in its meta box", avif[:meta + 40]
    yield "AVIF cut in its image", avif[:-20]
    yield "AVIF without a picture handler", avif.replace(b"pict", b"vide", 1)
    yield "AVIF without ispe", avif.replace(b"ispe", b"ispf", 1)
    yield "FLI with reserved bytes set", _put(fli, 20, "B", 1)
    yield "FLI cut in its palette", fli[:150]
    yield "FLI cut in its frame", fli[:165]
    yield "FLI whose palette runs past index 255", _put(fli, 128 + 24, "B", 255)
    yield "J2K of 5 components", _put(j2k, 4 + 36, ">H", 5)
    yield "J2K cut in its SIZ segment", j2k[:30]
    yield "J2K cut in its main header", j2k[:60]
    yield "J2K cut in a tile", j2k[:-30]
    yield "JP2 without jp2h", jp2[:12] + jp2[12:].replace(b"jp2h", b"jp2x", 1)
    yield "JP2 with an ihdr box too short for its fields", _put(jp2, ihdr, ">I", 12)
    yield "JP2 of 5 components", _put(jp2, ihdr + 16, ">H", 5)
    yield "JP2 without its codestream", jp2[:jp2c - 4]
    yield "JP2 cut in its codestream", jp2[:jp2c + 200]
    yield "IPTC without its size", _iptc().replace(bytes([0x1C, 3, 20]), bytes([0x1C, 3, 21]))
    yield "PCD without its tag", _pcd()[:2048] + b"XXXX" + _pcd()[2052:]


@pytest.mark.parametrize("case", list(dict(_refused_headers())), ids=str)
def test_named_formats_check_their_headers_as_pillow_does(case):
    """A format the port names is named only for a file whose header
    Pillow opens: where Pillow's _open refuses the header, or the file is
    cut short and fails to load, the port skips it too (or reads it with
    the next plugin Pillow tries)."""
    data = dict(_refused_headers())[case]
    assert _pillow(data) is None
    assert _check(data) == "skipped"


# --------------------------------------------------------------------- #
# decompression bombs: a header of more pixels than Pillow opens
# --------------------------------------------------------------------- #

W, H = 13_000, 14_000  # 182,000,000 pixels: above Pillow's 178,956,970
W16, H16 = 65_535, 2_731  # the same for 16-bit sizes: 178,976,085


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _png_of(w: int, h: int) -> bytes:
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(bytes(64))) + _png_chunk(b"IEND", b""))


def _j2k_of(w: int, h: int) -> bytes:
    j2k = _saved(Image.fromarray(_picture(16, 16, 1)), "JPEG2000", no_jp2=True)
    return _put(j2k, 8, ">II", w, h)


def _bigtiff_of(w: int, h: int) -> bytes:
    fields = [(256, 4, w), (257, 4, h), (258, 3, 8), (262, 3, 1), (273, 4, 8),
              (278, 4, h), (279, 4, 1)]
    ifd = struct.pack("<Q", len(fields)) + b"".join(
        struct.pack("<HHQQ", tag, typ, 1, v) for tag, typ, v in fields) + bytes(8)
    return b"II+\x00" + struct.pack("<HHQ", 8, 0, 16) + ifd


def _spider_of(w: int, h: int) -> bytes:
    data = _saved(Image.fromarray(_picture(4, 4, 1)).convert("F"), "SPIDER")
    order = ">" if 1 <= struct.unpack_from(">f", data, 4)[0] < 1e6 else "<"
    v = list(struct.unpack_from(f"{order}27f", data))
    v[1], v[11], v[12], v[21], v[22] = h, w, 1, 4 * w, 4 * w  # nrow, nsam, labrec, labbyt, lenbyt
    return struct.pack(f"{order}27f", *v) + data[108:]


def _iptc_of(w: int, h: int) -> bytes:
    def field(rec, tag, value):
        return bytes([0x1C, rec, tag]) + struct.pack(">H", len(value)) + value
    return (field(3, 60, bytes([1, 0])) + field(3, 20, struct.pack(">I", w))
            + field(3, 30, struct.pack(">I", h)) + field(3, 120, bytes([1]))
            + field(8, 10, bytes(range(6))) + bytes(5))


def _webp_of(w: int, h: int) -> bytes:
    data = _saved(Image.fromarray(_picture(16, 16, 1)), "WEBP")
    at = data.index(b"\x9d\x01\x2a") + 3
    return _put(data, at, "<HH", w, h)


def _bombs():
    pic = Image.fromarray(_picture(16, 16, 1))
    png = _png_of(W, H)
    bc6 = _dds(16, 16, 0x4, b"DX10", extra=_dx10(95), body=bytes(256))
    avif = _saved(pic, "AVIF")
    jp2 = _saved(pic, "JPEG2000")
    jpeg = _saved(pic, "JPEG")
    dib = _put(_icon_bitmap(_picture(4, 4, 1), "RGB")[1], 4, "<ii", W, 2 * H)
    sgi_rle = _sgi(_picture(4, 4, 2).transpose(2, 0, 1), 1, 3, True, np.random.RandomState(0))
    yield "BMP", _put(_saved(pic, "BMP"), 18, "<ii", W, H)
    yield "DIB", _put(_saved(pic, "DIB"), 4, "<ii", W, H)
    yield "GIF", _put(_saved(pic, "GIF"), 6, "<HH", W16, H16)
    yield "JPEG", _put(jpeg, jpeg.index(b"\xff\xc0") + 5, ">HH", H16, W16)
    yield "PPM", b"P6\n%d %d\n255\n" % (W, H) + bytes(30)
    yield "PFM", b"Pf\n%d %d\n-1.0\n" % (W, H) + bytes(30)
    yield "PNG", png
    yield "AVIF", _put(avif, avif.index(b"ispe") + 8, ">II", W, H)
    yield "BLP", _put(_from_pillow("BLP", "P")(), 12, "<II", W, H)
    yield "CUR", _put(_cur(), 22 + 4, "<ii", W, 2 * H)
    yield "PCX", _put(_saved(pic, "PCX"), 4, "<HHHH", 0, 0, W16 - 1, H16 - 1)
    yield "DCX", _put(_dcx(), 12 + 4, "<HHHH", 0, 0, W16 - 1, H16 - 1)
    yield "DDS", _put(_saved(pic, "DDS"), 12, "<II", H, W)
    yield "DDS BC6H", _put(bc6, 12, "<II", H, W)
    yield "FITS", _fits_cards(b"SIMPLE  =                    T", b"BITPIX  =                    8",
                              b"NAXIS   =                    2", b"NAXIS1  = %20d" % W,
                              b"NAXIS2  = %20d" % H) + bytes(64)
    yield "FLI", _put(_fli(), 8, "<HH", W16, H16)
    yield "FTEX", _put(_ftex(), 8, "<ii", W, H)
    yield "GBR", _put(_gbr(), 8, ">II", W, H)
    yield "JPEG 2000 codestream", _j2k_of(W, H)
    yield "JPEG 2000 JP2", _put(jp2, _jp2_boxes(jp2)[b"ihdr"] + 8, ">II", H, W)
    yield "ICNS PNG member", _icns([(b"ic07", png)])
    yield "ICNS JPEG 2000 member", _icns([(b"ic07", _j2k_of(W, H))])
    yield "ICO BMP entry", _icon([(4, 4, 0, 24, dib)])
    yield "ICO PNG entry", _icon([(4, 4, 0, 32, png)])
    yield "IM", _im(b"RGB image", W, H, b"")
    yield "IM YCC", _im(b"YCC image", W, H, b"")
    yield "IMT", b"width %d\nheight %d\npixel n8\n\x0c" % (W, H) + bytes(6)
    yield "IPTC", _iptc_of(W, H)
    yield "MCIDAS", _put(_mcidas(), 32, ">ii", H, W)
    yield "TIFF", _tiff(_picture(2, 2, 1), photo=2, tags={256: (4, [W]), 257: (4, [H])})
    yield "TIFF JPEG-compressed", _tiff(_picture(2, 2, 1), photo=2, tags={
        256: (4, [W]), 257: (4, [H]), 259: (3, [7])})
    yield "BigTIFF", _bigtiff_of(W, H)
    yield "MSP", _msp_header(b"DanM", W16, H16) + bytes(16)
    yield "PIXAR", _put(_pixar(), 416, "<HH", H16, W16)
    yield "PSD", _put(_psd(3, 8, _picture(2, 2, 1).transpose(2, 0, 1).copy(), False,
                           np.random.RandomState(0)), 14, ">II", H, W)
    yield "PSD Lab", _put(_psd(9, 8, _picture(2, 2, 1).transpose(2, 0, 1).copy(), False,
                               np.random.RandomState(0)), 14, ">II", H, W)
    yield "QOI", _put(_saved(pic, "QOI"), 4, ">II", W, H)
    yield "SGI", _put(_saved(pic, "SGI"), 6, ">HH", W16, H16)
    yield "SGI RLE", _put(sgi_rle, 6, ">HH", W16, H16)
    yield "SPIDER", _spider_of(W, H)
    yield "SUN", _put(_sun(), 4, ">II", W, H)
    yield "TGA", _put(_saved(pic, "TGA"), 12, "<HH", W16, H16)
    yield "WEBP", _webp_of(16_383, 10_924)
    yield "XBM", b"#define x_width %d\n#define x_height %d\nstatic char x_bits[] = {\n0x00};\n" % (
        W, H)
    yield "XPM", b'/* XPM */\nstatic char *x[] = {\n"%d %d 1 1",\n"a c #FF0000",\n"a"\n};\n' % (
        W, H)
    yield "XVTHUMB", b"P7 332\n#END_OF_COMMENTS\n%d %d 255\n" % (W, H) + bytes(6)


@pytest.mark.parametrize("case", list(dict(_bombs())), ids=str)
def test_a_header_of_too_many_pixels_is_skipped_as_pillow_refuses_it(case):
    """A few bytes whose header claims more pixels than Pillow's
    decompression-bomb check lets through, for every reader and every
    named format whose header holds a size: Pillow raises
    DecompressionBombError, and the port raises its plain ValueError before
    it allocates the image (so the dataset sources skip the file), never
    an UnsupportedImageError and never a MemoryError."""
    data = dict(_bombs())[case]
    with pytest.raises(Image.DecompressionBombError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(raw.DECODE_ERRORS, match="decompression bomb") as err:
        decode_image(data)
    assert not isinstance(err.value, UnsupportedImageError)


# --------------------------------------------------------------------- #
# a folder corpus of mislabeled files
# --------------------------------------------------------------------- #


def test_folder_of_mislabeled_files_matches_the_jax_package(tmp_path):
    """Files of every newly read format named .jpg, .png, .bmp and .webp,
    beside bytes that are no image: the port's ImageFolderDataset yields the
    JAX package's names and arrays, and skips what it skips."""
    pic = Image.fromarray(_picture(20, 28, 15))
    rng = np.random.RandomState(15)
    files = {
        "a_tga.jpg": _saved(pic, "TGA"),
        "b_tga_rle.png": _saved(pic.convert("RGBA"), "TGA", compression="tga_rle"),
        "c_pcx.jpg": _saved(pic, "PCX"),
        "d_sgi.png": _sgi(np.asarray(pic).transpose(2, 0, 1), 1, 3, True, rng),
        "e_dib.bmp": _saved(pic, "DIB"),
        "f_ico.png": _saved(pic.resize((32, 32)), "ICO", bitmap_format="bmp"),
        "g_ico_png.jpg": _saved(pic.resize((32, 32)), "ICO"),
        "h_psd.jpg": _psd(3, 8, np.asarray(pic).transpose(2, 0, 1).copy(), True, rng),
        "i_dds.webp": _saved(pic, "DDS"),
        "j_pfm.png": b"Pf\n28 20\n-1.0\n" + rng.uniform(0, 255, 560).astype("<f4").tobytes(),
        "k_spider.jpg": _saved(pic.convert("L"), "SPIDER"),
        "l_text.jpg": b"not an image\n",
        "m_cut_tga.png": _saved(pic, "TGA")[:40],
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    want = list(jraw.ImageFolderDataset(str(tmp_path), img_size=16))
    src = raw.ImageFolderDataset(str(tmp_path), img_size=16)
    got = list(src)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == len(files) - 2 and src.skipped == 2
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def main() -> int:
    """This machine's host-CPU time to read a 256 x 256 file of each newer
    reader (best of 3), against Pillow's on the same bytes, byte-equal:
    ``PYTHONPATH=. python tests/test_torch_image_formats.py``."""
    pic = _picture(256, 256, 1)
    rng = np.random.RandomState(1)
    planes = list(pic.transpose(2, 0, 1))
    bc7 = rng.randint(0, 256, (64 * 64, 16)).astype(np.uint8)
    bc7[:, 0] = 0x40  # mode 6
    cases = {
        "arithmetic-coded JPEG": _arith_jpeg(planes, ((2, 2), (1, 1), (1, 1)), app=JFIF),
        "arithmetic-coded progressive JPEG": _arith_jpeg(planes, ((2, 2), (1, 1), (1, 1)),
                                                         True, app=JFIF),
        "lossless JPEG (predictor 1)": _lossless_jpeg(planes, ((1, 1),) * 3, 1),
        "lossless JPEG (predictor 7)": _lossless_jpeg(planes, ((1, 1),) * 3, 7),
        "JPEG 4:1:1 (H = 4)": _encode_jpeg(planes, ((4, 1), (1, 1), (1, 1)), app=JFIF),
        "TGA RLE": _saved(Image.fromarray(pic), "TGA", compression="tga_rle"),
        "PCX": _saved(Image.fromarray(pic), "PCX"),
        "SGI RLE": _sgi(pic.transpose(2, 0, 1), 1, 3, True, rng),
        "PSD PackBits": _psd(3, 8, pic.transpose(2, 0, 1).copy(), True, rng),
        "DDS BC1": _saved(Image.fromarray(pic), "DDS", pixel_format="DXT1"),
        "DDS BC7": _dds(256, 256, 0x4, b"DX10", extra=_dx10(98), body=bc7.tobytes()),
        "ICO (BMP)": _saved(Image.fromarray(pic), "ICO", bitmap_format="bmp",
                            sizes=[(256, 256)]),
        "Sun raster RLE": _sun_raster(256, 256, 24, 2, _sun_rle(pic.tobytes(), rng)),
    }
    for kind, data in cases.items():
        ours, pillow = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            got = decode_image(data)
            ours.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            want = _pillow(data)[1]
            pillow.append(time.perf_counter() - t0)
        assert np.array_equal(got, want)
        print(f"256x256 {kind} ({len(data)} bytes): {min(ours):.4f} s, Pillow "
              f"{min(pillow):.4f} s (host CPU, best of 3), byte-equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
