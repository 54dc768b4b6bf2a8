"""The port's TIFF reader (``cogview_tpu_torch/utils/tiff.py``, ``ccitt.py``
and ``jpeg.py``'s JPEG-in-TIFF path) against live Pillow 12.1, byte for
byte, with no tolerance.

Pillow opens a TIFF with its own directory reader and decodes every
compressed one through its bundled libtiff 4.7, which reads the directory
again by its own rules; each case here is a file whose outcome depends on
one of those steps: the sample layouts of Pillow's ``OPEN_INFO`` (2, 4, 12,
16 and 32 bits, signed and floating point, FillOrder 2, both byte orders,
strips, tiles and planar configuration 2), predictors 2 and 3, LZMA,
BigTIFF, CCITT RLE, Group 3 and Group 4, JPEG with JPEGTables, libtiff's
directory rules, and the formats still named or skipped.  The files come
from ``chip_smoke.py``'s writers (``_tiff_file``, ``_fax_rows``,
``_jpeg_file``) or from Pillow itself.

Where libtiff leaves part of Pillow's strip buffer unwritten (a Group 4
strip that ends early, a JPEG stream narrower than its strip), Pillow's
image holds whatever that memory held; the damaged-file sweeps find those
bytes by reading the strips through Pillow's own libtiff (ctypes) into
buffers filled two ways, and compare every other pixel.

``python tests/test_torch_image_tiff.py`` prints this machine's host time
to decode an A4 Group 4 page at 300 dpi, a 1024 x 768 JPEG-in-TIFF and a
256 x 256 16-bit file.
"""

import ctypes
import functools
import glob
import hashlib
import importlib.util
import io
import lzma
import os
import statistics
import struct
import sys
import tempfile
import time
import zlib

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

sys.path.insert(0, os.path.dirname(__file__))

from cogview_tpu_torch.preprocess import raw_datasets as raw  # noqa: E402
from cogview_tpu_torch.utils.image_errors import UnsupportedImageError  # noqa: E402
from cogview_tpu_torch.utils.image_formats import decode_image  # noqa: E402
from test_torch_image_damage_jpeg import picture, pillow  # noqa: E402
from test_torch_image_io import _lzw_tiff, _packbits_tiff  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load_chip_smoke()


def ends_as_in_pillow(data: bytes, undefined=None) -> str:
    """Assert the port ends ``data`` as Pillow does -> "read" or "skipped";
    pixels ``undefined`` marks (Pillow's unwritten buffer) are not
    compared."""
    want = pillow(data)
    if want is None:
        with pytest.raises(raw.DECODE_ERRORS) as err:
            decode_image(data)
        assert not isinstance(err.value, UnsupportedImageError), err.value
        return "skipped"
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    if undefined is not None and undefined.shape == want.shape[:2]:
        got, want = got[~undefined], want[~undefined]
    np.testing.assert_array_equal(got, want)
    return "read"


def reads_as_pillow(data: bytes) -> None:
    want = pillow(data)
    assert want is not None, "Pillow does not read this file"
    np.testing.assert_array_equal(decode_image(data), want)


# --------------------------------------------------------------------- #
# Pillow's libtiff, to find the strip-buffer bytes it leaves unwritten
# --------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _bundled_libtiff():
    libs = glob.glob(os.path.join(os.path.dirname(Image.__file__), os.pardir, "pillow.libs",
                                  "libtiff*.so*"))
    if not libs:
        return None
    lib = ctypes.CDLL(libs[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                         ctypes.c_ssize_t]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    lib.TIFFReadEncodedTile.argtypes = lib.TIFFReadEncodedStrip.argtypes
    lib.TIFFReadEncodedTile.restype = ctypes.c_ssize_t
    for fn in ("TIFFStripSize", "TIFFScanlineSize", "TIFFTileSize", "TIFFTileRowSize",
               "TIFFIsTiled"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_ssize_t
    lib.TIFFGetField.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
    lib.TIFFSetField.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFSetWarningHandler.argtypes = [ctypes.c_void_p]
    lib.TIFFSetErrorHandler.argtypes = [ctypes.c_void_p]
    lib.TIFFSetWarningHandler.restype = lib.TIFFSetErrorHandler.restype = ctypes.c_void_p
    return lib


def unwritten_pixels(data: bytes):
    """The pixels of a chunky TIFF that libtiff leaves unwritten in
    Pillow's strip or tile buffer, which Pillow reuses from strip to strip
    and tile to tile (TiffDecode.c): each strip or tile read as Pillow
    reads it (YCbCr JPEG as RGB) into two persistent buffers, one filled
    with 0x00 and one with 0xFF -> [h, w] bool, or None where the file is
    no such TIFF, its buffer is larger than 64 MiB, or the bundled libtiff
    is not found."""
    lib = _bundled_libtiff()
    if lib is None:
        return None
    fd, path = tempfile.mkstemp(suffix=".tif")
    os.write(fd, data)
    os.close(fd)
    quiet = (lib.TIFFSetWarningHandler(None), lib.TIFFSetErrorHandler(None))
    try:
        t = lib.TIFFOpen(path.encode(), b"rC")
        if not t:
            return None
        try:
            width, height = ctypes.c_uint32(), ctypes.c_uint32()
            photo, comp, rps = ctypes.c_uint16(), ctypes.c_uint16(), ctypes.c_uint32()
            lib.TIFFGetField(t, 256, ctypes.byref(width))
            lib.TIFFGetField(t, 257, ctypes.byref(height))
            lib.TIFFGetField(t, 262, ctypes.byref(photo))
            lib.TIFFGetField(t, 259, ctypes.byref(comp))
            if photo.value == 6 and comp.value == 7:
                lib.TIFFSetField(t, 65538, 1)  # JPEGCOLORMODE_RGB, as Pillow sets it
            w, h = width.value, height.value
            if lib.TIFFIsTiled(t):
                tw, th = ctypes.c_uint32(), ctypes.c_uint32()
                lib.TIFFGetField(t, 322, ctypes.byref(tw))
                lib.TIFFGetField(t, 323, ctypes.byref(th))
                tw, th = tw.value, th.value
                size, row = lib.TIFFTileSize(t), lib.TIFFTileRowSize(t)
                read, seg_w = lib.TIFFReadEncodedTile, tw
                order = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
                index = [(y // th) * -(-w // tw) + x // tw for y, x in order]
            else:
                if not lib.TIFFGetField(t, 278, ctypes.byref(rps)) or rps.value >= h:
                    rps.value = h
                th = rps.value
                size, row = lib.TIFFStripSize(t), lib.TIFFScanlineSize(t)
                read, seg_w = lib.TIFFReadEncodedStrip, w
                order = [(y, 0) for y in range(0, h, th)]
                index = [y // th for y, _ in order]
            if not size or not row or not w or size > 1 << 26:
                return None
            bufs = [(ctypes.c_uint8 * size)() for _ in range(2)]
            ctypes.memset(bufs[1], 255, size)
            bits = 8 * row // seg_w if row * 8 >= seg_w else 1
            x = np.arange(seg_w)
            lo, hi = x * bits // 8, ((x + 1) * bits + 7) // 8
            undefined = np.zeros((h, w), bool)
            for (y, x0), i in zip(order, index):
                for buf in bufs:
                    read(t, i, buf, size)
                a, b = (np.frombuffer(buf, np.uint8)[:size - size % row].reshape(-1, row)
                        for buf in bufs)
                n, m = min(th, h - y, len(a)), min(seg_w, w - x0)
                cum = np.concatenate([np.zeros((n, 1), int), np.cumsum((a != b)[:n], 1)], 1)
                cut = (cum[:, np.minimum(hi, row)] - cum[:, np.minimum(lo, row)]) > 0
                undefined[y:y + n, x0:x0 + m] = cut[:, :m]
            return undefined
        finally:
            lib.TIFFClose(t)
    finally:
        lib.TIFFSetWarningHandler(quiet[0])
        lib.TIFFSetErrorHandler(quiet[1])
        os.unlink(path)


# --------------------------------------------------------------------- #
# hand-built layouts
# --------------------------------------------------------------------- #

_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
ENCODERS = {1: lambda b: b, 5: _lzw_tiff, 8: zlib.compress, 32946: zlib.compress,
            32773: _packbits_tiff,
            34925: lambda b: lzma.compress(b, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)}


def _row_bytes(vals: np.ndarray, bits: int) -> np.ndarray:
    """Samples [r, n] -> their rows' bytes [r, m]: below 8 bits MSB first,
    12 bits packed MSB first, 8 bits and more as the array holds them."""
    r = vals.shape[0]
    if bits in (1, 2, 4):
        per = 8 // bits
        v = np.pad(vals.astype(np.uint16), ((0, 0), (0, (-vals.shape[1]) % per))).reshape(r, -1, per)
        return (v << np.arange(8 - bits, -1, -bits)).sum(-1).astype(np.uint8)
    if bits == 12:
        v = np.pad(vals.astype(np.uint32), ((0, 0), (0, vals.shape[1] % 2))).reshape(r, -1, 2)
        x = (v[..., 0] << 12) | v[..., 1]
        return np.stack([x >> 16, (x >> 8) & 255, x & 255], -1).astype(np.uint8).reshape(r, -1)
    return np.ascontiguousarray(vals).view(np.uint8).reshape(r, -1)


def _samples(bits: int, fmt: int, shape, rng) -> np.ndarray:
    h, n = shape
    if fmt == 3:
        v = rng.uniform(-20, 300, shape).astype(np.float32)
        v[0, :3] = (np.nan, np.inf, 254.6)
        return v
    if bits >= 16:
        dt = {(16, 1): np.uint16, (16, 2): np.int16, (32, 1): np.uint32, (32, 2): np.int32}
        v = rng.randint(-60 if fmt == 2 else 0, 600, shape).astype(dt[bits, fmt])
        if (bits, fmt) == (32, 1):
            v[0, 0] = 0xFFFFFFF0
        return v
    return rng.randint(0, 1 << bits, shape).astype(np.uint16 if bits == 12 else np.uint8)


def layout(photo, bits, fmt=1, spp=1, extra=(), comp=1, bo="<", pred=1, planar=1, rps=None,
           tile=None, fill=1, big=False, h=13, w=11, seed=0) -> bytes:
    """A TIFF of random samples in the given layout: strips of ``rps``
    rows or ``tile`` (w, h) tiles, predictor ``pred`` applied as libtiff's
    encoder applies it (2: each sample less its left neighbour in the
    machine's order; 3: the row's bytes as planes, most significant first,
    then differenced), FillOrder ``fill`` (2 reverses the bits of the
    stored bytes)."""
    rng = np.random.RandomState(seed)
    vals = _samples(bits, fmt, (h, w * spp), rng)
    planes = [vals[:, i::spp] for i in range(spp)] if planar == 2 else [vals]
    per = 1 if planar == 2 else spp
    tw, th = tile if tile else (w, rps or h)
    segs = []
    for p in planes:
        for r0 in range(0, h, th):
            for c0 in range(0, w, tw):
                blk = p[r0:r0 + th, c0 * per:(c0 + tw) * per]
                if tile:
                    blk = np.pad(blk, ((0, th - blk.shape[0]), (0, tw * per - blk.shape[1])))
                if pred == 2:
                    d = blk.copy()
                    d[:, per:] = blk[:, per:] - blk[:, :-per]
                    blk = d
                if pred == 3:
                    b = np.ascontiguousarray(blk).view(np.uint8).reshape(len(blk), -1, 4)
                    planes_ = b[:, :, ::-1].transpose(0, 2, 1).reshape(len(blk), -1)
                    d = planes_.astype(np.int16)
                    d[:, per:] = planes_[:, per:].astype(np.int16) - planes_[:, :-per]
                    raw_rows = (d & 255).astype(np.uint8)
                else:
                    if bo == ">" and blk.dtype.itemsize > 1:
                        blk = blk.astype(blk.dtype.newbyteorder(">"))
                    raw_rows = _row_bytes(blk, bits)
                data = ENCODERS[comp](np.ascontiguousarray(raw_rows).tobytes())
                if fill == 2:
                    data = _REV[np.frombuffer(data, np.uint8)].tobytes()
                segs.append(data)
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [comp]),
              262: (3, [photo]), 277: (3, [spp]), 284: (3, [planar])}
    if fmt != 1:
        fields[339] = (3, [fmt] * spp)
    if extra:
        fields[338] = (3, list(extra))
    if pred != 1:
        fields[317] = (3, [pred])
    if fill != 1:
        fields[266] = (3, [fill])
    if tile:
        fields[322], fields[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        fields[278] = (3, [th])
    return cs._tiff_file(fields, segs, bo=bo, big=big, tiled=bool(tile))


LAYOUTS = {}
for _bo in "<>":
    _e = "le" if _bo == "<" else "be"
    for _comp in (1, 5, 8, 32773, 34925):
        for _key in [(0, 2, 1, 1, ()), (1, 2, 1, 1, ()), (0, 4, 1, 1, ()), (1, 4, 1, 1, ()),
                     (1, 12, 1, 1, ()), (0, 16, 1, 1, ()), (1, 16, 1, 1, ()), (1, 16, 2, 1, ()),
                     (1, 32, 1, 1, ()), (1, 32, 2, 1, ()), (0, 32, 3, 1, ()), (1, 32, 3, 1, ()),
                     (2, 16, 1, 3, ()), (2, 16, 1, 4, ()), (2, 16, 1, 4, (0,)),
                     (2, 16, 1, 4, (1,)), (2, 16, 1, 4, (2,)), (5, 16, 1, 4, ())]:
            _p, _b, _f, _s, _x = _key
            if _bo == ">" and (_b, _f) in ((12, 1), (32, 1)) or (_bo, _p, _b) == (">", 0, 16):
                continue  # OPEN_INFO has these for little-endian files only
            LAYOUTS[f"{_e}-c{_comp}-photo{_p}-{_b}bit-fmt{_f}-spp{_s}-extra{''.join(map(str, _x))}"] = (
                dict(photo=_p, bits=_b, fmt=_f, spp=_s, extra=_x, comp=_comp, bo=_bo))
    for _comp in (5, 8, 34925):
        for _b, _f, _s, _p in [(8, 1, 3, 2), (16, 1, 1, 1), (16, 1, 3, 2), (16, 2, 1, 1),
                               (32, 2, 1, 1)][_comp != 34925:]:  # 8 bits: tests/test_torch_image_io.py
            LAYOUTS[f"{_e}-c{_comp}-predictor2-{_b}bit-fmt{_f}-spp{_s}"] = dict(
                photo=_p, bits=_b, fmt=_f, spp=_s, comp=_comp, bo=_bo, pred=2)
        LAYOUTS[f"{_e}-c{_comp}-predictor3-float"] = dict(photo=1, bits=32, fmt=3, comp=_comp,
                                                          bo=_bo, pred=3)
    for _comp in (1, 5):
        for _b, _p in [(1, 0), (1, 1), (2, 1), (4, 0), (8, 1), (8, 2), (16, 1)][:7 if _bo == "<" else 6]:
            LAYOUTS[f"{_e}-c{_comp}-fillorder2-{_b}bit-photo{_p}"] = dict(
                photo=_p, bits=_b, spp=3 if _p == 2 else 1, comp=_comp, bo=_bo, fill=2)
for _comp in (1, 5):
    for _big in (False, True):
        _t = f"c{_comp}-{'bigtiff' if _big else 'classic'}"
        LAYOUTS[f"{_t}-16bit-rgb-tiles"] = dict(photo=2, bits=16, spp=3, comp=_comp,
                                                tile=(16, 16), big=_big, h=37, w=21)
        LAYOUTS[f"{_t}-16bit-rgb-planar"] = dict(photo=2, bits=16, spp=3, comp=_comp, planar=2,
                                                 big=_big)
        if _big:
            LAYOUTS[f"{_t}-rgba-planar-strips"] = dict(photo=2, bits=8, spp=4, extra=(2,),
                                                       comp=_comp, planar=2, big=_big, rps=5)
        if _comp != 1:  # Pillow's own decoder has no unpacker for a 16-bit band
            LAYOUTS[f"{_t}-16bit-gray-planar"] = dict(photo=1, bits=16, comp=_comp, planar=2,
                                                      big=_big)
        LAYOUTS[f"{_t}-4bit-gray-planar"] = dict(photo=1, bits=4, comp=_comp, planar=2,
                                                 big=_big)
        LAYOUTS[f"{_t}-float-planar"] = dict(photo=1, bits=32, fmt=3, comp=_comp, planar=2,
                                             big=_big)
        LAYOUTS[f"{_t}-float-tiles"] = dict(photo=1, bits=32, fmt=3, comp=_comp,
                                            tile=(16, 32), big=_big, h=40, w=19)
        LAYOUTS[f"{_t}-4bit-strips"] = dict(photo=0, bits=4, comp=_comp, rps=3, big=_big)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_reads_as_pillow(name):
    """Each layout of Pillow's OPEN_INFO beyond 8 bits and bilevel (2, 4,
    12, 16 and 32 bits, signed and floating point, FillOrder 2), each
    predictor, LZMA and BigTIFF, uncompressed (Pillow's own unpackers) and compressed
    (libtiff's samples in the machine's order under Pillow's raw mode),
    both byte orders: byte-equal to Pillow."""
    reads_as_pillow(layout(**LAYOUTS[name]))


def _saved(img, mode=None, **kw) -> bytes:
    im = Image.fromarray(img) if mode is None else Image.fromarray(img).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _bilevel(h: int = 96, w: int = 128):
    return Image.fromarray(picture(h, w)).convert("L").point(lambda v: 255 if v > 128 else 0)


PILLOW_WRITTEN = {
    "group3": lambda: _saved(np.asarray(_bilevel()), "1", compression="group3"),
    "group4": lambda: _saved(np.asarray(_bilevel()), "1", compression="group4"),
    "ccitt-rle": lambda: _saved(np.asarray(_bilevel()), "1", compression="tiff_ccitt"),
    "group4-strips": lambda: _saved(np.asarray(_bilevel(200, 300)), "1",
                                    compression="group4", strip_size=512),
    "jpeg-rgb": lambda: _saved(picture(), compression="jpeg"),
    "jpeg-rgb-quality-30": lambda: _saved(picture(), compression="jpeg", quality=30),
    "jpeg-ycbcr": lambda: _saved(picture(), "YCbCr", compression="jpeg"),
    "jpeg-gray": lambda: _saved(picture(), "L", compression="jpeg"),
    "jpeg-strips": lambda: _saved(picture(150, 100), compression="jpeg", strip_size=8192),
    "lzma-rgb": lambda: _saved(picture(), compression="lzma"),
    "raw-bigtiff": lambda: _saved(picture(), big_tiff=True),
    "16bit-gray-big-endian-deflate": lambda: _saved(
        picture()[..., 0].astype(np.uint16) * 3, None, compression="tiff_adobe_deflate",
        tiffinfo={}),
    "16bit-gray-deflate": lambda: _saved((picture()[..., 0].astype(np.uint16) * 3), None,
                                         compression="tiff_deflate"),
    "16bit-gray-raw": lambda: _saved((picture()[..., 0].astype(np.uint16) * 2)),
    "32bit-int-lzw": lambda: _saved(picture()[..., 0].astype(np.int32) * 2 - 100, "I",
                                    compression="tiff_lzw"),
    "float-lzma": lambda: _saved(picture()[..., 0].astype(np.float32) * 1.7 - 30, "F",
                                 compression="lzma"),
    "float-raw": lambda: _saved(picture()[..., 0].astype(np.float32) / 3 + 0.5, "F"),
}


@pytest.mark.parametrize("name", list(PILLOW_WRITTEN))
def test_pillow_written_reads_as_pillow(name):
    """Files Pillow itself writes through libtiff: CCITT RLE, Group 3 and 4,
    JPEG from RGB (photometric 2), YCbCr (6) and L, LZMA, 16- and 32-bit
    grayscale and floating point; and a BigTIFF of its own writer (its
    libtiff path writes classic TIFF)."""
    reads_as_pillow(PILLOW_WRITTEN[name]())


# --------------------------------------------------------------------- #
# CCITT
# --------------------------------------------------------------------- #

def _fax_picture(h: int, w: int, seed: int) -> np.ndarray:
    """Noise, all-black and all-white rows, stripes of every run length
    below 64, and runs long enough for every makeup code."""
    rng = np.random.RandomState(seed)
    bits = (rng.rand(h, w) < 0.3).astype(np.uint8)
    bits[1] = 0
    bits[2] = 1
    runs = np.repeat(np.arange(64) % 2, np.arange(1, 65))[:w]
    bits[3, :len(runs)] = runs
    bits[4, :len(runs)] = 1 - runs
    bits[5:9] = bits[4]
    bits[5, 3:] = 1
    if w > 2600:
        bits[10, 5:2570] = 1
        bits[11, 70:] = 0
        bits[11, 1000:2700] = 1
    return bits


def _fax_file(comp: int, options: int = 0, photo: int = 0, fill: int = 1, bo: str = "<",
              h: int = 23, w: int = 77, rps=None, tile=None, seed: int = 0) -> bytes:
    bits = _fax_picture(h, w, seed)
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [1]), 259: (3, [comp]),
              262: (3, [photo]), 277: (3, [1])}
    if comp == 3:
        fields[292] = (4, [options])
    if fill == 2:
        fields[266] = (3, [2])
    if tile:
        tw, th = tile
        pad = np.pad(bits, ((0, -h % th), (0, -w % tw)))
        segs = [cs._fax_rows(pad[y:y + th, x:x + tw], comp, options)
                for y in range(0, h, th) for x in range(0, w, tw)]
        fields[322], fields[323] = (3, [tw]), (3, [th])
    else:
        rps = rps or h
        segs = [cs._fax_rows(bits[y:y + rps], comp, options) for y in range(0, h, rps)]
        fields[278] = (3, [rps])
    if fill == 2:
        segs = [_REV[np.frombuffer(s, np.uint8)].tobytes() for s in segs]
    return cs._tiff_file(fields, segs, bo=bo, tiled=bool(tile))


FAX = {}
for _comp, _opts in ((2, (0,)), (32771, (0,)), (3, (0, 1, 4, 5)), (4, (0,))):
    for _o in _opts:
        _n = {2: "rle", 32771: "rlew", 3: f"group3-options{_o}", 4: "group4"}[_comp]
        for _photo in (0, 1):
            FAX[f"{_n}-photo{_photo}"] = dict(comp=_comp, options=_o, photo=_photo)
        FAX[f"{_n}-fillorder2"] = dict(comp=_comp, options=_o, fill=2)
        FAX[f"{_n}-big-endian-strips"] = dict(comp=_comp, options=_o, bo=">",
                                              rps=1 if _comp == 32771 else 5)
        FAX[f"{_n}-wide-rows"] = dict(comp=_comp, options=_o, h=13, w=2750)
        FAX[f"{_n}-tiles"] = dict(comp=_comp, options=_o, tile=(32, 16), h=37, w=70)
# RLEW strips of several rows, each row padded to a 16-bit word of the strip:
# libtiff word-aligns its byte pointer after the bits it has fetched ahead,
# reads the second row astray, runs out of data and returns -1; Pillow fails
FAX["rlew-strips-of-8-rows"] = dict(comp=32771, rps=8, outcome="skipped")


@pytest.mark.parametrize("name", list(FAX))
def test_ccitt_reads_as_pillow(name):
    """CCITT RLE and RLEW, Group 3 1-D and 2-D (with and without EOL fill
    bits) and Group 4, photometric 0 and 1, FillOrder 2, big-endian, several
    strips, tiles, and rows wide enough for the extended makeup codes."""
    kw = dict(FAX[name])
    outcome = kw.pop("outcome", "read")
    assert ends_as_in_pillow(_fax_file(**kw)) == outcome


def _fax_strips(comp: int, damage: dict, options: int = 0, h: int = 20, rps: int = 10,
                tile=None) -> bytes:
    """A 40-pixel-wide CCITT file of ``h`` rows in strips of ``rps`` rows
    (or ``tile`` tiles), strip or tile i's data replaced by
    ``damage[i](data)``."""
    bits = _fax_picture(20, 40, 0)[:h]
    if tile:
        tw, th = tile
        pad = np.pad(bits, ((0, -h % th), (0, -40 % tw)))
        segs = [cs._fax_rows(pad[y:y + th, x:x + tw], comp, options)
                for y in range(0, h, th) for x in range(0, 40, tw)]
    else:
        segs = [cs._fax_rows(bits[y:y + rps], comp, options) for y in range(0, h, rps)]
    segs = [damage[i](s) if i in damage else s for i, s in enumerate(segs)]
    fields = {256: (4, [40]), 257: (4, [h]), 258: (3, [1]), 259: (3, [comp]), 262: (3, [0]),
              277: (3, [1])}
    if comp == 3:
        fields[292] = (4, [options])
    if tile:
        fields[322], fields[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        fields[278] = (3, [rps])
    return cs._tiff_file(fields, segs, tiled=bool(tile))


_EOFB = bytes([0x00, 0x10, 0x01])  # two EOLs, most significant bit first
G4_FIRST_ROW = {
    # name: (file, Pillow's outcome)
    "zero-bytes-the-only-strip": (lambda: _fax_strips(4, {0: lambda s: bytes(len(s))}, rps=20),
                                  "skipped"),
    "zero-bytes-a-later-strip": (lambda: _fax_strips(4, {1: lambda s: bytes(len(s))}), "skipped"),
    "one-zero-byte-a-later-strip": (lambda: _fax_strips(4, {1: lambda s: b"\0"}), "skipped"),
    "eofb-first-the-only-strip": (lambda: _fax_strips(4, {0: lambda s: _EOFB}, rps=20), "skipped"),
    "eofb-first-a-later-strip": (lambda: _fax_strips(4, {1: lambda s: _EOFB}), "skipped"),
    "cut-in-row-0-the-only-strip": (lambda: _fax_strips(4, {0: lambda s: s[:1]}, rps=20), "read"),
    "cut-in-row-0-a-later-strip": (lambda: _fax_strips(4, {1: lambda s: s[:1]}), "read"),
    "cut-in-row-0-a-later-strip-at-its-end": (lambda: _fax_strips(4, {1: lambda s: s[:4]}),
                                              "skipped"),
    "eofb-first-a-tile": (lambda: _fax_strips(4, {1: lambda s: _EOFB}, tile=(16, 16)), "read"),
    "zero-bytes-a-tile": (lambda: _fax_strips(4, {2: lambda s: bytes(len(s))}, tile=(16, 16)),
                          "read"),
}


def _g3_then(tail: bytes, options: int) -> bytes:
    """Three 40-pixel rows of Group 3: the first row coded, then ``tail``."""
    first = cs._fax_rows(_fax_picture(20, 40, 0)[:1], 3, options)
    return _fax_strips(3, {0: lambda s: first + tail}, options, h=3, rps=3)


G3_WITHOUT_EOL = {
    # name: (file, Pillow's outcome)
    "1d-ones-then-zeros": (lambda: _g3_then(b"\xff\0\0\0", 0), "read"),
    "2d-ones-then-zeros": (lambda: _g3_then(b"\xff\0\0\0", 1), "read"),
    # three zero bytes: every row white, and the next strip read without EOLs
    "1d-zeros-then-a-strip": (lambda: _fax_cut(3, 0, 0, "zeros", 3), "read"),
    "2d-tiles-narrower-than-their-data": (
        lambda: _retag(_retag(_fax_file(3, options=1, tile=(32, 16), h=37, w=70), 322,
                              value=16), 323, value=65520), "read"),
}


@pytest.mark.parametrize("name", list(G3_WITHOUT_EOL))
def test_group3_data_without_eol(name):
    """libtiff 4.7's SYNC_EOL: where the data end among the zeros after an
    EOL's first 11 (no EOL after all), it warns "Try to decode ... without
    EOL", restarts from the strip's first byte for the row in hand, and
    syncs no later row of the image."""
    make, outcome = G3_WITHOUT_EOL[name]
    data = make()
    assert ends_as_in_pillow(data, unwritten_pixels(data)) == outcome


def _fax_cut(comp: int, options: int, strip: int, kind: str, n: int) -> bytes:
    """A 40 x 20 CCITT file in two strips, strip ``strip`` cut to its first
    ``n`` bytes (``kind`` "cut") or replaced by ``n`` zero bytes."""
    return _fax_strips(comp, {strip: lambda s: s[:n] if kind == "cut" else bytes(n)}, options)


FAX_CODECS = {"rle": (2, 0), "rlew": (32771, 0), "group3-1d": (3, 0), "group3-2d": (3, 1),
              "group3-1d-eol-fill": (3, 4), "group3-2d-eol-fill": (3, 5), "group4": (4, 0)}


@pytest.mark.parametrize("codec", list(FAX_CODECS))
def test_fax_strips_cut_or_zeroed(codec):
    """Each strip of a two-strip file cut to 0-13 bytes or replaced by 1-13
    zero bytes (54 files a codec) ends as in Pillow: libtiff's -1 where the
    data end (RLE, Group 3; Group 4 in a strip's first row), Group 3's
    decoding without EOL, Group 4's rows kept after the first."""
    comp, options = FAX_CODECS[codec]
    for strip in (0, 1):
        for n in range(14):
            for kind in ("cut", "zeros") if n else ("cut",):
                data = _fax_cut(comp, options, strip, kind, n)
                ends_as_in_pillow(data, unwritten_pixels(data))


@pytest.mark.parametrize("name", list(G4_FIRST_ROW))
def test_group4_data_ending_in_the_first_row(name):
    """libtiff's Fax4Decode returns -1 where the data (or an EOFB) end in a
    strip's or tile's first row, and 1 after it; Pillow fails on a strip
    that returns -1 (TIFFReadEncodedStrip tests ``<= 0``) and keeps a tile
    that does (TIFFReadEncodedTile tests for zero), with the rows libtiff
    wrote and the rest of its buffer as it was."""
    make, outcome = G4_FIRST_ROW[name]
    data = make()
    assert ends_as_in_pillow(data, unwritten_pixels(data)) == outcome


# --------------------------------------------------------------------- #
# JPEG (compression 7)
# --------------------------------------------------------------------- #

def _jpeg_tiff(img, photo: int = 6, sampling=(2, 2), rps=None, tile=None, tables: bool = True,
               subsampling_tag: bool = True, planar: int = 1) -> bytes:
    """A JPEG-compressed TIFF of ``img`` written by the script's baseline
    encoder: YCbCr (``photo`` 6) at ``sampling``, or the samples as they
    are (2: RGB, 1: gray); abbreviated strips or tiles after a JPEGTables
    stream (``tables``), else every stream with its own tables; planar 2,
    one gray stream a sample and strip."""
    h, w = img.shape[:2]

    def enc(part):
        if photo == 1 or part.ndim == 2:
            return cs._jpeg_file(part if part.ndim == 2 else part[..., 0], sampling=(1, 1),
                                 ycc=False, abbreviated=tables)
        return cs._jpeg_file(part, sampling=sampling, ycc=photo == 6, abbreviated=tables)

    spp = 1 if photo == 1 else 3
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]),
              262: (3, [photo]), 277: (3, [spp]), 284: (3, [planar])}
    if tables:
        fields[347] = (7, cs._jpeg_tables())
    if photo == 6 and subsampling_tag:
        fields[530] = (3, list(sampling))
    if tile:
        tw, th = tile
        pad = np.pad(img, ((0, -h % th), (0, -w % tw), (0, 0)), mode="edge")
        segs = [enc(pad[y:y + th, x:x + tw]) for y in range(0, h, th) for x in range(0, w, tw)]
        fields[322], fields[323] = (3, [tw]), (3, [th])
    else:
        rps = rps or h
        planes = [img[..., c] for c in range(3)] if planar == 2 else [img]
        segs = [enc(p[y:y + rps]) for p in planes for y in range(0, h, rps)]
        fields[278] = (3, [rps])
    return cs._tiff_file(fields, segs, tiled=bool(tile))


JPEG = {
    "ycbcr-2x2": dict(),
    "ycbcr-2x1": dict(sampling=(2, 1)),
    "ycbcr-1x1": dict(sampling=(1, 1)),
    "ycbcr-2x2-strips-last-short": dict(rps=40),
    "ycbcr-2x1-strips": dict(sampling=(2, 1), rps=24),
    "ycbcr-2x2-tiles-past-the-edges": dict(tile=(48, 32)),
    "ycbcr-1x1-tiles": dict(sampling=(1, 1), tile=(32, 32)),
    "ycbcr-no-subsampling-tag": dict(sampling=(1, 1), subsampling_tag=False),
    "ycbcr-own-tables": dict(tables=False),
    "rgb": dict(photo=2, sampling=(1, 1)),
    "rgb-tiles": dict(photo=2, sampling=(1, 1), tile=(32, 48)),
    "rgb-planar": dict(photo=2, sampling=(1, 1), planar=2),
    "gray": dict(photo=1, sampling=(1, 1)),
    "gray-strips": dict(photo=1, sampling=(1, 1), rps=16),
}


@pytest.mark.parametrize("name", list(JPEG))
def test_jpeg_in_tiff_reads_as_pillow(name):
    """New-style JPEG: abbreviated strips and tiles after JPEGTables (or
    with their own tables), YCbCr at 1 x 1, 2 x 1 and 2 x 2 converted to RGB
    by libjpeg as Pillow asks libtiff to (fancy upsampling), RGB and gray
    with no conversion, tiles past the image's edges, a short last strip,
    planar configuration 2, and the subsampling libtiff takes from the
    first strip where the tag is missing."""
    reads_as_pillow(_jpeg_tiff(picture(90, 100, 3), **JPEG[name]))


# --------------------------------------------------------------------- #
# libtiff's directory rules, one hand-built file each
# --------------------------------------------------------------------- #

def _entries(data: bytes):
    at = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, at)[0]
    return at, [at + 2 + 12 * i for i in range(n)]


def _retag(data: bytes, tag: int, new_tag=None, typ=None, count=None, value=None) -> bytes:
    """``data`` with the directory entry of ``tag`` changed."""
    out = bytearray(data)
    for e in _entries(data)[1]:
        if struct.unpack_from("<H", out, e)[0] == tag:
            if new_tag is not None:
                struct.pack_into("<H", out, e, new_tag)
            if typ is not None:
                struct.pack_into("<H", out, e + 2, typ)
            if count is not None:
                struct.pack_into("<I", out, e + 4, count)
            if value is not None:
                struct.pack_into("<I", out, e + 8, value)
            return bytes(out)
    raise AssertionError(f"no tag {tag}")


def _gray_cut_for_pillow() -> bytes:
    """A Deflate gray file with an ImageDescription whose count runs past
    the end: Pillow's directory ends there, so it opens the image with its
    defaults (one sample, no strip tags) while libtiff reads every tag."""
    img = picture(30, 40, 6)[..., 1]
    data = cs._tiff_file({256: (4, [40]), 257: (4, [30]), 258: (3, [8]), 259: (3, [8]),
                          262: (3, [1]), 270: (2, list(b"a picture\0")), 277: (3, [1])},
                         [zlib.compress(img.tobytes())])
    return _retag(data, 270, count=1 << 20)


def _rgb_deflate(rps=None) -> bytes:
    img = picture(40, 50, 5)
    rps = rps or 40
    segs = [zlib.compress(img[y:y + rps].tobytes()) for y in range(0, 40, rps)]
    return cs._tiff_file({256: (4, [50]), 257: (4, [40]), 258: (3, [8, 8, 8]), 259: (3, [8]),
                          262: (3, [2]), 277: (3, [3]), 278: (3, [rps])}, segs)


DIRECTORY = {
    # name: (file, Pillow's outcome)
    "planar-configuration-3": (lambda: _add_tag(_rgb_deflate(), 284, 3, 3), "skipped"),
    "rows-per-strip-of-count-2": (lambda: _retag(_rgb_deflate(), 278, count=2), "skipped"),
    "planar-configuration-of-count-2": (lambda: _retag(_add_tag(_rgb_deflate(), 284, 3, 1),
                                                       284, count=2), "skipped"),
    "strip-byte-counts-missing": (lambda: _retag(_rgb_deflate(), 279, new_tag=65000), "read"),
    "strip-byte-counts-zero": (lambda: _retag(_rgb_deflate(), 279, value=0), "read"),
    "strip-byte-counts-missing-two-strips": (
        lambda: _retag(_rgb_deflate(20), 279, new_tag=65000), "skipped"),
    "photometric-past-the-end-cuts-pillows-directory": (
        lambda: _retag(_rgb_deflate(), 262, count=1 << 24), "skipped"),
    "a-value-past-the-end-leaves-pillow-its-defaults": (_gray_cut_for_pillow, "read"),
    "samples-per-pixel-unknown-to-pillow-and-libtiff": (
        lambda: _retag(_retag(_rgb_deflate(), 262, typ=210), 277, new_tag=8725), "read"),
    "extra-samples-above-2": (lambda: _add_tag(_rgb_deflate(), 338, 3, 5), "skipped"),
    "width-of-type-rational": (lambda: _retag(_rgb_deflate(), 256, typ=5), "skipped"),
    "compression-byte-typed": (lambda: _retag(_rgb_deflate(), 259, typ=1), "skipped"),
}


def _add_tag(data: bytes, tag: int, typ: int, value: int) -> bytes:
    """``data`` with one more SHORT or LONG entry, the directory rewritten
    at the end of the file."""
    at, entries = _entries(data)
    items = [data[e:e + 12] for e in entries]
    items.append(struct.pack("<HHI", tag, typ, 1) + struct.pack("<H" if typ == 3 else "<I",
                                                                value).ljust(4, b"\0"))
    items.sort(key=lambda b: struct.unpack_from("<H", b)[0])
    new_at = len(data) + (len(data) & 1)
    ifd = struct.pack("<H", len(items)) + b"".join(items) + bytes(4)
    out = bytearray(data + bytes(new_at - len(data)) + ifd)
    struct.pack_into("<I", out, 4, new_at)
    return bytes(out)


@pytest.mark.parametrize("name", list(DIRECTORY))
def test_directory_rule(name):
    """libtiff's TIFFReadDirectory and Pillow's ImageFileDirectory_v2 on
    damaged directories: a PlanarConfiguration other than 1 or 2, a tag of
    the wrong count for its type, StripByteCounts lost (estimated from the
    file's size for one strip, refused for two) or zero, Pillow's directory
    cut short by a value past the end (Pillow's defaults after it), a tag
    neither reads, ExtraSamples libtiff refuses, and tag types Pillow's
    _setup cannot use."""
    make, outcome = DIRECTORY[name]
    assert ends_as_in_pillow(make()) == outcome


def _g4_tiles() -> bytes:
    return _fax_file(4, tile=(32, 16), h=37, w=70)


def _jpeg_tiles() -> bytes:
    return _jpeg_tiff(picture(40, 50, 3), tile=(32, 32))


def _sized(make, tags: dict, typ: int = 3):
    """``make()``'s file with each tag of ``tags`` given its value, as a
    SHORT (3) or LONG (4)."""
    def build():
        data = make()
        for tag, value in tags.items():
            data = _retag(data, tag, typ=typ, value=value)
        return data
    return build


BUFFER = {
    # name: (file, Pillow's outcome)
    "group4-tiles-65520-square-short": (_sized(_g4_tiles, {322: 65520, 323: 65520}), "read"),
    "group4-tiles-65535-square-short": (_sized(_g4_tiles, {322: 65535, 323: 65535}), "read"),
    "group4-tiles-65520-wide-short": (_sized(_g4_tiles, {322: 65520, 323: 16}), "read"),
    "group4-tiles-2-20-square-long": (_sized(_g4_tiles, {322: 1 << 20, 323: 1 << 20}, 4),
                                      "skipped"),
    "group4-tiles-2-20-wide-long": (_sized(_g4_tiles, {322: (1 << 20) + 16, 323: 16}, 4),
                                    "read"),
    "group4-tiles-past-2-31-wide-long": (_sized(_g4_tiles, {322: 2 ** 31 + 16, 323: 1}, 4),
                                         "skipped"),
    "group4-tiles-36-wide-past-pillows-buffer": (_sized(_g4_tiles, {322: 36}), "skipped"),
    "group4-tiles-40-wide": (_sized(_g4_tiles, {322: 40}), "read"),
    "jpeg-tiles-65520-wide-short": (_sized(_jpeg_tiles, {322: 65520, 323: 16}), "skipped"),
    "jpeg-tiles-4096-square-short": (_sized(_jpeg_tiles, {322: 4096, 323: 4096}), "read"),
    "jpeg-tiles-2-20-square-long": (_sized(_jpeg_tiles, {322: 1 << 20, 323: 1 << 20}, 4),
                                    "skipped"),
    "jpeg-tiles-2-22-wide-long": (_sized(_jpeg_tiles, {322: 1 << 22, 323: 16}, 4),
                                  "skipped"),
    "deflate-strips-of-14316558-rows": (_sized(_rgb_deflate, {278: 14316558}, 4), "read"),
    "deflate-strips-of-2-31-rows": (_sized(_rgb_deflate, {278: 2 ** 31}, 4), "skipped"),
    "deflate-strips-of-2-32-less-2-rows": (_sized(_rgb_deflate, {278: 2 ** 32 - 2}, 4),
                                           "skipped"),
    "group4-strips-of-2-31-less-1-rows": (
        _sized(lambda: _fax_file(4, h=37, w=70), {278: 2 ** 31 - 1}, 4), "read"),
}


@pytest.mark.parametrize("name", list(BUFFER))
def test_strip_and_tile_buffer_rule(name):
    """Pillow's TiffDecode.c sizes a tile's buffer as TileWidth times the
    bytes of a TileLength-pixel column, and refuses, before it reads
    anything, a buffer past 2**31 - 1 bytes or smaller than libtiff's
    TIFFTileSize, and rows per strip past 2**31 - 1 (a strip's buffer holds
    at most the image's height); libtiff's CCITT codec refuses rows whose
    run arrays would pass 2**32 entries.  A small image with damaged tile
    or strip tags is read (or skipped) as Pillow reads it, and nothing is
    allocated from the tags first."""
    make, outcome = BUFFER[name]
    data = make()
    assert ends_as_in_pillow(data, unwritten_pixels(data)) == outcome


# --------------------------------------------------------------------- #
# the sweeps
# --------------------------------------------------------------------- #

def _damaged(base: bytes, seed: int, lo: int, hi: int) -> bytes:
    """``base`` with 1 to 3 bytes in [lo, hi) overwritten, from a seed."""
    rng = np.random.RandomState(5000 + seed)
    out = bytearray(base)
    for _ in range(rng.randint(1, 4)):
        out[rng.randint(lo, hi)] = rng.randint(256)
    return bytes(out)


def _directory_base() -> bytes:
    return _saved(picture(), compression="tiff_lzw")


def _g4_base() -> bytes:
    return _saved(np.asarray(_bilevel()), "1", compression="group4")


def _jpeg_base() -> bytes:
    return _saved(picture(), "YCbCr", compression="jpeg")


SWEEPS = {  # name -> (base writer, which bytes: "directory" or "data", files)
    "directory": (_directory_base, "directory", 200),
    "directory-group4-tiles": (_g4_tiles, "directory", 100),
    "directory-jpeg-tiles": (_jpeg_tiles, "directory", 100),
    "group4-data": (_g4_base, "data", 100),
    "group3-1d-data": (lambda: _fax_file(3, options=0, h=37, w=70, rps=8), "data", 100),
    "group3-2d-data": (lambda: _fax_file(3, options=1, h=37, w=70, rps=8), "data", 100),
    "jpeg-data": (_jpeg_base, "data", 100),
}
CHUNK = 20
SWEEP_CASES = [(k, s) for k, (_, _, n) in SWEEPS.items() for s in range(0, n, CHUNK)]
_BASES = {}


@pytest.mark.parametrize("sweep,start", SWEEP_CASES, ids=[f"{k}-{s}" for k, s in SWEEP_CASES])
def test_damaged_tiff_ends_as_in_pillow(sweep, start):
    """20 files of a sweep: Pillow's LZW RGB file and hand-built Group 4
    and YCbCr JPEG files in tiles with 1-3 bytes of their directory
    overwritten, and Pillow's Group 4 and YCbCr JPEG files and hand-built
    Group 3 1-D and 2-D strips with 1-3 bytes of their data overwritten,
    each read byte-equal to Pillow (but for the bytes libtiff leaves
    unwritten in a tiled or damaged-data file) or skipped where Pillow
    raises."""
    make, where, _ = SWEEPS[sweep]
    if sweep not in _BASES:
        _BASES[sweep] = make()
    base = _BASES[sweep]
    at = struct.unpack_from("<I", base, 4)[0]
    n = struct.unpack_from("<H", base, at)[0]
    lo, hi = (at, at + 2 + 12 * n + 4) if where == "directory" else (8, at)
    for seed in range(start, start + CHUNK):
        data = _damaged(base, seed, lo, hi)
        masked = sweep != "directory" and pillow(data) is not None
        ends_as_in_pillow(data, unwritten_pixels(data) if masked else None)


# --------------------------------------------------------------------- #
# sizes, the named formats and the skipped ones
# --------------------------------------------------------------------- #

def test_bigtiff_header_of_too_many_pixels_is_skipped_as_pillow_refuses_it():
    """A BigTIFF whose LZW image claims 60,000 x 60,000 pixels raises the
    decompression-bomb ValueError before anything is allocated, as
    ``Image.open`` refuses it."""
    data = bytearray(layout(2, 8, spp=3, comp=5, big=True))
    at = struct.unpack_from("<Q", data, 8)[0]
    for i in range(struct.unpack_from("<Q", data, at)[0]):
        e = at + 8 + 20 * i
        tag, typ = struct.unpack_from("<HH", data, e)
        if tag in (256, 257):
            struct.pack_into("<HHQQ", data, e, tag, 4, 1, 60_000)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(bytes(data)))
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_image(bytes(data))


def _ojpeg() -> bytes:
    img = picture(32, 48)
    jpg = cs._jpeg_file(img)
    return cs._tiff_file({256: (4, [48]), 257: (4, [32]), 258: (3, [8, 8, 8]), 259: (3, [6]),
                          262: (3, [6]), 277: (3, [3]), 278: (3, [32]), 530: (3, [2, 2])}, [jpg])


def _thunderscan() -> bytes:
    g = (picture(32, 48)[..., 0] >> 4).astype(np.uint8)
    data = b"".join(bytes(0xC0 | v for v in row) for row in g)  # every pixel a raw code
    return cs._tiff_file({256: (4, [48]), 257: (4, [32]), 258: (3, [4]), 259: (3, [32809]),
                          262: (3, [1]), 277: (3, [1])}, [data])


# the files of the rows the reader named, and the feature it names where it
# still does (None: read since the port decodes it)
NAMED = {
    "zstandard": (lambda: _saved(picture(), compression="zstd"), None),
    "old-style-jpeg": (_ojpeg, None),
    "thunderscan": (_thunderscan, None),
    "ycbcr-lzw": (lambda: layout(6, 8, spp=3, comp=5), None),
    "ycbcr-jpeg-planar": (lambda: _jpeg_tiff(picture(40, 48), sampling=(1, 1), planar=2,
                                             photo=6, subsampling_tag=True), None),
    "cielab": (lambda: layout(8, 8, spp=3), None),
    "cielab-lzw": (lambda: layout(8, 8, spp=3, comp=5), None),
}


@pytest.mark.parametrize("name", list(NAMED))
def test_still_named_formats_are_ones_pillow_reads(name):
    """The rows the reader named, each on a hand-built or Pillow-written
    file that Pillow reads: Zstandard, old-style JPEG, ThunderScan, YCbCr
    under LZW, YCbCr JPEG in planes and CIELab (raw and LZW) now read
    byte-equal to Pillow (a feature still named would raise
    UnsupportedImageError naming it)."""
    make, feature = NAMED[name]
    data = make()
    assert pillow(data) is not None
    if feature is None:
        reads_as_pillow(data)
        return
    with pytest.raises(UnsupportedImageError, match=feature):
        decode_image(data)


def _gray_with(**fields) -> bytes:
    f = {256: (4, [7]), 257: (4, [9]), 258: (3, [8]), 259: (3, [1]), 262: (3, [1]),
         277: (3, [1])}
    f.update({int(k[1:]): v for k, v in fields.items()})
    return cs._tiff_file(f, [bytes(range(63))])


SKIPPED = {
    "webp-compression": lambda: _gray_with(t259=(3, [50001])),
    "jpeg2000-compression": lambda: _gray_with(t259=(3, [34712])),
    "lerc-compression": lambda: _gray_with(t259=(3, [34887])),
    "sgilog-compression": lambda: _gray_with(t259=(3, [34676])),
    "sgilog24-compression": lambda: _gray_with(t259=(3, [34677])),
    "logl-photometric": lambda: _gray_with(t262=(3, [32844])),
    "logluv-photometric": lambda: _gray_with(t262=(3, [32845]), t258=(3, [8, 8, 8]),
                                             t277=(3, [3])),
    "transparency-mask": lambda: _gray_with(t262=(3, [4]), t258=(3, [1])),
    "icclab-photometric": lambda: _gray_with(t262=(3, [9]), t258=(3, [8, 8, 8]),
                                             t277=(3, [3])),
    "itulab-photometric": lambda: _gray_with(t262=(3, [10]), t258=(3, [8, 8, 8]),
                                             t277=(3, [3])),
    "64-bit-float": lambda: _gray_with(t258=(3, [64]), t339=(3, [3])),
    "big-endian-12-bit": lambda: layout(1, 12, bo=">"),
    "big-endian-unsigned-32-bit": lambda: layout(1, 32, bo=">"),
    "big-endian-16-bit-fillorder2": lambda: layout(1, 16, bo=">", fill=2),
    "uncompressed-16-bit-planar-gray": lambda: layout(1, 16, planar=2),
}


@pytest.mark.parametrize("name", list(SKIPPED))
def test_tiff_pillow_cannot_read_is_skipped(name):
    """TIFF compressions and photometrics Pillow cannot read (WebP without
    libtiff's codec, JPEG 2000 and LERC missing from Pillow's
    COMPRESSION_INFO, SGILog without LogL/LogLuv, which Pillow cannot open,
    masks and ICCLab/ITULab missing from OPEN_INFO) and layouts OPEN_INFO
    lacks: skipped, a plain ValueError."""
    assert ends_as_in_pillow(SKIPPED[name]()) == "skipped"


def _sha(arr) -> str:
    return "skip" if arr is None else hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_chip_smoke_tiff_files_table_is_pillows():
    """chip_smoke.py's phase 23d files, rebuilt here by its own writers:
    TIFF_OUTCOMES names each one and gives Pillow's outcome (skip, or the
    SHA-256 of the RGB array it reads), and the port's outcome is the
    same."""
    files = cs._tiff_files()
    assert sorted(files) == sorted(cs.TIFF_OUTCOMES)
    for name, data in files.items():
        assert _sha(pillow(data)) == cs.TIFF_OUTCOMES[name], name
        try:
            got = decode_image(data)
        except ValueError:
            got = None
        assert _sha(got) == cs.TIFF_OUTCOMES[name], name
    assert "skip" in cs.TIFF_OUTCOMES.values()


# --------------------------------------------------------------------- #
# host time
# --------------------------------------------------------------------- #

def _a4_page() -> bytes:
    """A 2480 x 3508 (A4 at 300 dpi) page of text-like black strokes, as
    Pillow writes it in Group 4."""
    rng = np.random.RandomState(7)
    page = np.full((3508, 2480), 255, np.uint8)
    for line in range(120):
        y = 150 + line * 27
        x = 150
        while x < 2300:
            wlen = rng.randint(20, 140)
            glyphs = rng.rand(18, wlen) < 0.35
            page[y:y + 18, x:x + wlen][glyphs] = 0
            x += wlen + rng.randint(10, 25)
    return _saved(page, "1", compression="group4")


def main() -> None:
    """This machine's host CPU seconds, least and median of several runs,
    to decode an A4 Group 4 page at 300 dpi, a 1024 x 768 JPEG-in-TIFF
    (YCbCr) and a 256 x 256 16-bit grayscale TIFF (Deflate), each against
    Pillow's decode of the same bytes."""
    cases = [("A4 page 2480 x 3508, Group 4", _a4_page(), 5),
             ("1024 x 768 JPEG-in-TIFF (YCbCr)",
              _saved(picture(768, 1024, 1), "YCbCr", compression="jpeg"), 5),
             ("256 x 256 16-bit grayscale (Deflate)",
              _saved(picture(256, 256, 2)[..., 0].astype(np.uint16) * 200, None,
                     compression="tiff_adobe_deflate"), 21)]
    for name, data, runs in cases:
        ours, theirs = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            got = decode_image(data)
            ours.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            want = pillow(data)
            theirs.append(time.perf_counter() - t0)
        assert np.array_equal(got, want)
        print(f"{name} ({len(data)} bytes): port {min(ours):.4f} s least, "
              f"{statistics.median(ours):.4f} s median; Pillow {min(theirs):.4f} s least, "
              f"{statistics.median(theirs):.4f} s median (host CPU, {runs} runs), byte-equal")


if __name__ == "__main__":
    sys.exit(main())
