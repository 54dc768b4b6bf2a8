"""The TIFF codecs and layouts the port's reader took on last
(``cogview_tpu_torch/utils/zstd.py``, ``xz.py``, ``tiff_rgba.py``,
``ojpeg.py``, ``lab.py`` and ``tiff.py``'s ThunderScan) against live Pillow 12.1 and the libraries it
bundles, byte for byte, with no tolerance.

- Zstandard: frames from Pillow's libzstd 1.5.7 (by ctypes) at levels 1, 3,
  9 and 19, streamed or in one piece with a content size, with and without
  a checksum, raw and RLE blocks, predictors 2 and 3, tiles, a skippable
  and a second frame; the decoder against libzstd driven as libtiff's
  ``ZSTDDecode`` drives it on seeded damaged frames; damaged and cut
  strips of a Pillow-written file.
- ThunderScan: the script's encoder (``chip_smoke._thunder_rows``) and
  hand-built rows (runs that end a row or start on an odd pixel, skips,
  deltas that wrap), and damaged strips.
- YCbCr through libtiff's RGBA interface: every subsampling libtiff takes
  and two it refuses, strips, tiles, planes, ReferenceBlackWhite and
  YCbCrCoefficients; damaged LZW, Deflate, PackBits, LZMA and Zstandard
  strips.
- old-style JPEG: its header in JPEGInterchangeFormat, in tags or at the
  start of the first strip, every subsampling, several strips, tiles one
  above the other and side by side, three planes and one, gray; and
  damaged files in strips, tiles and planes.
- CIELab under every codec, and Pillow's LittleCMS conversion of LAB.
- LZMA: 252 damaged strips, and the decoder against Pillow's liblzma 5.8.2
  driven as libtiff's ``LZMADecode`` drives it.
- phase 23e's files and constants in ``chip_smoke.py``.
"""

import ctypes
import functools
import glob
import io
import lzma
import os
import struct
import sys
import zlib

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

sys.path.insert(0, os.path.dirname(__file__))

from cogview_tpu_torch.utils import xz, zstd  # noqa: E402
from cogview_tpu_torch.utils.image_errors import UnsupportedImageError  # noqa: E402
from cogview_tpu_torch.utils.image_formats import decode_image  # noqa: E402
from test_torch_image_damage_jpeg import picture, pillow  # noqa: E402
from test_torch_image_io import _lzw_tiff, _packbits_tiff  # noqa: E402
from test_torch_image_tiff import (_damaged, _retag, _saved, _sha, cs,  # noqa: E402
                                   ends_as_in_pillow, layout, reads_as_pillow,
                                   unwritten_pixels)

# --------------------------------------------------------------------- #
# Pillow's libzstd and liblzma, by ctypes
# --------------------------------------------------------------------- #


def _bundled(name: str):
    libs = glob.glob(os.path.join(os.path.dirname(Image.__file__), os.pardir, "pillow.libs",
                                  f"{name}*.so*"))
    if not libs:
        pytest.skip(f"Pillow's bundled {name} is not there")
    return ctypes.CDLL(libs[0])


class _Buf(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def _zstd_lib():
    lib = _bundled("libzstd")
    lib.ZSTD_createDStream.restype = ctypes.c_void_p
    lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Buf),
                                          ctypes.POINTER(_Buf)]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compressStream2.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Buf),
                                         ctypes.POINTER(_Buf), ctypes.c_int]
    lib.ZSTD_compressStream2.restype = ctypes.c_size_t
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    return lib


def zstd_compress(data: bytes, level: int = 3, checksum: bool = False,
                  one_piece: bool = False) -> bytes:
    """One frame of libzstd: ``one_piece`` as ZSTD_compress2 writes it (its
    content size in the header), else streamed as libtiff's encoder streams
    it (no content size)."""
    lib = _zstd_lib()
    cc = lib.ZSTD_createCCtx()
    lib.ZSTD_CCtx_setParameter(cc, 100, level)  # ZSTD_c_compressionLevel
    lib.ZSTD_CCtx_setParameter(cc, 201, int(checksum))  # ZSTD_c_checksumFlag
    out = ctypes.create_string_buffer(2 * len(data) + 1024)
    src = ctypes.create_string_buffer(data, len(data))
    try:
        if one_piece:
            n = lib.ZSTD_compress2(cc, out, len(out), src, len(data))
            assert not lib.ZSTD_isError(n)
            return out.raw[:n]
        ob = _Buf(ctypes.cast(out, ctypes.c_void_p), len(out), 0)
        ib = _Buf(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        while ib.pos < ib.size:
            assert not lib.ZSTD_isError(lib.ZSTD_compressStream2(cc, ctypes.byref(ob),
                                                                 ctypes.byref(ib), 0))
        empty = _Buf(None, 0, 0)
        while lib.ZSTD_compressStream2(cc, ctypes.byref(ob), ctypes.byref(empty), 2):
            pass
        return out.raw[:ob.pos]
    finally:
        lib.ZSTD_freeCCtx(cc)


def libtiff_zstd(src: bytes, size: int):
    """libtiff's ZSTDDecode loop over libzstd -> the strip's bytes, or None
    where libtiff fails it."""
    lib = _zstd_lib()
    ds = lib.ZSTD_createDStream()
    lib.ZSTD_initDStream(ds)
    ib, ob = ctypes.create_string_buffer(src, len(src)), ctypes.create_string_buffer(size)
    inb = _Buf(ctypes.cast(ib, ctypes.c_void_p), len(src), 0)
    outb = _Buf(ctypes.cast(ob, ctypes.c_void_p), size, 0)
    try:
        while True:
            r = lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(r):
                return None
            if not (r != 0 and inb.pos < inb.size and outb.pos < outb.size):
                break
        return ob.raw if outb.pos == size else None
    finally:
        lib.ZSTD_freeDStream(ds)


class _LzmaStream(ctypes.Structure):
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                ("total_in", ctypes.c_uint64), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
                ("reserved", ctypes.c_void_p * 4), ("seek_pos", ctypes.c_uint64),
                ("reserved_int2", ctypes.c_uint64), ("reserved_int3", ctypes.c_size_t),
                ("reserved_int4", ctypes.c_size_t), ("reserved_enum1", ctypes.c_int),
                ("reserved_enum2", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _lzma_lib():
    lib = _bundled("liblzma")
    lib.lzma_stream_decoder.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_uint64,
                                        ctypes.c_uint32]
    lib.lzma_code.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_int]
    lib.lzma_end.argtypes = [ctypes.POINTER(_LzmaStream)]
    return lib


def libtiff_lzma(src: bytes, size: int) -> int:
    """libtiff's LZMADecode loop over Pillow's liblzma -> the bytes it gave
    before it stopped (the strip is good where that is ``size``)."""
    lib = _lzma_lib()
    s = _LzmaStream()
    assert lib.lzma_stream_decoder(ctypes.byref(s), 2 ** 64 - 1, 0) == 0
    ib, ob = ctypes.create_string_buffer(src, len(src)), ctypes.create_string_buffer(size)
    s.next_in, s.avail_in = ctypes.cast(ib, ctypes.c_void_p), len(src)
    s.next_out, s.avail_out = ctypes.cast(ob, ctypes.c_void_p), size
    while lib.lzma_code(ctypes.byref(s), 0) == 0 and s.avail_out:
        pass
    got = size - s.avail_out
    lib.lzma_end(ctypes.byref(s))
    return got, ob.raw[:got]


# --------------------------------------------------------------------- #
# Zstandard
# --------------------------------------------------------------------- #

def _zstd_tiff(arr, compress, pred: int = 1, rps=None, tile=None) -> bytes:
    """A Zstandard TIFF of ``arr`` ([h, w] or [h, w, 3] uint8, [h, w] uint16
    or float32), each strip or tile through ``compress``."""
    h, w = arr.shape[:2]
    spp = 1 if arr.ndim == 2 else 3
    bits = arr.dtype.itemsize * 8
    fmt = 3 if arr.dtype == np.float32 else 1
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [50000]),
              262: (3, [1 if spp == 1 else 2]), 277: (3, [spp])}
    if fmt == 3:
        fields[339] = (3, [3])
    if pred != 1:
        fields[317] = (3, [pred])
    rows = arr.reshape(h, w * spp)

    def code(blk):
        if pred == 2:
            d = blk.astype(np.int64)
            d[:, spp:] -= blk[:, :-spp].astype(np.int64)
            blk = (d % (1 << bits)).astype(blk.dtype)
        if pred == 3:
            b = np.ascontiguousarray(blk).view(np.uint8).reshape(len(blk), -1, 4)
            planes = b[:, :, ::-1].transpose(0, 2, 1).reshape(len(blk), -1).astype(np.int16)
            planes[:, 1:] -= planes[:, :-1].copy()
            return compress((planes & 255).astype(np.uint8).tobytes())
        return compress(np.ascontiguousarray(blk).tobytes())

    if tile:
        tw, th = tile
        pad = np.pad(rows, ((0, -h % th), (0, (-w % tw) * spp)))
        segs = [code(pad[y:y + th, x * spp:(x + tw) * spp])
                for y in range(0, h, th) for x in range(0, w, tw)]
        fields[322], fields[323] = (3, [tw]), (3, [th])
    else:
        rps = rps or h
        segs = [code(rows[y:y + rps]) for y in range(0, h, rps)]
        fields[278] = (3, [rps])
    return cs._tiff_file(fields, segs, tiled=bool(tile))


def _skippable(data: bytes) -> bytes:
    return struct.pack("<II", 0x184D2A5E, 5) + b"hello" + data


ZSTD = {
    **{f"level-{lv}{'-checksum' if ck else ''}{'-one-piece' if one else ''}":
       (lambda lv=lv, ck=ck, one=one: _zstd_tiff(
           picture(), lambda b: zstd_compress(b, lv, ck, one)))
       for lv in (1, 3, 9, 19) for ck in (False, True) for one in (False, True)},
    "pillow-written-rgb": lambda: _saved(picture(), compression="zstd"),
    "pillow-written-gray": lambda: _saved(picture()[..., 0], compression="zstd"),
    "raw-blocks": lambda: _zstd_tiff(np.random.RandomState(1).randint(0, 256, (64, 80, 3),
                                                                      ).astype(np.uint8),
                                     zstd_compress),
    "rle-blocks": lambda: _zstd_tiff(np.full((64, 80), 77, np.uint8),
                                     lambda b: zstd_compress(b, 19, True, True)),
    "predictor-2-rgb": lambda: _zstd_tiff(picture(), zstd_compress, pred=2),
    "predictor-2-16-bit": lambda: _zstd_tiff(picture()[..., 1].astype(np.uint16) * 251,
                                             lambda b: zstd_compress(b, 9, True), pred=2),
    "predictor-3-float": lambda: _zstd_tiff(picture()[..., 2].astype(np.float32) * 1.3 - 7,
                                            zstd_compress, pred=3),
    "strips": lambda: _zstd_tiff(picture(), lambda b: zstd_compress(b, 5, True), rps=13),
    "tiles": lambda: _zstd_tiff(picture(), zstd_compress, tile=(48, 32)),
    "skippable-frame-first": lambda: _zstd_tiff(picture(40, 48), lambda b: _skippable(
        zstd_compress(b))),
    "two-frames": lambda: _zstd_tiff(picture(40, 48), lambda b: zstd_compress(b[:900])
                                     + zstd_compress(b[900:])),
    "frame-then-garbage": lambda: _zstd_tiff(picture(40, 48), lambda b: zstd_compress(b)
                                             + b"\x00garbage"),
    "content-size-short": lambda: _zstd_tiff(picture(40, 48), lambda b: zstd_compress(
        b[:-10], 3, False, True)),
}


ZSTD_SKIPPED = {"skippable-frame-first", "two-frames", "content-size-short"}


@pytest.mark.parametrize("name", list(ZSTD))
def test_zstd_tiff_ends_as_in_pillow(name):
    """Zstandard strips and tiles at every level, streamed or in one piece,
    with and without a checksum, raw and RLE blocks, predictors 2 and 3
    (8-, 16-bit and float): read byte-equal to Pillow; a strip that starts
    with a skippable frame, or whose first frame is short, is skipped as
    Pillow skips it (libtiff stops at a frame's end)."""
    want = "skipped" if name in ZSTD_SKIPPED else "read"
    assert ends_as_in_pillow(ZSTD[name]()) == want


ZSTD_DATA = {"picture": lambda: picture().tobytes(),
             "predicted": lambda: np.diff(picture().astype(np.int16), axis=1).astype(
                 np.uint8).tobytes(),
             "text": lambda: b"a tiff strip of zstandard frames, " * 300,
             "few-literals": lambda: np.random.RandomState(3).choice(
                 np.frombuffer(b"abcdefgh", np.uint8), 700,
                 p=[.5, .2, .1, .05, .05, .05, .03, .02]).tobytes() + b"xyz" * 40}
ZSTD_FUZZ = [(d, lv, ck, one) for d in ZSTD_DATA for lv in (1, 9, 19)
             for ck, one in ((False, False), (True, True))]


@pytest.mark.parametrize("data,level,checksum,one", ZSTD_FUZZ,
                         ids=[f"{d}-{lv}-{'ck' if ck else 'stream'}" for d, lv, ck, one in ZSTD_FUZZ])
def test_zstd_decoder_ends_as_libzstd_under_libtiff(data, level, checksum, one):
    """40 seeded damaged frames (1-3 bytes overwritten, or cut) of each
    stream, into the whole strip's buffer and into half of it: the port's
    ``tiff_decode`` gives libzstd's bytes where libtiff's loop over libzstd
    fills the buffer, and fails where it fails."""
    raw = ZSTD_DATA[data]()
    frame = zstd_compress(raw, level, checksum, one)
    for seed in range(40):
        rng = np.random.RandomState(seed)
        bad = bytearray(frame)
        if rng.randint(3):
            for _ in range(rng.randint(1, 4)):
                bad[rng.randint(len(bad))] = rng.randint(256)
        else:
            bad = bad[:rng.randint(1, len(bad))]
        for size in (len(raw), len(raw) // 2):
            want = libtiff_zstd(bytes(bad), size)
            try:
                got = zstd.tiff_decode(bytes(bad), size)
            except ValueError:
                got = None
            assert got == want, (seed, size)


def _zstd_base() -> bytes:
    return _saved(picture(48, 64), compression="zstd")


def _strip_cut(base: bytes, seed: int) -> bytes:
    """``base`` with its one strip's byte count cut to a seeded length."""
    at = struct.unpack_from("<I", base, 4)[0]
    n = struct.unpack_from("<H", base, at)[0]
    for i in range(n):
        tag, typ, count, value = struct.unpack_from("<HHII", base, at + 2 + 12 * i)
        if tag == 279:
            cut = np.random.RandomState(7000 + seed).randint(1, value)
            return _retag(base, 279, typ=4, count=1, value=cut)
    raise AssertionError("no StripByteCounts")


@pytest.mark.parametrize("start", [0, 20, 40])
def test_zstd_strips_damaged_end_as_in_pillow(start):
    """A Pillow-written 48 x 64 Zstandard TIFF (one streamed frame, no
    checksum): 20 files a case, 1-3 bytes of its strip overwritten, then 20
    with the strip's byte count cut short: each read byte-equal to Pillow
    (damaged literals and sequences give libzstd's bytes) or skipped where
    Pillow fails."""
    base = _zstd_base()
    at = struct.unpack_from("<I", base, 4)[0]
    for seed in range(start, start + 20):
        data = _strip_cut(base, seed) if start == 40 else _damaged(base, seed, 8, at)
        ends_as_in_pillow(data)


# --------------------------------------------------------------------- #
# ThunderScan
# --------------------------------------------------------------------- #

def _thunder_tiff(rows: bytes, h: int, w: int, rps=None, segs=None) -> bytes:
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [4]), 259: (3, [32809]),
              262: (3, [1]), 277: (3, [1])}
    if rps:
        fields[278] = (3, [rps])
    return cs._tiff_file(fields, segs or [rows])


def _g4(h: int, w: int, seed: int = 0) -> np.ndarray:
    """4-bit samples with runs, small steps and jumps."""
    g = (picture(h, w, seed)[..., 0] >> 4).astype(np.uint8)
    g[::3, 5:30] = 9  # runs
    g[1::4, :] = np.cumsum(np.random.RandomState(seed).randint(-1, 2, w)) % 16  # 2-bit deltas
    return g


THUNDER = {
    "encoder": lambda: _thunder_tiff(cs._thunder_rows(_g4(32, 48)), 32, 48),
    "encoder-odd-width": lambda: _thunder_tiff(cs._thunder_rows(_g4(17, 37, 1)), 17, 37),
    "encoder-strips": lambda: _thunder_tiff(b"", 40, 21, rps=8, segs=[
        cs._thunder_rows(_g4(40, 21, 2)[y:y + 8]) for y in range(0, 40, 8)]),
    "run-ending-the-row": lambda: _thunder_tiff(bytes([0xC5, 0x08]) * 2, 2, 9),
    "run-from-an-odd-pixel": lambda: _thunder_tiff(bytes([0xC5, 0x06, 0xC2, 0xC1]) * 3, 3, 9),
    "skips-and-wraps": lambda: _thunder_tiff(bytes([0xC0, 0x7B, 0x6F, 0xA4, 0x94, 0xCF, 0x06,
                                                    0xC1, 0xC2, 0xC3]), 1, 16),
    "row-too-short": lambda: _thunder_tiff(bytes([0xC5, 0x03]), 1, 9),
    "row-too-long": lambda: _thunder_tiff(bytes([0xC5, 0x3F]), 1, 9),
    "eight-bits-a-sample": lambda: cs._tiff_file({
        256: (4, [8]), 257: (4, [2]), 258: (3, [8]), 259: (3, [32809]), 262: (3, [1]),
        277: (3, [1])}, [bytes([0xC1] * 16)]),
}


THUNDER_SKIPPED = {"row-too-short", "row-too-long", "eight-bits-a-sample"}


@pytest.mark.parametrize("name", list(THUNDER))
def test_thunderscan_ends_as_in_pillow(name):
    """ThunderScan (32809): the script's encoder at even and odd widths and
    in strips, runs that end a row or start on an odd pixel, delta skips
    and wraps, rows too short or too long (the strip fails; what libtiff
    leaves unwritten in Pillow's buffer is not compared), and 8-bit samples
    (libtiff refuses them)."""
    data = THUNDER[name]()
    want = "skipped" if name in THUNDER_SKIPPED else "read"
    assert ends_as_in_pillow(data, unwritten_pixels(data)) == want


@pytest.mark.parametrize("start", [0, 20, 40, 60, 80])
def test_thunderscan_strips_damaged_end_as_in_pillow(start):
    """A 32 x 48 ThunderScan TIFF of four strips from the script's encoder:
    20 files a case with 1-3 bytes of its data overwritten, each read
    byte-equal to Pillow but for the pixels libtiff leaves unwritten, or
    skipped where Pillow fails."""
    g = _g4(32, 48, 3)
    base = _thunder_tiff(b"", 32, 48, rps=8, segs=[cs._thunder_rows(g[y:y + 8])
                                                   for y in range(0, 32, 8)])
    at = struct.unpack_from("<I", base, 4)[0]
    for seed in range(start, start + 20):
        data = _damaged(base, seed, 8, at)
        ends_as_in_pillow(data, unwritten_pixels(data) if pillow(data) is not None else None)


# --------------------------------------------------------------------- #
# YCbCr through libtiff's RGBA interface
# --------------------------------------------------------------------- #

def _ycbcr_tiff(img, sh: int, sv: int, comp: int = 5, rps=None, tile=None, planar: int = 1,
                more=None) -> bytes:
    """YCbCr of ``img`` in chunky blocks (chip_smoke._ycbcr_blocks, the
    picture's edges repeated to whole blocks) or planes."""
    enc = {1: lambda b: b, 5: _lzw_tiff, 8: zlib.compress,
           50000: lambda b: zstd_compress(b, 3)}[comp]
    h, w = img.shape[:2]
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [comp]),
              262: (3, [6]), 277: (3, [3]), 284: (3, [planar]), 530: (3, [sh, sv])}
    fields.update(more or {})
    if planar == 2:
        rps = rps or h
        f = img.astype(np.float64)
        ycc = [0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
               128 - 0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2],
               128 + 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2]]
        planes = [np.clip(np.round(p), 0, 255).astype(np.uint8) for p in ycc]
        segs = [enc(p[y:y + rps].tobytes()) for p in planes for y in range(0, h, rps)]
        fields[278] = (3, [rps])
        return cs._tiff_file(fields, segs)
    if tile:
        tw, th = tile
        pad = np.pad(img, ((0, -h % th), (0, -w % tw), (0, 0)), mode="edge")
        segs = [enc(cs._ycbcr_blocks(pad[y:y + th, x:x + tw], sh, sv))
                for y in range(0, h, th) for x in range(0, w, tw)]
        fields[322], fields[323] = (3, [tw]), (3, [th])
        return cs._tiff_file(fields, segs, tiled=True)
    rps = rps or h
    segs = []
    for y in range(0, h, rps):
        part = img[y:y + rps]
        part = np.pad(part, ((0, -len(part) % sv), (0, -w % sh), (0, 0)), mode="edge")
        segs.append(enc(cs._ycbcr_blocks(part, sh, sv)))
    fields[278] = (3, [rps])
    return cs._tiff_file(fields, segs)


_PIC = functools.partial(picture, 37, 45, 4)
YCBCR = {
    **{f"lzw-{sh}x{sv}": (lambda sh=sh, sv=sv: _ycbcr_tiff(_PIC(), sh, sv))
       for sh, sv in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (2, 4), (1, 4))},
    "lzw-2x2-strips": lambda: _ycbcr_tiff(_PIC(), 2, 2, rps=8),
    "lzw-2x2-odd-strips": lambda: _ycbcr_tiff(_PIC(), 2, 2, rps=7),
    "lzw-4x4-strips": lambda: _ycbcr_tiff(_PIC(), 4, 4, rps=12),
    "deflate-2x1": lambda: _ycbcr_tiff(_PIC(), 2, 1, comp=8),
    "zstd-4x2": lambda: _ycbcr_tiff(_PIC(), 4, 2, comp=50000),
    "raw-2x2": lambda: _ycbcr_tiff(_PIC(), 2, 2, comp=1),
    "tiles-2x2": lambda: _ycbcr_tiff(_PIC(), 2, 2, tile=(16, 16)),
    "tiles-4x2": lambda: _ycbcr_tiff(_PIC(), 4, 2, tile=(32, 16)),
    "planes-1x1": lambda: _ycbcr_tiff(_PIC(), 1, 1, planar=2, rps=16),
    "planes-2x2-refused": lambda: _ycbcr_tiff(_PIC(), 2, 2, planar=2),
    "reference-black-white": lambda: _ycbcr_tiff(_PIC(), 2, 2, more={
        532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}),
    "coefficients-rec709": lambda: _ycbcr_tiff(_PIC(), 2, 2, more={
        529: (5, [2126, 10000, 7152, 10000, 722, 10000])}),
    "reference-black-white-wide": lambda: _ycbcr_tiff(_PIC(), 1, 1, more={
        532: (5, [0, 1, 255, 1, 0, 1, 255, 1, 0, 1, 255, 1])}),
    "jpeg-planes": lambda: cs._tiff_codec_files()["ycbcr_jpeg_planes.png"],
}


# libtiff converts neither 2 x 4 nor 1 x 4 nor subsampled planes; Pillow
# reads uncompressed YCbCr with its own raw decoder, four bytes a pixel
YCBCR_SKIPPED = {"lzw-2x4", "lzw-1x4", "planes-2x2-refused", "raw-2x2"}


@pytest.mark.parametrize("name", list(YCBCR))
def test_ycbcr_through_the_rgba_interface_reads_as_pillow(name):
    """YCbCr without JPEG, or JPEG in planes, which Pillow reads through
    libtiff's RGBA interface: LZW at every subsampling libtiff converts (and
    2 x 4 and 1 x 4, which it refuses), strips of odd heights, tiles,
    Deflate, Zstandard and raw strips, planes at 1 x 1 (and subsampled,
    refused), ReferenceBlackWhite and YCbCrCoefficients: byte-equal."""
    want = "skipped" if name in YCBCR_SKIPPED else "read"
    assert ends_as_in_pillow(YCBCR[name]()) == want


@pytest.mark.parametrize("start", [0, 20, 40, 60, 80])
def test_ycbcr_lzw_strips_damaged_end_as_in_pillow(start):
    """A 48 x 64 YCbCr LZW TIFF at 2 x 2 in strips of 16 rows: 20 files a
    case with 1-3 bytes of its strips overwritten; libtiff's RGBA interface
    reads a damaged strip as LZW leaves it (the rest zeroed): byte-equal to
    Pillow, or skipped where it fails."""
    base = _ycbcr_tiff(picture(48, 64, 5), 2, 2, rps=16)
    at = struct.unpack_from("<I", base, 4)[0]
    for seed in range(start, start + 20):
        ends_as_in_pillow(_damaged(base, seed, 8, at))


YCBCR_CODECS = {"deflate": (8, zlib.compress), "packbits": (32773, _packbits_tiff),
                "lzma": (34925, lambda b: lzma.compress(b, format=lzma.FORMAT_XZ)),
                "zstd": (50000, lambda b: zstd_compress(b, 3))}


@pytest.mark.parametrize("codec", list(YCBCR_CODECS))
def test_ycbcr_strips_damaged_under_each_codec_end_as_in_pillow(codec):
    """A 48 x 64 YCbCr TIFF at 2 x 2 in strips of 16 rows under Deflate,
    PackBits, LZMA and Zstandard, 40 files each with 1-3 bytes of its
    strips overwritten: libtiff's RGBA interface keeps what each codec
    wrote before it failed (zlib's bytes up to the bad code, LZMA's up to
    liblzma's error, Zstandard's blocks before the one that fails), the
    rest zeros and the predictor unapplied: byte-equal to Pillow."""
    comp, enc = YCBCR_CODECS[codec]
    img = picture(48, 64, 5)
    fields = {256: (4, [64]), 257: (4, [48]), 258: (3, [8, 8, 8]), 259: (3, [comp]),
              262: (3, [6]), 277: (3, [3]), 278: (3, [16]), 530: (3, [2, 2])}
    base = cs._tiff_file(fields, [enc(cs._ycbcr_blocks(img[y:y + 16], 2, 2))
                                  for y in range(0, 48, 16)])
    at = struct.unpack_from("<I", base, 4)[0]
    for seed in range(40):
        ends_as_in_pillow(_damaged(base, seed, 8, at))


# --------------------------------------------------------------------- #
# old-style JPEG
# --------------------------------------------------------------------- #

_OJ = functools.partial(picture, 48, 64, 7)


def _frame_rows(data: bytes, rows: int) -> bytes:
    """``data`` with its stream's frame (SOF0) declaring ``rows`` rows."""
    out = bytearray(data)
    at = out.find(b"\xff\xc0")
    struct.pack_into(">H", out, at + 5, rows)
    return bytes(out)


OJPEG = {
    **{f"{form}-{sh}x{sv}": (lambda form=form, sh=sh, sv=sv: cs._ojpeg_file(
        _OJ(), form, (sh, sv)))
       for form in ("interchange", "tables", "inline")
       for sh, sv in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2))},
    **{f"{form}-strips": (lambda form=form: cs._ojpeg_file(_OJ(), form, rps=16))
       for form in ("interchange", "tables", "inline")},
    "tables-strips-1x1": lambda: cs._ojpeg_file(_OJ(), "tables", (1, 1), rps=8),
    "interchange-strips-4x2": lambda: cs._ojpeg_file(_OJ(), "interchange", (4, 2), rps=16),
    "rgb-photometric": lambda: cs._ojpeg_file(_OJ(), "tables", photo=2),
    "gray": lambda: cs._ojpeg_file(_OJ()[..., 0], "interchange", rps=16, photo=1),
    "gray-tables": lambda: cs._ojpeg_file(_OJ()[..., 1], "tables", photo=0),
    "cmyk-photometric": lambda: cs._ojpeg_file(_OJ(), "tables", photo=5),
    "strips-not-whole-rows": lambda: cs._ojpeg_file(_OJ(), "inline", rps=12),
    "no-subsampling-tag": lambda: _retag(cs._ojpeg_file(_OJ(), "inline", (2, 1)), 530,
                                         new_tag=531),
    **{f"{form}-tile": (lambda form=form: cs._ojpeg_file(_OJ(), form, tile=(64, 48)))
       for form in ("interchange", "tables", "inline")},
    **{f"{form}-tiles-in-a-column": (lambda form=form: cs._ojpeg_file(_OJ(), form,
                                                                      tile=(64, 16)))
       for form in ("interchange", "tables", "inline")},
    "tile-past-the-edges": lambda: cs._ojpeg_file(_OJ(), "inline", tile=(80, 64)),
    "tables-tiles-1x1": lambda: cs._ojpeg_file(_OJ(), "tables", (1, 1), tile=(64, 8)),
    "interchange-tiles-4x2": lambda: cs._ojpeg_file(_OJ(), "interchange", (4, 2),
                                                    tile=(96, 16)),
    "gray-tiles": lambda: cs._ojpeg_file(_OJ()[..., 0], "interchange", tile=(64, 16), photo=1),
    "gray-tables-tiles": lambda: cs._ojpeg_file(_OJ()[..., 2], "tables", tile=(80, 32),
                                                photo=0),
    "gray-planes": lambda: cs._ojpeg_file(_OJ()[..., 0], "inline", rps=16, photo=1, planar=2),
    "gray-tables-planes": lambda: cs._ojpeg_file(_OJ()[..., 1], "tables", photo=1, planar=2),
    **{f"{form}-tiles-side-by-side": (lambda form=form: cs._ojpeg_file(_OJ(), form,
                                                                       tile=(32, 16)))
       for form in ("interchange", "tables", "inline")},
    "tiles-side-by-side-1x1": lambda: cs._ojpeg_file(_OJ(), "tables", (1, 1), tile=(16, 24)),
    "tiles-side-by-side-4x2": lambda: cs._ojpeg_file(_OJ(), "inline", (4, 2), tile=(32, 32)),
    "gray-tiles-side-by-side": lambda: cs._ojpeg_file(_OJ()[..., 0], "inline", tile=(16, 16),
                                                      photo=1),
    **{f"{form}-planes": (lambda form=form: cs._ojpeg_file(_OJ(), form, planar=2))
       for form in ("interchange", "tables", "inline")},
    "planes-in-strips": lambda: cs._ojpeg_file(_OJ(), "inline", rps=16, planar=2),
    "rgb-planes": lambda: cs._ojpeg_file(_OJ(), "interchange", rps=8, photo=2, planar=2),
    "planes-in-tiles": lambda: cs._ojpeg_file(_OJ(), "interchange", tile=(64, 16), planar=2),
    "planes-in-tiles-side-by-side": lambda: cs._ojpeg_file(_OJ(), "inline", tile=(32, 16),
                                                           planar=2),
    "planes-subsampled": lambda: _retag(cs._ojpeg_file(_OJ(), "tables", planar=2), 530,
                                        value=0x00020002),
    "tables-planes-in-strips": lambda: cs._ojpeg_file(_OJ(), "tables", rps=16, planar=2),
    "tables-planes-in-tiles": lambda: cs._ojpeg_file(_OJ(), "tables", tile=(32, 16),
                                                     planar=2),
    "tiles-side-by-side-part-imcu-row": lambda: _frame_rows(
        cs._ojpeg_file(picture(36, 64, 7), "inline", tile=(32, 16)), 36),
    "tiles-side-by-side-taller-frame": lambda: _frame_rows(
        cs._ojpeg_file(picture(40, 64, 7), "interchange", tile=(32, 16)), 44),
    "tiles-not-whole-rows": lambda: cs._ojpeg_file(_OJ(), "inline", tile=(64, 24)),
    "gray-tile-in-ycbcr": lambda: cs._ojpeg_file(_OJ()[..., 0], "inline", tile=(64, 16)),
}
# libtiff reads three samples of old-style JPEG only as YCbCr (RGB it reads
# as YCbCr), strips and tiles only of whole iMCU rows, one sample not as
# YCbCr, planes only at 1 x 1, and planes in several strips only where each
# later plane's scan starts
OJPEG_SKIPPED = {"cmyk-photometric", "strips-not-whole-rows", "tiles-not-whole-rows",
                 "gray-tile-in-ycbcr", "planes-subsampled", "tables-planes-in-strips",
                 "tables-planes-in-tiles"}


@pytest.mark.parametrize("name", list(OJPEG))
def test_old_style_jpeg_ends_as_in_pillow(name):
    """Old-style JPEG (6) with its header in JPEGInterchangeFormat, its
    tables in tags or its header at the start of the first strip, at every
    subsampling libtiff converts, in one strip or several (libtiff's
    restart markers between them), in tiles (one stream a tile wide, each
    tile the next band of it: side by side, the tiles past its end keep
    the rows read before, and where its frame is not whole iMCU rows the
    rows of no block keep the iMCU row before), RGB read as YCbCr, one
    component read as gray, three in planes (a scan each, from the SOS
    markers in the planes' strips), the JPEG's sampling without a
    YCbCrSubsampling tag: byte-equal to Pillow; three samples of another
    photometric, strips or tiles that cut an iMCU row, one sample called
    YCbCr, planes subsampled and planes whose later scans name components
    the tags' frame lacks, in several strips, are skipped as Pillow skips
    them."""
    want = "skipped" if name in OJPEG_SKIPPED else "read"
    assert ends_as_in_pillow(OJPEG[name]()) == want


OJPEG_DAMAGED = {
    **{form: functools.partial(cs._ojpeg_file, form=form, rps=16)
       for form in ("interchange", "tables", "inline")},
    "tiles": functools.partial(cs._ojpeg_file, form="interchange", tile=(64, 16)),
    "tiles-side-by-side": functools.partial(cs._ojpeg_file, form="inline", tile=(32, 16)),
    "planes": functools.partial(cs._ojpeg_file, form="interchange", rps=16, planar=2),
}


@pytest.mark.parametrize("form,start", [(f, s) for f in OJPEG_DAMAGED for s in (0, 20)])
def test_old_style_jpeg_damaged_ends_as_in_pillow(form, start):
    """A 48 x 64 old-style JPEG TIFF in three strips (or three tiles one
    above the other, six tiles side by side, three planes of three strips),
    20 files a case with 1-3 bytes of its strips and tables overwritten:
    read byte-equal to Pillow (a restart marker libjpeg does not expect
    stops the decode: the rows from there on are zeros, or the image fails
    where a strip follows) or skipped where Pillow fails.  The one case
    the reader names, planes whose second scan's SOS marker is corrupt
    (libtiff then reads the first plane's later strips from where its
    search stopped), must be one Pillow reads, and only the planes files
    may meet it (one of the 40)."""
    base = OJPEG_DAMAGED[form](_OJ())
    at = struct.unpack_from("<I", base, 4)[0]
    named = 0
    for seed in range(start, start + 20):
        data = _damaged(base, seed, 8, at)
        try:
            ends_as_in_pillow(data)
        except UnsupportedImageError as err:
            assert "second scan's SOS marker is corrupt" in str(err)
            assert pillow(data) is not None
            named += 1
    assert named <= (1 if form == "planes" else 0)


# --------------------------------------------------------------------- #
# CIELab
# --------------------------------------------------------------------- #

CIELAB = {
    **{f"comp{c}": (lambda c=c: layout(8, 8, spp=3, comp=c))
       for c in (1, 5, 8, 32773, 34925)},
    "planes-raw": lambda: layout(8, 8, spp=3, planar=2),
    "planes-lzw": lambda: layout(8, 8, spp=3, comp=5, planar=2),
    "tiles-deflate": lambda: layout(8, 8, spp=3, comp=8, tile=(16, 16), h=20, w=37),
    "big-endian-lzw": lambda: layout(8, 8, spp=3, comp=5, bo=">"),
    "pillow-written": lambda: _saved(picture(), "LAB"),
    "pillow-written-lzw": lambda: _saved(picture(), "LAB", compression="tiff_lzw"),
    "zstd": lambda: _layout_zstd(photo=8, bits=8, spp=3),
    "chip-smoke": lambda: cs._tiff_codec_files()["cielab_lzw.png"],
}


@pytest.mark.parametrize("name", list(CIELAB))
def test_cielab_reads_as_pillow(name):
    """CIELab (photometric 8), which Pillow opens as LAB and converts to RGB
    through LittleCMS: uncompressed (Pillow's own decoder, planes too) and
    under every codec, tiled, big-endian, Pillow-written: byte-equal."""
    reads_as_pillow(CIELAB[name]())


def test_lab_conversion_is_littlecms():
    """``lab.lab_to_rgb`` against Pillow's ``convert("RGB")`` of mode LAB on
    2**20 seeded Lab triples and on every triple of the lines through the
    grey axis, the nodes' planes and the corners (the module holds all
    2**24 equal; here a cross-section)."""
    from cogview_tpu_torch.utils.lab import lab_to_rgb

    rng = np.random.RandomState(11)
    v = rng.randint(0, 256, (1 << 20, 3)).astype(np.uint8)
    axes = np.arange(256, dtype=np.uint8)
    lines = [np.stack([axes, np.full(256, a, np.uint8), np.full(256, b, np.uint8)], -1)
             for a in (0, 8, 127, 128, 129, 255) for b in (0, 128, 247, 255)]
    lines += [np.stack([np.full(256, l, np.uint8), axes, axes[::-1]], -1) for l in (0, 100, 255)]
    v = np.concatenate([v] + lines)
    img = Image.frombytes("LAB", (len(v), 1), (v ^ np.array([0, 128, 128], np.uint8)).tobytes())
    want = np.asarray(img.convert("RGB")).reshape(-1, 3)
    np.testing.assert_array_equal(lab_to_rgb(v), want)


# --------------------------------------------------------------------- #
# LZMA
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("start", range(0, 252, 42))
def test_lzma_strips_damaged_end_as_in_pillow(start):
    """The LZMA sweep: a Pillow-written 32 x 48 LZMA TIFF (libtiff's delta
    and LZMA2 chain) with 1-3 bytes of its strip overwritten, 252 files in
    six cases, each read byte-equal to Pillow (liblzma 5.8.2 gives what it
    decoded before an error, and stops reading once the strip is full) or
    skipped where Pillow fails, whichever liblzma this host's standard
    library binds."""
    base = _saved(picture(32, 48, 6), compression="lzma")
    at = struct.unpack_from("<I", base, 4)[0]
    for seed in range(start, start + 42):
        ends_as_in_pillow(_damaged(base, seed, 8, at))


LZMA_DATA = {"picture": lambda: picture(32, 48).tobytes(),
             "text": lambda: b"an lzma strip of a tiff, " * 200,
             "ramp": lambda: np.arange(6000, dtype=np.uint16).tobytes()}
LZMA_FUZZ = [(d, ck, dist) for d in LZMA_DATA for ck in (lzma.CHECK_NONE, lzma.CHECK_CRC64)
             for dist in (0, 1, 3)]


@pytest.mark.parametrize("data,check,delta", LZMA_FUZZ,
                         ids=[f"{d}-check{ck}-delta{dist}" for d, ck, dist in LZMA_FUZZ])
def test_xz_decoder_ends_as_liblzma_under_libtiff(data, check, delta):
    """40 seeded damaged .xz streams each (1-3 bytes overwritten, or cut),
    LZMA2 alone or after a delta filter (libtiff's chain, distance 1 or
    3), into the whole strip's buffer and into a third of it:
    ``xz.decode`` gives the bytes Pillow's liblzma 5.8.2 gives under
    libtiff's loop before it stops, and ``tiff_decode`` reads the strip
    exactly where libtiff does."""
    raw = LZMA_DATA[data]()
    filters = [{"id": lzma.FILTER_LZMA2, "preset": 6}]
    if delta:
        filters.insert(0, {"id": lzma.FILTER_DELTA, "dist": delta})
    stream = lzma.compress(raw, format=lzma.FORMAT_XZ, check=check, filters=filters)
    for seed in range(40):
        rng = np.random.RandomState(seed)
        bad = bytearray(stream)
        if rng.randint(4):
            for _ in range(rng.randint(1, 4)):
                bad[rng.randint(len(bad))] = rng.randint(256)
        else:
            bad = bad[:rng.randint(1, len(bad))]
        for size in (len(raw), len(raw) // 3):
            n, want = libtiff_lzma(bytes(bad), size)
            assert xz.decode(bytes(bad), size) == want, (seed, size)
            try:
                got = xz.tiff_decode(bytes(bad), size)
            except ValueError:
                got = None
            assert got == (want if n == size else None), (seed, size)


# --------------------------------------------------------------------- #
# chip_smoke.py's phase 23e
# --------------------------------------------------------------------- #

def test_chip_smoke_tiff_codec_files_table_is_pillows():
    """Phase 23e's files, rebuilt by the script's own writers:
    TIFF_CODEC_OUTCOMES names each and gives Pillow's outcome (the SHA-256
    of the RGB array), and the port's outcome is the same; its Zstandard
    constants decode, by Pillow's libzstd, to the green channel of phase
    23d's picture (the second with predictor 2 applied)."""
    import base64

    files = cs._tiff_codec_files()
    assert sorted(files) == sorted(cs.TIFF_CODEC_OUTCOMES)
    for name, data in files.items():
        assert _sha(pillow(data)) == cs.TIFF_CODEC_OUTCOMES[name], name
        assert _sha(decode_image(data)) == cs.TIFF_CODEC_OUTCOMES[name], name
    rng = np.random.RandomState(41)
    h, w = cs.TIFF_SIZE
    img = cs._gradient_image(rng, h, w)
    img = np.clip(img.astype(np.int64) + rng.randint(-20, 21, img.shape), 0, 255)
    gray = img[..., 1].astype(np.uint8)
    pred = gray.astype(np.int16)
    pred[:, 1:] -= gray[:, :-1]
    for const, want in ((cs.ZSTD_GRAY, gray), (cs.ZSTD_GRAY_PREDICTOR2, pred.astype(np.uint8))):
        frame = base64.b64decode(const)
        assert libtiff_zstd(frame, h * w) == want.tobytes()
    stored = zstd._header(base64.b64decode(cs.ZSTD_GRAY_PREDICTOR2), 0)
    assert stored[2] == h * w and stored[3] == 1  # content size and checksum, one piece


def test_chip_smoke_progressive_writer_reads_as_pillow():
    """The progressive JPEG writer phase 23e uses (SOF2, an interleaved DC
    scan and each component's AC scan): read byte-equal to Pillow at 4:2:0,
    4:2:2 and 4:4:4 on sizes that are not whole MCUs."""
    img = cs._gradient_image(np.random.RandomState(9), 45, 71)
    for sampling in ((2, 2), (2, 1), (1, 1)):
        data = cs._jpeg_file(img, sampling=sampling, progressive=True)
        assert Image.open(io.BytesIO(data)).info.get("progressive")
        reads_as_pillow(data)


def test_layout_of_zstd_and_predictors_reads_as_pillow():
    """Zstandard through the layouts' writer with predictor 2 at 8 and 16
    bits and 3 on floats, big-endian, tiled and in planes."""
    for kw in (dict(photo=2, bits=8, spp=3, pred=2), dict(photo=1, bits=16, pred=2, bo=">"),
               dict(photo=1, bits=32, fmt=3, pred=3), dict(photo=2, bits=8, spp=3, tile=(16, 16)),
               dict(photo=2, bits=8, spp=3, planar=2)):
        reads_as_pillow(_layout_zstd(**kw))


def _layout_zstd(**kw) -> bytes:
    from test_torch_image_tiff import ENCODERS

    ENCODERS.setdefault(50000, lambda b: zstd_compress(b, 3, True))
    return layout(comp=50000, **kw)


# --------------------------------------------------------------------- #
# host time
# --------------------------------------------------------------------- #

def _timing_files(h: int, w: int, small: bool) -> dict:
    """{name: TIFF bytes} of a seeded h x w picture through each reader
    this file holds (LZMA strips cut short or damaged, and LZW, only where
    ``small``: the pure-Python LZMA decoder and the test's LZW writer take
    minutes at 12 MP)."""
    img = picture(h, w, 3)
    rps = max(1, 65536 // (3 * w))
    files = {
        "Zstandard RGB (Pillow's writer)": _saved(img, compression="zstd"),
        "ThunderScan 4-bit": _thunder_tiff(cs._thunder_rows(_g4(h, w)), h, w),
        "YCbCr 2x2 Deflate (RGBA interface)": _ycbcr_tiff(img, 2, 2, comp=8, rps=rps - rps % 2),
        "old-style JPEG, strips": cs._ojpeg_file(img, "interchange", rps=64),
        "old-style JPEG, tiles side by side": cs._ojpeg_file(img, "inline", tile=(256, 256)),
        "old-style JPEG, planes": cs._ojpeg_file(img, "inline", rps=64, planar=2),
        "CIELab (Pillow's writer)": _saved(img, "LAB"),
        "LZMA RGB (Pillow's writer)": _saved(img, compression="lzma"),
    }
    if small:
        files["YCbCr 2x2 LZW (RGBA interface)"] = _ycbcr_tiff(img, 2, 2, rps=rps - rps % 2)
        xz = lzma.compress(img.tobytes(), format=lzma.FORMAT_XZ)
        fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [34925]),
                  262: (3, [2]), 277: (3, [3])}
        files["LZMA RGB, its strip cut short"] = cs._tiff_file(
            fields, [xz[:len(xz) * 9 // 10]])  # one strip, 90 % of its stream
        bad = bytearray(xz)
        bad[len(xz) // 2] ^= 0x10
        files["LZMA RGB, a byte of its strip damaged (the Python decoder)"] = cs._tiff_file(
            fields, [bytes(bad)])
    return files


def main(argv) -> int:
    """This machine's host CPU seconds for each reader above against
    Pillow 12.1 on the same bytes, at 1024 x 768 and at 4032 x 3024 (a
    12 MP photo), least and median of ``repeats`` (5 and 3, or the first
    argument for both), each read checked against Pillow's:
    ``PYTHONPATH=. python tests/test_torch_image_tiff_codecs.py`` from the
    repository root."""
    import statistics
    import time

    for (h, w), repeats in (((768, 1024), 5), ((3024, 4032), 3)):
        repeats = int(argv[0]) if argv else repeats
        for name, data in _timing_files(h, w, h < 1000).items():
            ours, theirs = [], []
            for _ in range(repeats):
                t0 = time.process_time()
                try:
                    got = decode_image(data)
                except ValueError:
                    got = None
                ours.append(time.process_time() - t0)
                t0 = time.process_time()
                want = pillow(data)
                theirs.append(time.process_time() - t0)
                assert (got is None) == (want is None) and (
                    got is None or np.array_equal(got, want)), name
            print(f"{w}x{h} {name} ({len(data)} bytes): port {min(ours):.3f} s least, "
                  f"{statistics.median(ours):.3f} median; Pillow {min(theirs):.4f}, "
                  f"{statistics.median(theirs):.4f} (host CPU, {repeats} each"
                  f"{', both fail' if want is None else ''})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
