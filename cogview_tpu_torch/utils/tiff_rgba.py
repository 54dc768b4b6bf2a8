"""libtiff 4.7's RGBA interface (``tif_getimage.c``) for a YCbCr TIFF that
is not JPEG-compressed in one plane, as Pillow 12.1's ``TiffDecode.c``
calls it: ``_decodeStripYCbCr`` (``TIFFRGBAImageGet`` a strip at a time)
and ``_decodeTile`` (``TIFFReadRGBATile`` a tile at a time), the RGBA
raster unpacked as RGBX.

Each call reads its strip or tile into a fresh buffer of zeros: a strip
libtiff cannot find fails the image, a codec error does not: the buffer
keeps the bytes the codec wrote before it failed (zlib's inflated bytes,
LZW's and PackBits' rows, liblzma's bytes, Zstandard's blocks), the rest
zeros, the predictor unapplied.  Chunky YCbCr is
8-bit samples in blocks of the YCbCrSubsampling (1, 2 or 4 across, 1, 2
or 4 down; libtiff converts only 1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4):
each block's h x v luma samples row by row, then Cb and Cr, and every
pixel takes the luma at its place in its block and its block's chroma
(``putcontig8bitYCbCr*tile``, blocks cut at the image's edges included).
Planar YCbCr is read only at 1x1 (``putseparate8bitYCbCr11tile``).  The
conversion is ``TIFFYCbCrToRGBInit``'s tables from YCbCrCoefficients and
ReferenceBlackWhite (their defaults: Rec. 601 luma, 0/255 128/255
128/255), built in C floats then 16-bit fixed point, as ``TIFFYCbCrtoRGB``
applies them.
"""

from __future__ import annotations

import numpy as np

_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)
_PUT_CONTIG = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}


def _f(x) -> np.float32:
    return np.float32(x)


def _fix(x: np.float32) -> int:
    """FIX(x): (int32_t)(x * 65536 + 0.5), the product in float, the sum in
    double."""
    return int(float(_f(x) * _f(65536)) + 0.5)


def _clampw(f: np.float32, lo: float, hi: float) -> np.float32:
    if not f >= lo:
        return _f(lo)
    return _f(hi) if f > hi else f


def _code2v(c: int, rb: np.float32, rw: np.float32, cr: int) -> np.float32:
    """Code2V: (c - (int32)RB) * (float)CR / (float)(RW - RB or 1)."""
    span = _f(rw - rb)
    return _f(_f(_f(c - int(rb)) * _f(cr)) / (span if span != 0 else _f(1)))


def ycbcr_tables(luma, refbw):
    """TIFFYCbCrToRGBInit -> (Y, Cr_r, Cb_b, Cr_g, Cb_g) tables [256] int64."""
    lr, lg, lb = (_f(v) for v in luma)
    f1 = _f(_f(2) - _f(2) * lr)
    d1 = _fix(min(max(f1, _f(0)), _f(2)))
    f2 = _f(_f(lr * f1) / lg)
    d2 = -_fix(min(max(f2, _f(0)), _f(2)))
    f3 = _f(_f(2) - _f(2) * lb)
    d3 = _fix(min(max(f3, _f(0)), _f(2)))
    f4 = _f(_f(lb * f3) / lg)
    d4 = -_fix(min(max(f4, _f(0)), _f(2)))
    rbw = [_f(v) for v in refbw]
    tabs = [[0] * 256 for _ in range(5)]
    for i in range(256):
        x = i - 128
        cr = int(_clampw(_code2v(x, _f(rbw[4] - _f(128)), _f(rbw[5] - _f(128)), 127),
                         -128.0 * 32, 128.0 * 32))
        cb = int(_clampw(_code2v(x, _f(rbw[2] - _f(128)), _f(rbw[3] - _f(128)), 127),
                         -128.0 * 32, 128.0 * 32))
        tabs[1][i] = (d1 * cr + _ONE_HALF) >> _SHIFT
        tabs[2][i] = (d3 * cb + _ONE_HALF) >> _SHIFT
        tabs[3][i] = d2 * cr
        tabs[4][i] = d4 * cb + _ONE_HALF
        tabs[0][i] = int(_clampw(_code2v(x + 128, rbw[0], rbw[1], 255), -128.0 * 32, 128.0 * 32))
    return tuple(np.array(t, np.int64) for t in tabs)


def ycbcr_to_rgb(tables, y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """TIFFYCbCrtoRGB on uint8 samples -> [..., 3] uint8."""
    yt, crr, cbb, crg, cbg = tables
    yv = yt[y]
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(yv + crr[cr], 0, 255)
    out[..., 1] = np.clip(yv + ((cbg[cb] + crg[cr]) >> _SHIFT), 0, 255)
    out[..., 2] = np.clip(yv + cbb[cb], 0, 255)
    return out


def _check_tables(lt):
    """initYCbCrConversion's checks -> the tables."""
    luma = lt.luma or [0.299, 0.587, 0.114]
    refbw = lt.refbw or [0.0, 255.0, 128.0, 255.0, 128.0, 255.0]
    if any(v != v for v in luma) or abs(luma[1]) < 1e-6:
        raise ValueError("TIFF YCbCrCoefficients libtiff refuses")
    lo, hi = float(_f(-0x7FFFFFFF + 128)), float(_f(0x7FFFFFFF))
    if not all(lo < v < hi for v in refbw):
        raise ValueError("TIFF ReferenceBlackWhite libtiff refuses")
    return ycbcr_tables(luma, refbw)


def _blocks_to_rgb(tables, seg: np.ndarray, rows: int, width: int, sh: int, sv: int):
    """A strip's or tile's chunky YCbCr blocks [..] -> [rows, width, 3]."""
    across = -(-width // sh)
    down = -(-rows // sv)
    unit = sh * sv + 2
    blocks = np.zeros(across * down * unit, np.uint8)
    n = min(len(seg), len(blocks))
    blocks[:n] = seg[:n]
    blocks = blocks.reshape(down, across, unit)
    luma = blocks[..., :sh * sv].reshape(down, across, sv, sh).transpose(0, 2, 1, 3)
    luma = luma.reshape(down * sv, across * sh)[:rows, :width]
    cb = np.repeat(np.repeat(blocks[..., sh * sv], sv, 0), sh, 1)[:rows, :width]
    cr = np.repeat(np.repeat(blocks[..., sh * sv + 1], sv, 0), sh, 1)[:rows, :width]
    return ycbcr_to_rgb(tables, luma, cb, cr)


def _read(codec, i: int, size: int) -> np.ndarray:
    """_TIFFReadEncodedStripAndAllocBuffer into a fresh buffer of zeros: a
    strip libtiff cannot find fails (ValueError); a codec that fails keeps
    the bytes it wrote before (the predictor then unapplied)."""
    from . import xz, zstd
    from .tiff import _inflate, _inflate_partial, _lzw, _packbits, _predict

    lt = codec.lt
    src = codec.raw(i)  # TIFFFillStrip / TIFFFillTile
    comp = lt.compression
    buf = np.zeros(size, np.uint8)
    if comp == 5:
        seg = _lzw(src, size, partial=True)
    elif comp in (8, 32946):
        try:
            seg = _inflate(src, size)
        except ValueError:  # what zlib inflated before it failed, a byte at a time
            seg = _inflate_partial(src, size)
    elif comp == 32773:
        seg = _packbits(src, size, partial=True)
    elif comp == 34925:
        try:
            seg = xz.tiff_decode(src, size)
        except ValueError:
            seg = xz.decode(src, size)
    elif comp == 50000:
        seg = zstd.tiff_decode(src, size, partial=True)
    elif comp == 7:  # YCbCr JPEG in planes
        from .jpeg import decode_tiff_jpeg
        rows = size // max(lt.scanline(), 1)
        try:
            px = decode_tiff_jpeg(src, lt.jpeg_tables, lt.tw if lt.tiled else lt.width, rows,
                                  1, lt.bps, (1, 1), False, not lt.tiled)
            seg = px.reshape(-1)[:size].tobytes()
        except ValueError:
            seg = b""
    else:
        return buf
    if len(seg) >= size and comp in (5, 8, 32946, 34925, 50000) and lt.predictor != 1:
        seg = _predict(seg[:size], size // max(lt.scanline(upsampled=True), 1), lt)
    seg = np.frombuffer(seg, np.uint8)[:size]
    buf[:len(seg)] = seg
    return buf


def decode_ycbcr(codec, lt, width: int, height: int) -> np.ndarray:
    """The image [height, width, 3] uint8, Pillow's RGBX of libtiff's RGBA
    raster."""
    if lt.bps not in (1, 2, 4, 8, 16) or lt.fmt == 3:
        raise ValueError("TIFF samples libtiff's RGBA interface cannot take")
    if lt.bps != 8 or lt.spp != 3:
        raise ValueError("YCbCr TIFF of other than three 8-bit samples: libtiff's RGBA "
                         "interface cannot convert it")
    sh, sv = lt.subsampling if lt.planar == 1 else (1, 1)
    if lt.planar == 1 and (sh, sv) not in _PUT_CONTIG:
        raise ValueError(f"YCbCr TIFF subsampled {sh} x {sv}: libtiff cannot handle it")
    if lt.planar == 2 and lt.subsampling != (1, 1):
        raise ValueError("planar YCbCr TIFF subsampled: libtiff cannot handle it")
    tables = _check_tables(lt)
    img = np.zeros((height, width, 3), np.uint8)
    if lt.tiled:
        tw, th = lt.tw, lt.th
        across = -(-lt.width // tw)
        for y in range(0, height, th):
            for x in range(0, width, tw):
                rows, cols = min(th, height - y), min(tw, width - x)
                t = (y // th) * across + x // tw
                img[y:y + rows, x:x + cols] = _unit(codec, lt, tables, t, th, tw, sh, sv,
                                                   lt.per_image)[:rows, :cols]
        return img
    rps = height if lt.rps == 2 ** 32 - 1 else lt.rps
    per = min(lt.rps, lt.length)
    for y in range(0, height, rps):
        rows = min(rps, height - y)
        strip = y // per if lt.rps != 2 ** 32 - 1 else 0
        in_strip = min(per, lt.length - strip * per)
        img[y:y + rows] = _unit(codec, lt, tables, strip, in_strip, lt.width, sh, sv,
                                lt.per_image, rows)[:rows, :width]
    return img


def _unit(codec, lt, tables, i: int, rows: int, width: int, sh: int, sv: int, per_image: int,
          want=None) -> np.ndarray:
    """One strip or tile of ``rows`` rows -> [rows, width, 3]: read as
    gtStripContig / gtTileContig (or their Separate forms) read it, the
    bytes asked for a whole number of block rows of ``TIFFScanlineSize``."""
    want = rows if want is None else want
    scan = lt.scanline()
    if lt.planar == 1:
        nsub = -(-want // sv) * sv
        block_row = -(-(-(-width // sh) * (sh * sv + 2) * 8) // 8)
        size = min(-(-rows // sv) * block_row, nsub * scan)
        seg = _read(codec, i, size)
        return _blocks_to_rgb(tables, seg, rows, width, sh, sv)
    size = min(rows * width, want * scan)
    planes = [_read(codec, i + k * per_image, size) for k in range(3)]
    full = np.zeros((3, rows * width), np.uint8)
    for k in range(3):
        full[k, :len(planes[k])] = planes[k][:rows * width]
    y, cb, cr = (p.reshape(rows, width) for p in full)
    return ycbcr_to_rgb(tables, y, cb, cr)
