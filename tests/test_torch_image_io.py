"""The port's image readers against Pillow and the JAX package.

``cogview_tpu_torch/utils/png.py`` reads every PNG colour type, depth and
interlace, ``cogview_tpu_torch/utils/jpeg.py`` baseline and progressive
JPEG (also CMYK and YCCK), ``utils/bmp.py`` BMP, ``utils/gif.py`` GIF's
first frame, ``utils/tiff.py`` baseline TIFF (Pillow's own files, and
hand-built big-endian, tiled, planar, predictor-2, old-style LZW and
palette files from a small writer here), and
``models/vqvae.py::read_img`` picks between them by the file's magic bytes.
Each case holds the port's pixels against Pillow 12.1's
``Image.open(p).convert("RGB")`` and its ``read_img`` against the JAX
package's (which opens the file with Pillow).  Tolerance: byte-equal for
both formats, and ``read_img`` bit-equal.

Pillow writes neither interlaced PNGs nor every depth, so the PNG cases are
built by a raw writer here (zlib + struct, a seeded choice of row filter
per row).  Pillow writes only 4:4:4, 4:2:2 and 4:2:0 JPEGs, so the other
sampling factors, several scans, RGB and SOF1 files come from a small
baseline encoder here (a float DCT, flat Huffman tables).

Run as a script, it prints this machine's host-CPU time to decode a
256 x 256 and a 1024 x 768 baseline and progressive JPEG, WebP and TIFF:
``PYTHONPATH=. python tests/test_torch_image_io.py`` from the repository root.
"""

import io
import math
import struct
import sys
import time
import zlib

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from cogview_tpu.models import vqvae as jvq  # noqa: E402
from cogview_tpu_torch.models import vqvae  # noqa: E402
from cogview_tpu_torch.utils.bmp import decode_bmp  # noqa: E402
from cogview_tpu_torch.utils.gif import decode_gif  # noqa: E402
from cogview_tpu_torch.utils.image_errors import UnsupportedImageError  # noqa: E402
from cogview_tpu_torch.utils.jpeg import decode_jpeg  # noqa: E402
from cogview_tpu_torch.utils.png import decode_png, read_png  # noqa: E402
from cogview_tpu_torch.utils import webp  # noqa: E402

SIZES = ((1, 1), (3, 5), (9, 7), (37, 53))  # (height, width)
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
         (0, 1, 2, 2), (1, 0, 2, 1))


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _check_read_img(tmp_path, data: bytes, name: str = "img") -> None:
    """The port's read_img equals the JAX package's on the same file."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(vqvae.read_img(path, 64), jvq.read_img(path, 64))


# --------------------------------------------------------------------- #
# PNG
# --------------------------------------------------------------------- #


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(s: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, c] -> packed scanlines [h, stride] (big-endian 16-bit,
    sub-byte samples MSB first)."""
    h = s.shape[0]
    if depth == 16:
        return s.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, -1)
    bits = (s.reshape(h, -1)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(h, -1), axis=1)


def _filter_rows(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """The encoder side of the five PNG row filters, one type a row."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r, ftype in zip(range(rows.shape[0]), ftypes):
        line = rows[r].astype(np.int64)
        shift = np.zeros_like(line)
        a, c = shift.copy(), shift.copy()
        a[bpp:], c[bpp:] = line[:-bpp], prev[:-bpp]
        pred = {0: 0 * line, 1: a, 2: prev, 3: (a + prev) // 2}.get(ftype)
        if ftype == 4:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([ftype]) + ((line - pred) % 256).astype(np.uint8).tobytes())
        prev = line
    return b"".join(out)


def _png(samples: np.ndarray, depth: int, ctype: int, interlace: int = 0, extra: bytes = b"",
         seed: int = 0, ftypes=None) -> bytes:
    """A PNG of ``samples`` [h, w, channels]; each row's filter is drawn
    from a seeded generator unless ``ftypes`` (a function of the row count
    -> types) is given."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    rng = np.random.RandomState(seed)

    def rows(part):
        n = part.shape[0]
        types = ftypes(n) if ftypes else rng.randint(0, 5, n)
        return _filter_rows(_pack(part, depth), bpp, types)

    if interlace:
        raw = b"".join(rows(samples[y0::dy, x0::dx]) for y0, x0, dy, dx in ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = rows(samples)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + extra + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


PNG_CASES = [(hw, ctype, depth, interlace) for hw in SIZES for ctype in DEPTHS
             for depth in DEPTHS[ctype] for interlace in (0, 1)]


@pytest.mark.parametrize("hw,ctype,depth,interlace", PNG_CASES)
def test_png_every_colour_type_depth_and_interlace(tmp_path, hw, ctype, depth, interlace):
    h, w = hw
    rng = np.random.RandomState(h * 1000 + w * 10 + ctype + depth)
    samples = rng.randint(0, 1 << depth, (h, w, CHANNELS[ctype]))
    extra = b""
    if ctype == 3:  # a palette shorter than the index range at 8 bits
        n = min(1 << depth, 200)
        extra = _chunk(b"PLTE", rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes())
    data = _png(samples, depth, ctype, interlace, extra, seed=h + w)
    got = decode_png(data)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pillow(data))
    _check_read_img(tmp_path, data)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_png_palette_with_trns_and_indices_past_plte(tmp_path, depth):
    """tRNS is dropped; an index past the end of PLTE reads black (Pillow's
    palette holds 256 entries, zero past PLTE)."""
    n = (1 << depth) - 1 if depth < 8 else 5  # indices n.. lie past PLTE
    plte = np.arange(3 * n, dtype=np.uint8) * 7 + 11
    extra = _chunk(b"PLTE", plte.tobytes()) + _chunk(b"tRNS", bytes([0, 128, 255][:n]))
    idx = np.arange(9 * 7).reshape(9, 7, 1) % (1 << depth)
    data = _png(idx, depth, 3, extra=extra, seed=depth)
    got = decode_png(data)
    want = _pillow(data)
    np.testing.assert_array_equal(got, want)
    past = idx[..., 0] >= n
    assert past.any() and (got[past] == 0).all()
    np.testing.assert_array_equal(got[~past], plte.reshape(-1, 3)[idx[..., 0][~past]])
    _check_read_img(tmp_path, data)


@pytest.mark.parametrize("ctype,trns", [(0, struct.pack(">H", 1)),
                                        (2, struct.pack(">HHH", 1, 2, 3))])
def test_png_trns_is_dropped_for_gray_and_rgb(tmp_path, ctype, trns):
    samples = np.random.RandomState(4).randint(0, 4, (5, 6, CHANNELS[ctype]))
    data = _png(samples, 8, ctype, extra=_chunk(b"tRNS", trns))
    np.testing.assert_array_equal(decode_png(data), _pillow(data))
    np.testing.assert_array_equal(decode_png(data)[..., 0], samples[..., 0])
    _check_read_img(tmp_path, data)


def test_png_16_bit_gray_clamps():
    """Pillow opens 16-bit gray as I;16 and convert("RGB") saturates: it
    does not take the high byte."""
    samples = np.array([0, 255, 256, 1000, 65535]).reshape(1, 5, 1)
    data = _png(samples, 16, 0)
    got = decode_png(data)
    np.testing.assert_array_equal(got[0, :, 0], [0, 255, 255, 255, 255])
    np.testing.assert_array_equal(got, _pillow(data))


@pytest.mark.parametrize("ctype", [2, 4, 6])
def test_png_16_bit_colour_and_alpha_take_the_high_byte(ctype):
    c = CHANNELS[ctype]
    samples = np.array([0x1234, 0x807F, 0xFFFF, 0x00FF][:c]).reshape(1, 1, c)
    samples = np.repeat(samples, 3, axis=1)
    data = _png(samples, 16, ctype)
    got = decode_png(data)
    want = [0x12, 0x80, 0xFF] if ctype in (2, 6) else [0x12] * 3
    np.testing.assert_array_equal(got[0, 0], want)
    np.testing.assert_array_equal(got, _pillow(data))


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (3, 4), (0, 16), (2, 16),
                                         (4, 8), (6, 16)])
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_every_filter_type(ctype, depth, interlace):
    """Rows cycle through the five filters (None, Sub, Up, Average, Paeth)
    at every bytes-per-pixel, sub-byte rows included."""
    rng = np.random.RandomState(depth)
    samples = rng.randint(0, 1 << depth, (11, 13, CHANNELS[ctype]))
    extra = _chunk(b"PLTE", rng.randint(0, 256, 48).astype(np.uint8).tobytes()) \
        if ctype == 3 else b""
    data = _png(samples, depth, ctype, interlace, extra, ftypes=lambda n: np.arange(n) % 5)
    np.testing.assert_array_equal(decode_png(data), _pillow(data))


@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "I;16", "RGB", "RGBA"])
def test_png_as_pillow_writes_it(tmp_path, mode):
    """Every mode Pillow saves as PNG, with its own filter choices."""
    rng = np.random.RandomState(5)
    arr = rng.randint(0, 256, (37, 53, 4)).astype(np.uint8)
    if mode == "I;16":
        im = Image.fromarray((arr[..., 0].astype(np.uint16) * 257 // 3))
        im = im.convert("I;16") if im.mode != "I;16" else im
    elif mode in ("RGB", "RGBA", "LA"):
        im = Image.fromarray(arr[..., :len(mode)], mode)
    else:
        im = Image.fromarray(arr[..., :3], "RGB").convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_png(data), _pillow(data))
    _check_read_img(tmp_path, data)


# --------------------------------------------------------------------- #
# JPEG as Pillow writes it
# --------------------------------------------------------------------- #

JPEG_SIZES = ((1, 1), (3, 5), (9, 7), (17, 33), (37, 53))


def _picture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth ramps and a sine, with noise and a block of pure noise: both
    flat and busy blocks, and values that the IDCT clamps."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5 + y / 7)], -1)
    a = a + rng.randint(-40, 41, a.shape)
    a[h // 2:, :w // 3] = rng.randint(0, 256, a[h // 2:, :w // 3].shape)
    return np.clip(a, 0, 255).astype(np.uint8)


def _pillow_jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _check_jpeg(tmp_path, data: bytes) -> None:
    got = decode_jpeg(data)
    want = _pillow(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    _check_read_img(tmp_path, data, "img.jpg")


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_jpeg_qualities_and_subsampling(tmp_path, quality, subsampling):
    for h, w in JPEG_SIZES:
        data = _pillow_jpeg(_picture(h, w, h * 100 + w), quality=quality,
                            subsampling=subsampling)
        _check_jpeg(tmp_path, data)


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_grayscale(tmp_path, quality):
    for h, w in JPEG_SIZES:
        _check_jpeg(tmp_path, _pillow_jpeg(_picture(h, w, w)[..., 1], quality=quality))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
def test_jpeg_restart_markers(tmp_path, restart, subsampling):
    for h, w in ((9, 7), (37, 53), (40, 72)):
        data = _pillow_jpeg(_picture(h, w, 3), quality=75, subsampling=subsampling, **restart)
        assert b"\xff\xdd" in data  # DRI; the small sizes may hold one interval
        assert b"\xff\xd0" in data or h < 40
        _check_jpeg(tmp_path, data)


PROGRESSIVE_CASES = (
    [dict(quality=q, subsampling=sub) for sub in ("4:4:4", "4:2:2", "4:2:0")
     for q in (50, 75, 95)]
    + [dict(quality=q, gray=True) for q in (50, 75, 95)]
    + [dict(quality=75, subsampling=sub, **restart) for sub in ("4:4:4", "4:2:0")
       for restart in ({"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
                       {"restart_marker_rows": 1})]
    + [dict(quality=q, subsampling="4:2:0", optimize=True) for q in (50, 95)]
    + [dict(quality=80, gray=True, optimize=True, restart_marker_blocks=2)])


@pytest.mark.parametrize("case", PROGRESSIVE_CASES,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_progressive_jpeg_reads_as_pillow(tmp_path, case):
    """Pillow's progressive=True files (libjpeg's standard script: DC first
    and refinement, spectral bands of AC first scans with end-of-band runs,
    AC refinement with correction bits) at odd sizes, byte-equal."""
    case = dict(case)
    gray = case.pop("gray", False)
    for h, w in JPEG_SIZES + ((40, 72),):
        arr = _picture(h, w, h * 10 + w)
        data = _pillow_jpeg(arr[..., 2] if gray else arr, progressive=True, **case)
        assert b"\xff\xc2" in data
        _check_jpeg(tmp_path, data)


def test_jpeg_restart_markers_grayscale(tmp_path):
    data = _pillow_jpeg(_picture(37, 53, 8)[..., 0], quality=90, restart_marker_blocks=2)
    assert b"\xff\xd0" in data
    _check_jpeg(tmp_path, data)


# --------------------------------------------------------------------- #
# JPEG from a small baseline encoder: the files Pillow does not write
# --------------------------------------------------------------------- #

_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * math.pi / 16) / 2
    c[0] /= math.sqrt(2)
    return c


def _encode_jpeg(planes, sampling, quality_step=6, ids=(1, 2, 3), app=b"", sof=0xC0,
                 separate_scans=False, restart=0) -> bytes:
    """A baseline JPEG of ``planes`` (full-size uint8 planes, one a
    component, taken as they are: no colour conversion) with per-component
    (H, V) ``sampling``.  Chroma is subsampled by taking every H-th / V-th
    sample.  Flat Huffman tables: DC categories in 4 bits, every AC symbol
    in 8."""
    h, w = planes[0].shape
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    dct = _dct_matrix()
    quant = 2 + (np.add.outer(np.arange(8), np.arange(8)) * quality_step) // 4  # [8, 8]
    blocks = []
    for plane, (hs, vs) in zip(planes, sampling):
        dh, dw = -(-h * vs // vmax), -(-w * hs // hmax)
        sub = plane[::vmax // vs, ::hmax // hs][:dh, :dw].astype(np.float64)
        bh, bw = mcuy * vs, mcux * hs
        full = np.pad(sub, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode="edge") - 128.0
        tiles = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ij,abjk,lk->abil", dct, tiles, dct)
        blocks.append((np.round(coef / quant).astype(np.int64), dh, dw))
    zz = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
          34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
          37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

    def segment(m, body):
        return b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body

    def dht(tc, symbols, length):
        counts = [0] * 16
        counts[length - 1] = len(symbols)
        return bytes([tc << 4]) + bytes(counts) + bytes(symbols)

    def scan_units(comps):
        """The scan's blocks in stream order, grouped by MCU."""
        if len(comps) == 1:
            ci = comps[0]
            coef, dh, dw = blocks[ci]
            return [[(ci, coef[by, bx])] for by in range(-(-dh // 8)) for bx in range(-(-dw // 8))]
        return [[(ci, blocks[ci][0][my * sampling[ci][1] + v, mx * sampling[ci][0] + u])
                 for ci in comps for v in range(sampling[ci][1]) for u in range(sampling[ci][0])]
                for my in range(mcuy) for mx in range(mcux)]

    def entropy(units):
        out, bits, pred = bytearray(), [], {}

        def put(value, n):
            bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

        def flush():
            bits.extend([1] * (-len(bits) % 8))
            for i in range(0, len(bits), 8):
                byte = int("".join(map(str, bits[i:i + 8])), 2)
                out.append(byte)
                if byte == 0xFF:
                    out.append(0)
            bits.clear()

        def value(v):
            s = int(abs(v)).bit_length()
            return s, (v if v >= 0 else v + (1 << s) - 1)

        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                flush()
                out.extend(b"\xff" + bytes([0xD0 + (n // restart - 1) % 8]))
                pred = {}
            for ci, blk in unit:
                flat = blk.reshape(-1)[zz]
                s, bitsv = value(flat[0] - pred.get(ci, 0))
                pred[ci] = flat[0]
                put(_DC_SYMBOLS.index(s), 4)
                put(bitsv, s)
                run = 0
                last = max([k for k in range(1, 64) if flat[k]] or [0])
                for k in range(1, last + 1):
                    if flat[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        put(_AC_SYMBOLS.index(0xF0), 8)
                        run -= 16
                    s, bitsv = value(flat[k])
                    put(_AC_SYMBOLS.index((run << 4) | s), 8)
                    put(bitsv, s)
                    run = 0
                if last < 63:
                    put(_AC_SYMBOLS.index(0x00), 8)
        flush()
        return bytes(out)

    nc = len(planes)
    body = [b"\xff\xd8", app,
            segment(0xDB, bytes([0]) + bytes(int(q) for q in quant.reshape(-1)[zz])),
            segment(sof, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
                bytes([ids[i], (sampling[i][0] << 4) | sampling[i][1], 0]) for i in range(nc))),
            segment(0xC4, dht(0, _DC_SYMBOLS, 4) + dht(1, _AC_SYMBOLS, 8))]
    if restart:
        body.append(segment(0xDD, struct.pack(">H", restart)))
    for comps in ([[i] for i in range(nc)] if separate_scans else [list(range(nc))]):
        body.append(segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[i], 0x00]) for i in comps) + bytes([0, 63, 0])))
        body.append(entropy(scan_units(comps)))
    body.append(b"\xff\xd9")
    return b"".join(body)


JFIF = b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _adobe(transform: int) -> bytes:
    return b"\xff\xee" + struct.pack(">H", 14) + b"Adobe\x00\x64\x00\x00\x00\x00" + bytes(
        [transform])


SAMPLINGS = {
    "4:4:0": ((1, 2), (1, 1), (1, 1)),
    "4:1:1-like 2x2/1x2/2x1": ((2, 2), (1, 2), (2, 1)),
    "chroma above luma": ((1, 1), (2, 2), (2, 2)),
    "2x1/1x2/1x1": ((2, 1), (1, 2), (1, 1)),
    "all 2x2": ((2, 2), (2, 2), (2, 2)),
    "4:2:0": ((2, 2), (1, 1), (1, 1)),
}


@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_jpeg_any_sampling_factors_of_1_and_2(tmp_path, name):
    for h, w in ((1, 1), (2, 3), (9, 7), (17, 33), (37, 53)):
        planes = list(_picture(h, w, h + w).transpose(2, 0, 1))
        # an interleaved MCU holds at most 10 blocks: all 2x2 needs a scan
        # per component
        separate = sum(u * v for u, v in SAMPLINGS[name]) > 10
        _check_jpeg(tmp_path, _encode_jpeg(planes, SAMPLINGS[name], app=JFIF,
                                           separate_scans=separate))


@pytest.mark.parametrize("variant", ["separate scans", "restart 2", "SOF1", "Adobe RGB",
                                     "RGB ids", "Adobe YCbCr", "gray 2x2"])
def test_jpeg_encoder_variants(tmp_path, variant):
    """One scan per component, restarts in a 4:2:0 file, the extended
    sequential frame at 8 bits, and the colour space rules: an Adobe
    transform 0 or component ids 'R', 'G', 'B' mean RGB (no conversion),
    Adobe transform 1 means YCbCr."""
    planes = list(_picture(37, 53, 6).transpose(2, 0, 1))
    kw = {"separate scans": dict(separate_scans=True, app=JFIF),
          "restart 2": dict(restart=2, app=JFIF, sampling=SAMPLINGS["4:2:0"]),
          "SOF1": dict(sof=0xC1, app=JFIF),
          "Adobe RGB": dict(app=_adobe(0)),
          "RGB ids": dict(ids=(82, 71, 66)),
          "Adobe YCbCr": dict(app=_adobe(1)),
          "gray 2x2": dict(sampling=((2, 2),))}[variant]
    sampling = kw.pop("sampling", ((2, 1), (1, 1), (1, 1)))
    data = _encode_jpeg(planes[:len(sampling)], sampling, **kw)
    _check_jpeg(tmp_path, data)
    if variant in ("Adobe RGB", "RGB ids"):  # no colour conversion at 4:4:4 luma
        assert np.abs(decode_jpeg(data)[..., 0].astype(int) - planes[0]).mean() < 8


# --------------------------------------------------------------------- #
# rejected inputs, the magic bytes, the end-to-end query
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("sof,match", [(0xC6, "hierarchical progressive JPEG"),
                                       (0xCA, "arithmetic-coded progressive JPEG")])
def test_progressive_jpeg_raises_a_named_error(sof, match):
    """The progressive frames that still raise (Huffman SOF2 reads, above):
    hierarchical (SOF6) and arithmetic-coded (SOF10), in hand-made headers."""
    header = bytes([0xFF, sof]) + struct.pack(">HBHHB", 11, 8, 8, 8, 1) + b"\x01\x11\x00"
    with pytest.raises(ValueError, match=match):
        decode_jpeg(b"\xff\xd8" + header + b"\xff\xd9")


def test_cmyk_jpeg_raises_a_named_error(tmp_path):
    """A CMYK JPEG now reads as Pillow reads it (the cases below), and so
    does an arithmetic-coded one (tests/test_torch_image_formats.py); a
    four-component arithmetic-coded frame with no scan, which Pillow cannot
    load, raises a ValueError naming the frame, and is no named refusal."""
    buf = io.BytesIO()
    Image.fromarray(_picture(9, 7, 1)).convert("CMYK").save(buf, "JPEG")
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(vqvae.read_img(str(path)), jvq.read_img(str(path)))
    header = b"\xff\xc9" + struct.pack(">HBHHB", 20, 8, 8, 8, 4) + b"".join(
        bytes([k, 0x11, 0]) for k in range(1, 5))
    with pytest.raises(ValueError, match="arithmetic-coded") as err:
        decode_jpeg(b"\xff\xd8" + header + b"\xff\xd9")
    assert not isinstance(err.value, UnsupportedImageError)
    with pytest.raises(OSError):
        _pillow(b"\xff\xd8" + header + b"\xff\xd9")


@pytest.mark.parametrize("header,match", [
    (b"\xff\xc1" + struct.pack(">HBHHB", 11, 12, 8, 8, 1) + b"\x01\x11\x00", "12-bit JPEG"),
    (b"\xff\xc9" + struct.pack(">HBHHB", 11, 8, 8, 8, 1) + b"\x01\x11\x00", "arithmetic-coded"),
    (b"\xff\xc3" + struct.pack(">HBHHB", 11, 8, 8, 8, 1) + b"\x01\x11\x00", "lossless JPEG"),
])
def test_other_jpeg_frames_raise_named_errors(header, match):
    with pytest.raises(ValueError, match=match):
        decode_jpeg(b"\xff\xd8" + header + b"\xff\xd9")


def test_adobe_transform_2_and_oversized_mcus_raise():
    """A three-component file with Adobe transform 2 (a four-component
    transform) now reads as YCbCr, byte-equal to Pillow, as libjpeg reads
    it; an interleaved MCU of more than 10 blocks raises as libjpeg (and so
    Pillow) refuses it."""
    planes = list(_picture(9, 7, 3).transpose(2, 0, 1))
    _check_pillow(decode_jpeg, _encode_jpeg(planes, ((1, 1),) * 3, app=_adobe(2)))
    data = _encode_jpeg(planes, ((2, 2),) * 3, app=JFIF)
    with pytest.raises(ValueError, match="10 blocks"):
        decode_jpeg(data)
    with pytest.raises(OSError):
        _pillow(data)


@pytest.mark.parametrize("fmt", ["GIF", "BMP", "TIFF", "text"])
def test_other_files_raise_an_error_naming_what_is_read(tmp_path, fmt):
    """GIF, BMP and TIFF now read, by their magic bytes, as the JAX
    package reads them; other bytes raise a ``ValueError`` naming what is
    read."""
    path = tmp_path / "img.png"  # the name is not what decides
    if fmt == "text":
        path.write_bytes(b"not an image\n")
    else:
        Image.fromarray(_picture(9, 7, 2)).save(str(path), fmt)
    if fmt in ("GIF", "BMP", "TIFF"):
        np.testing.assert_array_equal(vqvae.read_img(str(path)), jvq.read_img(str(path)))
        return
    with pytest.raises(ValueError, match="PNG .* or baseline JPEG"):
        vqvae.read_img(str(path))


def test_read_img_chooses_by_magic_bytes(tmp_path):
    """A JPEG named .png and a PNG named .jpg read as what they hold."""
    arr = _picture(40, 72, 4)
    jpg = _pillow_jpeg(arr, quality=80)
    png = _png(arr, 8, 2)
    for data, name in ((jpg, "really_a_jpeg.png"), (png, "really_a_png.jpg")):
        path = tmp_path / name
        path.write_bytes(data)
        np.testing.assert_array_equal(vqvae.read_img(str(path), 32), jvq.read_img(str(path), 32))
    np.testing.assert_array_equal(read_png(str(tmp_path / "really_a_png.jpg")), arr)


def test_image_query_context_tokens_match_jax(tmp_path):
    """An [Image] query of image->text and of low-level super-resolution at
    the tiny width: the context tokens the port's tokenizer makes from a
    JPEG, a palette PNG and an interlaced 16-bit PNG equal the JAX
    package's."""
    import jax

    from cogview_tpu.generation import tasks as jtasks
    from cogview_tpu.tokenization.unified import UnifiedTokenizer as JaxUnified
    from cogview_tpu.tokenization.vq_tokenizer import JaxVQTokenizer
    from cogview_tpu_torch.config import VQVAEConfig
    from cogview_tpu_torch.generation import tasks as ttasks
    from cogview_tpu_torch.models.bridge import vqvae_params_from_jax
    from cogview_tpu_torch.tokenization.unified import UnifiedTokenizer
    from cogview_tpu_torch.tokenization.vq_tokenizer import TorchVQTokenizer

    class TinyTextTok:
        num_tokens = 64

        def encode(self, s):
            return [ord(c) % 64 for c in s]

        def decode(self, ids):
            return "".join(chr(97 + (i % 26)) for i in ids)

    vq = dict(channel=16, embed_dim=8, n_embed=32)
    jvqp = jvq.init_params(jax.random.PRNGKey(1), jvq.VQVAEConfig(**vq))
    jtok = JaxUnified(img_tokenizer=JaxVQTokenizer(jvqp, jvq.VQVAEConfig(**vq)),
                      txt_tokenizer=TinyTextTok())
    ttok = UnifiedTokenizer(
        img_tokenizer=TorchVQTokenizer(vqvae_params_from_jax(jax.tree.map(np.asarray, jvqp)),
                                       VQVAEConfig(**vq)),
        txt_tokenizer=TinyTextTok())
    arr = _picture(300, 260, 5)
    rng = np.random.RandomState(6)
    files = {
        "photo.jpg": _pillow_jpeg(arr, quality=85, subsampling="4:2:0"),
        "palette.png": _png(rng.randint(0, 16, (120, 200, 1)), 4, 3, extra=_chunk(
            b"PLTE", rng.randint(0, 256, 48).astype(np.uint8).tobytes())),
        "deep.png": _png(rng.randint(0, 65536, (90, 70, 3)), 16, 2, interlace=1),
    }
    for name, data in files.items():
        path = tmp_path / name
        path.write_bytes(data)
        for task, raw in (("image2text", str(path)),
                          ("low-level super-resolution", "ab cd\t" + str(path))):
            want = jtasks.parse_query_line(raw, task, jtok)
            got = ttasks.parse_query_line(raw, task, ttok)
            assert len(got) == len(want) > 256, (name, task)
            assert list(got) == list(want), (name, task)


# --------------------------------------------------------------------- #
# CMYK / YCCK JPEG, BMP and GIF: byte-equal to Pillow's convert("RGB")
# --------------------------------------------------------------------- #


def _check_pillow(decode, data: bytes) -> None:
    """The port's pixels equal Pillow's, or both refuse the file."""
    try:
        want = _pillow(data)
    except (OSError, ValueError, SyntaxError):
        with pytest.raises(ValueError):
            decode(data)
        return
    got = decode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"quality": 50}, {"subsampling": "4:2:0"},
                                {"progressive": True}, {"progressive": True, "quality": 95}],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_cmyk_jpeg_as_pillow_writes_it(tmp_path, kw):
    """Pillow's CMYK files (Adobe marker, transform 0), baseline and
    progressive, at odd sizes."""
    for h, w in JPEG_SIZES:
        cmyk = Image.fromarray(_picture(h, w, h + w)).convert("CMYK")
        buf = io.BytesIO()
        cmyk.save(buf, "JPEG", **kw)
        assert b"Adobe" in buf.getvalue()
        _check_jpeg(tmp_path, buf.getvalue())


@pytest.mark.parametrize("app,sampling", [
    (b"", ((1, 1),) * 4), (_adobe(0), ((2, 2), (1, 1), (1, 1), (1, 1))),
    (_adobe(2), ((2, 2), (1, 1), (1, 1), (2, 2))), (_adobe(1), ((1, 1),) * 4),
    (JFIF + _adobe(2), ((2, 1), (1, 1), (1, 1), (1, 1)))],
    ids=["no marker", "transform 0", "transform 2", "transform 1", "JFIF + transform 2"])
def test_four_component_jpeg_colour_spaces(tmp_path, app, sampling):
    """Four components from the small encoder: no Adobe marker and
    transform 0 are CMYK, transform 2 (and 1) YCCK, as libjpeg decides."""
    for h, w in ((1, 1), (9, 7), (37, 53)):
        arr = _picture(h, w, 5 * h + w)
        planes = list(np.concatenate([arr, arr[..., :1] // 2 + 64], -1).transpose(2, 0, 1))
        _check_jpeg(tmp_path, _encode_jpeg(planes, sampling, ids=(1, 2, 3, 4), app=app))


def _bmp(pix: bytes, w: int, h: int, bits: int, *, header: int = 40, compression: int = 0,
         palette: bytes = b"", masks=(), colors: int = 0, topdown: bool = False) -> bytes:
    """A BMP file around ``pix`` (rows already in file order and padded)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if topdown else h, 1, bits,
                           compression, len(pix), 2835, 2835, colors, 0)
        tail = b"".join(struct.pack("<I", m) for m in masks) if header > 40 else b""
        info += (tail + bytes(header - 40))[:header - 40]
        if header == 40:
            info += b"".join(struct.pack("<I", m) for m in masks)
    offset = 14 + len(info) + len(palette)
    return b"BM" + struct.pack("<IHHI", offset + len(pix), 0, 0, offset) + info + palette + pix


def _rows(idx_or_bytes: np.ndarray, bits: int, topdown=False) -> bytes:
    """[h, w] indices (bits <= 8) or [h, w*k] bytes -> padded rows, bottom-up
    unless ``topdown``."""
    a = np.asarray(idx_or_bytes)
    if bits < 8:
        per = 8 // bits
        a = np.pad(a, ((0, 0), (0, -a.shape[1] % per)))
        a = a.reshape(a.shape[0], -1, per)
        a = sum(a[..., i].astype(np.uint8) << (8 - bits * (i + 1)) for i in range(per))
    a = a.astype(np.uint8)
    a = np.pad(a, ((0, 0), (0, -a.shape[1] % 4)))
    return (a if topdown else a[::-1]).tobytes()


def _rle8(idx: np.ndarray, rle4=False) -> bytes:
    """Bottom-up RLE: encoded runs, an absolute run, a delta and EOLs."""
    out = bytearray()
    h, w = idx.shape
    for y, row in enumerate(idx[::-1]):
        x = 0
        if y == 1 and w > 4:  # a delta of 2 right in row 1 (Pillow reads 4 bytes)
            out += bytes([0, 2, 0, 0, 2, 0])
            x = 2
        while x < w:
            if w - x >= 4 and x % 2 == 0:  # an absolute run of up to 4 pixels
                n = min(w - x, 4) & ~1 if rle4 else min(w - x, 3)
                vals = row[x:x + n]
                if rle4:
                    out += bytes([0, n]) + bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
                    pad = (n // 2) % 2
                else:
                    out += bytes([0, n]) + bytes(int(v) for v in vals)
                    pad = n % 2
                out += bytes(pad)
                x += n
                continue
            n = 1
            while x + n < w and row[x + n] == row[x] and n < 255:
                n += 1
            v = int((row[x] << 4) | row[x] if rle4 else row[x])
            out += bytes([n, v])
            x += n
        out += bytes([0, 0])
    return bytes(out + bytes([0, 1]))


def _bmp_cases(h: int, w: int, rng):
    """(name, file) of every BMP variant at h x w."""
    out = []
    for bits in (1, 4, 8):
        ncol = 1 << bits
        for colors, top in ((0, False), (3, True)):
            pal = rng.randint(0, 256, ((colors or ncol), 4)).astype(np.uint8).tobytes()
            idx = rng.randint(0, ncol, (h, w))
            for hdr in (40, 124, 12):
                if hdr == 12 and top:
                    continue
                p = pal if hdr != 12 else np.frombuffer(pal, np.uint8).reshape(-1, 4)[:, :3].tobytes()
                out.append((f"{bits}-bit colors={colors} topdown={top} header={hdr}",
                            _bmp(_rows(idx, bits, top), w, h, bits, header=hdr, palette=p,
                                 colors=colors, topdown=top)))
        if bits > 1:
            pal = rng.randint(0, 256, (ncol, 4)).astype(np.uint8).tobytes()
            out.append((f"RLE{bits}", _bmp(_rle8(rng.randint(0, 3, (h, w)), bits == 4), w, h,
                                           bits, compression=2 if bits == 4 else 1, palette=pal)))
    gray = b"".join(bytes([i, i, i, 0]) for i in range(256))
    out += [("gray 8-bit", _bmp(_rows(rng.randint(0, 256, (h, w)), 8), w, h, 8, palette=gray)),
            ("gray 1-bit", _bmp(_rows(rng.randint(0, 2, (h, w)), 1), w, h, 1,
                                palette=bytes(4) + bytes([255] * 3 + [0]))),
            ("gray 4-bit (Pillow refuses)", _bmp(_rows(rng.randint(0, 16, (h, w)), 4), w, h, 4,
                                                 palette=gray[:64]))]
    px16 = rng.randint(0, 65536, (h, w)).astype("<u2").view(np.uint8).reshape(h, 2 * w)
    out.append(("16-bit", _bmp(_rows(px16, 8), w, h, 16)))
    for masks in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F), (0xF00, 0xF0, 0xF)):
        for hdr in (40, 56, 124):
            out.append((f"16-bit bitfields {masks} header={hdr}",
                        _bmp(_rows(px16, 8), w, h, 16, compression=3, header=hdr,
                             masks=masks + ((0,) if hdr > 40 else ()))))
    out.append(("24-bit top-down", _bmp(_rows(rng.randint(0, 256, (h, 3 * w)), 8, True), w, h,
                                         24, topdown=True)))
    px32 = rng.randint(0, 256, (h, 4 * w))
    out.append(("32-bit", _bmp(_rows(px32, 8), w, h, 32)))
    for masks in ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                  (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
                  (0, 0, 0, 0)):
        out.append((f"32-bit bitfields {masks}",
                    _bmp(_rows(px32, 8), w, h, 32, compression=3, masks=masks, header=124)))
    return out


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (9, 7), (17, 33)], ids=str)
def test_bmp_every_depth_compression_and_header(hw):
    """BI_RGB at 1/4/8 (palettes, short ones, gray ones Pillow drops),
    16/24/32 bits, BI_BITFIELDS (Pillow's masks, and one it refuses), RLE8
    and RLE4 with a delta and absolute runs, top-down and bottom-up, the
    core, info, v3 and v5 headers; equal to Pillow or refused by both."""
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    for name, data in _bmp_cases(*hw, rng):
        try:
            _check_pillow(decode_bmp, data)
        except AssertionError as e:
            raise AssertionError(name) from e


@pytest.mark.parametrize("mode", ["RGB", "P", "L", "1", "RGBA"])
def test_bmp_as_pillow_writes_it(tmp_path, mode):
    for h, w in ((1, 1), (9, 7), (37, 53)):
        im = Image.fromarray(_picture(h, w, h * w))
        im = im.quantize(7) if mode == "P" else im.convert(mode)
        buf = io.BytesIO()
        im.save(buf, "BMP")
        _check_pillow(decode_bmp, buf.getvalue())
        _check_read_img(tmp_path, buf.getvalue(), "img.bmp")



def _lzw_encode(idx, bits, clear_every=0):
    """Plain LZW (codes LSB-first) with a clear code first, optional clears."""
    clear, end = 1 << bits, (1 << bits) + 1
    out, acc, nacc = bytearray(), 0, 0
    size = bits + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, end + 1

    put(clear)
    table, nxt = reset()
    w = b""
    for k, v in enumerate(bytes(int(x) for x in idx)):
        if clear_every and k and k % clear_every == 0 and w:
            put(table[w]); put(clear)
            table, nxt = reset(); size = bits + 1; w = b""
        wc = w + bytes([v])
        if wc in table:
            w = wc
            continue
        put(table[w])
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt - 1 == (1 << size) and size < 12:
                size += 1
        w = bytes([v])
    if w:
        put(table[w])
    put(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _blocks(b):
    return b"".join(bytes([len(b[i:i + 255])]) + b[i:i + 255] for i in range(0, len(b), 255)) + b"\x00"


def _gif(frame, sw, sh, *, x0=0, y0=0, gpal=None, lpal=None, interlace=False, trns=None,
         bits=None, extra=b"", clear_every=0, end=b";"):
    """A GIF89a of one frame ([fh, fw] indices) at (x0, y0) on an sw x sh screen."""
    fh, fw = frame.shape
    def pal_flags(p):
        n = len(p) // 3
        return 0x80 | (n.bit_length() - 2)
    head = b"GIF89a" + struct.pack("<HH", sw, sh) + bytes([pal_flags(gpal) if gpal else 0, 0, 0])
    head += gpal or b""
    head += extra
    if trns is not None:
        head += b"!\xf9\x04" + bytes([1, 0, 0, trns]) + b"\x00"
    rows = frame
    if interlace:
        order = [r for s, st in ((0, 8), (4, 8), (2, 4), (1, 2)) for r in range(s, fh, st)]
        rows = frame[order]
    flags = (pal_flags(lpal) if lpal else 0) | (0x40 if interlace else 0)
    desc = b"," + struct.pack("<HHHH", x0, y0, fw, fh) + bytes([flags]) + (lpal or b"")
    if bits is None:
        bits = max(2, int(frame.max()).bit_length())
    return head + desc + bytes([bits]) + _blocks(_lzw_encode(rows.reshape(-1), bits, clear_every)) + end


@pytest.mark.parametrize("ncol", [2, 4, 16, 256])
def test_gif_palettes_interlace_transparency_and_frames(ncol):
    """Global and local palettes, a gray palette Pillow drops, none at all,
    interlace, a transparent index, a frame offset on a larger screen and
    one that overhangs it, clear codes mid-stream and a comment; equal to
    Pillow."""
    rng = np.random.RandomState(ncol)

    def pal(n):
        return rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()

    gray = bytes(np.repeat(np.arange(ncol, dtype=np.uint8), 3))
    for h, w in ((1, 1), (3, 5), (9, 7), (17, 33), (64, 80)):
        fr = rng.randint(0, ncol, (h, w))
        for data in (_gif(fr, w, h, gpal=pal(ncol)),
                     _gif(fr, w, h, gpal=pal(ncol), lpal=pal(ncol), interlace=True),
                     _gif(fr, w + 3, h + 2, x0=2, y0=1, gpal=pal(ncol), trns=1),
                     _gif(fr, w + 3, h + 2, x0=2, y0=1, gpal=pal(ncol)),
                     _gif(fr, max(1, w - 2), h, x0=1, lpal=pal(ncol)),
                     _gif(fr, w, h),
                     _gif(fr, w, h, gpal=pal(ncol), clear_every=7, extra=b"!\xfe\x03abc\x00"),
                     _gif(fr, w, h, gpal=gray)):
            _check_pillow(decode_gif, data)


def test_gif_short_palette_truncation_and_pillow_files(tmp_path):
    """Indices past a two-entry palette, files cut short (both refuse), and
    Pillow's own GIFs of P, L and RGB images with and without transparency,
    through ``read_img`` as well."""
    rng = np.random.RandomState(7)
    for h, w in ((1, 1), (9, 7), (64, 80)):
        _check_pillow(decode_gif, _gif(rng.randint(0, 4, (h, w)), w, h,
                                       gpal=bytes(range(6)), bits=2))
        data = _gif(rng.randint(0, 16, (h, w)), w, h, gpal=bytes(range(48)))
        _check_pillow(decode_gif, data[:len(data) // 2 + 20])
    for mode in ("P", "L", "RGB"):
        im = Image.fromarray(_picture(33, 47, 3))
        im = im.quantize(50) if mode == "P" else im.convert(mode)
        for kw in ({}, {"transparency": 3}):
            buf = io.BytesIO()
            im.save(buf, "GIF", **kw)
            _check_pillow(decode_gif, buf.getvalue())
            _check_read_img(tmp_path, buf.getvalue(), "img.gif")


@pytest.mark.parametrize("fmt", ["WEBP", "TIFF", "ICO", "PPM", "JPEG2000", "PSD", "QOI"])
def test_formats_pillow_reads_raise_a_named_error(fmt):
    """Files Pillow reads and the port does not: an ``UnsupportedImageError``
    naming the format, on a file Pillow writes and reads back.  PNM, QOI,
    WebP, TIFF, ICO and PSD are read now: Pillow's own files (a PSD built
    here, since Pillow writes none) decode byte-equal to it."""
    if fmt in ("PPM", "QOI", "WEBP", "TIFF", "ICO"):
        _check_pillow(vqvae.decode_image, _encoded_by_pillow(fmt))
        return
    if fmt == "PSD":  # 8-bit RGB, raw: header, empty sections, the composite
        planes = _picture(5, 7, 2).transpose(2, 0, 1)
        _check_pillow(vqvae.decode_image, b"8BPS\x00\x01" + bytes(6) + struct.pack(
            ">HIIHH", 3, 5, 7, 8, 3) + bytes(12) + b"\x00\x00" + planes.tobytes())
        return
    data = _encoded_by_pillow(fmt)  # JPEG 2000: a file Pillow reads, so named
    Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(UnsupportedImageError, match="JPEG 2000"):
        vqvae.decode_image(data)


def _encoded_by_pillow(fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_picture(16, 16, 1)).save(buf, fmt)
    return buf.getvalue()


# --------------------------------------------------------------------- #
# PNM, QOI and the three-component Adobe-transform-2 JPEG: byte-equal to
# Pillow's convert("RGB")
# --------------------------------------------------------------------- #


def _plain(values, per_line=7, comment_every=0) -> bytes:
    out, line = [], []
    for i, v in enumerate(np.asarray(values).ravel().tolist()):
        line.append(str(v))
        if len(line) == per_line:
            out.append(" ".join(line))
            line = []
        if comment_every and i % comment_every == comment_every - 1:
            out.append("# a comment between values")
    if line:
        out.append(" ".join(line))
    return ("\n".join(out) + "\n").encode()


PNM_SIZES = ((1, 1), (3, 5), (9, 7), (17, 13))


@pytest.mark.parametrize("maxval", [1, 7, 100, 255, 256, 1000, 65535])
def test_pnm_gray_every_maxval(maxval):
    """P2 (plain) and P5 (raw) at maxvals that take Pillow's three routes:
    255 as it is, 65535 as 16-bit "I", any other scaled (to 65535 above
    255, then clipped by the RGB conversion)."""
    rng = np.random.RandomState(maxval)
    for h, w in PNM_SIZES:
        v = rng.randint(0, maxval + 1, (h, w))
        head = b"%d %d\n%d\n" % (w, h, maxval)
        _check_pillow(vqvae.decode_image, b"P2\n" + head + _plain(v, 5, 11))
        raw = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
        _check_pillow(vqvae.decode_image, b"P5\n" + head + raw)


@pytest.mark.parametrize("maxval", [1, 15, 255, 300, 4095, 65535])
def test_pnm_colour_every_maxval(maxval):
    rng = np.random.RandomState(maxval + 1)
    for h, w in PNM_SIZES:
        v = rng.randint(0, maxval + 1, (h, w, 3))
        head = b"%d %d %d\n" % (w, h, maxval)
        _check_pillow(vqvae.decode_image, b"P3 " + head + _plain(v, 9, 17))
        raw = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
        _check_pillow(vqvae.decode_image, b"P6\t" + head + raw)


def test_pnm_bitmaps():
    """P1 with and without whitespace between bits and with comments; P4
    at widths that are no multiple of 8 (each row padded to a byte)."""
    rng = np.random.RandomState(3)
    for h, w in PNM_SIZES + ((2, 8), (3, 9)):
        bits = rng.randint(0, 2, (h, w))
        head = b"%d %d\n" % (w, h)
        _check_pillow(vqvae.decode_image, b"P1\n" + head + _plain(bits, 4, 9))
        dense = b"".join(b"".join(b"%d" % x for x in row) + b"\n" for row in bits)
        _check_pillow(vqvae.decode_image, b"P1\n# made by hand\n" + head + dense)
        packed = np.packbits(bits.astype(np.uint8), axis=1).tobytes()
        _check_pillow(vqvae.decode_image, b"P4\n" + head + packed)


def test_pnm_headers_and_refusals():
    """Comments and runs of whitespace in the header, raw values above
    maxval (Pillow clamps them), Pillow's own files, and the files both
    refuse: a truncated raster, a plain value above maxval, a bitmap byte
    other than 0 or 1, maxval 0, an unknown magic."""
    v = np.arange(12).reshape(3, 4)
    for data in (b"P2 #c\n 4\t3 # w h\n\n15 " + _plain(v),
                 b"P5\n4 3\n100\n" + bytes([0, 50, 100, 101, 200, 255] * 2),
                 b"P6\n1 2\n65535\n" + bytes(range(12)),
                 b"P5\n4 3\n255\n" + bytes(11),
                 b"P2\n2 1\n5\n3 6\n",
                 b"P1\n2 1\n1 2\n",
                 b"P5\n2 1\n0\n\x00\x00",
                 b"P8\n2 1\n255\n\x00\x00"):
        _check_pillow(vqvae.decode_image, data)
    pic = _picture(9, 7, 4)
    for mode in ("1", "L", "I;16", "RGB"):
        im = Image.fromarray(pic).convert("L" if mode == "I;16" else mode)
        if mode == "I;16":
            im = Image.fromarray(pic[..., 0].astype(np.uint16) * 257)
        buf = io.BytesIO()
        im.save(buf, "PPM")
        _check_pillow(vqvae.decode_image, buf.getvalue())


def _qoi(w: int, h: int, channels: int, ops: bytes) -> bytes:
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops + bytes(7) + b"\x01"


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi_as_pillow_writes_it(mode):
    """Pillow's QOI files (every op: runs of flat colour, small and luma
    differences, index hits and whole pixels) at odd sizes."""
    for h, w in ((1, 1), (9, 7), (37, 53)):
        pic = _picture(h, w, h * w)
        pic[: h // 2, : w // 2] = 40  # runs
        if mode == "RGBA":
            alpha = np.where(np.arange(w)[None, :] % 3 == 0, 255, 7 * np.arange(h)[:, None] % 256)
            pic = np.concatenate([pic, alpha[..., None].astype(np.uint8)], -1)
        buf = io.BytesIO()
        Image.fromarray(pic, mode).save(buf, "QOI")
        _check_pillow(vqvae.decode_image, buf.getvalue())


def test_qoi_hand_built_ops():
    """The ops Pillow's writer does not emit alike: an INDEX into an empty
    slot (0, 0, 0, 0), RGB keeping the previous alpha, a RUN past the last
    pixel, a channel count other than 3 or 4 (read as RGBA); a truncated
    stream raises."""
    ops = bytes([0xFF, 10, 20, 30, 40, 0x05, 0xFE, 1, 2, 3, 0x40 | 0x1B, 0x80 | 40, 0x9A,
                 0xC0 | 9])
    for channels in (3, 4, 5):
        _check_pillow(vqvae.decode_image, _qoi(4, 3, channels, ops))
    with pytest.raises(ValueError, match="QOI"):
        vqvae.decode_image(_qoi(4, 3, 3, ops)[:20])


@pytest.mark.parametrize("sampling", [((1, 1),) * 3, ((2, 2), (1, 1), (1, 1)),
                                      ((2, 1), (1, 1), (1, 1))],
                         ids=["4:4:4", "4:2:0", "4:2:2"])
def test_three_component_adobe_transform_2_reads_as_ycbcr(tmp_path, sampling):
    """libjpeg reads three components under an Adobe transform 2 as YCbCr
    (with a warning), and so does the port, at odd sizes."""
    for h, w in ((1, 1), (9, 7), (37, 53)):
        planes = list(_picture(h, w, 3 * h + w).transpose(2, 0, 1))
        data = _encode_jpeg(planes, sampling, app=_adobe(2))
        _check_pillow(decode_jpeg, data)
        _check_read_img(tmp_path, data, "img.jpg")


# --------------------------------------------------------------------- #
# WebP: byte-equal to Pillow's convert("RGB") (libwebp's WebPAnimDecoder)
# --------------------------------------------------------------------- #


def _webp(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _counting(monkeypatch, names) -> dict:
    """Wrap the webp module's functions ``names`` to count their calls (and
    keep the arguments) -> name -> list of argument tuples."""
    calls = {n: [] for n in names}
    for n in names:
        obj, attr = (webp._ColorCache, "lookup") if n == "cache" else (webp, n)
        fn = getattr(obj, attr)

        def wrapper(*a, _fn=fn, _n=n, **kw):
            calls[_n].append(a)
            return _fn(*a, **kw)

        monkeypatch.setattr(obj, attr, wrapper)
    return calls


def _few_colours(h: int, w: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    pal = rng.randint(0, 256, (n, 3))
    y, x = np.mgrid[0:h, 0:w]
    return pal[(x // 3 + y // 2 + rng.randint(0, 2, (h, w))) % n].astype(np.uint8)


def test_webp_lossless_every_transform_and_the_colour_cache(monkeypatch):
    """Pillow's lossless files of busy and smooth pictures at every method:
    between them the predictor (its modes), cross-colour, subtract-green
    and colour-indexing transforms, the colour cache and backward
    references all run, and every file equals Pillow's pixels."""
    calls = _counting(monkeypatch, ["_inverse_predictor", "_inverse_cross_color",
                                    "_inverse_subtract_green", "_inverse_color_index",
                                    "_copy_distance", "cache"])
    pictures = [_picture(48, 64, 1), _picture(31, 45, 2), _few_colours(40, 56, 40, 3)]
    tiled = np.tile(_picture(8, 8, 4), (6, 8, 1))
    pictures.append(tiled)
    for arr in pictures:
        for method in (0, 4, 6):
            _check_pillow(webp.decode_webp, _webp(arr, lossless=True, method=method))
    assert all(calls[n] for n in calls), {n: len(v) for n, v in calls.items()}
    modes = set()
    for img, bits, data in calls["_inverse_predictor"]:
        modes |= set(((np.asarray(data) >> 8) & 0xF).ravel().tolist())
    assert len(modes) >= 8, modes  # many of the 14 predictors


@pytest.mark.parametrize("ncolours,bits", [(2, 3), (4, 2), (16, 1), (256, 0)])
def test_webp_lossless_colour_indexing_bundles_pixels(monkeypatch, ncolours, bits):
    """A palette of 2, 4, 16 and 256 colours: 8, 4, 2 and 1 pixels a byte."""
    calls = _counting(monkeypatch, ["_inverse_color_index"])
    for h, w in ((1, 1), (7, 5), (37, 61)):
        arr = _few_colours(h, w, ncolours, ncolours)
        if h * w >= ncolours:  # every colour used, so the palette has them all
            arr.reshape(-1, 3)[:ncolours] = np.random.RandomState(ncolours).randint(
                0, 256, (ncolours, 3))
        _check_pillow(webp.decode_webp, _webp(arr, lossless=True))
    assert bits in {c[1] for c in calls["_inverse_color_index"]}


@pytest.mark.parametrize("method", [0, 6])
@pytest.mark.parametrize("quality", [5, 50, 95])
def test_webp_lossy_qualities_and_methods(monkeypatch, quality, method):
    """Lossy files through the 16x16, 4x4 and chroma predictors, the token
    decoder, the IDCT and WHT and the normal loop filter, then the fancy
    upsampler: equal to Pillow's pixels."""
    calls = _counting(monkeypatch, ["_pred4", "_pred_block", "_edge"])
    for h, w in ((64, 64), (40, 56)):
        _check_pillow(webp.decode_webp, _webp(_picture(h, w, quality + method),
                                              quality=quality, method=method))
    assert calls["_pred_block"] and calls["_edge"]
    if method == 6 or quality == 95:  # method 0 below 95 writes 16x16 modes only
        assert {c[0] for c in calls["_pred4"]} == set(range(10))


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (8, 1), (2, 2), (3, 5), (17, 33), (31, 16)])
def test_webp_odd_sizes(hw):
    """Widths and heights where the upsampler's last column and row and the
    4x4 prediction's above-right pixels at a macroblock row's end matter."""
    h, w = hw
    arr = _picture(h, w, h * 7 + w)
    for kw in ({"quality": 80}, {"quality": 30, "method": 6}, {"lossless": True}):
        _check_pillow(webp.decode_webp, _webp(arr, **kw))


def test_webp_all_4x4_modes_at_macroblock_edges(monkeypatch):
    """Busy pictures at high quality take every 4x4 mode, including on the
    right column of the last macroblock of a row and in the first row."""
    calls = _counting(monkeypatch, ["_pred4"])
    rng = np.random.RandomState(11)
    for seed in range(3):
        arr = np.clip(_picture(48, 40, seed).astype(int)
                      + rng.randint(-60, 61, (48, 40, 3)), 0, 255).astype(np.uint8)
        _check_pillow(webp.decode_webp, _webp(arr, quality=95, method=seed * 3))
    assert {c[0] for c in calls["_pred4"]} == set(range(10))


@pytest.mark.parametrize("kw", [{"quality": 70}, {"quality": 70, "alpha_quality": 50},
                                {"quality": 70, "alpha_quality": 100, "method": 0},
                                {"lossless": True}, {"lossless": True, "exact": True},
                                {"quality": 60, "exact": True}])
def test_webp_rgba_alpha_is_checked_and_dropped(monkeypatch, kw):
    """RGBA pictures: lossy with an ALPH chunk (compressed or not), decoded
    for its validity and dropped; lossless with its own alpha."""
    calls = _counting(monkeypatch, ["_check_alpha"])
    arr = _picture(29, 38, 5)
    alpha = np.clip(np.arange(29 * 38).reshape(29, 38) * 3 % 300, 0, 255).astype(np.uint8)
    alpha[:10, :10] = 0
    data = _webp(np.dstack([arr, alpha]), **kw)
    assert data[12:16] == (b"VP8X" if not kw.get("lossless") else b"VP8L")
    _check_pillow(webp.decode_webp, data)
    assert bool(calls["_check_alpha"]) == (not kw.get("lossless"))
    # a corrupt ALPH chunk: both refuse
    if not kw.get("lossless"):
        i = data.index(b"ALPH") + 8
        bad = data[:i] + bytes([data[i] | 0xC0]) + data[i + 1:]
        _check_pillow(webp.decode_webp, bad)


def _riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _webp_chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def _image_chunks(data: bytes) -> bytes:
    """The ALPH, VP8 or VP8L chunks of a file Pillow wrote."""
    pos, out = 12, b""
    while pos < len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        end = pos + 8 + size + (size & 1)
        if data[pos:pos + 4] in (b"ALPH", b"VP8 ", b"VP8L"):
            out += data[pos:end]
        pos = end
    return out


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _webp_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little"))


@pytest.mark.parametrize("kw", [{"quality": 75}, {"lossless": True}, {"quality": 75, "rgba": 1}])
def test_webp_animation_first_frame_at_its_offset(kw):
    """An animation whose first frame (lossy, lossless, or lossy with ALPH)
    lies at an offset on a larger canvas, with a second frame after it: the
    canvas is transparent black around the first frame, as libwebp's
    WebPAnimDecoder leaves it.  Also Pillow's own animated file."""
    kw = dict(kw)
    rgba = kw.pop("rgba", 0)
    arr = _picture(21, 27, 8)
    if rgba:
        arr = np.dstack([arr, np.full(arr.shape[:2], 200, np.uint8)])
    first = _image_chunks(_webp(arr, **kw))
    second = _image_chunks(_webp(_picture(10, 10, 9), **kw))

    def anmf(x, y, w, h, chunks):
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + b"\x00")
        return _webp_chunk(b"ANMF", head + chunks)

    flags = 0x02 | (0x10 if rgba or kw.get("lossless") else 0)
    for x, y in ((0, 0), (6, 4), (20, 30)):
        data = _riff([_vp8x(flags, 48, 52), _webp_chunk(b"ANIM", bytes(6)),
                      anmf(x, y, 27, 21, first), anmf(2, 2, 10, 10, second)])
        _check_pillow(webp.decode_webp, data)
        got = webp.decode_webp(data)
        assert (got[:y] == 0).all() and (got[y + 21:] == 0).all() and (got[:, :x] == 0).all()
    # a first frame past the canvas: both refuse
    _check_pillow(webp.decode_webp, _riff([_vp8x(flags, 30, 30), _webp_chunk(b"ANIM", bytes(6)),
                                           anmf(10, 10, 27, 21, first)]))
    frames = [Image.fromarray(_picture(20, 24, i)) for i in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50, **kw)
    _check_pillow(webp.decode_webp, buf.getvalue())


def test_webp_extended_chunks_are_skipped():
    """VP8X files with ICCP, EXIF, XMP and an unknown chunk around the
    image; a still VP8X image that does not fill its canvas is refused."""
    arr = _picture(19, 23, 10)
    for kw in ({"quality": 80}, {"lossless": True}):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "WEBP", icc_profile=b"\x00" * 131, exif=b"Exif\x00\x00x",
                                  xmp=b"<x/>", **kw)
        _check_pillow(webp.decode_webp, buf.getvalue())
        img = _image_chunks(buf.getvalue())
        data = _riff([_vp8x(0x2C, 23, 19), _webp_chunk(b"ICCP", b"icc"), _webp_chunk(b"ABCD", b"xyz"),
                      img, _webp_chunk(b"EXIF", b"e"), _webp_chunk(b"XMP ", b"m")])
        _check_pillow(webp.decode_webp, data)
        _check_pillow(webp.decode_webp, _riff([_vp8x(0, 24, 19), img]))
        _check_pillow(webp.decode_webp, _riff([_vp8x(0x01, 23, 19), img]))  # reserved flag


class _RecordingBools(webp._BoolDecoder):
    """A boolean decoder that keeps every (probability, bit) it reads."""

    log = None

    def get(self, prob):
        bit = super().get(prob)
        if self.log is not None:
            self.log.append((prob, bit))
        return bit


def _bool_encode(symbols) -> bytes:
    """RFC 6386's boolean encoder (section 7.3) over (probability, bit)."""
    out = bytearray()
    rng, bottom, count = 255, 0, 24

    def carry():
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, bit in symbols:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if not count:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    c, v = count, bottom
    if v & (1 << (32 - c)):
        carry()
    v = (v << (c & 7)) & 0xFFFFFFFF
    for _ in range(c >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _vp8_bits(value: int, n: int):
    return [(128, (value >> i) & 1) for i in range(n - 1, -1, -1)]


def _vp8_signed(value: int, n: int):
    return _vp8_bits(abs(value), n) + [(128, int(value < 0))]


def _reencoded(monkeypatch, data: bytes, filter_hdr=None, quant=None, parts: int = 1) -> bytes:
    """A Pillow lossy file with its first partition's filter header and
    quantizer deltas replaced, or its tokens split over ``parts``
    partitions, re-encoded with the boolean encoder."""
    payload = data[data.index(b"VP8 ") + 8:]
    frames = []  # (decoder, log, row starts)
    spans = {}
    real_filter, real_quant, real_modes = webp._filter_header, webp._quant_matrices, \
        webp._parse_modes

    class Rec(_RecordingBools):
        def __init__(self, *a):
            self.log = []
            super().__init__(*a)
            frames.append(self)

    def filter_header(br):
        start = len(br.log)
        out = real_filter(br)
        spans["filter"] = (start, len(br.log))
        return out

    def quant_matrices(br, seg):
        start = len(br.log)
        out = real_quant(br, seg)
        spans["quant"] = (start, len(br.log))
        return out

    rows = []

    def modes(br, seg, skip, top, left, x):
        if x == 0:
            rows.append(len(frames[-1].log))
        return real_modes(br, seg, skip, top, left, x)

    with monkeypatch.context() as m:
        m.setattr(webp, "_BoolDecoder", Rec)
        m.setattr(webp, "_filter_header", filter_header)
        m.setattr(webp, "_quant_matrices", quant_matrices)
        m.setattr(webp, "_parse_modes", modes)
        webp.decode_webp(data)
    p0, tokens = frames[0].log, frames[-1].log
    assert len(frames) == 2, "expected one token partition"
    f0, f1 = spans["filter"]
    q0, q1 = spans["quant"]
    new_filter = p0[f0:f1] if filter_hdr is None else filter_hdr
    new_quant = p0[q0:q1] if quant is None else quant
    # the two bits after the filter header give the partition count
    part_bits = _vp8_bits({1: 0, 2: 1, 4: 2, 8: 3}[parts], 2)
    p0_new = p0[:f0] + new_filter + part_bits + new_quant + p0[q1:]
    part0 = _bool_encode(p0_new)
    # the token partition's reads of each macroblock row
    rows.append(len(tokens))
    bounds = rows[1:]  # rows[0] is the first row of modes, before any token
    starts = [0] + bounds[:-1]
    streams = [[] for _ in range(parts)]
    for r, (a, b) in enumerate(zip(starts, bounds)):
        streams[r % parts] += tokens[a:b]
    encoded = [_bool_encode(s) for s in streams]
    sizes = b"".join(len(e).to_bytes(3, "little") for e in encoded[:-1])
    w, h = struct.unpack("<HH", payload[6:10])
    tag = (len(part0) << 5) | 0x10  # key frame, profile 0, shown
    frame = tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", w, h)
    return _riff([_webp_chunk(b"VP8 ", frame + part0 + sizes + b"".join(encoded))])


def _filter_bits(simple: int, level: int, sharpness: int, ref=None, mode=None):
    out = [(128, simple)] + _vp8_bits(level, 6) + _vp8_bits(sharpness, 3)
    if ref is None and mode is None:
        return out + [(128, 0)]
    out += [(128, 1), (128, 1)]
    for deltas in (ref, mode):
        for d in deltas:
            out += [(128, 0)] if d is None else [(128, 1)] + _vp8_signed(d, 6)
    return out


@pytest.mark.parametrize("name,filter_hdr,quant,parts", [
    ("as-written", None, None, 1),
    ("simple-filter", _filter_bits(1, 20, 0), None, 1),
    ("simple-filter-sharp", _filter_bits(1, 40, 5), None, 1),
    ("normal-sharpness-3", _filter_bits(0, 30, 3), None, 1),
    ("normal-sharpness-7-level-63", _filter_bits(0, 63, 7), None, 1),
    ("lf-deltas", _filter_bits(0, 25, 2, ref=[6, None, -3, None], mode=[-12, 4, None, 2]), None,
     1),
    ("no-filter", _filter_bits(0, 0, 0), None, 1),
    ("quant-deltas", None, _vp8_bits(40, 7) + [(128, 1)] + _vp8_signed(5, 4) + [(128, 1)]
     + _vp8_signed(-7, 4) + [(128, 1)] + _vp8_signed(3, 4) + [(128, 0)] + [(128, 1)] + _vp8_signed(-2, 4),
     1),
    ("two-partitions", None, None, 2),
    ("four-partitions", _filter_bits(1, 15, 1), None, 4),
])
def test_webp_lossy_header_variants(monkeypatch, name, filter_hdr, quant, parts):
    """Pillow's encoder writes only the normal loop filter at sharpness 0,
    no filter deltas and one token partition.  Its files re-encoded here
    with the simple filter, other sharpness and levels, reference and mode
    deltas, other quantizer deltas and 2 or 4 token partitions decode equal
    to Pillow's pixels (the re-encoding itself is checked by the
    unchanged file decoding equal too)."""
    arr = _picture(48, 64, 12)
    for kw in ({"quality": 60}, {"quality": 90, "method": 6}):
        data = _reencoded(monkeypatch, _webp(arr, **kw), filter_hdr, quant, parts)
        calls = _counting(monkeypatch, ["_edge", "_BoolDecoder"])
        _check_pillow(webp.decode_webp, data)
        kinds = {c[-1] for c in calls["_edge"]}
        simple = filter_hdr is not None and filter_hdr[0][1]
        level = 1 if filter_hdr is None else sum(b for _, b in filter_hdr[1:7])
        assert kinds == (set() if not level else {"simple"} if simple
                         else {"mb", "inner"}), kinds
        assert len(calls["_BoolDecoder"]) == 1 + parts
        if name == "as-written":
            np.testing.assert_array_equal(_pillow(data), _pillow(_webp(arr, **kw)))


def test_webp_truncated_and_corrupt_bytes_refuse_or_match():
    """Files cut short are refused as Pillow refuses them.  Flipped bits:
    where Pillow refuses so does the port, with a ValueError; a file that
    still decodes gives Pillow's pixels, lossy ones too (out-of-range
    coefficients of a corrupt stream go through libwebp's SSE2 transform,
    which wraps at 16 bits, as the port's does)."""
    rng = np.random.RandomState(13)
    arr = _picture(40, 48, 13)
    for kw in ({"quality": 70}, {"lossless": True},
               {"quality": 70, "alpha_quality": 80}):
        src = arr if "alpha_quality" not in kw else np.dstack(
            [arr, np.full(arr.shape[:2], 99, np.uint8)])
        data = _webp(src, **kw)
        for cut in (12, 20, 30, len(data) // 2, len(data) - 1):
            with pytest.raises(ValueError):
                webp.decode_webp(data[:cut])
            _check_pillow(webp.decode_webp, data[:cut])
        refused = 0
        for _ in range(40):
            i = rng.randint(12, len(data))
            bad = data[:i] + bytes([data[i] ^ (1 << rng.randint(8))]) + data[i + 1:]
            try:
                want = _pillow(bad)
            except (OSError, ValueError):
                refused += 1
                with pytest.raises(ValueError):
                    webp.decode_webp(bad)
                continue
            got = webp.decode_webp(bad)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        assert refused > 0


def test_webp_reads_through_read_img(tmp_path):
    """``read_img`` and ``decode_image`` take WebP by its magic bytes, as the
    JAX package's Pillow reader does."""
    arr = _picture(70, 90, 14)
    for kw in ({"quality": 80}, {"lossless": True}):
        data = _webp(arr, **kw)
        _check_pillow(vqvae.decode_image, data)
        _check_read_img(tmp_path, data, "img.png")


# --------------------------------------------------------------------- #
# TIFF: byte-equal to Pillow's convert("RGB")
# --------------------------------------------------------------------- #


TIFF_MODES = ("1", "L", "P", "RGB", "RGBA", "CMYK")
TIFF_COMPRESSIONS = ("raw", "packbits", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate")


def _pillow_tiff(mode: str, h: int, w: int, seed: int, **kw) -> bytes:
    """A TIFF that Pillow writes of a picture in ``mode``."""
    pic = _picture(h, w, seed)
    if mode == "CMYK":
        im = Image.frombytes("CMYK", (w, h), np.dstack([pic, pic[..., :1] // 3]).tobytes())
    elif mode == "RGBA":
        im = Image.fromarray(np.dstack([pic, pic[..., 1:2] ^ 0x5A]), "RGBA")
    elif mode == "P":
        im = Image.fromarray(pic).convert("P", palette=Image.Palette.ADAPTIVE, colors=100)
    else:
        im = Image.fromarray(pic).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("compression", TIFF_COMPRESSIONS)
@pytest.mark.parametrize("mode", TIFF_MODES)
def test_tiff_as_pillow_writes_it(tmp_path, mode, compression):
    """Every mode Pillow writes, in every compression it writes, at odd
    sizes; and ``read_img`` as the JAX package's."""
    for i, (h, w) in enumerate(((1, 1), (9, 7), (37, 53))):
        data = _pillow_tiff(mode, h, w, i, compression=compression)
        got = vqvae.decode_image(data)
        np.testing.assert_array_equal(got, _pillow(data))
    _check_read_img(tmp_path, data, "img.tif")


def _lzw_tiff(data: bytes, old: bool = False, clear_every: int = 0) -> bytes:
    """LZW as libtiff writes it: a clear code first, codes MSB first whose
    width grows when the next free code passes the width (one code before
    the decoder needs it), a clear at 4094 codes, EOI last; ``old``, the
    old-style (compat) stream: LSB first, one code later."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9
    grow = 513 if old else 512  # table size at which the encoder widens

    def put(code):
        nonlocal acc, nacc
        if old:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nbits) | code
            nacc += nbits
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
            acc &= (1 << nacc) - 1

    def reset():
        nonlocal nbits
        put(256)
        nbits = 9
        return {bytes([i]): i for i in range(256)}

    table = reset()
    w, emitted = b"", 0
    for c in data:
        wc = w + bytes([c])
        if w == b"" or wc in table:
            w = wc
            continue
        put(table[w])
        emitted += 1
        table[wc] = len(table) + 2
        w = bytes([c])
        if len(table) + 2 >= 4094 or (clear_every and emitted % clear_every == 0):
            table = reset()
        elif len(table) + 2 >= (1 << nbits) + grow - 512 and nbits < 12:
            nbits += 1
    if w:
        put(table[w])
        if len(table) + 3 >= (1 << nbits) + grow - 512 and nbits < 12:
            nbits += 1
    put(257)
    if nacc:  # the last bits, zero-padded to a byte
        out.append(acc & 0xFF if old else (acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _packbits_tiff(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and (j + 1 >= len(data) or data[j + 1] != data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_rows(blk: np.ndarray, bits: int) -> bytes:
    """Samples [rows, w, n] -> their rows, MSB first below 8 bits, each
    row padded to a byte."""
    rows, w, n = blk.shape
    flat = blk.reshape(rows, w * n).astype(np.uint8)
    if bits == 8:
        return flat.tobytes()
    per = 8 // bits
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(rows, -1, per).astype(np.uint16)
    shifts = np.arange(8 - bits, -1, -bits)
    return (flat << shifts).sum(-1).astype(np.uint8).tobytes()


def _tiff(samples: np.ndarray, *, photo: int, bits: int = 8, extra=(), comp: int = 1,
          predictor: int = 1, planar: int = 1, bo: str = "<", tile=None, rps=None,
          colormap=None, orientation=None, old_lzw: bool = False, lzw_clear: int = 0,
          tags=None) -> bytes:
    """A TIFF of ``samples`` [h, w, spp] (indices below 8 bits), strips of
    ``rps`` rows or ``tile`` (w, h) tiles, in one IFD after the data;
    ``tags`` {tag: (type, values)} add or replace fields."""
    h, w, spp = samples.shape
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    tw, th = tile if tile else (w, rps or h)
    across, down = -(-w // tw), -(-h // th)
    segs = []
    for p in planes:
        for r in range(down):
            for c in range(across):
                blk = p[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
                if tile:
                    blk = np.pad(blk, ((0, th - blk.shape[0]), (0, tw - blk.shape[1]), (0, 0)))
                if predictor == 2:  # each sample less its left neighbour's
                    orig, blk = blk, blk.copy()
                    blk[:, 1:] = orig[:, 1:] - orig[:, :-1]
                raw = _tiff_rows(blk, bits)
                segs.append({1: lambda b: b, 32773: _packbits_tiff,
                             5: lambda b: _lzw_tiff(b, old_lzw, lzw_clear), 8: zlib.compress,
                             32946: zlib.compress}.get(comp, lambda b: b)(raw))
    head = (b"II*\x00" if bo == "<" else b"MM\x00*")
    offsets, pos = [], 8
    for s in segs:
        offsets.append(pos)
        pos += len(s)
    ifd_at = pos + (pos & 1)
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [comp]),
              262: (3, [photo]), 277: (3, [spp]), 284: (3, [planar])}
    if tile:
        fields.update({322: (3, [tw]), 323: (3, [th]), 324: (4, offsets),
                       325: (4, [len(s) for s in segs])})
    else:
        fields.update({273: (4, offsets), 278: (4, [th]), 279: (4, [len(s) for s in segs])})
    if predictor != 1:
        fields[317] = (3, [predictor])
    if extra:
        fields[338] = (3, list(extra))
    if colormap is not None:
        fields[320] = (3, list(colormap))
    if orientation is not None:
        fields[274] = (3, [orientation])
    fields.update(tags or {})
    n = len(fields)
    tail_at = ifd_at + 2 + 12 * n + 4
    ifd, tail = bytearray(struct.pack(bo + "H", n)), bytearray()
    for tag in sorted(fields):
        typ, vals = fields[tag]
        payload = struct.pack(bo + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(payload) <= 4:
            val = payload.ljust(4, b"\x00")
        else:
            val = struct.pack(bo + "I", tail_at + len(tail))
            tail += payload + b"\x00" * (len(payload) & 1)
        ifd += struct.pack(bo + "HHI", tag, typ, len(vals)) + val
    ifd += b"\x00\x00\x00\x00"
    return (head + struct.pack(bo + "I", ifd_at) + b"".join(segs)
            + b"\x00" * (ifd_at - pos) + bytes(ifd) + bytes(tail))


def _tiff_case(name: str, rng) -> bytes:
    h, w = 23, 37
    rgb = _picture(h, w, 3)
    rgba = np.dstack([rgb, rng.randint(0, 256, (h, w, 1)).astype(np.uint8)])
    rgba[0, :5, 3] = (0, 255, 1, 128, 254)
    cmyk = np.dstack([rgb, rgb[..., :1] // 2])
    gray = rgb[..., :1]
    cases = {
        "big-endian-lzw": lambda: _tiff(rgb, photo=2, comp=5, bo=">"),
        "big-endian-raw-strips": lambda: _tiff(rgb, photo=2, bo=">", rps=4),
        "strips-raw": lambda: _tiff(rgb, photo=2, rps=5),
        "strips-packbits": lambda: _tiff(rgb, photo=2, comp=32773, rps=5),
        "strips-lzw": lambda: _tiff(rgb, photo=2, comp=5, rps=5),
        "strips-deflate": lambda: _tiff(cmyk, photo=5, comp=8, rps=7),
        "one-row-strips-adobe-deflate": lambda: _tiff(gray, photo=1, comp=32946, rps=1),
        "tiles-raw": lambda: _tiff(rgb, photo=2, tile=(16, 16)),
        "tiles-packbits": lambda: _tiff(rgb, photo=2, comp=32773, tile=(16, 16)),
        "tiles-lzw-big-endian": lambda: _tiff(rgba, photo=2, extra=(2,), comp=5,
                                              tile=(16, 32), bo=">"),
        "tiles-deflate-planar": lambda: _tiff(rgb, photo=2, comp=8, tile=(32, 16), planar=2),
        "planar-raw": lambda: _tiff(rgb, photo=2, planar=2, rps=6),
        "planar-packbits-cmyk": lambda: _tiff(cmyk, photo=5, comp=32773, planar=2),
        "planar-lzw-rgba": lambda: _tiff(rgba, photo=2, extra=(2,), comp=5, planar=2, rps=8),
        "planar-lzw-associated": lambda: _tiff(rgba, photo=2, extra=(1,), comp=5, planar=2),
        "predictor-lzw": lambda: _tiff(rgb, photo=2, comp=5, predictor=2, rps=6),
        "predictor-deflate-gray": lambda: _tiff(gray, photo=1, comp=8, predictor=2),
        "predictor-lzw-planar-tiles": lambda: _tiff(cmyk, photo=5, comp=5, predictor=2,
                                                    planar=2, tile=(16, 16)),
        "predictor-on-raw-is-ignored": lambda: _tiff(rgb, photo=2, predictor=2),
        "predictor-on-packbits-is-ignored": lambda: _tiff(rgb, photo=2, comp=32773,
                                                          predictor=2),
        "old-style-lzw": lambda: _tiff(rgb, photo=2, comp=5, old_lzw=True, rps=9),
        "lzw-clear-codes": lambda: _tiff(rgba, photo=2, extra=(0,), comp=5, lzw_clear=300),
        "associated-alpha": lambda: _tiff(rgba, photo=2, extra=(1,)),
        "associated-alpha-lzw": lambda: _tiff(rgba, photo=2, extra=(1,), comp=5),
        "unassociated-alpha": lambda: _tiff(rgba, photo=2, extra=(2,), comp=8),
        "alpha-without-extra-samples": lambda: _tiff(rgba, photo=2),
        "rgb-and-two-ignored-samples": lambda: _tiff(
            np.dstack([rgba, rgb[..., :1]]), photo=2, extra=(0, 0), comp=5),
        "gray-white-is-zero": lambda: _tiff(gray, photo=0, comp=32773),
        "gray-and-alpha": lambda: _tiff(rgba[..., 2:], photo=1, extra=(2,), comp=5),
        "gray-signed-8-bit": lambda: _tiff(gray, photo=1, tags={339: (3, [2])}),
    }
    for bits in (1, 2, 4, 8):
        idx = rng.randint(0, 1 << bits, (h, w, 1)).astype(np.uint8)
        cmap = rng.randint(0, 65536, 3 << bits)
        cases[f"palette-{bits}-bit"] = (lambda idx=idx, cmap=cmap, bits=bits: _tiff(
            idx, photo=3, bits=bits, colormap=cmap, comp=5, rps=7))
        cases[f"palette-{bits}-bit-raw-tiles"] = (lambda idx=idx, cmap=cmap, bits=bits: _tiff(
            idx, photo=3, bits=bits, colormap=cmap, tile=(16, 16)))
    bw = rng.randint(0, 2, (h, w, 1)).astype(np.uint8)
    for photo in (0, 1):
        cases[f"bilevel-{photo}"] = lambda photo=photo: _tiff(bw, photo=photo, bits=1, rps=6)
        cases[f"bilevel-{photo}-packbits"] = lambda photo=photo: _tiff(bw, photo=photo, bits=1,
                                                                        comp=32773)
    for o in range(1, 9):
        cases[f"orientation-{o}"] = lambda o=o: _tiff(rgb, photo=2, comp=5, orientation=o)
    return cases[name]()


TIFF_CASES = ["big-endian-lzw", "big-endian-raw-strips", "strips-raw", "strips-packbits",
              "strips-lzw", "strips-deflate", "one-row-strips-adobe-deflate", "tiles-raw",
              "tiles-packbits", "tiles-lzw-big-endian", "tiles-deflate-planar", "planar-raw",
              "planar-packbits-cmyk", "planar-lzw-rgba", "planar-lzw-associated",
              "predictor-lzw", "predictor-deflate-gray", "predictor-lzw-planar-tiles",
              "predictor-on-raw-is-ignored", "predictor-on-packbits-is-ignored",
              "old-style-lzw", "lzw-clear-codes", "associated-alpha", "associated-alpha-lzw",
              "unassociated-alpha", "alpha-without-extra-samples",
              "rgb-and-two-ignored-samples", "gray-white-is-zero", "gray-and-alpha",
              "gray-signed-8-bit"]
TIFF_CASES += [f"palette-{b}-bit{t}" for b in (1, 2, 4, 8) for t in ("", "-raw-tiles")]
TIFF_CASES += [f"bilevel-{p}{c}" for p in (0, 1) for c in ("", "-packbits")]
TIFF_CASES += [f"orientation-{o}" for o in range(1, 9)]


@pytest.mark.parametrize("name", TIFF_CASES)
def test_tiff_hand_built_layouts(name):
    """Files Pillow does not write: big-endian, tiles, planar
    configuration 2, predictor 2, several strips, old-style LZW, associated
    alpha, palettes below 8 bits, bilevel and the Orientation tag."""
    data = _tiff_case(name, np.random.RandomState(len(name)))
    want = _pillow(data)
    got = vqvae.decode_image(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_tiff_lzw_streams_round_trip():
    """The test's LZW writer and the reader agree on long streams (the
    width growing to 12 bits, clear codes), new and old style, and Pillow
    reads both."""
    from cogview_tpu_torch.utils import tiff

    data = np.random.RandomState(0).randint(0, 6, 20000).astype(np.uint8).tobytes()
    for old in (False, True):
        for every in (0, 700):
            assert tiff._lzw(_lzw_tiff(data, old, every), len(data)) == data
    img = np.random.RandomState(1).randint(0, 4, (100, 80, 3)).astype(np.uint8) * 60
    for old in (False, True):
        tif = _tiff(img, photo=2, comp=5, old_lzw=old)
        np.testing.assert_array_equal(vqvae.decode_image(tif), _pillow(tif))
        np.testing.assert_array_equal(vqvae.decode_image(tif), img)


REFUSED_TIFF = {
    # name: (the old-style JPEG file in three planes: form and layout, the
    # byte of the second plane's SOS marker overwritten: 3 is Ls, 4 is Ns)
    f"{layout}-{field}": (kw, 3 if field == "sos-length" else 4)
    for layout, kw in (
        ("strips-of-8", dict(form="inline", rps=8)),
        ("strips-of-16", dict(form="interchange", rps=16)),
        ("strips-of-24", dict(form="inline", rps=24)),
        ("tiles-in-a-column", dict(form="interchange", tile=(64, 16))),
        ("tiles-side-by-side", dict(form="inline", tile=(32, 16))),
        ("rgb-strips-of-16", dict(form="inline", rps=16, photo=2)),
        ("rgb-tiles", dict(form="interchange", tile=(32, 32), photo=2)))
    for field in ("sos-length", "sos-components")
}


def _ojpeg_planes_sos_damaged(kw: dict, at: int) -> bytes:
    """A 48 x 64 old-style JPEG TIFF in three planes (``chip_smoke``'s
    writer) whose second plane's SOS marker has byte ``at`` overwritten."""
    from test_torch_image_tiff import cs

    data = bytearray(cs._ojpeg_file(_picture(48, 64, 7), planar=2, **kw))
    first = data.find(b"\xff\xda\x00\x08\x01\x02")  # the second component's scan
    assert first > 0
    data[first + at] ^= 0x40
    return bytes(data)


@pytest.mark.parametrize("name", list(REFUSED_TIFF))
def test_tiff_refuses_named_features(name):
    """The one TIFF the reader names: old-style JPEG in planes whose second
    scan's SOS marker is corrupt, where the first plane has more than one
    strip or tile.  libtiff then reads the first plane's later strips or
    tiles from where its search for that marker stopped; Pillow reads every
    one of these files, and the port raises ``UnsupportedImageError``
    naming it."""
    kw, at = REFUSED_TIFF[name]
    data = _ojpeg_planes_sos_damaged(kw, at)
    Image.open(io.BytesIO(data)).load()
    with pytest.raises(UnsupportedImageError, match="old-style JPEG"):
        vqvae.decode_image(data)


@pytest.mark.parametrize("cut", [30, 200, -40, -1])
def test_tiff_truncated_or_corrupt_refuses_as_pillow_does(cut):
    """A cut file (directory or pixel data missing) raises a plain
    ``ValueError``, as Pillow fails; so does a corrupt LZW strip."""
    full = _tiff(_picture(20, 30, 2), photo=2, comp=5, rps=8)
    if cut == -1:
        # the first LZW code after the clear points past the table
        data = bytearray(full)
        data[9] = 0xFF
        data = bytes(data)
    else:
        data = full[:cut] if cut > 0 else full[:len(full) + cut]
    with pytest.raises(ValueError) as err:
        vqvae.decode_image(data)
    assert not isinstance(err.value, UnsupportedImageError)
    with pytest.raises((OSError, ValueError, SyntaxError)):
        _pillow(data)


def main() -> None:
    """This machine's host-CPU seconds to decode a 256 x 256 and a
    1024 x 768 baseline and progressive JPEG (quality 75, 4:2:0), WebP
    (lossy at quality 75, and lossless) and RGB TIFF (LZW, Deflate), best
    of 3, against Pillow's decode of the same bytes."""
    cases = [(hw, "JPEG", dict(progressive=p)) for p in (False, True)
             for hw in ((256, 256), (768, 1024))]
    cases += [(hw, "WEBP", kw) for kw in ({"quality": 75}, {"lossless": True})
              for hw in ((256, 256), (768, 1024))]
    cases += [(hw, "TIFF", {"compression": c}) for c in ("tiff_lzw", "tiff_adobe_deflate")
              for hw in ((256, 256), (768, 1024))]
    for (h, w), fmt, kw in cases:
        if fmt == "JPEG":
            data, decode = _pillow_jpeg(_picture(h, w, 1), quality=75, **kw), decode_jpeg
            kind = "progressive JPEG" if kw["progressive"] else "baseline JPEG"
        elif fmt == "TIFF":
            buf = io.BytesIO()
            Image.fromarray(_picture(h, w, 1)).save(buf, "TIFF", **kw)
            data, decode = buf.getvalue(), vqvae.decode_image
            kind = f"TIFF ({kw['compression']})"
        else:
            data, decode = _webp(_picture(h, w, 1), **kw), webp.decode_webp
            kind = "lossless WebP" if kw.get("lossless") else "lossy WebP"
        ours, pillow = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            got = decode(data)
            ours.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            want = _pillow(data)
            pillow.append(time.perf_counter() - t0)
        assert np.array_equal(got, want)
        print(f"{w}x{h} {kind} ({len(data)} bytes): {decode.__name__} {min(ours):.4f} s, "
              f"Pillow {min(pillow):.4f} s (host CPU, best of 3), byte-equal")


if __name__ == "__main__":
    sys.exit(main())
