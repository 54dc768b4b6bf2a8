"""The port's image readers against Pillow and the JAX package.

``cogview_tpu_torch/utils/png.py`` reads every PNG colour type, depth and
interlace, ``cogview_tpu_torch/utils/jpeg.py`` baseline and progressive
JPEG (also CMYK and YCCK), ``utils/bmp.py`` BMP and ``utils/gif.py`` GIF's
first frame, and
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
256 x 256 and a 1024 x 768 baseline and progressive JPEG:
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
    """A CMYK JPEG now reads as Pillow reads it (the cases below); what
    still raises by name is a four-component frame that no reader here
    takes, an arithmetic-coded one."""
    buf = io.BytesIO()
    Image.fromarray(_picture(9, 7, 1)).convert("CMYK").save(buf, "JPEG")
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(vqvae.read_img(str(path)), jvq.read_img(str(path)))
    header = b"\xff\xc9" + struct.pack(">HBHHB", 20, 8, 8, 8, 4) + b"".join(
        bytes([k, 0x11, 0]) for k in range(1, 5))
    with pytest.raises(UnsupportedImageError, match="arithmetic-coded"):
        decode_jpeg(b"\xff\xd8" + header + b"\xff\xd9")


@pytest.mark.parametrize("header,match", [
    (b"\xff\xc1" + struct.pack(">HBHHB", 11, 12, 8, 8, 1) + b"\x01\x11\x00", "12-bit JPEG"),
    (b"\xff\xc9" + struct.pack(">HBHHB", 11, 8, 8, 8, 1) + b"\x01\x11\x00", "arithmetic-coded"),
    (b"\xff\xc3" + struct.pack(">HBHHB", 11, 8, 8, 8, 1) + b"\x01\x11\x00", "lossless JPEG"),
])
def test_other_jpeg_frames_raise_named_errors(header, match):
    with pytest.raises(ValueError, match=match):
        decode_jpeg(b"\xff\xd8" + header + b"\xff\xd9")


def test_adobe_transform_2_and_oversized_mcus_raise():
    """An Adobe transform 2 (YCCK) file raises by name; an interleaved MCU
    of more than 10 blocks raises as libjpeg (and so Pillow) refuses it."""
    planes = list(_picture(9, 7, 3).transpose(2, 0, 1))
    with pytest.raises(ValueError, match="YCCK"):
        decode_jpeg(_encode_jpeg(planes, ((1, 1),) * 3, app=_adobe(2)))
    data = _encode_jpeg(planes, ((2, 2),) * 3, app=JFIF)
    with pytest.raises(ValueError, match="10 blocks"):
        decode_jpeg(data)
    with pytest.raises(OSError):
        _pillow(data)


@pytest.mark.parametrize("fmt", ["GIF", "BMP", "TIFF", "text"])
def test_other_files_raise_an_error_naming_what_is_read(tmp_path, fmt):
    """GIF and BMP now read, by their magic bytes, as the JAX package reads
    them; TIFF raises an ``UnsupportedImageError`` and other bytes a
    ``ValueError``, each naming what is read."""
    path = tmp_path / "img.png"  # the name is not what decides
    if fmt == "text":
        path.write_bytes(b"not an image\n")
    else:
        Image.fromarray(_picture(9, 7, 2)).save(str(path), fmt)
    if fmt in ("GIF", "BMP"):
        np.testing.assert_array_equal(vqvae.read_img(str(path)), jvq.read_img(str(path)))
        return
    error = UnsupportedImageError if fmt == "TIFF" else ValueError
    with pytest.raises(error, match="PNG .* or baseline JPEG"):
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
    naming the format (Pillow writes them here where it can)."""
    names = {"WEBP": "WebP", "ICO": "ICO", "PPM": "PNM", "JPEG2000": "JPEG 2000", "TIFF": "TIFF",
             "PSD": "PSD", "QOI": "QOI"}
    try:
        data = _encoded_by_pillow(fmt)
    except (KeyError, OSError, ValueError):  # no writer in this Pillow: the magic bytes
        data = {"WEBP": b"RIFF\x10\x00\x00\x00WEBPVP8 ", "PSD": b"8BPS\x00\x01",
                "JPEG2000": b"\xff\x4f\xff\x51", "QOI": b"qoif"}[fmt] + bytes(16)
    with pytest.raises(UnsupportedImageError, match=names[fmt]):
        vqvae.decode_image(data)


def _encoded_by_pillow(fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_picture(16, 16, 1)).save(buf, fmt)
    return buf.getvalue()


def main() -> None:
    """This machine's host-CPU seconds to decode a 256 x 256 and a
    1024 x 768 baseline and progressive JPEG (quality 75, 4:2:0), best of 3,
    against Pillow's decode of the same bytes."""
    for (h, w), progressive in ((hw, p) for p in (False, True)
                                for hw in ((256, 256), (768, 1024))):
        data = _pillow_jpeg(_picture(h, w, 1), quality=75, progressive=progressive)
        ours, pillow = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            got = decode_jpeg(data)
            ours.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            want = _pillow(data)
            pillow.append(time.perf_counter() - t0)
        assert np.array_equal(got, want)
        kind = "progressive" if progressive else "baseline"
        print(f"{w}x{h} {kind} JPEG ({len(data)} bytes): decode_jpeg {min(ours):.4f} s, "
              f"Pillow {min(pillow):.4f} s (host CPU, best of 3), byte-equal")


if __name__ == "__main__":
    sys.exit(main())
