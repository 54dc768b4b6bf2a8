"""Damaged JPEG files end in the port as they end in Pillow 12.1.

The JAX package decodes every image with Pillow: it trains on what
``Image.open(...).convert("RGB")`` returns and skips what it raises.  A
crawl holds damaged files, and libjpeg-turbo recovers most damaged JPEGs,
so the port (``cogview_tpu_torch/utils/jpeg.py``) follows libjpeg-turbo's
recovery: its restart bookkeeping and ``jpeg_resync_to_restart``, the
zero blocks after a marker inside an interval, 16-bit coefficients, its
AVX2 IDCT, the standard Huffman tables, block smoothing, where its reads
run past the end of the file, and the errors Pillow turns into "broken
data stream".  Every file ends as in Pillow: read byte-equal, or skipped
(a ``ValueError`` the dataset sources skip, never
``UnsupportedImageError``) where Pillow raises.

The sweep damages a seeded 96 x 128 picture saved by Pillow (baseline,
with a restart interval, progressive) and by this suite's arithmetic-coded
and lossless writers: in each file 1 to 3 bytes at offsets 20 and on are
overwritten from ``RandomState(1000 + seed)``.  The hand-built cases hold
one rule each on a small file.
"""

import io
import os
import re
import struct
import sys
import warnings

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

sys.path.insert(0, os.path.dirname(__file__))

from cogview_tpu_torch.preprocess import raw_datasets as raw  # noqa: E402
from cogview_tpu_torch.utils.image_errors import UnsupportedImageError  # noqa: E402
from cogview_tpu_torch.utils.image_formats import decode_image  # noqa: E402
from cogview_tpu_torch.utils.jpeg import _ZIGZAG  # noqa: E402
from test_torch_image_formats import _arith_jpeg, _lossless_jpeg  # noqa: E402
from test_torch_image_io import JFIF  # noqa: E402


def picture(h: int = 96, w: int = 128, seed: int = 0) -> np.ndarray:
    """A noisy gradient: three ramps and +-24 of noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 255 // (h + w)], -1)
    return np.clip(base + rng.randint(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def saved(arr: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


def damaged(base: bytes, seed: int) -> bytes:
    """``base`` with 1 to 3 bytes at offsets 20 and on overwritten."""
    rng = np.random.RandomState(1000 + seed)
    out = bytearray(base)
    for _ in range(rng.randint(1, 4)):
        out[rng.randint(20, len(out))] = rng.randint(256)
    return bytes(out)


def pillow(data: bytes):
    """Pillow's RGB array, or None where it raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def ends_as_in_pillow(data: bytes) -> str:
    """Assert the port ends ``data`` as Pillow does -> "read" or "skipped"."""
    want = pillow(data)
    if want is None:
        with pytest.raises(raw.DECODE_ERRORS) as err:
            decode_image(data)
        assert not isinstance(err.value, UnsupportedImageError), err.value
        return "skipped"
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return "read"


# --------------------------------------------------------------------- #
# the sweep
# --------------------------------------------------------------------- #


def _arith() -> bytes:
    planes = list(picture(40, 56).transpose(2, 0, 1))
    return _arith_jpeg(planes, ((2, 2), (1, 1), (1, 1)), False, app=JFIF, restart=3)


def _arith_progressive() -> bytes:
    planes = list(picture(40, 56).transpose(2, 0, 1))
    return _arith_jpeg(planes, ((2, 2), (1, 1), (1, 1)), True, app=JFIF, restart=3)


def _lossless() -> bytes:
    return _lossless_jpeg(list(picture(24, 32).transpose(2, 0, 1)), ((1, 1),) * 3, 4,
                          restart_rows=2)


# variant -> (writer, files); 20 seeds a case
VARIANTS = {
    "baseline": (lambda: saved(picture(), "JPEG", quality=85), 200),
    "restart": (lambda: saved(picture(), "JPEG", quality=85, restart_marker_blocks=4), 100),
    "progressive": (lambda: saved(picture(), "JPEG", quality=85, progressive=True), 100),
    "arithmetic": (_arith, 20),
    "arithmetic progressive": (_arith_progressive, 20),
    "lossless": (_lossless, 40),
}
CHUNK = 20
SWEEP = [(name, start) for name, (_, n) in VARIANTS.items() for start in range(0, n, CHUNK)]
_BASES = {}


@pytest.mark.parametrize("variant,start", SWEEP, ids=[f"{v}-{s}" for v, s in SWEEP])
def test_damaged_jpeg_ends_as_in_pillow(variant, start):
    """20 damaged files of one variant: each read byte-equal to Pillow, or
    skipped where Pillow raises."""
    if variant not in _BASES:
        _BASES[variant] = VARIANTS[variant][0]()
    base = _BASES[variant]
    outcomes = [ends_as_in_pillow(damaged(base, seed)) for seed in range(start, start + CHUNK)]
    assert "read" in outcomes


# --------------------------------------------------------------------- #
# one rule each
# --------------------------------------------------------------------- #

# a gray baseline file's tables: DC categories 0..15 in 5-bit codes, every
# AC (run, size) symbol and EOB and ZRL in 9-bit codes
_AC = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 16)]


def _seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def coefficient_jpeg(blocks: np.ndarray, quant, restart: int = 0, dc_diffs=None) -> bytes:
    """A gray baseline JPEG whose quantized coefficients are ``blocks``
    [rows, cols, 64] (natural order), quantizers ``quant`` [64] (natural
    order, 8-bit); ``dc_diffs`` gives the DC differences in place of
    those of ``blocks``."""
    rows, cols, _ = blocks.shape
    zz = list(_ZIGZAG)
    out, acc, nacc = bytearray(), 0, 0

    def put(v: int, n: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << n) | (v & ((1 << n) - 1)), nacc + n
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
            if out[-1] == 0xFF:
                out.append(0)

    def value(v: int) -> int:
        s = abs(v).bit_length()
        return s, v if v >= 0 else v + (1 << s) - 1

    pred = 0
    for n, blk in enumerate(blocks.reshape(-1, 64)):
        if restart and n and n % restart == 0:
            put(0x7F, -nacc % 8)
            out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            pred = 0
        z = [int(blk[zz[k]]) for k in range(64)]
        diff = dc_diffs[n] if dc_diffs is not None else z[0] - pred
        pred = z[0]
        s, v = value(diff)
        put(s, 5)
        put(v, s)
        last = max([k for k in range(1, 64) if z[k]] or [0])
        run = 0
        for k in range(1, last + 1):
            if not z[k]:
                run += 1
                continue
            while run > 15:
                put(_AC.index(0xF0), 9)
                run -= 16
            s, v = value(z[k])
            put(_AC.index((run << 4) | s), 9)
            put(v, s)
            run = 0
        if last < 63:
            put(0, 9)
    put(0x7F, -nacc % 8)
    dht = bytes([0x00, 0, 0, 0, 0, 16] + [0] * 11) + bytes(range(16))
    dht += bytes([0x10] + [0] * 8 + [len(_AC)] + [0] * 7) + bytes(_AC)
    body = [b"\xff\xd8", _seg(0xDB, bytes([0]) + bytes(int(quant[zz[k]]) for k in range(64))),
            _seg(0xC0, struct.pack(">BHHB", 8, 8 * rows, 8 * cols, 1) + bytes([1, 0x11, 0])),
            _seg(0xC4, dht)]
    if restart:
        body.append(_seg(0xDD, struct.pack(">H", restart)))
    body += [_seg(0xDA, bytes([1, 1, 0, 0, 63, 0])), bytes(out), b"\xff\xd9"]
    return b"".join(body)


def _gradient_blocks(rows: int = 4, cols: int = 6) -> np.ndarray:
    blocks = np.zeros((rows, cols, 64), np.int64)
    blocks[..., 0] = (np.arange(rows * cols).reshape(rows, cols) * 7) % 90 - 45
    blocks[..., 1] = 9
    blocks[..., 8] = -6
    return blocks


def _rsts(data: bytes):
    return [m.start() for m in re.finditer(rb"\xff[\xd0-\xd7]", data)]


def _put(data: bytes, at: int, new: bytes) -> bytes:
    return data[:at] + new + data[at + len(new):]


def _forged_rst(ahead: int) -> bytes:
    """The fourth restart marker of a file with one every block renumbered
    ``ahead`` places on: 1 or 2 are the next two expected (libjpeg leaves
    the marker unread, and the intervals up to it are empty), -1 or -2
    ones already passed (it skips on to the next marker), 4 too far away
    (it drops the marker and reads on)."""
    data = coefficient_jpeg(_gradient_blocks(), np.full(64, 4), restart=1)
    at = _rsts(data)[3]
    return _put(data, at + 1, bytes([0xD0 + (3 + ahead) % 8]))


def _lost_rst() -> bytes:
    """A restart marker whose FF is overwritten: two intervals' data run
    together, and libjpeg resynchronizes at the next marker."""
    data = coefficient_jpeg(_gradient_blocks(), np.full(64, 4), restart=2)
    return _put(data, _rsts(data)[2], b"\x35")


def _marker_in_interval(marker: int, restart: int) -> bytes:
    """A marker written over the middle of the scan data: the interval's
    data end there, the MCU then decoded is finished with zero bits and
    the rest of the interval is zero blocks (DC 0: mid-gray), the DC
    prediction unmoved."""
    data = coefficient_jpeg(_gradient_blocks(), np.full(64, 4), restart=restart)
    start = data.index(b"\xff\xda") + 10
    at = start + (len(data) - start) // 3
    while data[at] == 0xFF or data[at - 1] == 0xFF:
        at += 1
    return _put(data, at, bytes([0xFF, marker]))


def _dc_past_16_bits() -> bytes:
    """DC differences of 2,047 and more that carry the predictor past
    32,767: each block's DC is stored in a JCOEF (16 bits) and wraps, its
    prediction (an int) does not."""
    blocks = np.zeros((2, 8, 64), np.int64)
    diffs = [30000, 2047, 2047, 2047, 2047, 30000, -30000, 2047] * 2
    return coefficient_jpeg(blocks, np.ones(64, np.int64), dc_diffs=diffs)


def _idct_out_of_range() -> bytes:
    """Coefficients far past what an encoder writes: libjpeg-turbo's AVX2
    islow IDCT keeps 16-bit lanes (the dequantized values and some sums
    wrap, each pass saturates), where its C IDCT wraps the samples modulo
    1,024."""
    rng = np.random.RandomState(3)
    blocks = np.zeros((2, 4, 64), np.int64)
    blocks[0, :, 0] = [900, -900, 3000, -3000]
    for b in blocks.reshape(-1, 64)[4:]:
        b[rng.randint(64, size=3)] = rng.randint(-2000, 2001, 3)
    return coefficient_jpeg(blocks, rng.randint(1, 120, 64))


def _no_huffman_tables() -> bytes:
    """A baseline file without its DHT marker: libjpeg-turbo decodes it
    with T.81's standard tables (those Pillow's own files carry)."""
    data = saved(picture(16, 24), "JPEG", quality=90)
    at = data.index(b"\xff\xc4")
    return data[:at] + data[at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]:]


def _progressive_cut(scans: int) -> bytes:
    """A progressive file ending (with EOI) after ``scans`` scans: the
    coefficients not yet exact are estimated from the DC values around
    each block (block smoothing; after the DC scan alone, the DC values
    too)."""
    data = saved(picture(40, 48), "JPEG", quality=80, progressive=True)
    sos = [m.start() for m in re.finditer(rb"\xff\xda", data)]
    cut = max(m.start() for m in re.finditer(rb"\xff\xc4", data[:sos[scans]]))
    return data[:max(cut, sos[scans - 1] + 8)] + b"\xff\xd9"


def _eoi_overwritten(restart: int, quality: int) -> bytes:
    """The end-of-image marker overwritten: the scan's data run to the end
    of the file, and Pillow reads the file where libjpeg's bit buffer never
    asks for a byte past it."""
    data = saved(picture(48, 64), "JPEG", quality=quality, restart_marker_blocks=restart)
    return data[:-2] + b"\x5a\x5a"


def _bad_progression() -> bytes:
    """A refinement scan whose Al is not Ah - 1: a fatal libjpeg error,
    which Pillow raises as a broken data stream."""
    data = bytearray(saved(picture(16, 24), "JPEG", quality=90, progressive=True))
    sos = [m.start() for m in re.finditer(rb"\xff\xda", data)]
    for at in sos:
        n = data[at + 4]
        if data[at + 5 + 2 * n + 2] >> 4:  # a refinement scan
            data[at + 5 + 2 * n + 2] = (data[at + 5 + 2 * n + 2] & 0xF0) | 0x0F
            return bytes(data)
    raise AssertionError("no refinement scan")


def _scan_components_reordered() -> bytes:
    """An interleaved scan that names the luma component second: libjpeg
    takes a component only for a scan slot not below its own index."""
    data = bytearray(saved(picture(16, 16), "JPEG", quality=90, subsampling=0))
    at = data.index(b"\xff\xda")
    data[at + 5], data[at + 7] = data[at + 7], data[at + 5]
    return bytes(data)


def _arith_across_a_read(pad: int) -> bytes:
    """An arithmetic-coded file whose entropy-coded data cross 65,536 bytes
    (where ``pad`` APP1 bytes push them): Pillow hands libjpeg the file
    65,536 bytes at a time, more each time it suspends, and jdarith.c
    cannot suspend, so data past the bytes handed over are a fatal error;
    markers that run past them (a header over 65,536 bytes) hand over
    more first."""
    apps = b"".join(_seg(0xE1, b"x" * min(60000, pad - k)) for k in range(0, pad, 60000))
    planes = list(picture(64, 64).transpose(2, 0, 1))
    return _arith_jpeg(planes, ((2, 2), (1, 1), (1, 1)), True, app=JFIF + apps)


RULES = {
    "forged RST, one of the next two": (lambda: _forged_rst(1), "read"),
    "forged RST, one already passed": (lambda: _forged_rst(-2), "read"),
    "forged RST, too far away": (lambda: _forged_rst(4), "read"),
    "lost RST": (_lost_rst, "read"),
    "EOI inside the scan": (lambda: _marker_in_interval(0xD9, 0), "read"),
    "RST inside a scan without restarts": (lambda: _marker_in_interval(0xD5, 0), "read"),
    "reserved marker inside an interval": (lambda: _marker_in_interval(0x05, 2), "read"),
    "DC past 16 bits": (_dc_past_16_bits, "read"),
    "IDCT of out-of-range coefficients": (_idct_out_of_range, "read"),
    "no DHT: the standard tables": (_no_huffman_tables, "read"),
    "block smoothing after the DC scan": (lambda: _progressive_cut(1), "read"),
    "block smoothing after three scans": (lambda: _progressive_cut(3), "read"),
    "EOI overwritten, fast path, reads stay in the file": (lambda: _eoi_overwritten(0, 90),
                                                           "read"),
    "EOI overwritten, restarts, reads stay in the file": (lambda: _eoi_overwritten(3, 75),
                                                          "read"),
    "EOI overwritten, a read past the end": (lambda: _eoi_overwritten(1, 75), "skipped"),
    "arithmetic-coded data across Pillow's 64 KiB read": (lambda: _arith_across_a_read(64000),
                                                          "skipped"),
    "arithmetic-coded data after a header over 64 KiB": (lambda: _arith_across_a_read(70000),
                                                         "read"),
    "bad progression": (_bad_progression, "skipped"),
    "scan components reordered": (_scan_components_reordered, "skipped"),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_libjpeg_recovery_rule(rule):
    """One hand-built file for each rule the port follows: Pillow ends it
    as the case says, and the port ends it so too."""
    build, outcome = RULES[rule]
    assert ends_as_in_pillow(build()) == outcome


def _reader_of(root: str, name: str):
    """The reader module ``utils/<name>.py`` of the checkout at ``root``,
    loaded beside this one's (its relative imports resolve here)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"cogview_tpu_torch.utils._{name}_of_checkout",
        os.path.join(root, "cogview_tpu_torch", "utils", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("pad", [0, 2, 3, 8])
def test_lossless_data_that_run_to_the_end_of_the_file(pad):
    """A lossless JPEG whose EOI is replaced by ``pad`` zero bytes: its data
    run to the end of the file, and libjpeg-turbo's bit-buffer fills
    (``jdlhuff.c`` through ``jpeg_fill_bit_buffer``, to 57 bits where a
    code or its extra bits need more than are held) decide: Pillow reads
    it where no fill before its last sample passes the end of the file (3
    bytes and more here) and fails otherwise, and the port ends each as
    Pillow does, where a reader that treats every such file as cut short
    skips them all."""
    base = _lossless_jpeg(list(picture(24, 32).transpose(2, 0, 1)), ((1, 1),) * 3, 1)
    data = base[:base.rfind(b"\xff\xd9")] + bytes(pad)
    assert ends_as_in_pillow(data) == ("read" if pad >= 3 else "skipped")


def main(argv) -> int:
    """This machine's host CPU seconds for the port to read five valid
    files: a 1024 x 768 baseline JPEG, the same with a restart marker every
    4 MCUs, a 256 x 256 and a 1024 x 768 progressive JPEG (quality 85,
    4:2:0) and a 256 x 256 lossy WebP (quality 80), byte-equal to Pillow.  Alone it prints the
    best of 3; ``python tests/test_torch_image_damage_jpeg.py <checkout>``
    alternates this tree's readers with those of another checkout in one
    process (40 pairs, 16 or 8 for the larger files, the order swapped each
    pair, so a shared host's load falls on both) and prints each side's
    least and median CPU seconds and their ratios."""
    import statistics
    import time

    from cogview_tpu_torch.utils import jpeg, webp

    cases = {
        "1024x768 baseline JPEG": (saved(picture(768, 1024), "JPEG", quality=85), "jpeg", 16),
        "1024x768 JPEG, restart every 4 MCUs": (saved(picture(768, 1024), "JPEG", quality=85,
                                                      restart_marker_blocks=4), "jpeg", 16),
        "256x256 progressive JPEG": (saved(picture(256, 256), "JPEG", quality=85,
                                           progressive=True), "jpeg", 40),
        "1024x768 progressive JPEG": (saved(picture(768, 1024), "JPEG", quality=85,
                                             progressive=True), "jpeg", 8),
        "256x256 lossy WebP": (saved(picture(256, 256), "WEBP", quality=80), "webp", 16),
    }
    ours = {"jpeg": jpeg.decode_jpeg, "webp": webp.decode_webp}
    theirs = None
    if argv:
        theirs = {"jpeg": _reader_of(argv[0], "jpeg").decode_jpeg,
                  "webp": _reader_of(argv[0], "webp").decode_webp}

    def cpu(fn, data, want) -> float:
        t0 = time.process_time()
        got = fn(data)
        seconds = time.process_time() - t0
        assert np.array_equal(got, want)
        return seconds

    for kind, (data, reader, pairs) in cases.items():
        want = pillow(data)
        if theirs is None:
            best = min(cpu(ours[reader], data, want) for _ in range(3))
            print(f"{kind} ({len(data)} bytes): {best:.3f} s (host CPU, best of 3), "
                  "byte-equal to Pillow")
            continue
        mine, other = [], []
        for i in range(pairs):
            for fn, times in ((ours[reader], mine), (theirs[reader], other))[::1 - 2 * (i % 2)]:
                times.append(cpu(fn, data, want))
        lo, med = min(mine) / min(other), statistics.median(mine) / statistics.median(other)
        print(f"{kind} ({len(data)} bytes, {pairs} pairs): this tree {min(mine):.4f} s least, "
              f"{statistics.median(mine):.4f} median; {argv[0]} {min(other):.4f}, "
              f"{statistics.median(other):.4f}; ratio {lo:.3f} least, {med:.3f} median "
              "(host CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
