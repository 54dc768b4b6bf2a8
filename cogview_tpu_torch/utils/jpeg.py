"""JPEG decoder on numpy, equal to libjpeg-turbo's default output as
Pillow 12.1 reads it (libjpeg-turbo 3.1), damaged files included.

Reads 8-bit JPEG, Huffman or arithmetic-coded (T.81 Annex D's QM coder,
``jdarith.c``, with the DAC conditioning), sequential (SOF0, SOF1, SOF9)
and progressive (SOF2, SOF10: spectral selection and successive
approximation, the DC and AC first and refinement scans), and 8-bit
lossless (SOF3: the seven predictors, point transforms): 1, 3 or 4
components, sampling factors of 1 to 4 whose ratios are whole, restart
intervals, several scans, and images whose sides are not a multiple of the
MCU.  A progressive file's scans fill one whole-image coefficient buffer
before the IDCT, as libjpeg-turbo reads every scan before its first output
pass when not in buffered-image mode; once every coefficient is complete
its block smoothing (``jdcoefct.c``, ``smoothing_ok``) is off, so the
output is that of a baseline file with the same coefficients.  It returns
[h, w, 3] uint8, as Pillow's ``Image.open(path).convert("RGB")``: Pillow
decodes through libjpeg-turbo, whose default output is integer
arithmetic, ported here:

- the "islow" IDCT as libjpeg-turbo's x86-64 build runs it, in AVX2
  (``jidctint-avx2.asm``, the same arithmetic as the SSE2 version):
  ``jidctint.c``'s sums (``CONST_BITS`` 13, ``PASS1_BITS`` 2) in 16-bit
  lanes, so the dequantized coefficients and the sums ``in0 + in4``,
  ``in7 + in3`` and ``in5 + in1`` wrap at 16 bits, each pass's outputs
  saturate to 16 bits, a block whose rows 1-7 are zero takes the shortcut
  ``(in0 << 2)`` in 16 bits, and the samples saturate to 0..255;
- fancy upsampling (``jdsample.c``: ``h2v1``, ``h2v2`` and ``h1v2``, the
  image's edge rows and columns repeated, the alternating biases), with
  plain replication where a component is at most two samples wide, for
  every other whole ratio (3, 4) and for every ratio of a lossless file;
- the fixed-point YCbCr -> RGB tables (``jdcolor.c``: 16 fraction bits,
  ``ONE_HALF``).

Damaged files end as in Pillow: its JPEG plugin's own header parse, which
``Image.open`` runs first (:func:`_pillow_open`), and then libjpeg's,
followed marker by marker (``jdmarker.c``: each segment's length and
table checks, the markers it refuses, a second SOI or SOF, a second scan
in a one-scan file).  In the entropy-coded data libjpeg-turbo counts MCUs
to each restart marker and, where the marker it meets is not the one it
expects, resynchronizes as ``jpeg_resync_to_restart`` does; a marker met
inside an interval ends its data, the MCU then in hand is finished with
zero bits and the rest of the interval is zero blocks, the DC predictions
unmoved, until a restart marker is read (``insufficient_data``); each
coefficient is stored in 16 bits (``JCOEF``).  Where libjpeg stops with
an error Pillow raises "broken data stream", and where its data run out
(a file cut short) Pillow raises "image file is truncated": both raise a
``ValueError`` here, as ``UnsupportedImageError`` never is.

Host memory stays near libjpeg's: a file of one scan holds its
coefficients a band of MCU rows at a time (about a sixteenth of the image,
at most 4,096 blocks, as libjpeg holds an iMCU row), each band going
through the IDCT into its component's samples when the decoder leaves it;
a file of several scans keeps each component's coefficients over the
whole image in 16 bits (an ``array('h')`` of JCOEF values), as libjpeg's
whole-image buffer does, and drops them once that component's samples
are made; the IDCT, block smoothing, upsampling and colour conversion
run over bands of rows, and a lossless file's differences are kept in 16
bits.  The peak is a few bytes a pixel
(``tests/test_torch_image_memory.py``).

Four components are read as libjpeg-turbo reads them for Pillow: CMYK
without an Adobe marker or with transform 0, YCCK with transform 2 (or any
other), each inverted as Pillow's ``CMYK;I`` raw mode and converted to RGB
as Pillow's ``cmyk2rgb`` does.  Three components are YCbCr unless an
Adobe marker's transform 0 or the ids 'R', 'G', 'B' (without JFIF) make
them RGB: an Adobe transform 2 is read as YCbCr, as libjpeg reads it.  A
lossless file's three components are RGB without a JFIF or Adobe marker;
libjpeg-turbo converts no colour in lossless mode, so Pillow fails on a
lossless YCbCr or YCCK file.  What Pillow cannot read raises a
``ValueError`` that names it: 12-bit (and other precisions), hierarchical
frames (SOF5-7, SOF13-15), arithmetic-coded lossless (SOF11), fractional
sampling ratios.  Entropy decoding is a Python loop over symbols: Huffman
codes read a 16-bit window through a 65,536-entry table, the arithmetic
decoder one binary decision at a time.
"""

from __future__ import annotations

import re
from array import array

import numpy as np

from .image_errors import NotThisFormat, check_pixels

# zigzag index -> natural (row-major) index of the 8x8 block
_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
           15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
           62, 63)

# SOF marker -> (arithmetic-coded, process); libjpeg-turbo reads these
_SOF = {0xC0: (False, "sequential"), 0xC1: (False, "sequential"),
        0xC2: (False, "progressive"), 0xC3: (False, "lossless"),
        0xC9: (True, "sequential"), 0xCA: (True, "progressive")}
# the frames it refuses (JERR_SOF_UNSUPPORTED): Pillow opens them and fails
_REFUSED_SOF = {
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical progressive JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)", 0xC8: "JPEG extension frame (JPG)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)",
}
_FRAME_NAMES = {0xC0: "baseline JPEG", 0xC1: "extended sequential JPEG (SOF1)",
                0xC2: "progressive JPEG", 0xC3: "lossless JPEG (SOF3)",
                0xC9: "arithmetic-coded JPEG (SOF9)",
                0xCA: "arithmetic-coded progressive JPEG (SOF10)",
                0xDE: "hierarchical progression (DHP)", **_REFUSED_SOF}


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def _s16(v: int) -> int:
    """An int stored in a JCOEF (int16)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class _Suspend(ValueError):
    """The file ends where libjpeg reads on: Pillow's decoder suspends for
    more data, and at the end of the file ``ImageFile.load`` raises "image
    file is truncated"."""


def _broken(why: str) -> ValueError:
    return ValueError(f"corrupt JPEG: {why} (libjpeg-turbo stops with an error, and Pillow "
                      "raises 'broken data stream')")


# ---- JpegImagePlugin's _open ---------------------------------------------

# the markers Pillow's MARKER table gives the SOF handler, and a plain skip
_PIL_SOF = frozenset((0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE,
                      0xCF, 0xDE))
_PIL_SKIP = frozenset((0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF))


def _pillow_open(data: bytes) -> int:
    """Pillow's ``JpegImagePlugin._open``: the markers up to the first SOS
    as Pillow parses them for the mode and size (its SOF, DQT, APPn, COM
    and skip handlers, junk bytes and fill bytes skipped), then
    ``Image.open``'s size and decompression-bomb checks -> the frame's
    components, which set Pillow's mode (1 L, 3 RGB, 4 CMYK).  Where it fails
    (a ``SyntaxError``, an ``IndexError``, a ``struct.error`` or a short
    read) ``Image.open`` opens no JPEG: ``NotThisFormat``, which names the
    frame where one was read."""
    n = len(data)
    pos, cur = 3, 0xFF
    frame = size = layers = None
    icc = []

    def fail(why: str):
        name = _FRAME_NAMES.get(frame, "JPEG") if frame is not None else "JPEG"
        raise NotThisFormat(f"{name}: Pillow's JPEG plugin cannot read the header ({why})")

    def body() -> bytes:
        nonlocal pos
        if pos + 2 > n:
            fail("a marker's length runs past the end of the file")
        length = _u16(data, pos) - 2
        pos += 2
        if length <= 0:
            return b""
        if pos + length > n:
            fail("a marker segment runs past the end of the file")
        pos += length
        return data[pos - length:pos]

    while True:
        if pos >= n:
            fail("no start-of-scan marker")
        if cur != 0xFF:  # junk between markers
            cur = data[pos]
            pos += 1
            continue
        m = data[pos]
        pos += 1
        if m == 0xFF:  # a fill byte: the next FF starts the marker
            continue
        if m == 0x00:
            cur = -1
            continue
        if m < 0xC0:
            fail("no marker found")
        if m in _PIL_SOF:
            s = body()
            if len(s) < 5:
                fail("a short frame header")
            if s[0] != 8:
                raise NotThisFormat(f"{s[0]}-bit JPEG: Pillow cannot open it (8-bit only)")
            if len(s) < 6:
                fail("a short frame header")
            if s[5] not in (1, 3, 4):
                raise NotThisFormat(f"JPEG with {s[5]} components: Pillow cannot open it")
            if icc and len(min(icc)) < 14:
                fail("a short ICC profile marker")
            icc = []
            if (len(s) - 6) % 3:
                fail("a frame header that ends inside a component")
            frame, size, layers = m, (_u16(s, 3), _u16(s, 1)), s[5]
        elif m in _PIL_SKIP:
            body()
        elif m == 0xDB:
            s = body()
            while s:
                qt_length = 65 if s[0] < 16 else 129
                if len(s) < qt_length:
                    fail("a bad quantization table marker")
                s = s[qt_length:]
        elif 0xE0 <= m <= 0xEF:
            s = body()
            if (m == 0xE0 and s[:4] == b"JFIF" or m == 0xEE and s[:5] == b"Adobe") and len(s) < 7:
                fail("a short JFIF or Adobe marker")
            if m == 0xE2 and s[:12] == b"ICC_PROFILE\0":
                icc.append(s)
            if m == 0xED and s[:14] == b"Photoshop 3.0\0":
                _photoshop(s, fail)
        elif m == 0xFE:
            body()
        if m == 0xDA:
            break
        if pos >= n:
            fail("no byte after a marker")
        cur = data[pos]
        pos += 1
    if frame is None or not size[0] or not size[1]:
        fail("no frame of a known size before the scan")
    check_pixels(*size)
    return layers


def _photoshop(s: bytes, fail) -> None:
    """The resource blocks of Pillow's APP13 parse: a block cut short ends
    it (its ``struct.error``), a name length past the end fails it (an
    ``IndexError``)."""
    at = 14
    while s[at:at + 4] == b"8BIM":
        at += 6
        if at > len(s):
            return
        if at >= len(s):
            fail("a Photoshop resource without its name")
        code = _u16(s, at - 2)
        at += 1 + s[at]
        at += at & 1
        if at + 4 > len(s):
            return
        size = int.from_bytes(s[at:at + 4], "big")
        at += 4
        if code == 0x03ED and len(s[at:at + size]) < 14:
            return
        at += size
        at += at & 1


# ---- Huffman tables ------------------------------------------------------

# T.81 Annex K.3's tables, which libjpeg-turbo puts in the Huffman slots 0
# and 1 that no DHT has filled when a sequential Huffman file's decoding
# starts (jstdhuff.c, for Motion-JPEG; not for a progressive or lossless
# file): (class, index) -> (counts, symbols)
_STD_TABLES = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
        "1718191a25262728292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
        "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
        "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
        "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}

# what a code no table holds decodes to: libjpeg warns, drops 17 bits and
# fakes the symbol 0 (jdhuff.c, jpeg_huff_decode)
_BAD_CODE = 17 << 8


def _huffman_table(counts, symbols, dc_limit=None) -> list:
    """A DHT table -> a 65,536-entry list indexed by the next 16 bits of the
    stream: (code length << 8) | symbol, or 0 where no code matches.  As
    ``jpeg_make_d_derived_tbl`` checks it when a scan first uses it: no
    code may be all ones, and a DC table's symbols are at most
    ``dc_limit``."""
    if dc_limit is not None and any(s > dc_limit for s in symbols):
        raise _broken("a DC Huffman table with a category past its limit")
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code + 1 >= 1 << length:
                raise _broken("a Huffman table with an all-ones code")
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            lut[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return lut


def _unstuff(chunk: bytes) -> bytes:
    """Entropy-coded bytes before a marker -> their data: each FF, or run
    of FF fill bytes, before a stuffed 00 is one FF byte, as
    ``jpeg_fill_bit_buffer`` reads them."""
    if b"\xff\xff" in chunk:
        return re.sub(rb"\xff+\x00", b"\xff", chunk)
    return chunk.replace(b"\xff\x00", b"\xff")


def _decode_segment(seg: bytes, blocks, coefs, tables):
    """Huffman-decode the blocks of one restart interval.  ``blocks`` gives,
    in stream order, (component, offset of the block's 64 coefficients in
    ``coefs[component]``, whether the block starts an MCU);
    ``tables[component]`` is (DC table, AC table); DC predictions start at
    0.  Past the interval's data libjpeg reads zero bits: once an MCU has
    needed them (``insufficient_data``) the rest of the interval stays
    zero blocks.  Returns None, or where the data ran out: the index in
    ``blocks`` of the first MCU left undecoded."""
    limit = 8 * len(seg)
    seg = seg + b"\x00" * 8  # libjpeg feeds zero bits past the end
    acc = nbits = pos = 0
    pred = {}
    zz = _ZIGZAG
    i = -1
    for i, (comp, base, first) in enumerate(blocks):
        if first and (pos << 3) - nbits > limit:
            return i
        dc, ac = tables[comp]
        out = coefs[comp]
        # DC: a category, then that many bits
        if nbits < 32:
            acc = ((acc & ((1 << nbits) - 1)) << 32) | int.from_bytes(seg[pos:pos + 4], "big")
            pos += 4
            nbits += 32
        e = dc[(acc >> (nbits - 16)) & 0xFFFF] or _BAD_CODE
        nbits -= e >> 8
        s = e & 0xFF
        v = 0
        if s:
            v = (acc >> (nbits - s)) & ((1 << s) - 1)
            nbits -= s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        v += pred.get(comp, 0)
        pred[comp] = v
        out[base] = v if -0x8000 <= v <= 0x7FFF else _s16(v)  # a JCOEF
        # AC: (run, size) symbols until EOB or coefficient 63
        k = 1
        while k < 64:
            if nbits < 32:
                acc = ((acc & ((1 << nbits) - 1)) << 32) | int.from_bytes(seg[pos:pos + 4],
                                                                          "big")
                pos += 4
                nbits += 32
            e = ac[(acc >> (nbits - 16)) & 0xFFFF] or _BAD_CODE
            nbits -= e >> 8
            rs = e & 0xFF
            s = rs & 15
            if s:
                k += rs >> 4
                v = (acc >> (nbits - s)) & ((1 << s) - 1)
                nbits -= s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                out[base + (zz[k] if k < 64 else 63)] = v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
    return i + 1 if (pos << 3) - nbits > limit else None


class _Dry(Exception):
    """A fill of libjpeg's bit buffer that needs a byte Pillow has not
    given the decoder."""


def _runs_dry(raw: bytes, start: int, mcus: int, mcu, tables, fast: bool,
              lossless=False) -> bool:
    """Whether libjpeg-turbo, Huffman-decoding ``mcus`` MCUs (each the
    blocks of the components ``mcu`` lists, in order) of a one-scan file
    whose entropy-coded data run from ``raw[start:]`` to the end of
    the file with no marker after them, asks for a byte past the end
    before its last MCU is complete: then Pillow's decoder suspends and
    the file is cut short; else Pillow reads it.  The bit buffer is
    filled as ``jdhuff.c`` fills it: the slow path (``decode_mcu_slow``:
    to at least 57 bits, when a code or its extra bits need more than
    are held, 8 for the lookahead) and, without restart intervals and
    with at least 512 bytes an MCU block left in Pillow's buffer, the fast
    path (``decode_mcu_fast``: six bytes when at most 16 bits are held;
    an MCU whose bytes hold an FF FF pair is decoded again slowly).
    Pillow gives the decoder the file 65,536 bytes at a time, and an MCU
    that runs past the buffer is decoded again once more is given.  A
    ``lossless`` scan's units are samples (``jdlhuff.c``: one difference
    each, its extra bits unless it is 0 or 16, through the slow path)."""
    data, ends, twice = bytearray(), [], []  # data bytes, the raw offset past each
    n, p = len(raw), start
    while p < n:
        q = p + 1
        if raw[p] == 0xFF:
            while q < n and raw[q] == 0xFF:
                q += 1
            if q >= n:
                break
            q += 1  # the stuffed 00
        data.append(raw[p])
        ends.append(q)
        twice.append(q - p > 2)
        p = q
    nd = len(data)
    data += bytes(8)
    end = min(n, -(-start // 65536) * 65536)
    loaded = used = 0  # data bytes loaded into the buffer, bits taken from it

    def fill(need: int) -> None:  # jpeg_fill_bit_buffer
        nonlocal loaded
        if 8 * loaded - used < need:
            to = loaded + max(0, (64 - 8 * loaded + used) // 8)
            if to > nd or ends[to - 1] > end:
                raise _Dry
            loaded = to

    def fill_fast() -> None:  # FILL_BIT_BUFFER_FAST
        nonlocal loaded
        if 8 * loaded - used <= 16:
            if loaded + 6 > nd or any(twice[loaded:loaded + 6]):
                raise _Dry
            loaded += 6

    def symbol(lut, quick: bool) -> int:
        nonlocal used
        at = used >> 3
        e = lut[(int.from_bytes(data[at:at + 3], "big") >> (8 - (used & 7))) & 0xFFFF]
        length = e >> 8 or 17
        if quick:
            fill_fast()
            used += length
        elif fill(8) or length <= 8:
            used += length
        else:  # jpeg_huff_decode: 9 bits, then one at a time
            fill(9)
            used += 9
            for _ in range(length - 9):
                fill(1)
                used += 1
        return e & 0xFF

    def extra(s: int, quick: bool) -> None:
        nonlocal used
        if s:
            fill_fast() if quick else fill(s)
            used += s

    for _ in range(mcus):
        state, slow = (loaded, used), False
        while True:
            left = end - (ends[loaded - 1] if loaded else start)
            quick = fast and not slow and left >= 512 * len(mcu)
            try:
                for comp in mcu:
                    if lossless:
                        s = symbol(tables[comp], False)
                        if s != 16:
                            extra(s, False)
                        continue
                    dc, ac = tables[comp]
                    extra(symbol(dc, quick), quick)
                    k = 1
                    while k < 64:
                        rs = symbol(ac, quick)
                        if rs & 15:
                            k += rs >> 4
                            extra(rs & 15, quick)
                        elif rs != 0xF0:
                            break
                        else:
                            k += 15
                        k += 1
                break
            except _Dry:
                loaded, used = state
                if quick:
                    slow = True
                elif end >= n:
                    return True
                else:
                    end = min(end + 65536, n)
    return False


class _BitReader:
    """MSB-first bits of one restart interval, zero bits past its end as
    libjpeg feeds them."""

    def __init__(self, seg: bytes):
        self.limit = 8 * len(seg)
        self.seg = seg + b"\x00" * 8
        self.acc = self.nbits = self.pos = 0

    def _fill(self) -> None:
        if self.nbits < 32:
            self.acc = (((self.acc & ((1 << self.nbits) - 1)) << 32)
                        | int.from_bytes(self.seg[self.pos:self.pos + 4], "big"))
            self.pos += 4
            self.nbits += 32

    def huff(self, lut) -> int:
        self._fill()
        e = lut[(self.acc >> (self.nbits - 16)) & 0xFFFF] or _BAD_CODE
        self.nbits -= e >> 8
        return e & 0xFF

    def bits(self, n: int) -> int:
        self._fill()
        self.nbits -= n
        return (self.acc >> self.nbits) & ((1 << n) - 1)

    def signed(self, s: int) -> int:
        """s bits as the JPEG magnitude category s value (HUFF_EXTEND)."""
        v = self.bits(s)
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    def ran_out(self) -> bool:
        """Whether more bits were read than the interval holds."""
        return (self.pos << 3) - self.nbits > self.limit


def _decode_progressive_segment(seg: bytes, blocks, coefs, tables, ss: int, se: int,
                                ah: int, al: int):
    """One restart interval of a progressive scan (``jdphuff.c``): DC first
    (Ss = 0, Ah = 0) or refinement, AC first or refinement over zigzag
    positions ss..se with point transform al.  ``blocks`` and ``tables`` as
    :func:`_decode_segment`, and so is the return; the DC predictions and
    the end-of-band run start at 0.  The AC coefficients are stored in 16
    bits as they are written, since a refinement reads them back."""
    br = _BitReader(seg)
    zz = _ZIGZAG
    limit = br.limit
    if ss == 0:
        pred = {}
        i = -1
        for i, (comp, base, first) in enumerate(blocks):
            if first and (br.pos << 3) - br.nbits > limit:  # a refinement reads on, to no avail
                return i
            if ah:
                if br.bits(1):
                    coefs[comp][base] |= 1 << al
                continue
            s = br.huff(tables[comp][0])
            v = (br.signed(s) if s else 0) + pred.get(comp, 0)
            pred[comp] = v
            coefs[comp][base] = _s16(v << al)
        return i + 1 if br.ran_out() else None
    p1, m1 = 1 << al, -1 << al
    big = 15 - al  # a category above this leaves 16 bits
    eobrun = 0
    # a block an MCU; the data can run out only in one that reads bits
    for i, (comp, base, _) in enumerate(blocks):
        out, ac = coefs[comp], tables[comp][1]
        if not ah:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                rs = br.huff(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    v = br.signed(s) * p1
                    out[base + (zz[k] if k < 64 else 63)] = _s16(v) if s > big else v
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + (br.bits(r) if r else 0) - 1
                    break
                k += 1
            if (br.pos << 3) - br.nbits > limit:
                return i + 1
            continue
        # refinement: a correction bit for every coefficient already nonzero
        # that the pass crosses, and new coefficients of magnitude 1 << al
        k = ss
        if not eobrun:
            while k <= se:
                rs = br.huff(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if br.bits(1) else m1
                elif r != 15:
                    eobrun = (1 << r) + (br.bits(r) if r else 0)
                    break
                while k <= se:
                    pos = base + zz[k]
                    c = out[pos]
                    if c:
                        if br.bits(1) and not c & p1:
                            v = c + (p1 if c >= 0 else m1)
                            out[pos] = v if v >= -0x8000 else v + 0x10000
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    out[base + (zz[k] if k < 64 else 63)] = s
                k += 1
        if eobrun:
            while k <= se:
                pos = base + zz[k]
                c = out[pos]
                if c and br.bits(1) and not c & p1:
                    v = c + (p1 if c >= 0 else m1)
                    out[pos] = v if v >= -0x8000 else v + 0x10000
                k += 1
            eobrun -= 1
        if (br.pos << 3) - br.nbits > limit:
            return i + 1
    return None


# T.81 Table D.2 as libjpeg's jpeg_aritab packs it: Qe << 16 | next index
# after an MPS << 8 | switch << 7 | next index after an LPS; entry 113 is
# the fixed probability 0.5 of the sign of an AC coefficient and of the
# refinement bits
_ARITAB = tuple((qe << 16) | (nm << 8) | (sw << 7) | nl for qe, nl, nm, sw in (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)))


class _ArithDecoder:
    """libjpeg's arith_decode (``jdarith.c``, T.81 D.2) over one restart
    interval's bytes, zeros past their end as libjpeg feeds them after a
    marker; ``stop``: None, or the bytes it can read before the data
    Pillow has handed over run out (see :meth:`_Decoder._segment`)."""

    def __init__(self, seg: bytes, stop):
        self.seg, self.pos, self.stop = seg, 0, stop
        self.end = len(seg) if stop is None else stop
        self.c = self.a = 0
        self.ct = -16

    def _past_end(self) -> int:
        """A byte past the readable data: 0 after a marker, else an error,
        since jdarith.c cannot suspend."""
        if self.stop is not None:
            raise _broken("arithmetic-coded data past the bytes Pillow hands over at once")
        return 0

    def decode(self, st: bytearray, i: int) -> int:
        """One binary decision with the statistics bin ``st[i]``."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                byte = self.seg[self.pos] if self.pos < self.end else self._past_end()
                self.pos += 1
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_segment(seg: bytes, stop, blocks, coefs, comps, scan, arith, ss: int, se: int,
                   ah: int, al: int, progressive: bool) -> None:
    """One restart interval of an arithmetic-coded scan (``jdarith.c``):
    sequential (DC and AC of every block), or a progressive DC first, DC
    refinement, AC first or AC refinement pass.  The statistics, the DC
    predictions and contexts start afresh; ``arith`` holds the DAC
    conditioning (L and U of each DC table, K of each AC table)."""
    dec = _ArithDecoder(seg, stop)
    dc_stats = {comps[ci]["td"]: bytearray(64) for ci in scan}
    ac_stats = {comps[ci]["ta"]: bytearray(256) for ci in scan}
    fixed = bytearray([113])
    last = {ci: 0 for ci in scan}
    ctx = {ci: 0 for ci in scan}
    zz = _ZIGZAG
    decode = dec.decode

    def dc_diff(ci: int):
        tbl = comps[ci]["td"]
        st = dc_stats[tbl]
        i = ctx[ci]
        if not decode(st, i):
            ctx[ci] = 0
            return 0
        sign = decode(st, i + 1)
        i += 2 + sign
        m = decode(st, i)
        if m:
            i = 20
            while decode(st, i):
                m <<= 1
                if m == 0x8000:
                    return None
                i += 1
        lo, hi = arith["L"].get(tbl, 0), arith["U"].get(tbl, 1)
        if m < (1 << lo) >> 1:
            ctx[ci] = 0
        elif m > (1 << hi) >> 1:
            ctx[ci] = 12 + 4 * sign
        else:
            ctx[ci] = 4 + 4 * sign
        v = m
        i += 14
        m >>= 1
        while m:
            if decode(st, i):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    def ac_value(st: bytearray, i: int, k: int, kx: int):
        """The nonzero AC coefficient at index k, its bins from st[i]."""
        sign = decode(fixed, 0)
        i += 2
        m = decode(st, i)
        if m and decode(st, i):
            m <<= 1
            i = 189 if k <= kx else 217
            while decode(st, i):
                m <<= 1
                if m == 0x8000:
                    return None
                i += 1
        v = m
        i += 14
        m >>= 1
        while m:
            if decode(st, i):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    if progressive and ss == 0 and ah:  # DC refinement
        for ci, base, _ in blocks:
            if decode(fixed, 0):
                coefs[ci][base] |= 1 << al
        return
    if progressive and ss == 0:  # DC first
        for ci, base, _ in blocks:
            d = dc_diff(ci)
            if d is None:
                return
            last[ci] = (last[ci] + d) & 0xFFFF
            coefs[ci][base] = _s16(last[ci] << al)
        return
    if progressive:
        ci0 = scan[0]
        tbl = comps[ci0]["ta"]
        st = ac_stats[tbl]
        kx = arith["K"].get(tbl, 5)
        p1, m1 = 1 << al, -1 << al
        for ci, base, _ in blocks:
            out = coefs[ci]
            if not ah:  # AC first
                k = ss
                while k <= se:
                    i = 3 * (k - 1)
                    if decode(st, i):
                        break  # end of block
                    while not decode(st, i + 1):
                        i += 3
                        k += 1
                        if k > se:
                            return
                    v = ac_value(st, i, k, kx)
                    if v is None:
                        return
                    out[base + zz[k]] = _s16(v << al)
                    k += 1
                continue
            # AC refinement: EOBx is the last coefficient already nonzero
            kex = se
            while kex > 0 and not out[base + zz[kex]]:
                kex -= 1
            k = ss
            while k <= se:
                i = 3 * (k - 1)
                if k > kex and decode(st, i):
                    break
                while True:
                    pos = base + zz[k]
                    if out[pos]:
                        if decode(st, i + 2):
                            out[pos] = _s16(out[pos] + (m1 if out[pos] < 0 else p1))
                        break
                    if decode(st, i + 1):
                        out[pos] = m1 if decode(fixed, 0) else p1
                        break
                    i += 3
                    k += 1
                    if k > se:
                        return
                k += 1
        return
    for ci, base, _ in blocks:  # sequential
        d = dc_diff(ci)
        if d is None:
            return
        last[ci] = (last[ci] + d) & 0xFFFF
        out = coefs[ci]
        out[base] = _s16(last[ci])
        tbl = comps[ci]["ta"]
        st = ac_stats[tbl]
        kx = arith["K"].get(tbl, 5)
        k = 1
        while k <= 63:
            i = 3 * (k - 1)
            if decode(st, i):
                break
            while not decode(st, i + 1):
                i += 3
                k += 1
                if k > 63:
                    return
            v = ac_value(st, i, k, kx)
            if v is None:
                return
            out[base + zz[k]] = _s16(v)
            k += 1


def _lossless_units(comps, scan, w: int, h: int, restart: int, k: int) -> tuple:
    """The MCUs of a lossless scan's restart interval ``k`` as
    :func:`_runs_dry` takes them -> (their number, the component of each
    sample of an MCU)."""
    if len(scan) == 1:
        c = comps[scan[0]]
        mcux, mcuy, mcu = c["dw"], c["dh"], [scan[0]]
    else:
        hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
        mcux, mcuy = -(-w // hmax), -(-h // vmax)
        mcu = [ci for ci in scan for _ in range(comps[ci]["h"] * comps[ci]["v"])]
    per_rows = restart // mcux if restart else mcuy
    return min(per_rows, mcuy - k * per_rows) * mcux, mcu


def _lossless_scan(drive, comps, scan, w: int, h: int, restart: int, luts: dict,
                   predictor: int, pt: int, samples) -> None:
    """A lossless scan (``jdlhuff.c``, ``jddiffct.c``, ``jdpred.c``): one
    Huffman-coded difference a sample, MCU by MCU (each component's h x v
    samples in an interleaved scan, one sample in a single-component one),
    its restart intervals read through ``drive``, then undifferenced row by
    row as ``jddiffct.c`` does, an iMCU row (the component's v rows) at a
    time: its first row, where the scan or a restart interval starts among
    its MCU rows, or where an MCU row's data had run out
    (``insufficient_data``: its differences stay 0 and the predictor is
    reset, as at a restart), from 1 << (7 - Pt) and its left neighbour,
    every other row's first sample from the one above, the rest by the
    scan's predictor, modulo 2**16.  ``luts[ci]`` is the component's
    Huffman table; ``samples[ci]`` receives the component's rows at its
    downsampled width, shifted left by Pt into 8 bits.  The differences
    are kept modulo 2**16 in 16 bits, and the undifferencing holds one row
    in 64 bits."""
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    if len(scan) == 1:
        c = comps[scan[0]]
        mcux, mcuy, units = c["dw"], c["dh"], [(scan[0], 1, 1)]
    else:
        mcux, mcuy = -(-w // hmax), -(-h // vmax)
        units = [(ci, comps[ci]["h"], comps[ci]["v"]) for ci in scan]
    diffs = {ci: np.zeros((mcuy * v, mcux * hh), np.uint16) for ci, hh, v in units}
    per_rows = restart // mcux if restart else mcuy  # MCU rows a restart interval
    if restart and (restart % mcux or not per_rows):
        raise ValueError("lossless JPEG with a restart interval that is not a whole "
                         "number of MCU rows")
    resets = set()  # the MCU rows where the predictor starts afresh

    def part(n: int, seg, stop):
        rows = range(n * per_rows, min(n * per_rows + per_rows, mcuy))
        resets.add(rows.start)
        if seg is None:
            resets.update(rows)
            return 0
        br = _BitReader(seg)
        for my in rows:
            if br.ran_out():
                resets.update(range(my, rows.stop))
                return my
            for mx in range(mcux):
                for ci, hh, v in units:
                    lut, d = luts[ci], diffs[ci]
                    for y in range(my * v, my * v + v):
                        for x in range(mx * hh, mx * hh + hh):
                            s = br.huff(lut)
                            d[y, x] = 32768 if s == 16 else (br.signed(s) & 0xFFFF if s else 0)
        return rows.stop if br.ran_out() else None

    drive(-(-mcuy // per_rows), part)
    initial = 1 << (8 - pt - 1)
    for ci, hh, v in units:
        c = comps[ci]
        d = diffs.pop(ci)[:, :c["dw"]]
        plane = samples[ci]
        vc = c["v"]  # the rows of an iMCU row, which libjpeg undifferences together
        prev = None
        for y in range(c["dh"]):
            dd = d[y].astype(np.int64)
            # the first row of an iMCU row in whose MCU rows (v of them, or 1)
            # the predictor was reset
            first = y % vc == 0 and any(k in resets for k in range(y // v, (y + vc) // v))
            if first:
                row = np.cumsum(dd)
                row += initial
                row &= 0xFFFF  # a running sum modulo 2**16 is the 1-D rule
            elif predictor in (1, 2):
                if predictor == 2:
                    row = (dd + prev) & 0xFFFF
                else:
                    row = dd
                    row[0] += prev[0]
                    np.cumsum(row, out=row)
                    row &= 0xFFFF
            else:
                row = np.empty_like(dd)
                ra = int(dd[0] + prev[0]) & 0xFFFF
                row[0] = ra
                up, dl = prev.tolist(), dd.tolist()
                for x in range(1, len(dl)):
                    rb, rc = up[x], up[x - 1]
                    if predictor == 3:
                        p = rc
                    elif predictor == 4:
                        p = ra + rb - rc
                    elif predictor == 5:
                        p = ra + ((rb - rc) >> 1)
                    elif predictor == 6:
                        p = rb + ((ra - rc) >> 1)
                    else:
                        p = (ra + rb) >> 1
                    ra = (dl[x] + p) & 0xFFFF
                    row[x] = ra
            plane[y] = (row << pt) & 0xFF
            prev = row


# jidctint.c's fixed-point constants, FIX(x) = round(x * 2**13)
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961, _F2053, _F2562,
 _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995, 25172)


def _w16(x: np.ndarray) -> np.ndarray:
    """Integers -> their low 16 bits as a signed int (a 16-bit lane)."""
    return x.astype(np.int16).astype(np.int32)


def _idct_pass(i0, i1, i2, i3, i4, i5, i6, i7, shift: int):
    """One pass of jsimd_idct_islow_avx2 (``dodct``) on 16-bit lanes held in
    int32 arrays (the eight inputs along the transformed axis): the
    products by the constant pairs and their sums in 32 bits
    (``vpmaddwd``, ``vpaddd``, wrapping as int32 arrays do), the sums
    ``in0 +- in4``, ``in7 + in3`` and ``in5 + in1`` in 16 bits, the eight
    outputs descaled by ``shift`` with rounding and saturated to 16 bits
    (``vpackssdw``)."""
    tmp3 = i2 * (_F0541 + _F0765) + i6 * _F0541
    tmp2 = i2 * _F0541 + i6 * (_F0541 - _F1847)
    tmp0 = _w16(i0 + i4) << 13
    tmp1 = _w16(i0 - i4) << 13
    tmp0 += 1 << (shift - 1)  # the rounding, folded into the even part
    tmp1 += 1 << (shift - 1)
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _w16(i7 + i3), _w16(i5 + i1)
    z3, z4 = (z3 * (_F1175 - _F1961) + z4 * _F1175, z3 * _F1175 + z4 * (_F1175 - _F0390))
    o0 = i7 * (_F0298 - _F0899) - i1 * _F0899 + z3
    o1 = i5 * (_F2053 - _F2562) - i3 * _F2562 + z4
    o2 = i3 * (_F3072 - _F2562) - i5 * _F2562 + z3
    o3 = i1 * (_F1501 - _F0899) - i7 * _F0899 + z4
    out = np.stack((t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2,
                    t10 - o3))
    out >>= shift
    return np.clip(out, -0x8000, 0x7FFF, out=out)


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Quantized coefficients [n, 64] (natural order, each stored in 16
    bits first as a JCOEF) and their table [64] -> samples [n, 8, 8]
    uint8, as libjpeg-turbo's x86-64 islow IDCT (AVX2): the dequantized
    coefficients in 16 bits (``vpmullw``); pass 1 over the columns, or for
    a block whose rows 1-7 are all zero each column's ``in0 << 2`` in 16
    bits; pass 2 over the rows; the samples saturated to -128..127 and
    offset by 128 (``vpacksswb``)."""
    c = _w16(coefs.T).reshape(8, 8, -1)  # [row, column, block]
    q = _w16(c * quant.astype(np.int32).reshape(8, 8, 1))
    ws = _idct_pass(*q, 11)  # [row, column, block]
    dc_rows = ~c[1:].any(axis=(0, 1))
    if dc_rows.any():
        ws[:, :, dc_rows] = _w16(q[0, :, dc_rows] << 2).T
    out = _idct_pass(*ws.transpose(1, 0, 2), 18)  # [column, row, block]
    np.clip(out, -128, 127, out=out)
    out += 128
    return out.transpose(2, 1, 0).astype(np.uint8)


def _upsample_h2(x: np.ndarray, width: int, fancy: bool) -> np.ndarray:
    """[rows, width] -> [rows, 2 * width]: h2v1_fancy_upsample (3/4 of the
    nearer sample, 1/4 of the further, bias 1 leftward and 2 rightward;
    the edge samples repeat), or plain replication."""
    if not fancy:
        return np.repeat(x, 2, axis=1)
    x = x.astype(np.int32)
    p = np.pad(x, ((0, 0), (1, 1)), mode="edge")
    out = np.empty((x.shape[0], 2 * width), np.int32)
    out[:, 0::2] = (3 * x + p[:, :-2] + 1) >> 2
    out[:, 1::2] = (3 * x + p[:, 2:] + 2) >> 2
    return out.astype(np.uint8)


def _upsample_v2(x: np.ndarray) -> np.ndarray:
    """[height, cols] -> [2 * height, cols]: h1v2_fancy_upsample (bias 1 for
    the row taken with the one above, 2 with the one below; the edge rows
    repeat)."""
    x = x.astype(np.int32)
    p = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = (3 * x + p[:-2] + 1) >> 2
    out[1::2] = (3 * x + p[2:] + 2) >> 2
    return out.astype(np.uint8)


def _upsample_h2v2(x: np.ndarray, fancy: bool) -> np.ndarray:
    """[height, width] -> [2 * height, 2 * width]: h2v2_fancy_upsample
    (column sums 3 * nearer row + further row, then 3 * nearer sum +
    further sum with bias 8 leftward and 7 rightward, over 16; the edge
    rows and columns repeat), or plain replication."""
    if not fancy:
        return np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)
    x = x.astype(np.int32)
    pv = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for v, other in ((0, pv[:-2]), (1, pv[2:])):
        colsum = 3 * x + other
        p = np.pad(colsum, ((0, 0), (1, 1)), mode="edge")
        out[v::2, 0::2] = (3 * colsum + p[:, :-2] + 8) >> 4
        out[v::2, 1::2] = (3 * colsum + p[:, 2:] + 7) >> 4
    return out.astype(np.uint8)


def _upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """A component at its downsampled size -> the full grid, by the
    (horizontal, vertical) ratio of the largest sampling factor to its own,
    as libjpeg-turbo's jinit_upsampler picks the method: the fancy h2v1,
    h1v2 and h2v2 filters, and replication (``int_upsample``) for every
    other whole ratio (3 and 4, and 2 beside 3 or 4)."""
    width = plane.shape[1]
    if (hr, vr) == (1, 1):
        return plane
    if (hr, vr) == (2, 1):
        return _upsample_h2(plane, width, width > 2)
    if (hr, vr) == (1, 2):
        return _upsample_v2(plane)
    if (hr, vr) == (2, 2):
        return _upsample_h2v2(plane, width > 2)
    return np.repeat(np.repeat(plane, vr, axis=0), hr, axis=1)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table: 16 fraction bits, ONE_HALF added."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return tuple(t.astype(np.int32) for t in (cr_r, cb_b, cr_g, cb_g))


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes -> [h, w, 3] uint8, as jdcolor.c's ycc_rgb_convert."""
    y = y.astype(np.int32)
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(y + _CR_R[cr], 0, 255)
    out[..., 1] = np.clip(y + ((_CB_G[cb] + _CR_G[cr]) >> 16), 0, 255)
    out[..., 2] = np.clip(y + _CB_B[cb], 0, 255)
    return out


def decode_jpeg(data: bytes, cmyk: bool = False) -> np.ndarray:
    """The bytes of a JPEG file -> [h, w, 3] uint8.  ``cmyk``: four
    components are CMYK whatever an Adobe marker says, as where Pillow's
    decoder is given the JPEG mode "CMYK" (a BLP1 texture's JPEG): libjpeg
    then converts no YCCK, and the inversion and ``cmyk2rgb`` follow."""
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError("not a JPEG")
    _pillow_open(data)
    dec = _Decoder(data)
    dec.cmyk = cmyk
    return dec.run()


_CUT = "JPEG cut short: Pillow raises 'image file is truncated'"
_CHUNK = 65536  # what ImageFile.load reads for the decoder at a time


class _Decoder:
    """libjpeg-turbo's reading of one file as Pillow's decoder drives it:
    ``jpeg_read_header`` (the markers to the first SOS), then every scan
    and the markers between them up to EOI.  A file of one scan is output
    as its MCU rows are decoded, so the end of the file after its last MCU
    is no error (the last ``jpeg_finish_decompress`` only suspends); a
    file of several scans (progressive, or one scan per component) must
    reach EOI first."""

    block_rows = False  # keep each component's rows to its last whole block row
    cmyk = False  # four components as CMYK whatever the Adobe transform (decode_jpeg)

    def __init__(self, data: bytes):
        self.data, self.n = data, len(data)
        self.pos, self.unread = 2, 0  # after SOI; a marker read and not yet processed
        self.held = min(self.n, _CHUNK)  # the bytes Pillow has handed the decoder
        self.fake_eoi = False  # libtiff's source: FF D9 FF D9 ... past the end, never cut short
        # libtiff's old-style JPEG source, whose resync_to_restart is an error:
        # the interval where a restart marker was not the one expected
        self.resync_fails, self.failed_part = False, None
        self.fixed = False  # inside jdarith.c, which cannot suspend for more
        self.dht = {}  # (0 DC or 1 AC, index) -> (counts, symbols)
        self.luts = {}
        self.quant = {}  # index -> [64] in natural order
        self.arith = {"L": {}, "U": {}, "K": {}}  # DAC conditioning; defaults 0, 1, 5
        self.restart = 0
        self.jfif, self.adobe = False, None
        self.sof = self.comps = self.scan = None

    # ---- jdmarker.c ------------------------------------------------------

    def _reach(self, end: int) -> None:
        """A read up to byte ``end``: Pillow hands over the file 65,536
        bytes at a time, more each time the decoder suspends, which the
        arithmetic decoder cannot do."""
        if self.held < min(end, self.n) and self.fixed:
            raise _broken("arithmetic-coded data past the bytes Pillow hands over at once")
        while self.held < min(end, self.n):
            self.held = min(self.held + _CHUNK, self.n)

    def _take(self, k: int) -> bytes:
        if self.pos + k > self.n:
            if not self.fake_eoi:
                raise _Suspend(_CUT)
            head, at = self.data[self.pos:], max(self.pos - self.n, 0) % 2
            self.pos += k
            return head + (b"\xff\xd9" * (k // 2 + 2))[at:at + k - len(head)]
        self.pos += k
        self._reach(self.pos)
        return self.data[self.pos - k:self.pos]

    def _fake_ff(self, pos: int) -> int:
        """Where the next fake FF D9 starts at or after ``pos``: the end of
        the data, or the next even offset past it (a new one once a skip
        runs past the end)."""
        return self.n + (max(pos - self.n, 0) + 1) // 2 * 2

    def _skip(self, k: int) -> None:
        """skip_input_data: a skip past the end of libtiff's source takes a
        fresh fake EOI."""
        self.pos = self._fake_ff(self.pos) if self.fake_eoi and self.pos + k > self.n else (
            self.pos + k)

    def _word(self) -> int:
        return _u16(self._take(2), 0)

    def _next_marker(self) -> None:
        """next_marker: skip bytes that are no marker (stuffed FF 00 pairs,
        FF fill bytes, anything else) and hold the next marker unread."""
        data, n, pos = self.data, self.n, self.pos
        while True:
            i = data.find(b"\xff", pos)
            j = i + 1
            while 0 < j < n and data[j] == 0xFF:
                j += 1
            if i < 0 or j >= n:  # the data end first
                if not self.fake_eoi:
                    raise _Suspend(_CUT)
                self.unread, self.pos = 0xD9, self._fake_ff(pos if i < 0 else n) + 2
                return
            if data[j]:
                self.unread, self.pos = data[j], j + 1
                self._reach(self.pos)
                return
            pos = j + 1

    def _read_markers(self) -> int:
        """read_markers: process markers up to the next SOS (its header
        read) or EOI, and return that marker."""
        while True:
            if not self.unread:
                self._next_marker()
            m = self.unread
            if m == 0xDA:
                self._get_sos()
            elif m in _SOF:
                self._get_sof(m)
            elif m in _REFUSED_SOF:
                raise ValueError(f"{_REFUSED_SOF[m]}: libjpeg-turbo, and so Pillow, cannot read it")
            elif m == 0xC4:
                self._get_dht()
            elif m == 0xCC:
                self._get_dac()
            elif m == 0xDB:
                self._get_dqt()
            elif m == 0xDD:
                if self._word() != 4:
                    raise _broken("a restart interval marker of the wrong length")
                self.restart = self._word()
            elif m in (0xE0, 0xEE):
                self._get_app(m)
            elif 0xE0 <= m <= 0xEF or m in (0xFE, 0xDC):  # skip_variable
                self._skip(max(self._word() - 2, 0))
            elif m == 0xD8:
                raise _broken("a second start-of-image marker")
            elif m != 0xD9 and not 0xD0 <= m <= 0xD7 and m != 0x01:
                raise _broken(f"the unknown marker FF{m:02X}")
            self.unread = 0
            if m in (0xDA, 0xD9):
                return m

    def _get_sof(self, m: int) -> None:
        if self.sof is not None:
            raise _broken("a second frame header")
        length, precision = self._word(), self._take(1)[0]
        h, w, nc = self._word(), self._word(), self._take(1)[0]
        if not (h and w and nc):
            raise _broken("an empty image")
        if length - 8 != 3 * nc:
            raise _broken("a frame header of the wrong length")
        body = self._take(3 * nc)
        self.sof, self.precision, self.size = m, precision, (h, w)
        self.comps = [{"id": body[3 * k], "h": body[3 * k + 1] >> 4, "v": body[3 * k + 1] & 15,
                       "tq": body[3 * k + 2], "quant": None} for k in range(nc)]

    def _get_sos(self) -> None:
        if self.sof is None:
            raise _broken("a scan before the frame header")
        length, ns = self._word(), self._take(1)[0]
        if length != 2 * ns + 6 or not 1 <= ns <= 4:
            raise _broken("a scan header of the wrong length")
        body = self._take(2 * ns + 3)
        scan = []
        for i in range(ns):
            cc, t = body[2 * i], body[2 * i + 1]
            # a component whose index names a scan slot not yet filled
            ci = next((k for k, c in enumerate(self.comps[:4]) if c["id"] == cc and k >= i),
                      None)
            if ci is None:
                raise _broken("a scan names a component the frame does not have")
            scan.append(ci)
            self.comps[ci]["td"], self.comps[ci]["ta"] = t >> 4, t & 15
        self.scan = (scan, body[2 * ns], body[2 * ns + 1], body[2 * ns + 2] >> 4,
                     body[2 * ns + 2] & 15)

    def _get_dht(self) -> None:
        length = self._word() - 2
        while length > 16:
            index, counts = self._take(1)[0], self._take(16)
            count = sum(counts)
            length -= 17
            if count > 256 or count > length:
                raise _broken("a bad Huffman table")
            symbols = self._take(count)
            length -= count
            tc, th = (1, index - 16) if index & 16 else (0, index)
            if th >= 4:
                raise _broken("a Huffman table index past 3")
            self.dht[tc, th] = (counts, symbols)
        if length:
            raise _broken("a Huffman table marker of the wrong length")

    def _get_dqt(self) -> None:
        length = self._word() - 2
        while length > 0:
            b = self._take(1)[0]
            if b & 15 >= 4:
                raise _broken("a quantization table index past 3")
            vals = np.frombuffer(self._take(128), ">u2") if b >> 4 else np.frombuffer(
                self._take(64), np.uint8)
            q = np.zeros(64, np.int64)
            q[list(_ZIGZAG)] = vals
            self.quant[b & 15] = q
            length -= 129 if b >> 4 else 65
        if length:
            raise _broken("a quantization table marker of the wrong length")

    def _get_dac(self) -> None:
        length = self._word() - 2
        while length > 0:
            index, val = self._take(2)
            length -= 2
            if index >= 32:
                raise _broken("a bad DAC index")
            if index >= 16:
                self.arith["K"][index - 16] = val
            elif (val & 15) > (val >> 4):
                raise _broken("a DAC with L above U")
            else:
                self.arith["L"][index], self.arith["U"][index] = val & 15, val >> 4
        if length:
            raise _broken("a DAC marker of the wrong length")

    def _get_app(self, m: int) -> None:
        """get_interesting_appn: the first 14 bytes of APP0 (JFIF) and
        APP14 (Adobe), the rest skipped."""
        length = self._word() - 2
        head = self._take(min(max(length, 0), 14))
        if m == 0xE0 and len(head) >= 14 and head[:5] == b"JFIF\0":
            self.jfif = True
        if m == 0xEE and len(head) >= 12 and head[:5] == b"Adobe":
            self.adobe = head[11]
        self._skip(max(length - len(head), 0))

    # ---- the scans -----------------------------------------------------

    def run(self) -> np.ndarray:
        if self._read_markers() == 0xD9:
            name = _FRAME_NAMES[self.sof] if self.sof is not None else "JPEG"
            raise ValueError(f"corrupt JPEG: the {name} frame has no scan")
        self._setup()
        self.single = len(self.scan[0]) == len(self.comps) and self.process != "progressive"
        while True:
            self._decode_scan()
            if self.single:
                try:  # jpeg_finish_decompress: on to EOI, where the file may end
                    if self._read_markers() == 0xDA:
                        raise _broken("a second scan in a file of one scan")
                except _Suspend:
                    pass
                break
            if self._read_markers() == 0xD9:
                break
        return self._output()

    def _setup(self) -> None:
        """initial_setup and the checks of jpeg_start_decompress, at the
        first scan."""
        (h, w), comps = self.size, self.comps
        if h > 65500 or w > 65500:
            raise _broken(f"an image of {w} x {h}, past libjpeg's 65,500 a side")
        if self.precision != 8:
            raise ValueError(f"{self.precision}-bit JPEG: Pillow cannot open it (8-bit only)")
        for c in comps:
            if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
                raise ValueError(f"corrupt JPEG: sampling factors {c['h']}x{c['v']} (libjpeg "
                                 "takes 1 to 4)")
        self.is_arith, self.process = _SOF[self.sof]
        if self.process == "sequential" and not self.is_arith:  # jinit_huff_decoder only
            for key, table in _STD_TABLES.items():
                self.dht.setdefault(key, table)
        hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
        if any(hmax % c["h"] or vmax % c["v"] for c in comps):
            raise ValueError("JPEG with a fractional sampling ratio: libjpeg cannot upsample it")
        mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        for c in comps:
            c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # blocks allocated
            c["dw"] = -(-w * c["h"] // hmax)  # downsampled size
            c["dh"] = -(-h * c["v"] // vmax)
        # each component's JCOEF values over the whole image (an array('h')),
        # kept only where the file has several scans, as libjpeg keeps them
        self.whole = [None] * len(comps)
        # each component's samples at its downsampled size, made at its first
        # IDCT (:meth:`_sample_plane`) but in a lossless file
        self.samples = [np.zeros((c["dh"], c["dw"]), np.uint8) if self.process == "lossless"
                        else None for c in comps]
        self.coef_bits = [[-1] * 64 for _ in comps]  # jdphuff.c's progression status
        self.prev_bits = [[-1] * 64 for _ in comps]  # ... before each component's last scan
        self.scans = 0
        self.last_good = 0  # the last iMCU row decoded before a scan's data ran out
        # default_decompress_parms, or the colour space Pillow's JPEG mode sets
        self.colour = (self.jfif, 0 if self.cmyk and len(comps) == 4 else self.adobe)
        if self.process == "lossless" and (len(comps) == 3 and self.jfif
                                           or self.colour[1] not in (None, 0)):
            raise ValueError("lossless JPEG in YCbCr or YCCK: libjpeg-turbo converts no colour "
                             "in lossless mode, and Pillow fails on it")

    def _lut(self, tc: int, th: int, dc_limit=None) -> list:
        table = self.dht.get((tc, th))
        if table is None:
            raise _broken("a scan names an undefined Huffman table")
        key = (tc, dc_limit) + table
        if key not in self.luts:
            self.luts[key] = _huffman_table(*table, dc_limit)
        return self.luts[key]

    def _decode_scan(self) -> None:
        """start_input_pass (per_scan_setup, latch_quant_tables, the
        entropy decoder's start_pass), then the scan's data."""
        scan, ss, se, ah, al = self.scan
        comps, (h, w) = self.comps, self.size
        self.scans += 1
        self.luts = {}  # the tables of this scan only
        if len(scan) > 1 and sum(comps[ci]["h"] * comps[ci]["v"] for ci in scan) > 10:
            raise ValueError("corrupt JPEG: more than 10 blocks in an MCU")
        if self.process == "lossless":
            if not 1 <= ss <= 7 or se or ah or al >= 8:
                raise _broken("bad lossless scan parameters")
            luts = {ci: self._lut(0, comps[ci]["td"], 16) for ci in scan}
            dry = None
            if self.single:
                def dry(k, start):
                    mcus, mcu = _lossless_units(comps, scan, w, h, self.restart, k)
                    return _runs_dry(self.data, start, mcus, mcu, luts, False, lossless=True)
            _lossless_scan(lambda n, part: self._drive(n, part, dry), comps, scan, w, h,
                           self.restart, luts, ss, al, self.samples)
            return
        for ci in scan:
            c = comps[ci]
            if c["quant"] is None:
                if c["tq"] not in self.quant:
                    raise _broken("a component whose quantization table is not defined")
                c["quant"] = self.quant[c["tq"]].copy()
        progressive = self.process == "progressive"
        if progressive:
            if (se if ss == 0 else se < ss or se > 63 or len(scan) != 1) or (
                    ah and al != ah - 1) or al > 13:
                raise _broken("bad progressive scan parameters")
            for ci in scan:
                cur, prev = self.coef_bits[ci], self.prev_bits[ci]
                for k in range(min(ss, 1), max(se, 9) + 1):
                    prev[k] = cur[k] if self.scans > 1 else 0
                cur[ss:se + 1] = [al] * (se - ss + 1)
        bands = _Bands(self, scan)
        nmcus = bands.mcux * bands.mcuy
        per = self.restart or nmcus  # MCUs a restart interval
        nparts = -(-nmcus // per)
        coefs = bands.cur
        dry = None

        def blocks(k):
            return bands.blocks(k * per, min(nmcus, k * per + per))

        if self.is_arith:
            def decode(k, seg, stop):
                _arith_segment(seg, stop, blocks(k), coefs, comps, scan, self.arith, ss, se, ah,
                               al, progressive)
        else:
            tables = {ci: (self._lut(0, comps[ci]["td"], 15)
                           if not progressive or ss == ah == 0 else None,
                           self._lut(1, comps[ci]["ta"]) if not progressive or ss else None)
                      for ci in scan}

            def decode(k, seg, stop):
                if seg is None:
                    return 0
                if progressive:
                    return _decode_progressive_segment(seg, blocks(k), coefs, tables, ss, se,
                                                       ah, al)
                return _decode_segment(seg, blocks(k), coefs, tables)

            if self.single:
                def dry(k, start):
                    return _runs_dry(self.data, start, min(per, nmcus - k * per),
                                     [b[0] for b in bands.layout], tables, not self.restart)
        stops = self._drive(nparts, decode, dry)
        bands.flush()
        # jdcoefct.c's last_good_iMCU_row: the iMCU row of the last MCU begun
        # before the scan's data ran out
        nb = len(bands.layout)  # blocks an MCU
        last = max(k * per * nb + (min(per, nmcus - k * per) * nb if stop is None else stop) - 1
                   for k, stop in stops)
        if len(scan) > 1:
            self.last_good = last // nb // bands.mcux
        else:
            self.last_good = last // bands.mcux // comps[scan[0]]["v"]

    def _segment(self):
        """The entropy-coded bytes from here to the next marker, which is
        held unread -> (their data, where libjpeg's reads stop, the end of
        the marker).  The reads stop nowhere (None) where the marker ends
        the data; where the file ends first, Huffman reads stop at the
        end of the data; arithmetic-coded reads, which jdarith.c cannot
        suspend, stop also at the end of the bytes Pillow has handed over,
        an FF there read only with the byte after it."""
        data, n, start = self.data, self.n, self.pos
        pos = start
        while True:
            i = data.find(b"\xff", pos)
            j = i + 1
            while 0 < j < n and data[j] == 0xFF:
                j += 1
            if i < 0 or j >= n:  # the file ends first
                if self.fake_eoi:  # the data, then a fake EOI (a lone D9 first where odd)
                    seg = _unstuff(data[start:n if i < 0 else i])
                    if start > n and (start - n) % 2:
                        seg = b"\xd9"
                    self.unread, self.pos = 0xD9, self._fake_ff(start if i < 0 else n) + 2
                    return seg, None, self.pos
                i, j = (n if i < 0 else i), n + 1
                break
            if data[j]:
                self.unread = data[j]
                break
            pos = j + 1
        seg = _unstuff(data[start:i])
        self.pos = min(j + 1, n)
        stop = len(seg) if j > n else None
        if self.is_arith and j + 1 > self.held:
            stop = len(_unstuff(data[start:min(i, self.held)].rstrip(b"\xff")))
        return seg, stop, j + 1

    def _drive(self, nparts: int, decode, dry=None) -> list:
        """A scan's restart intervals as libjpeg reads them.  Before each
        but the first, process_restart: the next marker must be the RSTn
        expected (n counting 0..7 from the scan's start), else
        jpeg_resync_to_restart decides; a marker left unread makes the
        next interval empty.  ``decode(k, data, stop)`` reads interval k
        (``stop`` as :meth:`_segment` gives it) and returns None, or where
        its data ran out (Huffman: the rest of that interval, and every
        interval up to a restart marker read, stays zero, ``decode(k,
        None, None)``) -> [(k, what decode returned)] for the intervals
        decoded.  Huffman data that run to the end of the file are a file
        cut short, unless ``dry(k, start)`` finds that libjpeg's reads stay
        inside the file."""
        insufficient = False
        expect = end = 0
        stops = []
        for k in range(nparts):
            if k:  # process_restart, which jdarith.c cannot suspend
                self.fixed = self.is_arith
                self._reach(end)
                if not self.unread:
                    self._next_marker()
                if self.unread == 0xD0 + expect:
                    self.unread = 0
                elif self.resync_fails:
                    self.failed_part = k
                    return stops
                else:
                    self._resync(expect)
                self.fixed = False
                expect = (expect + 1) & 7
                if not self.unread:
                    insufficient = False
            if insufficient:
                decode(k, None, None)
                continue
            start = self.pos
            seg, stop, end = (b"", None, start) if self.unread else self._segment()
            if stop is not None and not self.is_arith and (dry is None or dry(k, start)):
                raise _Suspend(_CUT)
            ran_out = decode(k, seg, stop)
            stops.append((k, ran_out))
            insufficient = ran_out is not None
        self._reach(end)  # the marker after the scan, read by consume_markers
        return stops

    def _resync(self, desired: int) -> None:
        """jpeg_resync_to_restart with the marker held unread: RSTn for
        n = desired or more than two away is dropped and decoding goes on
        (1); the next two RSTs, or any marker that is no RST, stay unread
        (3); the two before it, or a marker below SOF0, are skipped to the
        next marker and the choice is made again (2)."""
        while True:
            m = self.unread
            if m < 0xC0:
                action = 2
            elif not 0xD0 <= m <= 0xD7:
                action = 3
            elif m - 0xD0 in ((desired + 1) & 7, (desired + 2) & 7):
                action = 3
            elif m - 0xD0 in ((desired - 1) & 7, (desired - 2) & 7):
                action = 2
            else:
                action = 1
            if action == 1:
                self.unread = 0
                return
            if action == 3:
                return
            self._next_marker()

    def _output(self) -> np.ndarray:
        jfif, adobe = self.colour
        n = len(self.comps)
        if n == 1:
            def colour(planes):
                return np.repeat(planes[0][..., None], 3, axis=2)
        elif n == 4:
            def colour(planes):
                return _four_to_rgb(planes, adobe)
        elif self.process == "lossless" or _is_rgb(self.comps, jfif, adobe):
            def colour(planes):
                return np.stack(planes, axis=-1)
        else:
            def colour(planes):
                return ycc_to_rgb(*planes)
        return self._pixels(colour, 3)

    def _pixels(self, colour, channels: int) -> np.ndarray:
        """The image -> [h, w, channels] uint8: each component's samples
        (:meth:`_planes`), upsampled and passed through ``colour`` (a list
        of [rows, w] uint8 planes -> [rows, w, channels]) a band of rows at
        a time, each component's rows taken with the rows around them that
        its upsampling reads."""
        (h, w), comps = self.size, self.comps
        planes = self._planes()
        hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
        fancy = self.process != "lossless"  # libjpeg's fancy filters need DCT blocks
        out = np.empty((h, w, channels), np.uint8)
        step = vmax * _band_rows(-(-h // vmax), w * vmax, 1 << 18)
        for y0 in range(0, h, step):
            y1 = min(h, y0 + step)
            parts = [_upsampled(p, hmax // c["h"], vmax // c["v"], y0, y1, w, fancy)
                     for c, p in zip(comps, planes)]
            out[y0:y1] = colour(parts)
        return out

    def _planes(self) -> list:
        """The components' samples at their downsampled sizes, uint8.  A
        file of several scans is transformed here from its whole-image
        coefficients, a band of block rows at a time (block smoothing
        first, where it runs), each component's coefficients dropped once
        its samples are made."""
        if self.process == "lossless":
            return self.samples
        if self.single:
            return [self._sample_plane(ci) for ci in range(len(self.comps))]
        (h, w), comps = self.size, self.comps
        vmax = max(c["v"] for c in comps)
        smooth = self.process == "progressive" and _smoothing_ok(comps, self.coef_bits)
        total = -(-h // (8 * vmax))  # iMCU rows
        for ci, (c, bits, prev) in enumerate(zip(comps, self.coef_bits, self.prev_bits)):
            cf, self.whole[ci] = self.whole[ci], None
            if cf is None:  # no scan named it: libjpeg's zero multipliers, gray
                continue
            cf = np.frombuffer(cf, np.int16).reshape(c["bh"], c["bw"], 64)
            quant = c["quant"]
            if smooth:
                prev = prev[:10] if self.scans > 1 else [-1] * 10
                latch = [bits[:10] if i <= self.last_good else prev for i in range(total)]
                dc = cf[..., 0].astype(np.int64)
            rows = _band_rows(c["bh"], c["bw"], 4096)
            for r0 in range(0, c["bh"], rows):
                r1 = min(c["bh"], r0 + rows)
                band = cf[r0:r1]
                if smooth:
                    band = _smooth(cf, dc, quant, latch, c["v"], -(-c["dh"] // 8),
                                   -(-c["dw"] // 8), total, r0, r1)
                self._transform(ci, band, r0)
        return [self._sample_plane(ci) for ci in range(len(comps))]

    def _sample_plane(self, ci: int) -> np.ndarray:
        """Component ``ci``'s samples; where no block has been transformed yet,
        every block a zero block, 128 after the IDCT."""
        if self.samples[ci] is None:
            c = self.comps[ci]
            rows = -(-c["dh"] // 8) * 8 if self.block_rows else c["dh"]
            self.samples[ci] = np.full((rows, c["dw"]), 128, np.uint8)
        return self.samples[ci]

    def _transform(self, ci: int, blocks: np.ndarray, r0: int) -> None:
        """Blocks [rows, bw, 64] (JCOEF values) from block row ``r0`` of
        component ``ci`` -> its samples there, through the IDCT."""
        c = self.comps[ci]
        rows, bw = blocks.shape[:2]
        y0 = 8 * r0
        out = self._sample_plane(ci)
        y1 = min(out.shape[0], y0 + 8 * rows)
        if y1 <= y0:
            return
        px = idct_islow(blocks.reshape(-1, 64), c["quant"])
        plane = px.reshape(rows, bw, 8, 8).transpose(0, 2, 1, 3).reshape(8 * rows, 8 * bw)
        out[y0:y1] = plane[:y1 - y0, :c["dw"]]


def _band_rows(rows: int, per_row: int, most: int) -> int:
    """The rows a band takes: about a sixteenth of ``rows`` but at least an
    eighth of ``most`` units of ``per_row`` a row (a small image in few
    bands), at most ``most`` units, at least one row."""
    per_row = max(per_row, 1)
    return max(1, min(max(-(-rows // 16), most // 8 // per_row), most // per_row))


def _upsampled(plane: np.ndarray, hr: int, vr: int, y0: int, y1: int, w: int,
               fancy: bool) -> np.ndarray:
    """Rows y0..y1 (y0 a multiple of ``vr``) of a component upsampled to the
    full grid -> [y1 - y0, w]: its rows there and, for the fancy vertical
    filters, the row above and below where the image has them; every
    whole ratio but the fancy ones (and every ratio where not ``fancy``)
    replicates."""
    a, b = y0 // vr, -(-y1 // vr)
    if not fancy:
        return np.repeat(np.repeat(plane[a:b], vr, axis=0), hr, axis=1)[:y1 - y0, :w]
    a0, b0 = (max(a - 1, 0), min(b + 1, plane.shape[0])) if vr == 2 else (a, b)
    up = _upsample(plane[a0:b0], hr, vr)
    at = (a - a0) * vr
    return up[at:at + y1 - y0, :w]


class _Bands:
    """A scan's coefficients as its entropy decoder writes them, 16 bits each
    (JCOEF): ``cur[ci]`` is component ``ci``'s ``array('h')`` of the blocks
    the decoder is among.  A file of several scans keeps each component's
    whole image, as libjpeg does; a one-scan file holds a band of MCU rows
    (``blocks`` moves it), as libjpeg holds an iMCU row, and a band left
    goes through the IDCT into the samples."""

    def __init__(self, dec: _Decoder, scan):
        comps, (h, w) = dec.comps, dec.size
        self.dec, self.scan = dec, scan
        if len(scan) == 1:
            c = comps[scan[0]]
            self.mcux, self.mcuy = -(-c["dw"] // 8), -(-c["dh"] // 8)
            units = {scan[0]: (1, 1)}  # block rows and columns an MCU
        else:
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            self.mcux, self.mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            units = {ci: (comps[ci]["v"], comps[ci]["h"]) for ci in scan}
        # each block of an MCU: (component, offset a band's MCU row, offset an
        # MCU column, offset in the MCU, whether it starts the MCU)
        self.layout = []
        for ci in scan:
            bw = comps[ci]["bw"]
            v, u = units[ci]
            for y in range(v):
                for x in range(u):
                    self.layout.append((ci, v * bw * 64, u * 64, (y * bw + x) * 64,
                                        not self.layout))
        self.units = units
        self.rows = self.mcuy if not dec.single else _band_rows(
            self.mcuy, sum(comps[ci]["bw"] * v for ci, (v, _) in units.items()), 4096)
        self.cur = [None] * len(comps)
        self.band = None

    def blocks(self, m0: int, m1: int):
        """MCUs m0..m1 -> their blocks in stream order: (component, offset of
        its 64 coefficients in ``cur[component]``, whether it starts an
        MCU)."""
        mcux, rows, layout = self.mcux, self.rows, self.layout
        for m in range(m0, m1):
            my, mx = divmod(m, mcux)
            b = my // rows
            if b != self.band:
                self.move(b)
            ry = my - b * rows
            for ci, rs, cs, off, first in layout:
                yield ci, ry * rs + mx * cs + off, first

    def _extent(self, ci: int, b: int):
        bh = self.dec.comps[ci]["bh"]
        v = self.units[ci][0] * self.rows
        return min(bh, b * v), min(bh, b * v + v)

    def move(self, b: int) -> None:
        self.flush()
        self.band = b
        dec = self.dec
        for ci in self.scan:
            c = dec.comps[ci]
            if dec.single:
                r0, r1 = self._extent(ci, b)
                self.cur[ci] = array("h", [0]) * ((r1 - r0) * c["bw"] * 64)
            else:
                if dec.whole[ci] is None:
                    dec.whole[ci] = array("h", [0]) * (c["bh"] * c["bw"] * 64)
                self.cur[ci] = dec.whole[ci]

    def flush(self) -> None:
        if self.band is None or not self.dec.single:
            return
        for ci in self.scan:
            r0, r1 = self._extent(ci, self.band)
            band = np.frombuffer(self.cur[ci], np.int16).reshape(r1 - r0, -1, 64)
            self.dec._transform(ci, band, r0)
            self.cur[ci] = None
        self.band = None


class _TiffDecoder(_Decoder):
    """libjpeg-turbo as libtiff's JPEG codec drives it over one strip or
    tile: the whole strip in memory, a fake EOI marker after its end (so
    data that run out read as a marker met, never as a file cut short),
    the Huffman and quantization tables of the JPEGTables stream loaded
    first, no Pillow header parse."""

    def __init__(self, data: bytes, tables):
        if tables is not None:
            _check_soi(tables)
            super().__init__(tables)
            self.held, self.fake_eoi = self.n, True
            if self._read_markers() != 0xD9:
                raise _broken("a JPEGTables stream holding a scan: libtiff refuses it")
            dht, quant, arith = self.dht, self.quant, self.arith
        _check_soi(data)
        super().__init__(data)
        self.held, self.fake_eoi = self.n, True
        if tables is not None:
            self.dht, self.quant, self.arith = dht, quant, arith


def _check_soi(data: bytes) -> None:
    if data[:2] != b"\xff\xd8":
        raise _broken("a JPEG stream that does not start with SOI")


def decode_tiff_jpeg(data: bytes, tables, seg_w: int, seg_h: int, ncomps: int, bps: int,
                     sampling, rgb: bool, tall_ok: bool) -> np.ndarray:
    """One strip or tile of a JPEG-compressed TIFF as libtiff 4.7's
    ``JPEGPreDecode`` and ``JPEGDecode`` read it -> [rows, width *
    components] uint8, the rows libjpeg outputs: the strip's stream after
    the JPEGTables stream's tables, its size no larger than the segment's
    (``tall_ok``: a last strip may be taller), its components, precision
    and sampling factors those the tags give (the first component's
    ``sampling``, the others 1 x 1); YCbCr converted to RGB where ``rgb``
    (Pillow's JPEGCOLORMODE_RGB), every other stream's samples as they
    are.  libtiff ignores an error of ``jpeg_finish_decompress`` (its
    wrapper's -1 reads as success), so a one-scan stream's markers after
    its scan are not read."""
    d = _TiffDecoder(data, tables)
    if d._read_markers() == 0xD9:
        raise _broken("a JPEG stream of no image")
    h, w = d.size
    if w > seg_w or h > seg_h and not (w == seg_w and tall_ok):
        raise ValueError(f"JPEG strip or tile of {w} x {h} beyond its {seg_w} x {seg_h}: "
                         "libtiff refuses it")
    if len(d.comps) != ncomps:
        raise ValueError("JPEG strip of the wrong component count: libtiff refuses it")
    if d.precision != bps:
        raise ValueError("JPEG strip of the wrong data precision: libtiff refuses it")
    if (d.comps[0]["h"], d.comps[0]["v"]) != tuple(sampling) or any(
            (c["h"], c["v"]) != (1, 1) for c in d.comps[1:]):
        raise ValueError("JPEG strip of improper sampling factors: libtiff refuses it")
    d._setup()
    d.single = len(d.scan[0]) == len(d.comps) and d.process != "progressive"
    while True:
        d._decode_scan()
        if d.single:  # libtiff ignores what jpeg_finish_decompress meets after the scan
            break
        if d._read_markers() == 0xD9:
            break
    n = len(d.comps)
    if rgb and n == 3:
        px = d._pixels(lambda planes: ycc_to_rgb(*planes), 3)
    else:
        px = d._pixels(lambda planes: np.stack(planes, axis=-1), n)
    return px.reshape(h, w * n)


def _smoothing_ok(comps, coef_bits) -> bool:
    """jdcoefct.c's smoothing_ok: block smoothing runs where every
    component's table is latched with its first ten quantizers nonzero,
    its DC is known, and some component's first nine AC coefficients are
    not yet exact."""
    useful = False
    for c, bits in zip(comps, coef_bits):
        q = c["quant"]
        if q is None or not all(q[i] for i in _ZIGZAG[:10]) or bits[0] < 0:
            return False
        useful = useful or any(bits[1:10])
    return useful


# the first ten coefficients' natural positions: Q00, Q01, Q10, Q20, Q11, Q02, Q03, Q12, Q21, Q30
_SMOOTHED = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
# each AC estimate (coefficient k = 1..9 of _SMOOTHED) as weights of the 5 x 5 DC values
# around the block (rows above to below, columns left to right): libjpeg-turbo's kernels
# with DC interpolation (no AC coefficient known) and without (only for k = 1..5)
_KERNELS_DC = {
    1: ((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3), (-3, 13, 0, -13, 3),
        (-1, -1, 0, 1, 1)),
    2: ((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), (0, 0, 0, 0, 0), (1, -13, -38, -13, 1),
        (1, 3, 3, 3, 1)),
    3: ((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0), (0, 2, 7, 2, 0), (0, 0, 1, 0, 0)),
    4: ((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), (0, 0, 0, 0, 0), (0, -9, 0, 9, 0), (1, 0, 0, 0, -1)),
    5: ((0, 0, 0, 0, 0), (0, 2, -5, 2, 0), (1, 7, -14, 7, 1), (0, 2, -5, 2, 0), (0, 0, 0, 0, 0)),
    6: ((0, 0, 0, 0, 0), (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0), (0, 0, 0, 0, 0)),
    7: ((0, 0, 0, 0, 0), (0, 1, -3, 1, 0), (0, 0, 0, 0, 0), (0, -1, 3, -1, 0), (0, 0, 0, 0, 0)),
    8: ((0, 0, 0, 0, 0), (0, 1, 0, -1, 0), (0, -3, 0, 3, 0), (0, 1, 0, -1, 0), (0, 0, 0, 0, 0)),
    9: ((0, 0, 0, 0, 0), (0, 1, 2, 1, 0), (0, 0, 0, 0, 0), (0, -1, -2, -1, 0), (0, 0, 0, 0, 0)),
    0: ((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6), (-8, 42, 152, 42, -8), (-6, 6, 42, 6, -6),
        (-2, -6, -8, -6, -2)),
}
_KERNELS = {
    1: ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0), (-7, 50, 0, -50, 7), (0, 0, 0, 0, 0), (0, 0, 0, 0, 0)),
    2: ((0, 0, -7, 0, 0), (0, 0, 50, 0, 0), (0, 0, 0, 0, 0), (0, 0, -50, 0, 0), (0, 0, 7, 0, 0)),
    3: ((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0), (0, 0, 13, 0, 0), (0, 0, -1, 0, 0)),
    4: ((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), (0, 0, 0, 0, 0), (1, -10, 0, 10, -1),
        (0, 1, 0, -1, 0)),
    5: ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0), (-1, 13, -24, 13, -1), (0, 0, 0, 0, 0), (0, 0, 0, 0, 0)),
}


def _smooth(cf: np.ndarray, dc: np.ndarray, quant, latch, v: int, hib: int, wib: int,
            total: int, r0: int, r1: int) -> np.ndarray:
    """jdcoefct.c's decompress_smooth_data (libjpeg-turbo 2.1 and later)
    on block rows r0..r1 of one component's blocks ``cf`` [rows, cols, 64]
    (JCOEF values; ``dc`` their DC values in 64 bits, libjpeg's JLONG) ->
    those rows as the IDCT gets them.  ``latch[i]`` is the coef_bits latch
    (coefficients 0..9) that iMCU row i reads; a coefficient whose latch
    is not 0 (not yet exact) and that is still 0 gets an estimate from
    the 5 x 5 DC values around its block (the image's edge blocks
    repeated), as (Q00 * num + Q/2) / Q in sign-magnitude, capped below
    1 << Al; with no AC coefficient known at all the DC too is estimated
    (DC interpolation)."""
    out = cf[r0:r1].copy()
    view = out[:, :wib]  # the blocks that meet the image
    rows = np.arange(r0, r1)
    imcu = rows // v
    part = hib % v or v  # block rows in the last iMCU row
    block_rows = np.where(imcu < total - 1, v, part)
    keep = rows - imcu * v < block_rows
    ibr = imcu * block_rows + rows - imcu * v  # libjpeg's image_block_row
    ibrs = block_rows * total
    above = np.where(ibr > 0, rows - 1, rows)
    around = [np.where(ibr > 1, rows - 2, above), above, rows]
    below = np.where(ibr < ibrs - 1, rows + 1, rows)
    around += [below, np.where(ibr < ibrs - 2, rows + 2, below)]
    cols = np.arange(wib)
    grid = [[dc[r][:, np.clip(cols + d, 0, wib - 1)] for d in (-2, -1, 0, 1, 2)] for r in around]
    q = [int(quant[p]) for p in _SMOOTHED]
    for bits in {tuple(latch[i]) for i in set(imcu.tolist())}:
        sel = keep & np.array([tuple(latch[i]) == bits for i in imcu])
        change_dc = all(b == -1 for b in bits[1:])
        kernels = _KERNELS_DC if change_dc else _KERNELS
        for k, kern in kernels.items():
            al = bits[k]
            if k and not al:
                continue
            num = q[0] * sum(w * grid[a][b] for a in range(5) for b in range(5)
                             for w in (kern[a][b],) if w)
            big = (q[k] << 7) + np.abs(num)
            pred = big // (q[k] << 8)
            if k and al > 0:
                pred = np.minimum(pred, (1 << al) - 1)
            pred = _w16(np.where(num >= 0, pred, -pred))
            pos = _SMOOTHED[k]
            hit = sel[:, None] & ((view[..., pos] == 0) if k else True)
            view[..., pos] = np.where(hit, pred, view[..., pos])
    return out


def _is_rgb(comps, jfif: bool, adobe) -> bool:
    """libjpeg's default_decompress_parms for three components: JFIF means
    YCbCr; else an Adobe marker's transform 0 means RGB and any other
    YCbCr (transform 2, YCCK, is a four-component transform: libjpeg warns
    and reads the three as YCbCr); else component ids 'R', 'G', 'B' mean
    RGB."""
    if jfif:
        return False
    if adobe is not None:
        return adobe == 0
    return [c["id"] for c in comps] == [82, 71, 66]


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pillow's MULDIV255: a * b / 255, rounded, in integers."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def _four_to_rgb(planes, adobe) -> np.ndarray:
    """Four components -> [h, w, 3] uint8, as Pillow's
    ``convert("RGB")`` of the CMYK image it opens.  libjpeg's
    default_decompress_parms: no Adobe marker means CMYK, transform 0 CMYK,
    any other YCCK, which jdcolor.c's ycck_cmyk_convert turns into CMYK
    (255 minus the YCbCr -> RGB of the first three, K as it is).  Pillow
    then inverts all four (``CMYK;I``, Adobe's polarity) and ``cmyk2rgb``
    gives each channel ``nk - nk * c / 255`` with ``nk = 255 - k``."""
    c, m, y, k = (p.astype(np.int64) for p in planes)
    if adobe is not None and adobe != 0:  # YCCK: the inverted CMYK is the RGB
        inv = ycc_to_rgb(*planes[:3]).astype(np.int64)
    else:
        inv = 255 - np.stack([c, m, y], axis=-1)
    return cmyk_to_rgb(inv, 255 - k)


def cmyk_to_rgb(cmy: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb``: C, M, Y [..., 3] and K [...] (integers in
    0..255) -> [..., 3] uint8, each channel ``nk - nk * c / 255`` with
    ``nk = 255 - k``."""
    nk = 255 - np.asarray(k, np.int64)[..., None]
    return np.clip(nk - _muldiv255(np.asarray(cmy, np.int64), nk), 0, 255).astype(np.uint8)
