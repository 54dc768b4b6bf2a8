"""JPEG decoder on numpy, equal to libjpeg-turbo's default output as
Pillow 12.1 reads it (libjpeg-turbo 3.1).

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

- the "islow" IDCT (``jidctint.c``: ``CONST_BITS`` 13, ``PASS1_BITS`` 2,
  and the range-limit table that wraps the output modulo 1024);
- fancy upsampling (``jdsample.c``: ``h2v1``, ``h2v2`` and ``h1v2``, the
  image's edge rows and columns repeated, the alternating biases), with
  plain replication where a component is at most two samples wide, for
  every other whole ratio (3, 4) and for every ratio of a lossless file;
- the fixed-point YCbCr -> RGB tables (``jdcolor.c``: 16 fraction bits,
  ``ONE_HALF``).

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

import numpy as np

from .image_errors import check_pixels

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
    0xC7: "hierarchical lossless JPEG (SOF7)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)",
}
_FRAME_NAMES = {0xC0: "baseline JPEG", 0xC1: "extended sequential JPEG (SOF1)",
                0xC2: "progressive JPEG", 0xC3: "lossless JPEG (SOF3)",
                0xC9: "arithmetic-coded JPEG (SOF9)",
                0xCA: "arithmetic-coded progressive JPEG (SOF10)"}


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


# what a code no table holds decodes to: libjpeg warns, drops 17 bits and
# fakes the symbol 0 (jdhuff.c, jpeg_huff_decode)
_BAD_CODE = 17 << 8


def _huffman_table(counts, symbols) -> list:
    """A DHT table -> a 65,536-entry list indexed by the next 16 bits of the
    stream: (code length << 8) | symbol, or 0 where no code matches."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            if hi > 65536:
                raise ValueError("corrupt JPEG: bad Huffman table")
            lut[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return lut


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded data of a scan from ``pos`` -> (its restart
    intervals as unstuffed byte strings, the position of the marker that
    ends the scan)."""
    segments, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            segments.append(data[start:])
            return [s.replace(b"\xff\x00", b"\xff") for s in segments], len(data)
        j = i + 1
        while j < len(data) and data[j] == 0xFF:  # fill bytes
            j += 1
        m = data[j] if j < len(data) else 0xD9
        if m == 0x00:
            pos = j + 1
        elif 0xD0 <= m <= 0xD7:
            segments.append(data[start:i])
            start = pos = j + 1
        else:
            segments.append(data[start:i])
            return [s.replace(b"\xff\x00", b"\xff") for s in segments], i


def _decode_segment(seg: bytes, blocks, coefs, tables) -> None:
    """Huffman-decode the blocks of one restart interval.  ``blocks`` lists,
    in stream order, (component, offset of the block's 64 coefficients in
    ``coefs[component]``); ``tables[component]`` is (DC table, AC table);
    DC predictions start at 0."""
    seg = seg + b"\x00" * 8  # libjpeg feeds zero bits past the end
    acc = nbits = pos = 0
    pred = {}
    zz = _ZIGZAG
    for comp, base in blocks:
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
        out[base] = v
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


class _BitReader:
    """MSB-first bits of one restart interval, zero bits past its end as
    libjpeg feeds them."""

    def __init__(self, seg: bytes):
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


def _decode_progressive_segment(seg: bytes, blocks, coefs, tables, ss: int, se: int,
                                ah: int, al: int) -> None:
    """One restart interval of a progressive scan (``jdphuff.c``): DC first
    (Ss = 0, Ah = 0) or refinement, AC first or refinement over zigzag
    positions ss..se with point transform al.  ``blocks`` and ``tables`` as
    :func:`_decode_segment`; the DC predictions and the end-of-band run
    start at 0."""
    br = _BitReader(seg)
    zz = _ZIGZAG
    if ss == 0:
        pred = {}
        for comp, base in blocks:
            if ah:
                if br.bits(1):
                    coefs[comp][base] |= 1 << al
                continue
            s = br.huff(tables[comp][0])
            v = (br.signed(s) if s else 0) + pred.get(comp, 0)
            pred[comp] = v
            coefs[comp][base] = v << al
        return
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    for comp, base in blocks:
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
                    out[base + (zz[k] if k < 64 else 63)] = br.signed(s) * p1
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + (br.bits(r) if r else 0) - 1
                    break
                k += 1
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
                    if out[pos]:
                        if br.bits(1) and not out[pos] & p1:
                            out[pos] += p1 if out[pos] >= 0 else m1
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
                if out[pos] and br.bits(1) and not out[pos] & p1:
                    out[pos] += p1 if out[pos] >= 0 else m1
                k += 1
            eobrun -= 1


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
    marker."""

    def __init__(self, seg: bytes):
        self.seg, self.pos = seg, 0
        self.c = self.a = 0
        self.ct = -16

    def decode(self, st: bytearray, i: int) -> int:
        """One binary decision with the statistics bin ``st[i]``."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                byte = self.seg[self.pos] if self.pos < len(self.seg) else 0
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


def _s16(v: int) -> int:
    """An int stored in a JCOEF (int16)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _arith_segment(seg: bytes, blocks, coefs, comps, scan, arith, ss: int, se: int,
                   ah: int, al: int, progressive: bool) -> None:
    """One restart interval of an arithmetic-coded scan (``jdarith.c``):
    sequential (DC and AC of every block), or a progressive DC first, DC
    refinement, AC first or AC refinement pass.  The statistics, the DC
    predictions and contexts start afresh; ``arith`` holds the DAC
    conditioning (L and U of each DC table, K of each AC table)."""
    dec = _ArithDecoder(seg)
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
        for ci, base in blocks:
            if decode(fixed, 0):
                coefs[ci][base] |= 1 << al
        return
    if progressive and ss == 0:  # DC first
        for ci, base in blocks:
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
        for ci, base in blocks:
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
                            out[pos] += m1 if out[pos] < 0 else p1
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
    for ci, base in blocks:  # sequential
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


def _lossless_scan(segments, comps, scan, w: int, h: int, restart: int, dc_tables,
                   predictor: int, pt: int, samples) -> None:
    """A lossless scan (``jdlhuff.c``, ``jddiffct.c``, ``jdpred.c``): one
    Huffman-coded difference a sample, MCU by MCU (each component's h x v
    samples in an interleaved scan, one sample in a single-component one),
    then undifferenced row by row as ``jddiffct.c`` does, an iMCU row (the
    component's v rows) at a time: its first row, where the scan or a
    restart interval starts among its MCU rows, from 1 << (7 - Pt) and its
    left neighbour, every other
    row's first sample from the one above, the rest by the scan's
    predictor, modulo 2**16.  ``samples[ci]`` receives the component's rows
    at its downsampled width, shifted left by Pt into 8 bits."""
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    if len(scan) == 1:
        c = comps[scan[0]]
        mcux, mcuy, units = c["dw"], c["dh"], [(scan[0], 1, 1)]
    else:
        mcux, mcuy = -(-w // hmax), -(-h // vmax)
        units = [(ci, comps[ci]["h"], comps[ci]["v"]) for ci in scan]
    diffs = {ci: np.zeros((mcuy * v, mcux * hh), np.int64) for ci, hh, v in units}
    luts = {ci: dc_tables.get(comps[ci]["td"]) for ci, _, _ in units}
    if any(t is None for t in luts.values()):
        raise ValueError("corrupt JPEG: a lossless scan without its Huffman table")
    per_rows = restart // mcux if restart else mcuy  # MCU rows a restart interval
    if restart and (restart % mcux or not per_rows):
        raise ValueError("lossless JPEG with a restart interval that is not a whole "
                         "number of MCU rows")
    for n, my0 in enumerate(range(0, mcuy, per_rows)):  # the restart intervals
        br = _BitReader(segments[n] if n < len(segments) else b"")
        for my in range(my0, min(my0 + per_rows, mcuy)):
            for mx in range(mcux):
                for ci, hh, v in units:
                    lut, d = luts[ci], diffs[ci]
                    for y in range(my * v, my * v + v):
                        for x in range(mx * hh, mx * hh + hh):
                            s = br.huff(lut)
                            d[y, x] = 32768 if s == 16 else (br.signed(s) if s else 0)
    initial = 1 << (8 - pt - 1)
    per_rows = per_rows if restart else 1 << 30
    for ci, hh, v in units:
        c = comps[ci]
        d = diffs[ci][:, :c["dw"]]
        out = np.zeros_like(d)
        vc = c["v"]  # the rows of an iMCU row, which libjpeg undifferences together
        for y in range(d.shape[0]):
            row, dd = out[y], d[y]
            # the first row of an iMCU row in whose MCU rows (v of them, or 1)
            # the scan or a restart interval starts
            first = y % vc == 0 and any(k % per_rows == 0 for k in range(y // v, (y + vc) // v))
            if first:
                np.cumsum(dd, out=row)
                row += initial
                row &= 0xFFFF  # a running sum modulo 2**16 is the 1-D rule
                continue
            prev = out[y - 1]
            if predictor in (1, 2):
                if predictor == 2:
                    row[:] = (dd + prev) & 0xFFFF
                else:
                    row[0] = (dd[0] + prev[0]) & 0xFFFF
                    row[1:] = dd[1:]
                    np.cumsum(row, out=row)
                    row &= 0xFFFF
                continue
            ra = (dd[0] + prev[0]) & 0xFFFF
            row[0] = ra
            for x in range(1, len(dd)):
                rb, rc = prev[x], prev[x - 1]
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
                ra = (dd[x] + p) & 0xFFFF
                row[x] = ra
        samples[ci] = ((out[:c["dh"]] << pt) & 0xFF).astype(np.uint8)


# jidctint.c's fixed-point constants, FIX(x) = round(x * 2**13)
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961, _F2053, _F2562,
 _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995, 25172)


def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7):
    """One pass of jpeg_idct_islow on int64 arrays (the eight inputs along
    the transformed axis) -> its eight sums before the descale."""
    z1 = (s2 + s6) * _F0541
    tmp2 = z1 - s6 * _F1847
    tmp3 = z1 + s2 * _F0765
    tmp0 = (s0 + s4) << _CONST_BITS
    tmp1 = (s0 - s4) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = s7, s5, s3, s1
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0 = o0 * _F0298
    o1 = o1 * _F2053
    o2 = o2 * _F3072
    o3 = o3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def _range_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT table indexed by (x & 1023): x + 128 clamped
    to [0, 255] for x in [-512, 512), wrapping outside it."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit()


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Quantized coefficients [n, 64] (natural order) and their table [64]
    -> samples [n, 8, 8] uint8, as libjpeg-turbo's jpeg_idct_islow."""
    c = (coefs.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (axis 1), descaled by CONST_BITS - PASS1_BITS into int
    cols = _idct_1d(*(c[:, i, :] for i in range(8)))
    sh = _CONST_BITS - _PASS1_BITS
    ws = np.stack([(t + (1 << (sh - 1))) >> sh for t in cols], axis=1)
    # pass 2: rows (axis 2), descaled by CONST_BITS + PASS1_BITS + 3
    rows = _idct_1d(*(ws[:, :, i] for i in range(8)))
    sh = _CONST_BITS + _PASS1_BITS + 3
    out = np.stack([(t + (1 << (sh - 1))) >> sh for t in rows], axis=2)
    return _RANGE_LIMIT[out & 1023]


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
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes -> [h, w, 3] uint8, as jdcolor.c's ycc_rgb_convert."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """The bytes of a JPEG file -> [h, w, 3] uint8."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    pos = 2
    quant, dc_tables, ac_tables = {}, {}, {}
    arith = {"L": {}, "U": {}, "K": {}}  # DAC conditioning; libjpeg's defaults 0, 1, 5
    frame = sof = None
    restart = 0
    adobe = None
    jfif = False
    coefs = samples = None
    scans = 0
    while True:
        i = data.find(b"\xff", pos)
        if i < 0:
            raise ValueError("corrupt JPEG: no end-of-image marker")
        j = i + 1
        while j < len(data) and data[j] == 0xFF:
            j += 1
        if j >= len(data):
            raise ValueError("corrupt JPEG: no end-of-image marker")
        m = data[j]
        pos = j + 1
        if m == 0xD9:  # EOI
            break
        if m in (0x01,) or 0xD0 <= m <= 0xD7:  # no length
            continue
        length = _u16(data, pos)
        body = data[pos + 2:pos + length]
        pos += length
        if m in _SOF or m in _REFUSED_SOF:
            precision, h, w, nc = body[0], _u16(body, 1), _u16(body, 3), body[5]
            if precision != 8:  # Pillow's plugin refuses it: no plugin opens it
                raise ValueError(f"{precision}-bit JPEG: Pillow cannot open it (8-bit only)")
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG with {nc} components: Pillow cannot open it")
            if h == 0 or w == 0:
                raise ValueError("JPEG with a DNL-defined height: Pillow cannot open it")
            check_pixels(w, h)
            if m in _REFUSED_SOF:
                raise ValueError(f"{_REFUSED_SOF[m]}: libjpeg-turbo, and so Pillow, cannot "
                                 "read it")
            sof = m
            comps = []
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k], body[7 + 3 * k], body[8 + 3 * k]
                hs, vs = hv >> 4, hv & 15
                if not (1 <= hs <= 4 and 1 <= vs <= 4):
                    raise ValueError(f"corrupt JPEG: sampling factors {hs}x{vs} (libjpeg "
                                     "takes 1 to 4)")
                comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
            frame = (h, w, comps)
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            if any(hmax % c["h"] or vmax % c["v"] for c in comps):
                raise ValueError("JPEG with a fractional sampling ratio: libjpeg cannot "
                                 "upsample it")
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # blocks allocated
                c["dw"] = -(-w * c["h"] // hmax)  # downsampled size
                c["dh"] = -(-h * c["v"] // vmax)
            coefs = [[0] * (c["bw"] * c["bh"] * 64) for c in comps]
            samples = [np.zeros((c["dh"], c["dw"]), np.uint8) for c in comps]
        elif m == 0xC4:  # DHT
            at = 0
            while at < len(body):
                tc_th = body[at]
                counts = body[at + 1:at + 17]
                n = sum(counts)
                table = _huffman_table(counts, body[at + 17:at + 17 + n])
                (ac_tables if tc_th >> 4 else dc_tables)[tc_th & 15] = table
                at += 17 + n
        elif m == 0xCC:  # DAC
            for at in range(0, len(body) - 1, 2):
                index, val = body[at], body[at + 1]
                if index >= 32:
                    raise ValueError("corrupt JPEG: bad DAC index")
                if index >= 16:
                    arith["K"][index - 16] = val
                elif (val & 15) > (val >> 4):
                    raise ValueError("corrupt JPEG: DAC with L above U")
                else:
                    arith["L"][index], arith["U"][index] = val & 15, val >> 4
        elif m == 0xDB:  # DQT
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                if pq:
                    vals = [_u16(body, at + 1 + 2 * k) for k in range(64)]
                    at += 129
                else:
                    vals = list(body[at + 1:at + 65])
                    at += 65
                q = np.zeros(64, np.int64)
                q[list(_ZIGZAG)] = vals
                quant[tq] = q
        elif m == 0xDD:  # DRI
            restart = _u16(body, 0)
        elif m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe":
            adobe = body[11] if len(body) > 11 else None
        elif m == 0xDA:  # SOS
            if frame is None:
                raise ValueError("corrupt JPEG: scan before the frame header")
            h, w, comps = frame
            is_arith, process = _SOF[sof]
            ns = body[0]
            scan = []
            for k in range(ns):
                cid, tdta = body[1 + 2 * k], body[2 + 2 * k]
                ci = next((n for n, c in enumerate(comps) if c["id"] == cid), None)
                if ci is None:
                    raise ValueError("corrupt JPEG: scan names an unknown component")
                scan.append(ci)
                comps[ci]["td"], comps[ci]["ta"] = tdta >> 4, tdta & 15
                # a progressive DC scan needs no AC table, an AC scan no DC table
                comps[ci]["tables"] = (dc_tables.get(tdta >> 4), ac_tables.get(tdta & 15))
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], *divmod(body[3 + 2 * ns], 16)
            if not is_arith and process != "lossless":
                for ci in scan:  # libjpeg fails on a table the scan uses and no DHT defined
                    dc, ac = comps[ci]["tables"]
                    if (dc is None and (process == "sequential" or (ss == 0 and not ah))
                            or ac is None and (process == "sequential" or ss)):
                        raise ValueError("corrupt JPEG: a scan names an undefined Huffman "
                                         "table")
            segments, pos = _scan_segments(data, pos)
            scans += 1
            if len(scan) > 1 and sum(comps[ci]["h"] * comps[ci]["v"] for ci in scan) > 10:
                raise ValueError("corrupt JPEG: more than 10 blocks in an MCU")
            if process == "lossless":
                if not 1 <= ss <= 7 or se or ah or al >= 8:
                    raise ValueError("corrupt JPEG: bad lossless scan parameters")
                _lossless_scan(segments, comps, scan, w, h, restart, dc_tables, ss, al,
                               samples)
                continue
            progressive = process == "progressive"
            if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                                or (ss and len(scan) > 1)):
                raise ValueError("corrupt JPEG: bad progressive scan parameters")
            blocks = _scan_blocks(comps, scan, w, h)
            per = restart * len(blocks) // _scan_mcus(comps, scan, w, h) if restart else 0
            tables = {ci: comps[ci]["tables"] for ci in scan}
            if per:
                parts = [blocks[k:k + per] for k in range(0, len(blocks), per)]
            else:
                parts = [blocks]
            segments += [b""] * (len(parts) - len(segments))
            for seg, part in zip(segments, parts):
                if is_arith:
                    _arith_segment(seg, part, coefs, comps, scan, arith, ss, se, ah, al,
                                   progressive)
                elif progressive:
                    _decode_progressive_segment(seg, part, coefs, tables, ss, se, ah, al)
                else:
                    _decode_segment(seg, part, coefs, tables)
        # every other marker (APPn, COM, ...) is skipped
    if frame is None:
        raise ValueError("corrupt JPEG: no frame header")
    if not scans:
        raise ValueError(f"corrupt JPEG: the {_FRAME_NAMES[sof]} frame has no scan")
    h, w, comps = frame
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    lossless = _SOF[sof][1] == "lossless"
    planes = []
    for c, cf, px in zip(comps, coefs, samples):
        if lossless:  # no IDCT, and plain upsampling: libjpeg's fancy filters need DCT blocks
            planes.append(np.repeat(np.repeat(px, vmax // c["v"], 0), hmax // c["h"], 1)[:h, :w])
            continue
        if c["tq"] not in quant:
            raise ValueError("corrupt JPEG: missing quantization table")
        px = idct_islow(np.asarray(cf, np.int64).reshape(-1, 64), quant[c["tq"]])
        plane = px.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c["bh"] * 8, c["bw"] * 8)[:c["dh"], :c["dw"]]
        planes.append(_upsample(plane, hmax // c["h"], vmax // c["v"])[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if lossless and (len(planes) == 3 and jfif or adobe not in (None, 0)):
        raise ValueError("lossless JPEG in YCbCr or YCCK: libjpeg-turbo converts no colour "
                         "in lossless mode, and Pillow fails on it")
    if len(planes) == 4:
        return _four_to_rgb(planes, adobe)
    if lossless or _is_rgb(comps, jfif, adobe):
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


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


def _scan_mcus(comps, scan, w: int, h: int) -> int:
    """MCUs in a scan: one block each in a one-component scan."""
    if len(scan) == 1:
        c = comps[scan[0]]
        return -(-c["dw"] // 8) * -(-c["dh"] // 8)
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    return -(-w // (8 * hmax)) * -(-h // (8 * vmax))


def _scan_blocks(comps, scan, w: int, h: int):
    """The scan's blocks in stream order -> [(component, offset of its 64
    coefficients)]: MCU by MCU, each component's h x v blocks in turn; a
    one-component scan covers only the blocks that meet the component."""
    out = []
    if len(scan) == 1:
        ci = scan[0]
        c = comps[ci]
        for by in range(-(-c["dh"] // 8)):
            for bx in range(-(-c["dw"] // 8)):
                out.append((ci, (by * c["bw"] + bx) * 64))
        return out
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    for my in range(-(-h // (8 * vmax))):
        for mx in range(-(-w // (8 * hmax))):
            for ci in scan:
                c = comps[ci]
                for v in range(c["v"]):
                    for u in range(c["h"]):
                        out.append((ci, ((my * c["v"] + v) * c["bw"] + mx * c["h"] + u) * 64))
    return out

