"""Baseline and progressive JPEG decoder on numpy, equal to libjpeg-turbo's
default output.

Reads Huffman JPEG at 8 bits, sequential (SOF0, and SOF1 at 8 bits) and
progressive (SOF2: spectral selection and successive approximation, the DC
and AC first and refinement scans with their end-of-band runs): 1 or 3
components, any sampling factors whose H and V are 1 or 2 (4:4:4, 4:2:2,
4:2:0, 4:4:0 and the rest), restart intervals, several scans, and images
whose sides are not a multiple of the MCU.  A progressive file's scans fill
one whole-image coefficient buffer before the IDCT, as libjpeg-turbo reads
every scan before its first output pass when not in buffered-image mode;
once every coefficient is complete its block smoothing (``jdcoefct.c``,
``smoothing_ok``) is off, so the output is that of a baseline file with the
same coefficients.  It returns [h, w, 3] uint8, as
Pillow's ``Image.open(path).convert("RGB")``: Pillow decodes through
libjpeg-turbo, whose default output is integer arithmetic, ported here:

- the "islow" IDCT (``jidctint.c``: ``CONST_BITS`` 13, ``PASS1_BITS`` 2,
  and the range-limit table that wraps the output modulo 1024);
- fancy upsampling (``jdsample.c``: ``h2v1``, ``h2v2`` and ``h1v2``, the
  image's edge rows and columns repeated, the alternating biases), with
  plain replication where a component is at most two samples wide;
- the fixed-point YCbCr -> RGB tables (``jdcolor.c``: 16 fraction bits,
  ``ONE_HALF``).

Four components are read as libjpeg-turbo reads them for Pillow: CMYK
without an Adobe marker or with transform 0, YCCK with transform 2 (or any
other), each inverted as Pillow's ``CMYK;I`` raw mode and converted to RGB
as Pillow's ``cmyk2rgb`` does.  Lossless, hierarchical, arithmetic-coded
and 12-bit files raise an ``UnsupportedImageError`` (a ``ValueError``) that
names the format.  Huffman decoding is a Python loop over symbols: each reads a
16-bit window through a 65,536-entry table.
"""

from __future__ import annotations

import numpy as np

from .image_errors import UnsupportedImageError

# zigzag index -> natural (row-major) index of the 8x8 block
_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
           15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
           62, 63)

_UNSUPPORTED_SOF = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical progressive JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)",
}


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


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
        e = dc[(acc >> (nbits - 16)) & 0xFFFF]
        if not e:
            raise ValueError("corrupt JPEG: bad Huffman code")
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
            e = ac[(acc >> (nbits - 16)) & 0xFFFF]
            if not e:
                raise ValueError("corrupt JPEG: bad Huffman code")
            nbits -= e >> 8
            rs = e & 0xFF
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError("corrupt JPEG: coefficient index past 63")
                v = (acc >> (nbits - s)) & ((1 << s) - 1)
                nbits -= s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                out[base + zz[k]] = v
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
        e = lut[(self.acc >> (self.nbits - 16)) & 0xFFFF]
        if not e:
            raise ValueError("corrupt JPEG: bad Huffman code")
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
                    if k > 63:
                        raise ValueError("corrupt JPEG: coefficient index past 63")
                    out[base + zz[k]] = br.signed(s) * p1
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
                    if k > 63:
                        raise ValueError("corrupt JPEG: coefficient index past 63")
                    out[base + zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                pos = base + zz[k]
                if out[pos] and br.bits(1) and not out[pos] & p1:
                    out[pos] += p1 if out[pos] >= 0 else m1
                k += 1
            eobrun -= 1


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
    as libjpeg-turbo's jinit_upsampler picks the method."""
    width = plane.shape[1]
    if (hr, vr) == (1, 1):
        return plane
    if (hr, vr) == (2, 1):
        return _upsample_h2(plane, width, width > 2)
    if (hr, vr) == (1, 2):
        return _upsample_v2(plane)
    if (hr, vr) == (2, 2):
        return _upsample_h2v2(plane, width > 2)
    raise ValueError(f"JPEG sampling ratio {hr}x{vr} is not supported")


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
    """The bytes of a baseline or progressive JPEG file -> [h, w, 3] uint8."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    pos = 2
    quant, dc_tables, ac_tables = {}, {}, {}
    frame = None
    progressive = False
    restart = 0
    adobe = None
    jfif = False
    coefs = None
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
        if m in (0xC0, 0xC1, 0xC2):
            progressive = m == 0xC2
            precision, h, w, nc = body[0], _u16(body, 1), _u16(body, 3), body[5]
            if precision != 8:
                raise UnsupportedImageError(
                    f"{precision}-bit JPEG is not supported (8-bit only)")
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG with {nc} components is not supported")
            if h == 0 or w == 0:
                raise ValueError("JPEG with a DNL-defined height is not supported")
            comps = []
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k], body[7 + 3 * k], body[8 + 3 * k]
                hs, vs = hv >> 4, hv & 15
                if hs not in (1, 2) or vs not in (1, 2):
                    raise ValueError(f"JPEG sampling factors {hs}x{vs} are not supported "
                                     "(1 or 2 only)")
                comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
            frame = (h, w, comps)
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # blocks allocated
                c["dw"] = -(-w * c["h"] // hmax)  # downsampled size
                c["dh"] = -(-h * c["v"] // vmax)
            coefs = [[0] * (c["bw"] * c["bh"] * 64) for c in comps]
        elif m in _UNSUPPORTED_SOF or m == 0xCC:
            raise UnsupportedImageError(
                f"{_UNSUPPORTED_SOF.get(m, 'arithmetic-coded JPEG (DAC)')} is not supported "
                "(sequential and progressive Huffman only)")
        elif m == 0xC4:  # DHT
            at = 0
            while at < len(body):
                tc_th = body[at]
                counts = body[at + 1:at + 17]
                n = sum(counts)
                table = _huffman_table(counts, body[at + 17:at + 17 + n])
                (ac_tables if tc_th >> 4 else dc_tables)[tc_th & 15] = table
                at += 17 + n
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
            ns = body[0]
            scan = []
            for k in range(ns):
                cid, tdta = body[1 + 2 * k], body[2 + 2 * k]
                ci = next((n for n, c in enumerate(comps) if c["id"] == cid), None)
                if ci is None:
                    raise ValueError("corrupt JPEG: scan names an unknown component")
                scan.append(ci)
                # a progressive DC scan needs no AC table, an AC scan no DC table
                comps[ci]["tables"] = (dc_tables.get(tdta >> 4), ac_tables.get(tdta & 15))
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], *divmod(body[3 + 2 * ns], 16)
            if len(scan) > 1 and sum(comps[ci]["h"] * comps[ci]["v"] for ci in scan) > 10:
                raise ValueError("corrupt JPEG: more than 10 blocks in an MCU")
            if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                                or (ss and len(scan) > 1)):
                raise ValueError("corrupt JPEG: bad progressive scan parameters")
            blocks = _scan_blocks(comps, scan, w, h)
            segments, pos = _scan_segments(data, pos)
            per = restart * len(blocks) // _scan_mcus(comps, scan, w, h) if restart else 0
            tables = {ci: comps[ci]["tables"] for ci in scan}
            if per:
                parts = [blocks[k:k + per] for k in range(0, len(blocks), per)]
            else:
                parts = [blocks]
            segments += [b""] * (len(parts) - len(segments))
            for seg, part in zip(segments, parts):
                if progressive:
                    _decode_progressive_segment(seg, part, coefs, tables, ss, se, ah, al)
                else:
                    _decode_segment(seg, part, coefs, tables)
        # every other marker (APPn, COM, ...) is skipped
    if frame is None:
        raise ValueError("corrupt JPEG: no frame header")
    h, w, comps = frame
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    planes = []
    for c, cf in zip(comps, coefs):
        if c["tq"] not in quant:
            raise ValueError("corrupt JPEG: missing quantization table")
        px = idct_islow(np.asarray(cf, np.int64).reshape(-1, 64), quant[c["tq"]])
        plane = px.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c["bh"] * 8, c["bw"] * 8)[:c["dh"], :c["dw"]]
        planes.append(_upsample(plane, hmax // c["h"], vmax // c["v"])[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if len(planes) == 4:
        return _four_to_rgb(planes, adobe)
    if _is_rgb(comps, jfif, adobe):
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


def _is_rgb(comps, jfif: bool, adobe) -> bool:
    """libjpeg's default_decompress_parms for three components: JFIF means
    YCbCr; else an Adobe marker's transform (0 RGB, 1 YCbCr, 2 YCCK);
    else component ids 'R', 'G', 'B' mean RGB."""
    if jfif:
        return False
    if adobe is not None:
        if adobe == 2:
            raise UnsupportedImageError(
                "Adobe transform 2 (YCCK) on a three-component JPEG is not supported")
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
    nk = k[..., None]  # 255 - (255 - k)
    return np.clip(nk - _muldiv255(inv, nk), 0, 255).astype(np.uint8)


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

