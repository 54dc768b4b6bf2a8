"""Zstandard decoder (RFC 8878) on the standard library, as libtiff 4.7's
ZSTD codec drives libzstd 1.5.7 over one strip or tile.

Python 3.12 has no zstd module, so a TIFF whose Compression is 50000 is
read here.  :func:`tiff_decode` is libtiff's ``ZSTDDecode``: it calls
``ZSTD_decompressStream`` on the strip's bytes until a frame ends, the
input runs out or the strip's buffer is full, and the strip is good when
the buffer was filled before any error ("Not enough data" otherwise).
libzstd reads the first frame in one pass where its header gives a
content size the buffer holds and the whole frame is in the strip (an
error anywhere in it fails the strip); otherwise it streams: block by
block, each block decoded whole before any of it is flushed, a raw block
flushed as far as the strip holds it, and once the buffer is full the
decoder still reads on until it has a block of output it cannot flush,
so an error in that block (or in the checksum after a last block that
filled the buffer exactly) fails the strip.  A strip that starts with a
skippable frame, or whose first frame holds less than the strip, fails,
since libtiff stops at the end of the first frame.

Inside a frame: raw, RLE and compressed blocks; the literals section
(raw, RLE, Huffman-coded in one or four streams, with a new or the
previous table); the sequences (FSE tables predefined, RLE, compressed or
repeated; repeat offsets); the content checksum (the low 32 bits of
XXH64).  The checks are libzstd's, and so is the way it reads damaged
data: its bit containers (``BIT_DStream_t``, 64 bits, the state a reload
leaves), ``FSE_readNCount``'s reads near the end of a header, the
Huffman decoder it picks (``HUF_selectDecoder``: one symbol a lookup, or
two), the four-stream fast loops (``HUF_decompress4X*_fast``: a stream's
bits run on into the bytes below it, and no end check) and their
fallbacks, and the last-symbol rule of the two-symbol decoder.  The
history a match may reach is every byte the frame has output (libzstd's
buffer holds more than its window; a strip longer than the window plus
two blocks could reach less there).
"""

from __future__ import annotations

import struct

MAGIC = 0xFD2FB528
_M64 = (1 << 64) - 1
_BLOCK_MAX = 128 * 1024
_WINDOW_LIMIT = (1 << 27) + 1  # ZSTD_MAXWINDOWSIZE_DEFAULT


class ZstdError(ValueError):
    """libzstd's error: libtiff's ZSTDDecode fails the strip."""


def _err(why: str) -> ZstdError:
    return ZstdError(f"corrupt Zstandard data: {why}")


# ---------------------------------------------------------------------------
# bitstream.h: BIT_DStream_t
# ---------------------------------------------------------------------------

_UNFINISHED, _END_OF_BUFFER, _COMPLETED, _OVERFLOW = 0, 1, 2, 3


def _r64(buf, at: int) -> int:
    return int.from_bytes(buf[at:at + 8], "little")


class _BitD:
    """A backward bitstream read as libzstd reads it: a 64-bit container,
    the bits consumed from its top, the pointer a reload moves down to
    ``start``; once more bits are consumed than it holds a reload reports
    an overflow and the container keeps returning what the shifts leave."""

    __slots__ = ("buf", "start", "limit", "ptr", "c", "n")

    def __init__(self, buf, start: int, size: int):
        if size < 1:
            raise _err("an empty bitstream")
        self.buf, self.start, self.limit = buf, start, start + 8
        last = buf[start + size - 1]
        if not last:
            raise _err("a bitstream without its end mark")
        if size >= 8:
            self.ptr = start + size - 8
            self.c = _r64(buf, self.ptr)
            self.n = 8 - last.bit_length() + 1
        else:
            self.ptr = start
            self.c = int.from_bytes(buf[start:start + size], "little")
            self.n = 8 - last.bit_length() + 1 + (8 - size) * 8

    @classmethod
    def at(cls, buf, start: int, ptr: int, consumed: int) -> "_BitD":
        d = cls.__new__(cls)
        d.buf, d.start, d.limit, d.ptr = buf, start, start + 8, ptr
        d.c, d.n = _r64(buf, ptr), consumed
        return d

    def look_fast(self, nb: int) -> int:  # BIT_lookBitsFast
        return ((self.c << (self.n & 63)) & _M64) >> ((64 - nb) & 63)

    def read(self, nb: int) -> int:  # BIT_readBits: BIT_lookBits, then skip
        v = ((self.c << (self.n & 63)) & _M64) >> 1 >> ((63 - nb) & 63)
        self.n += nb
        return v

    def reload(self) -> int:  # BIT_reloadDStream
        n = self.n
        if n > 64:
            self.ptr = None  # libzstd's zero-filled sentinel
            return _OVERFLOW
        if self.ptr >= self.limit:
            self.ptr -= n >> 3
            self.n = n & 7
            self.c = _r64(self.buf, self.ptr)
            return _UNFINISHED
        if self.ptr == self.start:
            return _END_OF_BUFFER if n < 64 else _COMPLETED
        nb, result = n >> 3, _UNFINISHED
        if self.ptr - nb < self.start:
            nb, result = self.ptr - self.start, _END_OF_BUFFER
        self.ptr -= nb
        self.n = n - nb * 8
        self.c = _r64(self.buf, self.ptr)
        return result

    def reload_fast(self) -> int:  # BIT_reloadDStreamFast
        if self.ptr is None or self.ptr < self.limit:
            return _OVERFLOW
        self.ptr -= self.n >> 3
        self.n &= 7
        self.c = _r64(self.buf, self.ptr)
        return _UNFINISHED

    def end(self) -> bool:  # BIT_endOfDStream
        return self.ptr == self.start and self.n == 64


# ---------------------------------------------------------------------------
# FSE (entropy_common.c, fse_decompress.c, the sequences' tables)
# ---------------------------------------------------------------------------

def _read_ncount(buf, start: int, size: int, max_sv: int):
    """FSE_readNCount -> (counts, largest symbol, table log, bytes read)."""
    if size < 8:
        pad = bytes(buf[start:start + size]) + bytes(8 - size)
        counts, msv, log, used = _read_ncount(pad, 0, 8, max_sv)
        if used > size:
            raise _err("an FSE header past its data")
        return counts, msv, log, used
    end = start + size
    counts = [0] * (max_sv + 1)
    ip = start
    bits = int.from_bytes(buf[ip:ip + 4], "little")
    nbits = (bits & 0xF) + 5
    if nbits > 15:
        raise _err("an FSE table log past 15")
    bits >>= 4
    count_bits = 4
    log = nbits
    remaining = (1 << nbits) + 1
    threshold = 1 << nbits
    nbits += 1
    charnum = 0
    max1 = max_sv + 1
    previous0 = False

    def advance():
        nonlocal ip, count_bits, bits
        if ip <= end - 7 or ip + (count_bits >> 3) <= end - 4:
            ip += count_bits >> 3
            count_bits &= 7
        else:
            count_bits -= 8 * (end - 4 - ip)
            count_bits &= 31
            ip = end - 4
        bits = int.from_bytes(buf[ip:ip + 4], "little") >> count_bits

    while True:
        if previous0:
            repeats = _ctz32(~bits | 0x80000000) >> 1
            while repeats >= 12:
                charnum += 36
                if ip <= end - 7:
                    ip += 3
                else:
                    count_bits -= 8 * (end - 7 - ip)
                    count_bits &= 31
                    ip = end - 4
                bits = int.from_bytes(buf[ip:ip + 4], "little") >> count_bits
                repeats = _ctz32(~bits | 0x80000000) >> 1
            charnum += 3 * repeats
            bits >>= 2 * repeats
            count_bits += 2 * repeats
            charnum += bits & 3
            count_bits += 2
            if charnum >= max1:
                break
            advance()
        mx = (2 * threshold - 1) - remaining
        if (bits & (threshold - 1)) < mx:
            count = bits & (threshold - 1)
            count_bits += nbits - 1
        else:
            count = bits & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            count_bits += nbits
        count -= 1
        remaining -= count if count >= 0 else 1
        counts[charnum] = count
        charnum += 1
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nbits = remaining.bit_length()
            threshold = 1 << (nbits - 1)
        if charnum >= max1:
            break
        advance()
    if remaining != 1:
        raise _err("an FSE distribution that does not fill its table")
    if charnum > max1:
        raise _err("an FSE distribution past its largest symbol")
    if count_bits > 32:
        raise _err("an FSE header read past its bits")
    ip += (count_bits + 7) >> 3
    return counts, charnum - 1, log, ip - start


def _ctz32(x: int) -> int:
    x &= 0xFFFFFFFF
    return (x & -x).bit_length() - 1


def _spread(counts, max_sv: int, log: int):
    """The FSE table's symbols, nbBits and next-state bases, as
    FSE_buildDTable_internal and ZSTD_buildFSETable lay them down ->
    (symbols, nb_bits, new_state, fast)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = [0] * (max_sv + 1)
    large = 1 << (log - 1)
    fast = True
    for s in range(max_sv + 1):
        if counts[s] == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
        else:
            if counts[s] >= large:
                fast = False
            nxt[s] = counts[s]
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s in range(max_sv + 1):
        for _ in range(max(counts[s], 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    nb = [0] * size
    new = [0] * size
    for u in range(size):
        x = nxt[symbols[u]]
        nxt[symbols[u]] = x + 1
        nb[u] = log - (x.bit_length() - 1)
        new[u] = (x << nb[u]) - size
    return symbols, nb, new, fast


def _fse_weights(buf, start: int, size: int) -> list:
    """FSE_decompress_wksp of Huffman weights (table log at most 6, at most
    255 of them), two interleaved states, ended by the bitstream's
    overflow as libzstd ends it."""
    counts, msv, log, used = _read_ncount(buf, start, size, 255)
    if log > 6:
        raise _err("a Huffman weight table log past 6")
    symbols, nb, new, fast = _spread(counts, msv, log)
    d = _BitD(buf, start + used, size - used)
    s1 = d.read(log)
    d.reload()
    s2 = d.read(log)
    d.reload()
    if d.reload() == _OVERFLOW:
        raise _err("Huffman weights past their bits")
    out = []
    omax = 255

    def sym(state):
        v = symbols[state]
        return v, new[state] + d.read(nb[state])

    while d.reload() == _UNFINISHED and len(out) < omax - 3:
        v, s1 = sym(s1)
        out.append(v)
        v, s2 = sym(s2)
        out.append(v)
        v, s1 = sym(s1)
        out.append(v)
        v, s2 = sym(s2)
        out.append(v)
    while True:
        if len(out) > omax - 2:
            raise _err("too many Huffman weights")
        v, s1 = sym(s1)
        out.append(v)
        if d.reload() == _OVERFLOW:
            v, s2 = sym(s2)
            out.append(v)
            break
        if len(out) > omax - 2:
            raise _err("too many Huffman weights")
        v, s2 = sym(s2)
        out.append(v)
        if d.reload() == _OVERFLOW:
            v, s1 = sym(s1)
            out.append(v)
            break
    return out


# ---------------------------------------------------------------------------
# Huffman (huf_decompress.c)
# ---------------------------------------------------------------------------

class _Huf:
    """A literals table: each symbol's code length, and the lookup tables
    of the decoder that built it (``double``: HUF_readDTableX2)."""

    def __init__(self, lengths: dict, log: int, double: bool):
        self.double = double
        self.log = max(log, 11) if not double else (11 if log <= 11 else 12)
        dl = self.log
        # canonical codes: the longest codes (lowest weights) first, symbols in order
        order = sorted(lengths, key=lambda s: (-lengths[s], s))
        single = [None] * (1 << dl)
        pos = 0
        for s in order:
            span = 1 << (dl - lengths[s])
            for i in range(pos, pos + span):
                single[i] = (s, lengths[s])
            pos += span
        self.single = single
        if double:
            shortest = min(lengths.values())
            pairs = [None] * (1 << dl)
            for i in range(1 << dl):
                s1, l1 = single[i]
                rest = dl - l1
                if rest >= shortest:
                    s2, l2 = single[(i << l1) & ((1 << dl) - 1)]
                    if l2 <= rest:
                        pairs[i] = ((s1, s2), l1 + l2)
                        continue
                pairs[i] = ((s1,), l1)
            self.pairs = pairs


def _huf_table(buf, start: int, size: int, double: bool):
    """HUF_readStats and the decoding table -> (table, header bytes)."""
    if not size:
        raise _err("an empty Huffman table")
    head = buf[start]
    if head >= 128:
        n = head - 127
        isize = (n + 1) // 2
        if isize + 1 > size:
            raise _err("Huffman weights past the block")
        if n >= 256:
            raise _err("too many Huffman weights")
        weights = []
        for k in range(n):
            b = buf[start + 1 + k // 2]
            weights.append(b >> 4 if k % 2 == 0 else b & 15)
    else:
        isize = head
        if isize + 1 > size:
            raise _err("Huffman weights past the block")
        weights = _fse_weights(buf, start + 1, isize)
    total = 0
    ranks = [0] * 13
    for w in weights:
        if w > 12:
            raise _err("a Huffman weight past 12")
        ranks[w] += 1
        total += (1 << w) >> 1
    if total == 0:
        raise _err("Huffman weights of no code")
    log = total.bit_length()
    if log > 12:
        raise _err("a Huffman table log past 12")
    rest = (1 << log) - total
    last = rest.bit_length()
    if 1 << (last - 1) != rest:
        raise _err("Huffman weights that leave no whole last code")
    weights.append(last)
    ranks[last] += 1
    if ranks[1] < 2 or ranks[1] & 1:
        raise _err("Huffman weights of no valid tree")
    lengths = {s: log + 1 - w for s, w in enumerate(weights) if w}
    return _Huf(lengths, log, double), isize + 1


def _stream_x1(out: bytearray, d: _BitD, count: int, t: _Huf) -> None:
    """HUF_decodeStreamX1: ``count`` symbols."""
    single, dl = t.single, t.log
    p = 0
    if count > 3:
        while d.reload() == _UNFINISHED and p < count - 3:
            for _ in range(4):
                s, nb = single[d.look_fast(dl)]
                d.n += nb
                out.append(s)
            p += 4
    else:
        d.reload()
    while p < count:
        s, nb = single[d.look_fast(dl)]
        d.n += nb
        out.append(s)
        p += 1


def _x2(out: bytearray, d: _BitD, t: _Huf) -> int:
    syms, nb = t.pairs[d.look_fast(t.log)]
    d.n += nb
    out.extend(syms)
    return len(syms)


def _stream_x2(out: bytearray, d: _BitD, count: int, t: _Huf) -> None:
    """HUF_decodeStreamX2: ``count`` symbols, two a lookup where both fit,
    the last as HUF_decodeLastSymbolX2 reads it."""
    p = 0
    if count >= 8:
        if t.log <= 11:
            while d.reload() == _UNFINISHED and p < count - 9:
                for _ in range(5):
                    p += _x2(out, d, t)
        else:
            while d.reload() == _UNFINISHED and p < count - 7:
                for _ in range(4):
                    p += _x2(out, d, t)
    else:
        d.reload()
    if count - p >= 2:
        while d.reload() == _UNFINISHED and p <= count - 2:
            p += _x2(out, d, t)
        while p <= count - 2:
            p += _x2(out, d, t)
    if p < count:
        syms, nb = t.pairs[d.look_fast(t.log)]
        out.append(syms[0])
        if len(syms) == 1:
            d.n += nb
        elif d.n < 64:
            d.n += nb
            if d.n > 64:
                d.n = 64


def _huf_1stream(buf, start: int, size: int, count: int, t: _Huf) -> bytes:
    """HUF_decompress1X*_usingDTable: one stream that must end exactly."""
    d = _BitD(buf, start, size)
    out = bytearray()
    (_stream_x2 if t.double else _stream_x1)(out, d, count, t)
    if not d.end():
        raise _err("a Huffman stream that does not end with its literals")
    return bytes(out[:count])


def _huf_4streams(buf, start: int, size: int, count: int, t: _Huf) -> bytes:
    """HUF_decompress4X*_usingDTable_internal: the fast loops where
    ``HUF_DecompressFastArgs_init`` takes them, else the four streams in
    lock step and then one by one, each ending exactly."""
    seg = (count + 3) // 4
    if t.log == 11:
        if size < 10:
            raise _err("four Huffman streams in fewer than 10 bytes")
        l1, l2, l3 = struct.unpack_from("<HHH", buf, start)
        l4 = size - (l1 + l2 + l3 + 6)
        if min(l1, l2, l3) >= 8 and (l4 < 0 or l4 >= 8):
            if l4 < 0:
                raise _err("Huffman stream lengths past the literals")
            if 3 * seg < count:
                return _huf_fast(buf, start, size, count, t, (l1, l2, l3, l4))
    if size < 10:
        raise _err("four Huffman streams in fewer than 10 bytes")
    if count < 6:
        raise _err("four Huffman streams of fewer than 6 literals")
    l1, l2, l3 = struct.unpack_from("<HHH", buf, start)
    l4 = size - (l1 + l2 + l3 + 6)
    if l4 < 0:
        raise _err("Huffman stream lengths past the literals")
    if 3 * seg > count:
        raise _err("four Huffman streams of too few literals")
    starts = [start + 6, start + 6 + l1, start + 6 + l1 + l2, start + 6 + l1 + l2 + l3]
    ds = [_BitD(buf, a, n) for a, n in zip(starts, (l1, l2, l3, l4))]
    outs = [bytearray() for _ in range(4)]
    ends = [seg, seg, seg, count - 3 * seg]
    if ends[3] >= 8:  # the main loop, the four streams in lock step
        olimit = ends[3] - (7 if t.double else 3)
        signal = True
        while signal and len(outs[3]) < olimit:
            for k in range(4):
                for _ in range(4):
                    if t.double:
                        _x2(outs[k], ds[k], t)
                    else:
                        sym, nb = t.single[ds[k].look_fast(t.log)]
                        ds[k].n += nb
                        outs[k].append(sym)
            signal = [ds[k].reload_fast() for k in range(4)] == [_UNFINISHED] * 4
        for k in range(3):
            if len(outs[k]) > seg:
                raise _err("a Huffman stream past its literals")
    for k in range(4):
        (_stream_x2 if t.double else _stream_x1)(outs[k], ds[k], ends[k] - len(outs[k]), t)
    if not all(d.end() for d in ds):
        raise _err("a Huffman stream that does not end with its literals")
    return b"".join(bytes(o[:e]) for o, e in zip(outs, ends))


def _huf_fast(buf, start: int, size: int, count: int, t: _Huf, lengths) -> bytes:
    """HUF_decompress4X{1,2}_usingDTable_internal_fast: 64-bit containers
    with a sentinel bit, reloaded from memory below each stream (down to
    the jump table), 5 lookups a stream a round for as many rounds as are
    safe; then each stream finished from where it stands, with no end
    check."""
    l1, l2, l3, l4 = lengths
    iend = [start + 6, start + 6 + l1, start + 6 + l1 + l2, start + 6 + l1 + l2 + l3]
    lowest = start
    ip = [iend[1] - 8, iend[2] - 8, iend[3] - 8, start + size - 8]
    bits = []
    for i in range(4):
        last = buf[ip[i] + 7]
        consumed = 8 - last.bit_length() + 1 if last else 0
        bits.append(((_r64(buf, ip[i]) | 1) << consumed) & _M64)
    seg = (count + 3) // 4
    outs = [bytearray() for _ in range(4)]
    seg_ends = [seg, seg, seg, count - 3 * seg]
    single, pairs = t.single, getattr(t, "pairs", None)
    while True:
        if not t.double:
            iters = min((seg_ends[3] - len(outs[3])) // 5, (ip[0] - lowest) // 7)
        else:
            iters = (ip[0] - lowest) // 7
            for k in range(4):
                iters = min(iters, (seg_ends[k] - len(outs[k])) // 10)
        olimit = len(outs[3]) + 5 * iters
        if len(outs[3]) == olimit:
            break
        if any(ip[k] < ip[k - 1] for k in range(1, 4)):
            break
        while True:
            for k in range(4):
                b = bits[k]
                o = outs[k]
                for _ in range(5):
                    if pairs is None:
                        s, nb = single[b >> 53]
                        o.append(s)
                    else:
                        syms, nb = pairs[b >> 53]
                        o.extend(syms)
                    b = (b << nb) & _M64
                ctz = (b & -b).bit_length() - 1 if b else 64
                ip[k] -= ctz >> 3
                bits[k] = ((_r64(buf, ip[k]) | 1) << (ctz & 7)) & _M64
            if len(outs[3]) >= olimit:
                break
    for k in range(4):
        if len(outs[k]) > seg_ends[k]:
            raise _err("a Huffman stream past its literals")
        if ip[k] < iend[k] - 8:
            raise _err("a Huffman stream read past its start")
        b = bits[k]
        d = _BitD.at(buf, lowest, ip[k], (b & -b).bit_length() - 1 if b else 64)
        (_stream_x2 if t.double else _stream_x1)(outs[k], d, seg_ends[k] - len(outs[k]), t)
    return b"".join(bytes(o[:e]) for o, e in zip(outs, seg_ends))


# HUF_selectDecoder's timings: (table, per 256 bytes) of the one- and two-symbol decoders
_ALGO_TIME = ((0, 0, 1, 1), (0, 0, 1, 1), (150, 216, 381, 119), (170, 205, 514, 112),
              (177, 199, 539, 110), (197, 194, 644, 107), (221, 192, 735, 107),
              (256, 189, 881, 106), (359, 188, 1167, 109), (582, 187, 1570, 114),
              (688, 187, 1712, 122), (825, 186, 1965, 136), (976, 185, 2131, 150),
              (1180, 186, 2070, 175), (1377, 185, 1731, 202), (1412, 185, 1695, 202))


def _select_double(count: int, csize: int) -> bool:
    q = 15 if csize >= count else csize * 16 // count
    d256 = count >> 8
    t0, p0, t1, p1 = _ALGO_TIME[q]
    dt0 = t0 + p0 * d256
    dt1 = t1 + p1 * d256
    dt1 += dt1 >> 5
    return dt1 < dt0


# ---------------------------------------------------------------------------
# blocks (zstd_decompress_block.c)
# ---------------------------------------------------------------------------

# the sequences' codes: (baseline, extra bits)
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13),
    (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]
_OF = [((1 << n) - 3 if n > 1 else (0 if n == 0 else 1), n) for n in range(32)]
_LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1)
_ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
               -1)
_OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1)


def _seq_table(counts, max_sv: int, log: int, codes):
    """ZSTD_buildFSETable -> (log, [(baseline, extra bits, nbBits, next base)])."""
    symbols, nb, new, _ = _spread(counts, max_sv, log)
    return log, [codes[s] + (nb[u], new[u]) for u, s in enumerate(symbols)]


_DEFAULTS = {"ll": _seq_table(list(_LL_DEFAULT), 35, 6, _LL),
             "of": _seq_table(list(_OF_DEFAULT), 28, 5, _OF),
             "ml": _seq_table(list(_ML_DEFAULT), 52, 6, _ML)}
_LIMITS = {"ll": (35, 9, _LL), "of": (31, 8, _OF), "ml": (52, 9, _ML)}


class _Frame:
    """The state a frame's blocks share: the previous Huffman table and FSE
    tables (repeat modes), the repeat offsets, and the output."""

    def __init__(self, block_max: int):
        self.block_max = block_max
        self.huf = None
        self.fse = {}
        self.fse_ok = False
        self.rep = [1, 4, 8]
        self.out = bytearray()

    def literals(self, buf, start: int, size: int, cap: int):
        """ZSTD_decodeLiteralsBlock -> (literals, bytes read)."""
        if size < 2:
            raise _err("a compressed block of fewer than 2 bytes")
        b0 = buf[start]
        kind, code = b0 & 3, (b0 >> 2) & 3
        most = min(self.block_max, cap)
        if kind in (2, 3):
            if kind == 3 and self.huf is None:
                raise _err("repeated Huffman literals with no table before")
            if size < 5:
                raise _err("compressed literals in fewer than 5 bytes")
            lhc = int.from_bytes(buf[start:start + 4], "little")
            if code < 2:
                hsize, n, csize = 3, (lhc >> 4) & 0x3FF, (lhc >> 14) & 0x3FF
            elif code == 2:
                hsize, n, csize = 4, (lhc >> 4) & 0x3FFF, lhc >> 18
            else:
                hsize, n, csize = 5, (lhc >> 4) & 0x3FFFF, (lhc >> 22) + (buf[start + 4] << 10)
            one = code == 0
            if n > self.block_max:
                raise _err("more literals than a block holds")
            if not one and n < 6:
                raise _err("four Huffman streams of fewer than 6 literals")
            if csize + hsize > size:
                raise _err("Huffman literals past the block")
            if most < n:
                raise _err("more literals than the output holds")
            at = start + hsize
            if kind == 2:
                if one:
                    table, used = _huf_table(buf, at, csize, False)
                else:
                    table, used = _huf_table(buf, at, csize, _select_double(n, csize))
                if used >= csize:
                    raise _err("a Huffman table that fills its literals")
                at, rest = at + used, csize - used
            else:
                table, rest = self.huf, csize
            lits = (_huf_1stream if one else _huf_4streams)(buf, at, rest, n, table)
            self.huf = table
            return lits, csize + hsize
        if code in (0, 2):
            hsize, n = 1, b0 >> 3
        elif code == 1:
            hsize, n = 2, int.from_bytes(buf[start:start + 2], "little") >> 4
        else:
            hsize = 3
            if kind == 0 and size < 3 or kind == 1 and size < 4:
                raise _err("a literals header past the block")
            n = int.from_bytes(buf[start:start + 3], "little") >> 4
        if kind == 1 and code == 1 and size < 3:
            raise _err("RLE literals past the block")
        if n > self.block_max:
            raise _err("more literals than a block holds")
        if most < n:
            raise _err("more literals than the output holds")
        if kind == 0:
            if hsize + n > size:
                raise _err("raw literals past the block")
            return bytes(buf[start + hsize:start + hsize + n]), hsize + n
        return bytes([buf[start + hsize]]) * n, hsize + 1

    def table(self, name: str, mode: int, buf, at: int, end: int, nseq: int):
        """ZSTD_buildSeqTable -> bytes read."""
        max_sv, max_log, codes = _LIMITS[name]
        if mode == 0:
            self.fse[name] = _DEFAULTS[name]
            return 0
        if mode == 1:
            if at >= end:
                raise _err("an RLE sequence code past the block")
            if buf[at] > max_sv:
                raise _err("an RLE sequence code past its largest")
            self.fse[name] = (0, [codes[buf[at]] + (0, 0)])
            return 1
        if mode == 3:
            if not self.fse_ok:
                raise _err("repeated sequence tables with none before")
            return 0
        counts, msv, log, used = _read_ncount(buf, at, end - at, max_sv)
        if log > max_log:
            raise _err("a sequence table log past its limit")
        self.fse[name] = _seq_table(counts, msv, log, codes)
        return used

    def block(self, buf, start: int, size: int, cap: int) -> bytes:
        """ZSTD_decompressBlock_internal of one compressed block -> its output."""
        if size > self.block_max:
            raise _err("a compressed block larger than its maximum")
        lits, used = self.literals(buf, start, size, cap)
        at, end = start + used, start + size
        if at >= end:
            raise _err("no sequences section")
        nseq = buf[at]
        at += 1
        if nseq > 0x7F:
            if nseq == 0xFF:
                if at + 2 > end:
                    raise _err("a sequence count past the block")
                nseq = int.from_bytes(buf[at:at + 2], "little") + 0x7F00
                at += 2
            else:
                if at >= end:
                    raise _err("a sequence count past the block")
                nseq = ((nseq - 0x80) << 8) + buf[at]
                at += 1
        if nseq == 0:
            if at != end:
                raise _err("data after a sequences section of none")
            if len(lits) > cap:
                raise _err("more output than the buffer holds")
            return lits
        if at + 1 > end:
            raise _err("no sequence modes")
        modes = buf[at]
        if modes & 3:
            raise _err("reserved sequence mode bits set")
        at += 1
        for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
            at += self.table(name, (modes >> shift) & 3, buf, at, end, nseq)
        return self.sequences(buf, at, end - at, nseq, lits, cap)

    def sequences(self, buf, start: int, size: int, nseq: int, lits: bytes, cap: int):
        """ZSTD_decompressSequences: decode and execute, the bitstream ending
        exactly after the last sequence."""
        self.fse_ok = True
        d = _BitD(buf, start, size)
        (llog, ll), (olog, of), (mlog, ml) = self.fse["ll"], self.fse["of"], self.fse["ml"]
        sll = d.read(llog)
        d.reload()
        sof = d.read(olog)
        d.reload()
        sml = d.read(mlog)
        d.reload()
        rep = list(self.rep)
        out = self.out
        base = len(out)
        try:
            return self._run(d, nseq, lits, cap, rep, (llog, ll, olog, of, mlog, ml),
                             (sll, sof, sml))
        except ZstdError:
            del out[base:]  # a block that fails contributes nothing
            raise

    def _run(self, d, nseq, lits, cap, rep, tables, states):
        llog, ll, olog, of, mlog, ml = tables
        sll, sof, sml = states
        out = self.out
        base = len(out)
        lp = 0
        nlits = len(lits)
        for k in range(nseq, 0, -1):
            llb, llx, llnb, llnext = ll[sll]
            mlb, mlx, mlnb, mlnext = ml[sml]
            ofb, ofx, ofnb, ofnext = of[sof]
            if ofx > 1:
                offset = ofb + d.read(ofx)
                rep = [offset, rep[0], rep[1]]
            elif ofx == 0:
                if llb == 0:
                    rep = [rep[1], rep[0], rep[2]]
                offset = rep[0]
            else:
                offset = ofb + (llb == 0) + d.read(1)
                temp = rep[0] - 1 if offset == 3 else rep[offset]
                if temp == 0:
                    temp = -1  # libzstd's (size_t)-1: the match fails
                rep = [temp, rep[0], rep[1] if offset != 1 else rep[2]]
                offset = temp
            mlen = mlb + (d.read(mlx) if mlx else 0)
            if llx + mlx + ofx >= 31:
                d.reload()
            llen = llb + (d.read(llx) if llx else 0)
            if k > 1:
                sll = llnext + d.read(llnb)
                sml = mlnext + d.read(mlnb)
                sof = ofnext + d.read(ofnb)
                d.reload()
            if lp + llen > nlits:
                raise _err("a sequence past its literals")
            if len(out) - base + llen + mlen > cap:
                raise _err("more output than the buffer holds")
            out += lits[lp:lp + llen]
            lp += llen
            if offset <= 0 or offset > len(out):
                raise _err("a match offset before the output")
            src = len(out) - offset
            if offset >= mlen:
                out += out[src:src + mlen]
            else:
                chunk = bytes(out[src:])
                reps, extra = divmod(mlen, offset)
                out += chunk * reps + chunk[:extra]
        if not d.end():
            raise _err("a sequences bitstream that does not end with its sequences")
        self.rep = rep
        if len(out) - base + nlits - lp > cap:
            raise _err("more output than the buffer holds")
        out += lits[lp:]
        got = bytes(out[base:])
        del out[base:]
        return got


# ---------------------------------------------------------------------------
# frames (zstd_decompress.c) and libtiff's ZSTDDecode
# ---------------------------------------------------------------------------

def _header(src, at: int):
    """ZSTD_getFrameHeader -> None where the strip ends inside the header,
    ("skip",) for a skippable frame, else (header size, window size,
    content size or None, checksum flag, dictionary id)."""
    n = len(src) - at
    if n < 5:  # libzstd waits for more, or refuses a magic it does not know: both fail
        return None
    magic = struct.unpack_from("<I", src, at)[0]
    if magic & 0xFFFFFFF0 == 0x184D2A50:
        return ("skip",)
    if magic != MAGIC:
        raise _err("not a Zstandard frame")
    fhd = src[at + 4]
    single = (fhd >> 5) & 1
    did = (0, 1, 2, 4)[fhd & 3]
    fcs_code = fhd >> 6
    fcs_len = (1 if single else 0, 2, 4, 8)[fcs_code]
    size = 5 + (not single) + did + fcs_len
    if n < size:
        return None
    if fhd & 0x08:
        raise _err("a frame header's reserved bit set")
    pos = at + 5
    window = 0
    if not single:
        wl = src[pos]
        log = (wl >> 3) + 10
        if log > 31:
            raise _err("a window past 2**31")
        window = (1 << log) + ((1 << log) >> 3) * (wl & 7)
        pos += 1
    dict_id = int.from_bytes(src[pos:pos + did], "little")
    pos += did
    fcs = None
    if fcs_len:
        fcs = int.from_bytes(src[pos:pos + fcs_len], "little") + (256 if fcs_len == 2 else 0)
    if single:
        window = fcs
    return size, window, fcs, (fhd >> 2) & 1, dict_id


def _frame_size(src, at: int, head):
    """ZSTD_findFrameCompressedSize -> the frame's bytes, or None where
    libzstd finds no whole frame in the strip."""
    size, _, _, check, _ = head
    pos, n = at + size, len(src)
    while True:
        if n - pos < 3:
            return None
        h = int.from_bytes(src[pos:pos + 3], "little")
        kind, last, bsize = (h >> 1) & 3, h & 1, h >> 3
        if kind == 3:
            return None
        c = 1 if kind == 1 else bsize
        if 3 + c > n - pos:
            return None
        pos += 3 + c
        if last:
            break
    if check:
        if n - pos < 4:
            return None
        pos += 4
    return pos - at


def _block_header(src, pos: int):
    h = int.from_bytes(src[pos:pos + 3], "little")
    return h & 1, (h >> 1) & 3, h >> 3


def _one_pass(src, at: int, head, cap: int, got: bytearray) -> bytes:
    """ZSTD_decompress_usingDDict of one whole frame (libzstd's single-pass
    shortcut) into ``got`` -> its output, or an error anywhere in it."""
    size, window, fcs, check, dict_id = head
    if dict_id:
        raise _err("a frame that names a dictionary")
    f = _Frame(min(window, _BLOCK_MAX))
    f.out = got
    pos = at + size
    h = _xxh64()
    while True:
        last, kind, bsize = _block_header(src, pos)
        pos += 3
        if kind == 3:
            raise _err("a reserved block type")
        room = cap - len(f.out)
        if kind == 0:
            if bsize > room:
                raise _err("a raw block past the output")
            data = bytes(src[pos:pos + bsize])
        elif kind == 1:
            if bsize > room:
                raise _err("an RLE block past the output")
            data = bytes([src[pos]]) * bsize
            bsize = 1
        else:
            data = f.block(src, pos, bsize, room)
        pos += bsize
        f.out += data
        h.update(data)
        if last:
            break
    if fcs is not None and len(f.out) != fcs:
        raise _err("a frame whose output is not its content size")
    if check and struct.unpack_from("<I", src, pos)[0] != h.digest() & 0xFFFFFFFF:
        raise _err("a content checksum that does not match")
    return bytes(f.out)


def tiff_decode(src: bytes, size: int, partial: bool = False) -> bytes:
    """libtiff's ZSTDDecode of one strip or tile into ``size`` bytes ->
    those bytes, or a ValueError where libtiff fails it (``partial``: the
    output of the blocks decoded before the failure instead, the block
    that fails contributing nothing)."""
    got = bytearray()
    try:
        return _tiff_decode(src, size, got)
    except ValueError:
        if not partial:
            raise
        return bytes(got[:size])


def _tiff_decode(src: bytes, size: int, got: bytearray) -> bytes:
    head = _header(src, 0)
    short = ValueError("TIFF Zstandard strip ends early: libtiff has not enough data")
    if head is None or head[0] == "skip":
        raise short
    hsize, window, fcs, check, dict_id = head
    if fcs is not None and size >= fcs:
        whole = _frame_size(src, 0, head)
        if whole is not None:
            out = _one_pass(src, 0, head, size, got)
            if len(out) < size:
                raise short
            return out[:size]
    if dict_id:
        raise _err("a frame that names a dictionary")
    block_max = min(window, _BLOCK_MAX)
    window = max(window, 1024)
    if window > _WINDOW_LIMIT:
        raise _err("a window past libzstd's default limit")
    # libzstd's output buffer: the content size where that is smaller than a
    # window and two blocks
    cap = fcs if fcs is not None and fcs < window + 2 * block_max + 64 else None
    f = _Frame(block_max)
    f.out = out = got  # every byte of the frame so far, the history its matches reach
    h = _xxh64() if check else None
    full = False
    decoded = 0
    pos, n = hsize, len(src)
    while True:
        if n - pos < 3:
            break
        last, kind, bsize = _block_header(src, pos)
        if kind == 3:
            raise _err("a reserved block type")
        if kind != 1 and bsize > block_max:
            raise _err("a block larger than its maximum")
        pos += 3
        room = (cap - decoded) if cap is not None else 1 << 62
        partial = False
        if kind != 1 and bsize == 0:  # an empty block
            data = b""
        elif kind == 0:
            take = min(n - pos, bsize)
            if take == 0:
                break
            partial = take < bsize
            if take > room:
                raise _err("a raw block past the output")
            data = bytes(src[pos:pos + take])
            pos += take
        elif kind == 1:
            if n - pos < 1:
                break
            if bsize > room:
                raise _err("an RLE block past the output")
            data = bytes([src[pos]]) * bsize
            pos += 1
        else:
            if n - pos < bsize:
                break
            data = f.block(src, pos, bsize, room)
            pos += bsize
        if len(data) > block_max:
            raise _err("a block's output larger than its maximum")
        decoded += len(data)
        if h is not None:
            h.update(data)
        if last and not partial and (kind == 1 or bsize):
            if fcs is not None and decoded != fcs:
                raise _err("a frame whose output is not its content size")
        if data:
            if full:
                return bytes(out[:size])
            out += data
            if len(out) > size:
                return bytes(out[:size])
            full = len(out) == size
        if partial:
            break
        if last:
            if check:
                if n - pos < 4:
                    break
                if struct.unpack_from("<I", src, pos)[0] != h.digest() & 0xFFFFFFFF:
                    raise _err("a content checksum that does not match")
            break
    if len(out) < size:
        raise short
    return bytes(out[:size])


# ---------------------------------------------------------------------------
# XXH64
# ---------------------------------------------------------------------------

_P1, _P2, _P3, _P4, _P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                           0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


class _xxh64:
    """XXH64 with seed 0, fed as blocks come."""

    def __init__(self):
        self.v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        self.buf = b""
        self.total = 0

    def update(self, data: bytes) -> None:
        self.total += len(data)
        data = self.buf + bytes(data)
        n = len(data) // 32 * 32
        v = self.v
        if n:
            lanes = struct.unpack(f"<{n // 8}Q", data[:n])
            v1, v2, v3, v4 = v
            for i in range(0, len(lanes), 4):
                v1 = _round(v1, lanes[i])
                v2 = _round(v2, lanes[i + 1])
                v3 = _round(v3, lanes[i + 2])
                v4 = _round(v4, lanes[i + 3])
            self.v = [v1, v2, v3, v4]
        self.buf = data[n:]

    def digest(self) -> int:
        v1, v2, v3, v4 = self.v
        if self.total >= 32:
            h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
            for x in (v1, v2, v3, v4):
                h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        else:
            h = (v3 + _P5) & _M64
        h = (h + self.total) & _M64
        b, i = self.buf, 0
        while i + 8 <= len(b):
            k = _round(0, struct.unpack_from("<Q", b, i)[0])
            h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
            i += 8
        if i + 4 <= len(b):
            h = (_rotl(h ^ (struct.unpack_from("<I", b, i)[0] * _P1 & _M64), 23) * _P2
                 + _P3) & _M64
            i += 4
        while i < len(b):
            h = (_rotl(h ^ (b[i] * _P5 & _M64), 11) * _P1) & _M64
            i += 1
        h ^= h >> 33
        h = (h * _P2) & _M64
        h ^= h >> 29
        h = (h * _P3) & _M64
        h ^= h >> 32
        return h
