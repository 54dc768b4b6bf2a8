"""An .xz stream (LZMA2) decoder in Python, as libtiff 4.7's LZMA codec
reads a strip through liblzma 5.8.2, the version Pillow 12.1 bundles.

libtiff's ``LZMADecode`` calls ``lzma_code`` until the strip's buffer is
full, the stream ends or an error comes, and the strip is good when the
buffer was filled: liblzma hands over every byte it decoded before an
error, and once the buffer is full it reads no further in that call, so
an error after the bytes the strip needs (in a block's check, its
padding, the index or the footer) does not fail it.  Older liblzma
versions read on to the check in the call that fills the buffer and
fail such a strip, so the standard library's module (bound to whichever
liblzma the host has) decides only a strip it fills with no error, asked
for no more than the strip holds; :func:`tiff_decode` decodes the rest
here.

The stream header, each block header (its CRC32, flags, sizes, delta
filters before LZMA2, as libtiff's encoder chains them), the LZMA2 chunks (control bytes, dictionary and state resets,
properties, uncompressed chunks) and the LZMA decoder (range coder,
literals with match bytes, matches and the three repeat distances) are
read as liblzma reads them: a chunk's data are decoded up to its size,
the range coder must end at code 0, and a chunk whose decoding read past
its compressed size fails once the chunk is done; a distance past the
dictionary fails before its match is written; data that end early stop
the strip where the decoder waits for more.
"""

from __future__ import annotations

import zlib


class _Stop(Exception):
    """Decoding stops here: an error, or input that runs out."""


def _vli(src, pos: int, end: int):
    """A multibyte integer -> (value, next position)."""
    v = 0
    for i in range(9):
        if pos >= end:
            raise _Stop("a number past its field")
        b = src[pos]
        pos += 1
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            if b == 0 and i:
                raise _Stop("a number with a needless zero byte")
            return v, pos
    raise _Stop("a number longer than 9 bytes")


_CHECK_SIZES = (0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64)


class _Lzma:
    """LZMA's decoder state across the chunks of one LZMA2 block."""

    def __init__(self, dict_size: int):
        self.dict_size = dict_size
        self.out = bytearray()  # every byte of the block so far
        self.reset_at = 0  # where the dictionary was last reset

    def set_props(self, b: int) -> None:
        if b > (4 * 5 + 4) * 9 + 8:
            raise _Stop("bad LZMA properties")
        pb, b = divmod(b, 45)
        lp, lc = divmod(b, 9)
        if lc + lp > 4:
            raise _Stop("LZMA properties past lc + lp = 4")
        self.lc, self.lp, self.pb = lc, lp, pb
        self.reset_state()

    def reset_state(self) -> None:
        self.state = 0
        self.reps = [0, 0, 0, 0]
        n = 0x300 << (self.lc + self.lp)
        self.lit = [1024] * n
        self.is_match = [1024] * (12 << 4)
        self.is_rep = [1024] * 12
        self.is_rep0 = [1024] * 12
        self.is_rep1 = [1024] * 12
        self.is_rep2 = [1024] * 12
        self.is_rep0_long = [1024] * (12 << 4)
        self.slot = [[1024] * 64 for _ in range(4)]
        self.special = [1024] * 115
        self.align = [1024] * 16
        self.lens = [self._len_probs(), self._len_probs()]

    @staticmethod
    def _len_probs():
        return {"c1": [1024], "c2": [1024], "low": [[1024] * 8 for _ in range(16)],
                "mid": [[1024] * 8 for _ in range(16)], "high": [1024] * 256}

    def chunk(self, src, pos: int, packed: int, unpacked: int, room: int):
        """One LZMA chunk of ``unpacked`` bytes from src[pos:]: decoded into
        ``out`` up to ``room`` bytes of output -> (position after it, whether
        it ended).  Raises _Stop where liblzma stops, the bytes before
        written."""
        n = len(src)
        if pos >= n:
            raise _Stop("input ends")
        if src[pos]:
            raise _Stop("a range coder whose first byte is not 0")
        if pos + 5 > n:
            raise _Stop("input ends")
        code = int.from_bytes(src[pos + 1:pos + 5], "big")
        rng = 0xFFFFFFFF
        ip = pos + 5
        out = self.out
        start_len = len(out)
        limit = start_len + min(unpacked, room)
        lc, lp, pb = self.lc, self.lp, self.pb
        pb_mask, lp_mask = (1 << pb) - 1, (1 << lp) - 1
        state, reps = self.state, self.reps
        lit, is_match, is_rep = self.lit, self.is_match, self.is_rep
        is_rep0, is_rep1, is_rep2 = self.is_rep0, self.is_rep1, self.is_rep2
        is_rep0_long = self.is_rep0_long

        def bit(probs, i):
            nonlocal rng, code, ip
            if rng < 0x1000000:
                if ip >= n:
                    raise _Stop("input ends")
                rng = (rng << 8) & 0xFFFFFFFF
                code = ((code << 8) | src[ip]) & 0xFFFFFFFF
                ip += 1
            p = probs[i]
            bound = (rng >> 11) * p
            if code < bound:
                rng = bound
                probs[i] = p + ((2048 - p) >> 5)
                return 0
            rng -= bound
            code -= bound
            probs[i] = p - (p >> 5)
            return 1

        def tree(probs, nbits):
            m = 1
            for _ in range(nbits):
                m = (m << 1) | bit(probs, m)
            return m - (1 << nbits)

        def rtree(probs, nbits, base=0):
            m, v = 1, 0
            for i in range(nbits):
                b = bit(probs, base + m)
                m = (m << 1) | b
                v |= b << i
            return v

        def direct(nbits):
            nonlocal rng, code, ip
            v = 0
            for _ in range(nbits):
                if rng < 0x1000000:
                    if ip >= n:
                        raise _Stop("input ends")
                    rng = (rng << 8) & 0xFFFFFFFF
                    code = ((code << 8) | src[ip]) & 0xFFFFFFFF
                    ip += 1
                rng >>= 1
                if code >= rng:
                    code -= rng
                    v = (v << 1) | 1
                else:
                    v <<= 1
            return v

        def length(which, ps):
            p = self.lens[which]
            if not bit(p["c1"], 0):
                return 2 + tree(p["low"][ps], 3)
            if not bit(p["c2"], 0):
                return 10 + tree(p["mid"][ps], 3)
            return 18 + tree(p["high"], 8)

        def save():
            self.state, self.reps = state, reps

        try:
            while len(out) < limit:
                total = len(out) - self.reset_at
                ps = total & pb_mask
                if not bit(is_match, (state << 4) | ps):
                    prev = out[-1] if total else 0
                    base = 0x300 * ((((total & lp_mask) << 8) | prev) >> (8 - lc))
                    if state < 7:
                        m = 1
                        while m < 0x100:
                            m = (m << 1) | bit(lit, base + m)
                    else:  # a literal after a match: the byte at rep0 guides it
                        match = out[-reps[0] - 1] if reps[0] < total else 0
                        m, offs = 1, 0x100
                        while m < 0x100:
                            match <<= 1
                            was = offs
                            offs &= match
                            b = bit(lit, base + offs + was + m)
                            m = (m << 1) | b
                            if not b:
                                offs ^= was
                    out.append(m & 0xFF)
                    state = 0 if state < 4 else state - 3 if state < 10 else state - 6
                    continue
                if bit(is_rep, state):
                    if not total:
                        raise _Stop("a repeated match in an empty dictionary")
                    if not bit(is_rep0, state):
                        if not bit(is_rep0_long, (state << 4) | ps):
                            if reps[0] >= total:
                                raise _Stop("a distance past the dictionary")
                            state = 9 if state < 7 else 11
                            out.append(out[-reps[0] - 1])
                            continue
                    else:
                        if not bit(is_rep1, state):
                            d = reps[1]
                        else:
                            if not bit(is_rep2, state):
                                d = reps[2]
                            else:
                                d = reps[3]
                                reps[3] = reps[2]
                            reps[2] = reps[1]
                        reps[1] = reps[0]
                        reps[0] = d
                    mlen = length(1, ps)
                    state = 8 if state < 7 else 11
                else:
                    reps = [0, reps[0], reps[1], reps[2]]
                    mlen = length(0, ps)
                    state = 7 if state < 7 else 10
                    s = tree(self.slot[min(mlen - 2, 3)], 6)
                    if s < 4:
                        dist = s
                    else:
                        nd = (s >> 1) - 1
                        dist = (2 | (s & 1)) << nd
                        if s < 14:
                            dist += rtree(self.special, nd, dist - s - 1)
                        else:
                            dist += direct(nd - 4) << 4
                            dist += rtree(self.align, 4)
                    if dist == 0xFFFFFFFF:
                        raise _Stop("an end marker inside an LZMA2 chunk")
                    reps[0] = dist
                if reps[0] >= total or reps[0] >= self.dict_size:
                    raise _Stop("a distance past the dictionary")
                take = min(mlen, limit - len(out))
                d = reps[0] + 1
                for _ in range(take):
                    out.append(out[-d])
                if take < mlen:
                    save()
                    if len(out) - start_len >= unpacked:
                        raise _Stop("a match past the end of its chunk")
                    return ip, False
        except _Stop:
            save()
            raise
        save()
        if len(out) - start_len < unpacked:
            return ip, False
        if rng < 0x1000000:
            if ip >= n:
                raise _Stop("input ends")
            ip += 1
            code = ((code << 8) | src[ip - 1]) & 0xFFFFFFFF
        if code:
            raise _Stop("a range coder that does not end at 0")
        if ip - pos > packed:
            raise _Stop("an LZMA chunk read past its compressed size")
        if ip - pos != packed:
            raise _Stop("an LZMA chunk that leaves compressed bytes")
        return ip, True


def _lzma2(src, pos: int, dict_size: int, size: int, out_limit):
    """An LZMA2 block's data -> (its output, position after the end
    marker).  Raises _Stop with ``.out`` where liblzma stops first."""
    lz = _Lzma(dict_size)
    need_dict, need_props = True, True
    n = len(src)
    try:
        while True:
            if pos >= n:
                raise _Stop("input ends")
            control = src[pos]
            pos += 1
            if control == 0:
                return lz.out, pos
            if control >= 0xE0 or control == 1:  # a dictionary reset
                need_props, need_dict = True, False
                lz.reset_at = len(lz.out)
            elif need_dict:
                raise _Stop("an LZMA2 chunk before a dictionary reset")
            if control >= 0x80:
                if pos + 4 > n:
                    raise _Stop("input ends")
                unpacked = ((control & 0x1F) << 16) + (src[pos] << 8) + src[pos + 1] + 1
                packed = (src[pos + 2] << 8) + src[pos + 3] + 1
                pos += 4
                if control >= 0xC0:
                    if pos >= n:
                        raise _Stop("input ends")
                    need_props = False
                    lz.set_props(src[pos])
                    pos += 1
                elif need_props:
                    raise _Stop("an LZMA chunk without properties")
                elif control >= 0xA0:
                    lz.reset_state()
                room = min(size, out_limit) - len(lz.out)
                pos, ended = lz.chunk(src, pos, packed, unpacked, room)
                if not ended:
                    return lz.out, None
            else:
                if control > 2:
                    raise _Stop("a bad LZMA2 control byte")
                if pos + 2 > n:
                    raise _Stop("input ends")
                packed = (src[pos] << 8) + src[pos + 1] + 1
                pos += 2
                take = min(packed, n - pos)
                lz.out += src[pos:pos + take]
                pos += take
                if take < packed:
                    raise _Stop("input ends")
            if len(lz.out) >= min(size, out_limit):
                return lz.out, None
    except _Stop as e:
        e.out = lz.out
        raise


def _undelta(data, deltas) -> bytes:
    """The delta filters of a chain, last first, on its LZMA2 output: each
    byte plus the byte ``distance`` before it (its property + 1), mod 256."""
    import numpy as np

    v = np.frombuffer(bytes(data), np.uint8).copy()
    for _, prop in reversed(deltas):
        dist = prop + 1
        for r in range(min(dist, len(v))):
            v[r::dist] = np.cumsum(v[r::dist], dtype=np.uint64).astype(np.uint8)
    return v.tobytes()


def decode(src, size: int) -> bytes:
    """The first ``size`` bytes an .xz stream gives before liblzma stops ->
    bytes (fewer where it stops first)."""
    n = len(src)
    if n < 12 or bytes(src[:6]) != b"\xfd7zXZ\x00":
        return b""
    flags = bytes(src[6:8])
    if zlib.crc32(flags) != int.from_bytes(src[8:12], "little"):
        return b""
    if flags[0] or flags[1] & 0xF0:
        return b""
    check_size = _CHECK_SIZES[flags[1]]
    out = bytearray()
    pos = 12
    try:
        while len(out) < size:
            if pos >= n:
                break
            if src[pos] == 0:  # the index: no more blocks
                break
            block_at = pos
            hsize = (src[pos] + 1) * 4
            if pos + hsize > n:
                break
            head = bytes(src[pos:pos + hsize])
            if zlib.crc32(head[:-4]) != int.from_bytes(head[-4:], "little"):
                break
            bflags = head[1]
            if bflags & 0x3C:
                break
            at, hend = 2, hsize - 4
            csize = usize = None
            if bflags & 0x40:
                csize, at = _vli(head, at, hend)
                if csize == 0:
                    break
            if bflags & 0x80:
                usize, at = _vli(head, at, hend)
            chain = []  # (filter id, its one property byte)
            for _ in range((bflags & 3) + 1):
                fid, at = _vli(head, at, hend)
                psize, at = _vli(head, at, hend)
                if psize != 1 or at + 1 > hend:
                    raise _Stop("a filter's properties this decoder does not read")
                chain.append((fid, head[at]))
                at += 1
            # libtiff writes delta then LZMA2; other chains are read by the
            # standard library where whole and valid
            if chain[-1][0] != 0x21 or any(fid != 0x03 for fid, _ in chain[:-1]):
                break
            dprop = chain[-1][1]
            if dprop > 40 or dprop & 0xC0:
                break
            if any(head[at:hend]):
                break
            dict_size = 0xFFFFFFFF if dprop == 40 else (2 | (dprop & 1)) << (dprop // 2 + 11)
            pos += hsize
            limit = usize if usize is not None else 1 << 62
            data_end = pos + csize if csize is not None else n
            try:
                got, end = _lzma2(src[:data_end], pos, dict_size, size - len(out), limit)
            except _Stop as e:
                out += _undelta(e.out, chain[:-1])
                break
            out += _undelta(got, chain[:-1])
            if end is None:
                break
            if usize is not None and len(got) != usize:
                break
            # block padding to a multiple of 4 from the block's start, then the check
            pos = end + (-(end - block_at) % 4) + check_size
    except _Stop:
        pass
    return bytes(out[:size])


_FAR_SHORT = 1 << 16  # bytes: more than the last symbols liblzma versions may differ on


def tiff_decode(src: bytes, size: int) -> bytes:
    """libtiff's LZMADecode of one strip or tile into ``size`` bytes."""
    import lzma

    d = lzma.LZMADecompressor(lzma.FORMAT_XZ)
    try:
        # no more than the strip holds: liblzma stops there, as libtiff's
        # buffer does, and every version agrees on bytes it gave without error
        out = d.decompress(src, size)
        if len(out) == size:
            return out
        if size - len(out) > _FAR_SHORT:
            # no error, and the data run out far before the strip is full:
            # short under every liblzma (a newer one reads on no more than a
            # few symbols further), so libtiff fails it
            raise ValueError("TIFF LZMA strip ends early")
    except lzma.LZMAError:
        pass
    out = decode(src, size)
    if len(out) < size:
        raise ValueError("TIFF LZMA strip ends early or is corrupt")
    return out
