"""WebP decoder: equal to Pillow 12.1's ``Image.open(...).convert("RGB")``.

Pillow reads every WebP file through libwebp's ``WebPAnimDecoder`` (libwebp
1.6.0 in Pillow 12.1) and keeps the first frame: the canvas starts as
transparent black, the first frame is decoded into it at its offset (a
first frame is a key frame, so no blending with an earlier canvas), and
``convert("RGB")`` drops the alpha.  This module follows libwebp:

* the RIFF container (``demux.c``): the simple ``VP8 `` and ``VP8L``
  forms; ``VP8X`` files with ``ICCP``, ``EXIF``, ``XMP `` and unknown
  chunks skipped, an ``ALPH`` chunk decoded for validity (only where the
  VP8X alpha flag is set, as libwebp) and dropped; animations (``ANIM``,
  ``ANMF``), whose first frame lands at its offset on the canvas;
* VP8L, the lossless format (``vp8l_dec.c``, ``lossless.c``): prefix
  codes in their simple and normal forms, meta prefix codes, the colour
  cache, LZ77 backward references with the 2-D distance map, and the
  predictor (modes 0-13), cross-colour, subtract-green and colour-indexing
  transforms (pixel bundling at 2, 4 and 16 colours);
* VP8, the lossy format (``vp8_dec.c``, ``tree_dec.c``, ``quant_dec.c``,
  ``frame_dec.c``, ``dsp/dec.c``): the boolean decoder, the frame header,
  segments and quantizer deltas, intra prediction (16x16, 4x4 and chroma,
  with the 127/129 borders and the replicated above-right pixels of a
  macroblock's right column), token decoding with the probability
  updates, the WHT and the integer IDCT, the simple and normal loop
  filters with sharpness and the mode and reference deltas (each
  macroblock's vertical edges before its horizontal ones, in raster
  order, after the frame is reconstructed: intra prediction reads
  unfiltered pixels), then libwebp's fancy upsampling of the 4:2:0 chroma
  and its fixed-point ``VP8YUVToR/G/B``.

Per-block arithmetic is numpy; the entropy decoding is sequential Python.
Bytes that are not a valid WebP file, or a file cut short, raise a plain
``ValueError``.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from .image_errors import check_pixels

# VP8's key-frame tables: the intra 4x4 mode probabilities [10][10][9],
# the coefficient probabilities [4][8][3][11] and their update
# probabilities, and the DC and AC dequantization steps (RFC 6386)

_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850"
    "c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce17222ba6496b36201a3301"
    "512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e"
    "10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f"
    "24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80be502363b450"
    "7e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")

_COEFFS_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ff"
    "e3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e080808080800101ff808080808080"
    "8080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5"
    "f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4"
    "80808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e"
    "8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080"
    "801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")

_COEFFS_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcff"
    "fffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8feffffff"
    "fffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffffffffffffffffffff"
    "fffffffffefffffffffffffffffffefefffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fe"
    "f9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfefffffffffffffffff5fbfeffffffffffffff"
    "fffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")

_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f20212223242525262728292a2b"
    "2c2d2e2e2f303132333435363738393a3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f50515253545556575859"
    "5b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d")

_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,)

# VP8L's distance codes 1-120: (dy << 4) | (8 - dx) of the 2-D neighbourhood
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c035759131d565a232d"
    "444c555b333d68026769121e666a222e545c434d656b323e78017779535d111f646c424e767a212f757b313f636d525e"
    "00747c414f1020626e30737d515f40727e616f50717f6070")


# --------------------------------------------------------------------- #
# VP8L: lossless
# --------------------------------------------------------------------- #

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_NUM_LITERALS, _NUM_LENGTHS, _NUM_DISTANCES = 256, 24, 40
_ROOT_BITS = 8


class _LosslessBits:
    """VP8L's bit reader: least significant bit first.  Reading past the end
    of the data raises, as libwebp's end-of-stream fails the decode."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos, self.acc, self.n = data, pos, 0, 0

    def _fill(self, nbits: int) -> None:
        data, n = self.data, len(self.data)
        while self.n < nbits:
            byte = data[self.pos] if self.pos < n else 0
            self.pos += 1
            self.acc |= byte << self.n
            self.n += 8

    def peek(self, nbits: int) -> int:
        self._fill(nbits)
        return self.acc & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        self._fill(nbits)
        self.acc >>= nbits
        self.n -= nbits
        if self.pos * 8 - self.n > len(self.data) * 8:
            raise ValueError("WebP lossless bitstream ends early")

    def read(self, nbits: int) -> int:
        v = self.peek(nbits)
        self.skip(nbits)
        return v


class _PrefixCode:
    """A canonical prefix code from its code lengths, read bit by bit as
    VP8L stores it (the first bit read is the code's most significant).  A
    code of one symbol takes no bits."""

    def __init__(self, lengths: List[int]):
        count = [0] * 16
        for ln in lengths:
            if ln > 15:
                raise ValueError("WebP lossless: code length above 15")
            count[ln] += 1
        if count[0] == len(lengths):
            raise ValueError("WebP lossless: a prefix code without symbols")
        for ln in range(1, 16):
            if count[ln] > (1 << ln):
                raise ValueError("WebP lossless: an over-full prefix code")
        symbols = [s for s, ln in enumerate(lengths) if ln]
        self.single = symbols[0] if len(symbols) == 1 else None
        if self.single is not None:
            return
        open_ = 1
        for ln in range(1, 16):
            open_ = 2 * open_ - count[ln]
            if open_ < 0:
                raise ValueError("WebP lossless: an over-full prefix code")
        if open_ != 0:
            raise ValueError("WebP lossless: an incomplete prefix code")
        # canonical codes in (length, symbol) order
        code, nxt = 0, {}
        for ln in range(1, 16):
            nxt[ln] = code
            code = (code + count[ln]) << 1
        root = [None] * (1 << _ROOT_BITS)
        long_codes = {}
        self.max_len = max(lengths)
        for s in sorted(symbols, key=lambda s: (lengths[s], s)):
            ln = lengths[s]
            c = nxt[ln]
            nxt[ln] += 1
            rev = int(format(c, f"0{ln}b")[::-1], 2)
            if ln <= _ROOT_BITS:
                for hi in range(1 << (_ROOT_BITS - ln)):
                    root[rev | (hi << ln)] = (s, ln)
            else:
                long_codes[(ln, rev)] = s
        self.root, self.long_codes = root, long_codes

    def read(self, br: _LosslessBits) -> int:
        if self.single is not None:
            return self.single
        bits = br.peek(self.max_len)
        entry = self.root[bits & ((1 << _ROOT_BITS) - 1)]
        if entry is not None:
            br.skip(entry[1])
            return entry[0]
        for ln in range(_ROOT_BITS + 1, self.max_len + 1):
            s = self.long_codes.get((ln, bits & ((1 << ln) - 1)))
            if s is not None:
                br.skip(ln)
                return s
        raise ValueError("WebP lossless: an invalid prefix code")


def _read_code_lengths(br: _LosslessBits, cl_lengths: List[int], num_symbols: int) -> List[int]:
    table = _PrefixCode(cl_lengths)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > num_symbols:
            raise ValueError("WebP lossless: code lengths past the alphabet")
    else:
        max_symbol = num_symbols
    lengths = [0] * num_symbols
    symbol, prev = 0, 8
    while symbol < num_symbols:
        if max_symbol == 0:
            break
        max_symbol -= 1
        code = table.read(br)
        if code < 16:
            lengths[symbol] = code
            symbol += 1
            if code:
                prev = code
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[code - 16]
            repeat = br.read(extra) + offset
            if symbol + repeat > num_symbols:
                raise ValueError("WebP lossless: code lengths past the alphabet")
            value = prev if code == 16 else 0
            lengths[symbol:symbol + repeat] = [value] * repeat
            symbol += repeat
    return lengths


def _read_prefix_code(br: _LosslessBits, alphabet: int) -> _PrefixCode:
    if br.read(1):  # simple: one or two symbols
        two = br.read(1)
        lengths = [0] * max(alphabet, 256)
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if two:
            lengths[br.read(8)] = 1
        return _PrefixCode(lengths[:alphabet])
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    return _PrefixCode(_read_code_lengths(br, cl, alphabet))


class _ColorCache:
    """VP8L's colour cache: the pixels decoded so far, each in the slot of
    its hash (0x1e35a7bd * argb) >> (32 - bits)."""

    def __init__(self, bits: int):
        self.slots = [0] * (1 << bits)
        self.shift = 32 - bits

    def insert(self, argb: int) -> None:
        self.slots[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> self.shift] = argb

    def lookup(self, key: int) -> int:
        if key >= len(self.slots):
            raise ValueError("WebP lossless: a colour cache index out of range")
        return self.slots[key]


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _copy_distance(symbol: int, br: _LosslessBits) -> int:
    """A length or distance prefix symbol and its extra bits -> the value."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _plane_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    d = _CODE_TO_PLANE[code - 1]
    dist = (d >> 4) * xsize + 8 - (d & 0xF)
    return dist if dist >= 1 else 1


def _decode_pixels(br: _LosslessBits, xsize: int, ysize: int, allow_meta: bool) -> np.ndarray:
    """One entropy-coded image: its colour cache, its prefix codes (with a
    meta image where ``allow_meta``) and its ARGB pixels -> uint32 [ysize,
    xsize]."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("WebP lossless: colour cache bits out of range")
    meta_bits, meta = 0, None
    num_groups = 1
    if allow_meta and br.read(1):
        meta_bits = br.read(3) + 2
        mx, my = _subsample(xsize, meta_bits), _subsample(ysize, meta_bits)
        meta = ((_decode_pixels(br, mx, my, False) >> 8) & 0xFFFF).astype(np.int64)
        num_groups = int(meta.max()) + 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(num_groups):
        groups.append([_read_prefix_code(br, a) for a in (
            _NUM_LITERALS + _NUM_LENGTHS + cache_size, _NUM_LITERALS, _NUM_LITERALS,
            _NUM_LITERALS, _NUM_DISTANCES)])
    total = xsize * ysize
    out = [0] * total
    cache = _ColorCache(cache_bits) if cache_bits else None
    len_limit = _NUM_LITERALS + _NUM_LENGTHS
    meta_rows = None if meta is None else meta.tolist()
    pos, cached = 0, 0
    group = groups[0]
    while pos < total:
        if meta_rows is not None:  # the group of the tile this pixel lies in
            y, x = divmod(pos, xsize)
            group = groups[meta_rows[y >> meta_bits][x >> meta_bits]]
        green, red, blue, alpha, dist = group
        code = green.read(br)
        if code < _NUM_LITERALS:
            r = red.read(br)
            b = blue.read(br)
            a = alpha.read(br)
            out[pos] = (a << 24) | (r << 16) | (code << 8) | b
            pos += 1
        elif code < len_limit:
            length = _copy_distance(code - _NUM_LITERALS, br)
            d = _plane_distance(xsize, _copy_distance(dist.read(br), br))
            if d > pos or length > total - pos:
                raise ValueError("WebP lossless: a backward reference outside the image")
            for i in range(pos, pos + length):
                out[i] = out[i - d]
            pos += length
        else:
            if cache is None:
                raise ValueError("WebP lossless: a colour cache code without a cache")
            out[pos] = cache.lookup(code - len_limit)
            pos += 1
        if cache is not None:  # the cache holds every earlier pixel, in order
            while cached < pos:
                cache.insert(out[cached])
                cached += 1
    return np.array(out, dtype=np.uint32).reshape(ysize, xsize)


def _add_pixels(a: np.ndarray, b) -> np.ndarray:
    """Per-channel (a + b) mod 256 of ARGB uint32 values."""
    ag = ((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00
    rb = ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF
    return ag | rb


def _average2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _channels(c: int):
    return (c >> 24, (c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF)


def _pack(a: int, r: int, g: int, b: int) -> int:
    return (a << 24) | (r << 16) | (g << 8) | b


def _select(t: int, left: int, tl: int) -> int:
    pa_minus_pb = sum(abs(lc - tlc) - abs(tc - tlc) for tc, lc, tlc in
                      zip(_channels(t), _channels(left), _channels(tl)))
    return t if pa_minus_pb <= 0 else left


def _predict(mode: int, left: int, t: int, tr: int, tl: int) -> int:
    """VP8L's predictors 0-13 (14 and 15 predict black, as libwebp)."""
    if mode == 1:
        return left
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _average2(_average2(left, tr), t)
    if mode == 6:
        return _average2(left, tl)
    if mode == 7:
        return _average2(left, t)
    if mode == 8:
        return _average2(tl, t)
    if mode == 9:
        return _average2(t, tr)
    if mode == 10:
        return _average2(_average2(left, tl), _average2(t, tr))
    if mode == 11:
        return _select(t, left, tl)
    if mode == 12:
        return _pack(*(_clip255(a + b - c) for a, b, c in
                       zip(_channels(left), _channels(t), _channels(tl))))
    if mode == 13:
        ave = _average2(left, t)
        # C's division truncates toward zero
        return _pack(*(_clip255(a + int((a - c) / 2)) for a, c in
                       zip(_channels(ave), _channels(tl))))
    return 0xFF000000


def _inverse_predictor(res: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    h, w = res.shape
    rows = res.tolist()
    modes = ((modes >> 8) & 0xF).tolist()
    out = [[0] * w for _ in range(h)]

    def add(a, b):
        return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (
            ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)

    for y in range(h):
        src, dst = rows[y], out[y]
        if y == 0:
            dst[0] = add(src[0], 0xFF000000)
            for x in range(1, w):
                dst[x] = add(src[x], dst[x - 1])
            continue
        up = out[y - 1]
        mrow = modes[y >> bits]
        dst[0] = add(src[0], up[0])
        for x in range(1, w):
            # the top-right of the last pixel is the row's own first pixel
            tr = up[x + 1] if x + 1 < w else dst[0]
            dst[x] = add(src[x], _predict(mrow[x >> bits], dst[x - 1], up[x], tr, up[x - 1]))
    return np.array(out, dtype=np.uint32)


def _inverse_cross_color(img: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    h, w = img.shape
    d = data.astype(np.int64)[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]

    def s8(v):
        v = v & 0xFF
        return np.where(v >= 128, v - 256, v)

    g2r, g2b, r2b = s8(d), s8(d >> 8), s8(d >> 16)
    argb = img.astype(np.int64)
    green = s8(argb >> 8)
    red = ((argb >> 16) + ((g2r * green) >> 5)) & 0xFF
    blue = (argb + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)) & 0xFF
    return ((argb & 0xFF00FF00) | (red << 16) | blue).astype(np.uint32)


def _inverse_subtract_green(img: np.ndarray) -> np.ndarray:
    g = (img >> 8) & 0xFF
    return _add_pixels(img, (g << 16) | g)


def _inverse_color_index(img: np.ndarray, bits: int, xsize: int, palette: np.ndarray
                         ) -> np.ndarray:
    """Packed indices (green channel) -> palette colours, ``xsize`` wide;
    an index past the palette gives transparent black."""
    colors = np.zeros(256, np.uint32)
    colors[:len(palette)] = palette
    idx = (img >> 8) & 0xFF
    if bits:
        per = 1 << bits
        width = 8 >> bits
        shifts = (np.arange(per, dtype=np.uint32) * width)
        idx = (idx[:, :, None] >> shifts) & ((1 << width) - 1)
        idx = idx.reshape(img.shape[0], -1)[:, :xsize]
    return colors[idx]


def _decode_lossless_stream(br: _LosslessBits, xsize: int, ysize: int) -> np.ndarray:
    """A level-0 VP8L image (its transforms, then its entropy-coded pixels,
    then the transforms undone in reverse order) -> uint32 ARGB [ysize,
    xsize]."""
    transforms = []
    seen = set()
    width = xsize
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("WebP lossless: a transform used twice")
        seen.add(kind)
        if kind in (0, 1):  # predictor, cross-colour
            bits = br.read(3) + 2
            data = _decode_pixels(br, _subsample(width, bits), _subsample(ysize, bits), False)
            transforms.append((kind, width, bits, data))
        elif kind == 3:  # colour indexing
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _decode_pixels(br, n, 1, False)[0]
            # palette entries are coded as differences, channel by channel
            pal = np.cumsum(pal.view(np.uint8).reshape(n, 4).astype(np.int64), axis=0) & 0xFF
            pal = pal.astype(np.uint8).reshape(-1).view(np.uint32)
            transforms.append((kind, width, bits, pal))
            width = _subsample(width, bits)
        else:  # subtract green
            transforms.append((kind, width, 0, None))
    img = _decode_pixels(br, width, ysize, True)
    for kind, w, bits, data in reversed(transforms):
        if kind == 0:
            img = _inverse_predictor(img, bits, data)
        elif kind == 1:
            img = _inverse_cross_color(img, bits, data)
        elif kind == 2:
            img = _inverse_subtract_green(img)
        else:
            img = _inverse_color_index(img, bits, w, data)
    return img


def decode_vp8l(payload: bytes) -> np.ndarray:
    """A VP8L bitstream (the payload of a ``VP8L`` chunk) -> uint32 ARGB
    [h, w]."""
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError("not a WebP lossless bitstream")
    br = _LosslessBits(payload, 1)
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha is used
    if br.read(3) != 0:
        raise ValueError("WebP lossless: unknown version")
    return _decode_lossless_stream(br, w, h)


# --------------------------------------------------------------------- #
# VP8: lossy
# --------------------------------------------------------------------- #


class _BoolDecoder:
    """VP8's boolean entropy decoder (RFC 6386 section 7), loading bytes as
    libwebp's does: when a read finds fewer than 8 bits ahead.  The first
    load past the end of the partition reads zeros and sets ``eof``, which
    fails the decode where libwebp checks it; a second one raises."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value = 0
        self.bits = -8  # the 8-bit window's position in ``value``
        self.range = 255
        self.eof = False
        self._load()

    def _load(self) -> None:
        if self.pos < self.end:
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
        elif not self.eof:
            self.value <<= 8
            self.eof = True
        else:
            raise ValueError("WebP lossy: a partition ends early")
        self.bits += 8

    def get(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << self.bits
        if self.value >= big:
            self.range -= split
            self.value -= big
            bit = 1
        else:
            self.range = split
            bit = 0
        while self.range < 128:
            self.range <<= 1
            self.bits -= 1
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.get(128) else v


_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT_PROBAS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
               (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 intra mode tree: negative entries are leaves, -mode
_BMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)


def _segment_header(br: _BoolDecoder) -> dict:
    hdr = {"use": br.get(128), "update_map": 0, "absolute": 1, "quant": [0] * 4,
           "filter": [0] * 4, "probs": [255] * 3}
    if hdr["use"]:
        hdr["update_map"] = br.get(128)
        if br.get(128):  # update the segment data
            hdr["absolute"] = br.get(128)
            hdr["quant"] = [br.signed(7) if br.get(128) else 0 for _ in range(4)]
            hdr["filter"] = [br.signed(6) if br.get(128) else 0 for _ in range(4)]
        if hdr["update_map"]:
            hdr["probs"] = [br.literal(8) if br.get(128) else 255 for _ in range(3)]
    return hdr


def _filter_header(br: _BoolDecoder) -> dict:
    hdr = {"simple": br.get(128), "level": br.literal(6), "sharpness": br.literal(3),
           "use_delta": br.get(128), "ref": [0] * 4, "mode": [0] * 4}
    if hdr["use_delta"] and br.get(128):
        for key in ("ref", "mode"):
            for i in range(4):
                if br.get(128):
                    hdr[key][i] = br.signed(6)
    return hdr


def _quant_matrices(br: _BoolDecoder, seg: dict):
    """-> per segment (y1 [dc, ac], y2 [dc, ac], uv [dc, ac])."""
    base = br.literal(7)
    deltas = [br.signed(4) if br.get(128) else 0 for _ in range(5)]
    dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = deltas

    def clip(v, m):
        return 0 if v < 0 else m if v > m else v

    out = []
    for s in range(4):
        if seg["use"]:
            q = seg["quant"][s] + (0 if seg["absolute"] else base)
        else:
            q = base
        y2_ac = (_AC_TABLE[clip(q + dy2_ac, 127)] * 101581) >> 16
        out.append(((_DC_TABLE[clip(q + dy1_dc, 127)], _AC_TABLE[clip(q, 127)]),
                    (_DC_TABLE[clip(q + dy2_dc, 127)] * 2, max(y2_ac, 8)),
                    (_DC_TABLE[clip(q + duv_dc, 117)], _AC_TABLE[clip(q + duv_ac, 127)])))
    return out


def _coeff_probas(br: _BoolDecoder):
    """The coefficient probabilities after the frame's updates, as
    [type][position 0-16][ctx] -> 11 probabilities."""
    bands = []
    i = 0
    for t in range(4):
        tb = []
        for b in range(8):
            ctxs = []
            for c in range(3):
                row = []
                for p in range(11):
                    row.append(br.literal(8) if br.get(_COEFFS_UPDATE_PROBA[i])
                               else _COEFFS_PROBA0[i])
                    i += 1
                ctxs.append(row)
            tb.append(ctxs)
        bands.append([tb[_BANDS[n]] for n in range(17)])
    return bands


def _i16(v: int) -> int:
    """``v`` stored in an int16_t, as libwebp keeps its coefficients (only
    a corrupt stream's values wrap)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _large_value(br: _BoolDecoder, p) -> int:
    if not br.get(p[3]):
        return 2 if not br.get(p[4]) else 3 + br.get(p[5])
    if not br.get(p[6]):
        if not br.get(p[7]):
            return 5 + br.get(159)
        return 7 + 2 * br.get(165) + br.get(145)
    bit1 = br.get(p[8])
    cat = 2 * bit1 + br.get(p[9 + bit1])
    v = 0
    for prob in _CAT_PROBAS[cat]:
        v = 2 * v + br.get(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolDecoder, prob, ctx: int, dq, n: int, out: list, base: int) -> int:
    """One block's tokens from position ``n`` into out[base:base + 16]
    (raster order, dequantized) -> the position after the last token read
    (libwebp's GetCoeffs)."""
    p = prob[n][ctx]
    while n < 16:
        if not br.get(p[0]):
            return n  # end of block
        while not br.get(p[1]):  # a zero
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        if not br.get(p[2]):
            v = 1
            p = prob[n + 1][1]
        else:
            v = _large_value(br, p)
            p = prob[n + 1][2]
        if br.get(128):
            v = -v
        out[base + _ZIGZAG[n]] = _i16(v * dq[n > 0])
        n += 1
    return 16


def _parse_modes(br: _BoolDecoder, seg: dict, skip_prob, top: list, left: list, x: int):
    """One macroblock's header in the first partition -> (segment, skip,
    is_i4x4, 16 luma modes, chroma mode); ``top`` and ``left`` hold the
    neighbouring 4x4 modes (contexts)."""
    segment = 0
    if seg["update_map"]:
        pr = seg["probs"]
        segment = br.get(pr[1]) if not br.get(pr[0]) else 2 + br.get(pr[2])
    skip = br.get(skip_prob) if skip_prob is not None else 0
    i4x4 = not br.get(145)
    if not i4x4:
        if br.get(156):
            ymode = B_TM if br.get(128) else B_HE
        else:
            ymode = B_VE if br.get(163) else B_DC
        modes = [ymode] * 16
        top[4 * x:4 * x + 4] = [ymode] * 4
        left[:] = [ymode] * 4
    else:
        modes = [0] * 16
        for y in range(4):
            ymode = left[y]
            for xx in range(4):
                prob = _BMODES_PROBA[(top[4 * x + xx] * 10 + ymode) * 9:][:9]
                i = _BMODE_TREE[br.get(prob[0])]
                while i > 0:
                    i = _BMODE_TREE[2 * i + br.get(prob[i])]
                ymode = -i
                top[4 * x + xx] = ymode
                modes[4 * y + xx] = ymode
            left[y] = ymode
    if not br.get(142):
        uvmode = B_DC
    elif not br.get(114):
        uvmode = B_VE
    else:
        uvmode = B_TM if br.get(183) else B_HE
    return segment, skip, i4x4, modes, uvmode


def _idct_add(pred: np.ndarray, coeffs: np.ndarray, sse2=None) -> np.ndarray:
    """libwebp's TransformOne on blocks: pred [n, 4, 4] plus the inverse
    transform of coeffs [n, 16] (raster), each clipped to [0, 255].  The
    blocks marked in ``sse2`` go through Transform_SSE2 instead, whose sums
    wrap at 16 bits (the same as the C transform modulo 2**16 in each pass,
    its second pass reading the first's wrapped outputs); the rest, those
    libwebp sends to TransformDC_C or TransformAC3_C, do not wrap."""
    c = coeffs.reshape(-1, 4, 4).astype(np.int64)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    # vertical pass over each column i: in[i], in[4 + i], in[8 + i], in[12 + i]
    a, b = c[:, 0] + c[:, 2], c[:, 0] - c[:, 2]
    cc, d = mul2(c[:, 1]) - mul1(c[:, 3]), mul1(c[:, 1]) + mul2(c[:, 3])
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=1)  # t[:, k, i]: column i's k-th
    if sse2 is not None:
        t = np.where(sse2[:, None, None], _w16(t), t)
    dc = t[:, :, 0] + 4
    a, b = dc + t[:, :, 2], dc - t[:, :, 2]
    cc, d = mul2(t[:, :, 1]) - mul1(t[:, :, 3]), mul1(t[:, :, 1]) + mul2(t[:, :, 3])
    res = np.stack([a + d, b + cc, b - cc, a - d], axis=2)  # [n, row, x]
    if sse2 is not None:
        res = np.where(sse2[:, None, None], _w16(res), res)
    return np.clip(pred.astype(np.int64) + (res >> 3), 0, 255).astype(np.uint8)


def _w16(x: np.ndarray) -> np.ndarray:
    """The low 16 bits of each value, as a signed int (an SSE2 lane)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _iwht(dc: list) -> list:
    """libwebp's TransformWHT: the 16 luma DC values from the Y2 block."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i], out[4 * i + 1] = _i16((a0 + a1) >> 3), _i16((a3 + a2) >> 3)
        out[4 * i + 2], out[4 * i + 3] = _i16((a0 - a1) >> 3), _i16((a3 - a2) >> 3)
    return out


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: list, left: list, tl: int) -> np.ndarray:
    """One 4x4 luma prediction (libwebp's VP8PredLuma4): ``top`` the 8
    pixels above (4 above-right), ``left`` the 4 to the left, ``tl`` the
    corner."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        return np.full((4, 4), (sum(top[:4]) + sum(left) + 4) >> 3)
    if mode == B_TM:
        return np.clip(np.array(top[:4])[None, :] + np.array(left)[:, None] - X, 0, 255)
    if mode == B_VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return np.array([row] * 4)
    if mode == B_HE:
        col = [_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)]
        return np.repeat(np.array(col)[:, None], 4, axis=1)
    p = np.zeros((4, 4), np.int64)
    if mode == B_RD:
        vals = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
                _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)]
        for y in range(4):
            for x in range(4):
                p[y, x] = vals[3 - y + x]
    elif mode == B_LD:
        vals = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
        for y in range(4):
            for x in range(4):
                p[y, x] = vals[x + y]
    elif mode == B_VR:
        p[0, 0] = p[2, 1] = _avg2(X, A)
        p[0, 1] = p[2, 2] = _avg2(A, B)
        p[0, 2] = p[2, 3] = _avg2(B, C)
        p[0, 3] = _avg2(C, D)
        p[3, 0] = _avg3(K, J, I)
        p[2, 0] = _avg3(J, I, X)
        p[1, 0] = p[3, 1] = _avg3(I, X, A)
        p[1, 1] = p[3, 2] = _avg3(X, A, B)
        p[1, 2] = p[3, 3] = _avg3(A, B, C)
        p[1, 3] = _avg3(B, C, D)
    elif mode == B_VL:
        p[0, 0] = _avg2(A, B)
        p[0, 1] = p[2, 0] = _avg2(B, C)
        p[0, 2] = p[2, 1] = _avg2(C, D)
        p[0, 3] = p[2, 2] = _avg2(D, E)
        p[1, 0] = _avg3(A, B, C)
        p[1, 1] = p[3, 0] = _avg3(B, C, D)
        p[1, 2] = p[3, 1] = _avg3(C, D, E)
        p[1, 3] = p[3, 2] = _avg3(D, E, F)
        p[2, 3] = _avg3(E, F, G)
        p[3, 3] = _avg3(F, G, H)
    elif mode == B_HD:
        p[0, 0] = p[1, 2] = _avg2(I, X)
        p[1, 0] = p[2, 2] = _avg2(J, I)
        p[2, 0] = p[3, 2] = _avg2(K, J)
        p[3, 0] = _avg2(L, K)
        p[0, 3] = _avg3(A, B, C)
        p[0, 2] = _avg3(X, A, B)
        p[0, 1] = p[1, 3] = _avg3(I, X, A)
        p[1, 1] = p[2, 3] = _avg3(J, I, X)
        p[2, 1] = p[3, 3] = _avg3(K, J, I)
        p[3, 1] = _avg3(L, K, J)
    elif mode == B_HU:
        p[0, 0] = _avg2(I, J)
        p[0, 2] = p[1, 0] = _avg2(J, K)
        p[1, 2] = p[2, 0] = _avg2(K, L)
        p[0, 1] = _avg3(I, J, K)
        p[0, 3] = p[1, 1] = _avg3(J, K, L)
        p[1, 3] = p[2, 1] = _avg3(K, L, L)
        p[2, 2] = p[2, 3] = p[3, 0] = p[3, 1] = p[3, 2] = p[3, 3] = L
    return p


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, tl: int, size: int,
                has_top: bool, has_left: bool) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction (DC, TM, V, H), the DC one
    averaging only the edges that exist, as libwebp's CheckMode picks."""
    top, left = top.astype(np.int64), left.astype(np.int64)
    if mode == B_DC:
        shift = 4 if size == 16 else 3
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif has_left:
            v = (int(left.sum()) + size // 2) >> shift
        elif has_top:
            v = (int(top.sum()) + size // 2) >> shift
        else:
            v = 0x80
        return np.full((size, size), v, np.int64)
    if mode == B_TM:
        return np.clip(top[None, :] + left[:, None] - tl, 0, 255)
    if mode == B_VE:
        return np.repeat(top[None, :], size, axis=0)
    return np.repeat(left[:, None], size, axis=1)


def _filter_strengths(seg: dict, flt: dict):
    """libwebp's PrecomputeFilterStrengths -> [segment][i4x4] (limit, ilevel,
    hev threshold); a limit of 0 leaves the macroblock unfiltered."""
    out = []
    for s in range(4):
        base = flt["level"]
        if seg["use"]:
            base = seg["filter"][s] + (0 if seg["absolute"] else flt["level"])
        row = []
        for i4x4 in (0, 1):
            level = base
            if flt["use_delta"]:
                level += flt["ref"][0]
                if i4x4:
                    level += flt["mode"][0]
            level = 0 if level < 0 else 63 if level > 63 else level
            if level == 0:
                row.append((0, 0, 0))
                continue
            ilevel = level
            if flt["sharpness"] > 0:
                ilevel >>= 2 if flt["sharpness"] > 4 else 1
                ilevel = min(ilevel, 9 - flt["sharpness"])
            ilevel = max(ilevel, 1)
            row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
        out.append(row)
    return out


def _edge(plane: np.ndarray, pos: int, vertical: bool, lo: int, n: int, thresh: int,
          ilevel: int, hev_t: int, kind: str) -> None:
    """Filter the ``n`` lines from ``lo`` across the edge before row
    (``vertical`` False) or column ``pos`` of ``plane`` in place.  ``kind``
    is "simple", "mb" (6 taps where not high-variance) or "inner" (4)."""
    if vertical:
        seg = plane[lo:lo + n, pos - 4:pos + 4].astype(np.int64).T
    else:
        seg = plane[pos - 4:pos + 4, lo:lo + n].astype(np.int64)
    p3, p2, p1, p0, q0, q1, q2, q3 = seg
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    out = seg.copy()

    def s1(v):
        return np.clip(v, -128, 127)

    def s2(v):
        return np.clip(v, -16, 15)

    def c1(v):
        return np.clip(v, 0, 255)

    if kind == "simple":
        two = mask
    else:
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            mask &= np.abs(a - b) <= ilevel
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        two = mask & hev
        rest = mask & ~hev
        if kind == "mb":
            a = s1(3 * (q0 - p0) + s1(p1 - q1))
            a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            for i, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1),
                         (5, q1 - a2), (6, q2 - a3)):
                out[i] = np.where(rest, c1(v), out[i])
        else:
            a = 3 * (q0 - p0)
            a1, a2 = s2((a + 4) >> 3), s2((a + 3) >> 3)
            a3 = (a1 + 1) >> 1
            for i, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
                out[i] = np.where(rest, c1(v), out[i])
    a = 3 * (q0 - p0) + s1(p1 - q1)
    a1, a2 = s2((a + 4) >> 3), s2((a + 3) >> 3)
    out[3] = np.where(two, c1(p0 + a2), out[3])
    out[4] = np.where(two, c1(q0 - a1), out[4])
    if vertical:
        plane[lo:lo + n, pos - 4:pos + 4] = out.T
    else:
        plane[pos - 4:pos + 4, lo:lo + n] = out


def _loop_filter(planes, mbs, mb_w: int, mb_h: int, simple: bool) -> None:
    """Each macroblock in raster order: its left edge, its inner vertical
    edges, its top edge, its inner horizontal edges (libwebp's DoFilter)."""
    Y, U, V = planes
    for my in range(mb_h):
        for mx in range(mb_w):
            limit, ilevel, hev_t, inner = mbs[my * mb_w + mx]
            if limit == 0:
                continue
            y0, x0 = 16 * my, 16 * mx
            if simple:
                if mx > 0:
                    _edge(Y, x0, True, y0, 16, limit + 4, 0, 0, "simple")
                if inner:
                    for k in (4, 8, 12):
                        _edge(Y, x0 + k, True, y0, 16, limit, 0, 0, "simple")
                if my > 0:
                    _edge(Y, y0, False, x0, 16, limit + 4, 0, 0, "simple")
                if inner:
                    for k in (4, 8, 12):
                        _edge(Y, y0 + k, False, x0, 16, limit, 0, 0, "simple")
                continue
            cy, cx = 8 * my, 8 * mx
            if mx > 0:
                _edge(Y, x0, True, y0, 16, limit + 4, ilevel, hev_t, "mb")
                for P in (U, V):
                    _edge(P, cx, True, cy, 8, limit + 4, ilevel, hev_t, "mb")
            if inner:
                for k in (4, 8, 12):
                    _edge(Y, x0 + k, True, y0, 16, limit, ilevel, hev_t, "inner")
                for P in (U, V):
                    _edge(P, cx + 4, True, cy, 8, limit, ilevel, hev_t, "inner")
            if my > 0:
                _edge(Y, y0, False, x0, 16, limit + 4, ilevel, hev_t, "mb")
                for P in (U, V):
                    _edge(P, cy, False, cx, 8, limit + 4, ilevel, hev_t, "mb")
            if inner:
                for k in (4, 8, 12):
                    _edge(Y, y0 + k, False, x0, 16, limit, ilevel, hev_t, "inner")
                for P in (U, V):
                    _edge(P, cy + 4, False, cx, 8, limit, ilevel, hev_t, "inner")


def _vp8_frame(payload: bytes):
    """A VP8 key frame (the payload of a ``VP8 `` chunk) -> its Y, U, V
    planes [h, w], [(h+1)/2, (w+1)/2], after the loop filter."""
    if len(payload) < 10:
        raise ValueError("WebP lossy: truncated frame header")
    bits = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1:
        raise ValueError("WebP lossy: not a shown key frame")
    part0 = bits >> 5
    if payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP lossy: bad start code")
    w = (payload[6] | (payload[7] << 8)) & 0x3FFF
    h = (payload[8] | (payload[9] << 8)) & 0x3FFF
    if w == 0 or h == 0:
        raise ValueError("WebP lossy: empty frame")
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    if part0 > len(payload) - 10:
        raise ValueError("WebP lossy: bad partition length")
    br = _BoolDecoder(payload, 10, 10 + part0)
    br.get(128)  # colour space
    br.get(128)  # clamping type
    seg = _segment_header(br)
    flt = _filter_header(br)
    if br.eof:
        raise ValueError("WebP lossy: truncated frame header")
    # the token partitions
    nparts = 1 << br.literal(2)
    pos, end = 10 + part0, len(payload)
    if end - pos < 3 * (nparts - 1):
        raise ValueError("WebP lossy: truncated partition sizes")
    sizes_at, start = pos, pos + 3 * (nparts - 1)
    parts = []
    for p in range(nparts - 1):
        psize = int.from_bytes(payload[sizes_at + 3 * p:sizes_at + 3 * p + 3], "little")
        psize = min(psize, end - start)
        parts.append(_BoolDecoder(payload, start, start + psize))
        start += psize
    if start >= end:
        raise ValueError("WebP lossy: truncated partitions")
    parts.append(_BoolDecoder(payload, start, end))
    dqm = _quant_matrices(br, seg)
    br.get(128)  # refresh entropy probabilities: ignored for a key frame
    probas = _coeff_probas(br)
    skip_prob = br.literal(8) if br.get(128) else None
    strengths = _filter_strengths(seg, flt) if flt["level"] else None

    Y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    top_modes = [B_DC] * (4 * mb_w)
    top_nz = [0] * mb_w  # luma bits 0-3, chroma u 4-5, v 6-7 (libwebp's nz_)
    top_nz_dc = [0] * mb_w
    filters = []
    for my in range(mb_h):
        left_modes = [B_DC] * 4
        modes_row = [_parse_modes(br, seg, skip_prob, top_modes, left_modes, mx)
                     for mx in range(mb_w)]
        if br.eof:
            raise ValueError("WebP lossy: premature end of the first partition")
        tok = parts[my & (nparts - 1)]
        left_nz, left_nz_dc = 0, 0
        for mx, (segment, skip, i4x4, modes, uvmode) in enumerate(modes_row):
            coeffs = [0] * 384
            codes = [0] * 24  # libwebp's NzCodeBits, one a block (chroma: 0 or above 1)
            q_y1, q_y2, q_uv = dqm[segment]
            if skip_prob is None or not skip:
                tnz, lnz = top_nz[mx], left_nz
                if not i4x4:  # the Y2 block: every luma block's DC
                    dc = [0] * 16
                    nz = _coeffs(tok, probas[1], top_nz_dc[mx] + left_nz_dc, q_y2, 0, dc, 0)
                    top_nz_dc[mx] = left_nz_dc = int(nz > 0)
                    dc = _iwht(dc) if nz > 1 else [_i16((dc[0] + 3) >> 3)] * 16
                    for i in range(16):
                        coeffs[16 * i] = dc[i]
                    first, ac = 1, probas[0]
                else:
                    first, ac = 0, probas[3]
                any_nz = 0
                t, l_bits = tnz & 0x0F, lnz & 0x0F
                new_t, new_l = [0] * 4, [0] * 4
                tb = [(t >> i) & 1 for i in range(4)]
                lb = [(l_bits >> i) & 1 for i in range(4)]
                for y in range(4):
                    l = lb[y]
                    for x in range(4):
                        n = 4 * y + x
                        nz = _coeffs(tok, ac, l + tb[x], q_y1, first, coeffs, 16 * n)
                        l = int(nz > first)
                        tb[x] = l
                        codes[n] = 3 if nz > 3 else 2 if nz > 1 else int(coeffs[16 * n] != 0)
                        any_nz |= nz > 1 or coeffs[16 * n] != 0
                    lb[y] = l
                out_t = sum(b << i for i, b in enumerate(tb))
                out_l = sum(b << i for i, b in enumerate(lb))
                for ch, base in ((0, 256), (2, 320)):
                    tb = [(tnz >> (4 + ch + i)) & 1 for i in range(2)]
                    lb = [(lnz >> (4 + ch + i)) & 1 for i in range(2)]
                    for y in range(2):
                        l = lb[y]
                        for x in range(2):
                            n = 2 * y + x
                            nz = _coeffs(tok, probas[2], l + tb[x], q_uv, 0, coeffs,
                                         base + 16 * n)
                            l = int(nz > 0)
                            tb[x] = l
                            codes[base // 16 + n] = 3 if nz > 3 else 2 if nz > 1 else 0
                            any_nz |= nz > 1 or coeffs[base + 16 * n] != 0
                        lb[y] = l
                    out_t |= (tb[0] | (tb[1] << 1)) << (4 + ch)
                    out_l |= (lb[0] | (lb[1] << 1)) << (4 + ch)
                top_nz[mx], left_nz = out_t, out_l
                if tok.eof:
                    raise ValueError("WebP lossy: premature end of a token partition")
                skipped = not any_nz
            else:
                top_nz[mx] = left_nz = 0
                if not i4x4:
                    top_nz_dc[mx] = left_nz_dc = 0
                skipped = True
            _reconstruct(Y, U, V, mx, my, mb_w, i4x4, modes, uvmode, coeffs, codes)
            if strengths is not None:
                limit, ilevel, hev_t = strengths[segment][int(i4x4)]
                filters.append((limit, ilevel, hev_t, i4x4 or not skipped))
    if strengths is not None:
        _loop_filter((Y, U, V), filters, mb_w, mb_h, flt["simple"] == 1)
    return Y[:h, :w], U[:(h + 1) // 2, :(w + 1) // 2], V[:(h + 1) // 2, :(w + 1) // 2]


def _reconstruct(Y, U, V, mx: int, my: int, mb_w: int, i4x4: bool, modes, uvmode: int,
                 coeffs: list, codes: list) -> None:
    """Intra prediction plus the residuals of one macroblock, from the
    unfiltered neighbours, with libwebp's borders: 127 above the frame
    (the corner too), 129 left of it (and in the corner below the first
    row).  Each residual goes through the transform libwebp's DoTransform
    and DoUVTransform pick by the block's ``codes``: a luma block whose
    tokens reach past position 3, and every block of a chroma plane where
    one block's do past position 1, through the SSE2 transform; the C
    transforms otherwise.  Both agree where no coefficient reaches 2,048,
    as in every stream an encoder writes."""
    y0, x0 = 16 * my, 16 * mx
    c = np.array(coeffs, np.int64).reshape(24, 16)
    sse2 = None
    if np.abs(c).max() >= 2048:
        sse2 = np.array(codes) == 3
        for k in (16, 20):
            sse2[k:k + 4] = any(codes[k:k + 4])
    if my > 0:
        top = Y[y0 - 1, x0:x0 + 16].astype(np.int64)
        tl = int(Y[y0 - 1, x0 - 1]) if mx > 0 else 129
    else:
        top, tl = np.full(16, 127, np.int64), 127
    left = Y[y0:y0 + 16, x0 - 1].astype(np.int64) if mx > 0 else np.full(16, 129, np.int64)
    if not i4x4:
        pred = _pred_block(modes[0], top, left, tl, 16, my > 0, mx > 0)
        blocks = pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
        out = _idct_add(blocks, c[:16], None if sse2 is None else sse2[:16])
        Y[y0:y0 + 16, x0:x0 + 16] = out.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
    else:
        if my > 0:
            tr = (Y[y0 - 1, x0 + 16:x0 + 20].astype(np.int64) if mx < mb_w - 1
                  else np.full(4, Y[y0 - 1, x0 + 15], np.int64))
        else:
            tr = np.full(4, 127, np.int64)
        # a work area: row 0 the pixels above (with the corner in column 0
        # and the above-right in columns 17-20), column 0 the pixels left
        work = np.zeros((17, 21), np.int64)
        work[0, 0], work[0, 1:17], work[0, 17:21] = tl, top, tr
        work[1:17, 0] = left
        # the above-right of a right-column block below the first row is
        # the macroblock's above-right
        for r in (4, 8, 12):
            work[r, 17:21] = tr
        for n in range(16):
            by, bx = 4 * (n // 4), 4 * (n % 4)
            above = work[by, bx + 1:bx + 9].tolist()
            lft = work[by + 1:by + 5, bx].tolist()
            pred = _pred4(modes[n], above, lft, int(work[by, bx]))
            work[by + 1:by + 5, bx + 1:bx + 5] = _idct_add(
                pred[None], c[n:n + 1], None if sse2 is None else sse2[n:n + 1])[0]
        Y[y0:y0 + 16, x0:x0 + 16] = work[1:17, 1:17]
    cy, cx = 8 * my, 8 * mx
    for P, base in ((U, 16), (V, 20)):
        if my > 0:
            ctop = P[cy - 1, cx:cx + 8].astype(np.int64)
            ctl = int(P[cy - 1, cx - 1]) if mx > 0 else 129
        else:
            ctop, ctl = np.full(8, 127, np.int64), 127
        cleft = P[cy:cy + 8, cx - 1].astype(np.int64) if mx > 0 else np.full(8, 129, np.int64)
        pred = _pred_block(uvmode, ctop, cleft, ctl, 8, my > 0, mx > 0)
        blocks = pred.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4)
        out = _idct_add(blocks, c[base:base + 4], None if sse2 is None else sse2[base:base + 4])
        P[cy:cy + 8, cx:cx + 8] = out.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)


def _fancy_upsample(Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """libwebp's fancy upsampler and VP8YUVToR/G/B -> [h, w, 3] uint8."""
    h, w = Y.shape

    def line(T, C, near_top: bool):
        """One output row's chroma from chroma rows T (above) and C."""
        T, C = T.astype(np.int64), C.astype(np.int64)
        A, B = (T, C) if near_top else (C, T)  # A the nearer row
        out = np.empty(w, np.int64)
        out[0] = (3 * A[0] + B[0] + 2) >> 2
        k = np.arange(1, (w - 1) // 2 + 1)
        if len(k):
            tl, t, l, c = T[k - 1], T[k], C[k - 1], C[k]
            avg = tl + t + l + c + 8
            d12 = (avg + 2 * (t + l)) >> 3
            d03 = (avg + 2 * (tl + c)) >> 3
            if near_top:
                out[2 * k - 1], out[2 * k] = (d12 + tl) >> 1, (d03 + t) >> 1
            else:
                out[2 * k - 1], out[2 * k] = (d03 + l) >> 1, (d12 + c) >> 1
        if w % 2 == 0:
            out[w - 1] = (3 * A[-1] + B[-1] + 2) >> 2
        return out

    u_rows, v_rows = [], []
    for y in range(h):
        if y == 0:
            pair = (0, 0, True)
        elif y % 2 == 1 and y == h - 1:  # the last row of an even height
            pair = (y // 2, y // 2, True)
        elif y % 2 == 1:
            pair = ((y - 1) // 2, (y + 1) // 2, True)
        else:
            pair = (y // 2 - 1, y // 2, False)
        t, c, near = pair
        u_rows.append(line(U[t, :(w + 1) // 2], U[c, :(w + 1) // 2], near))
        v_rows.append(line(V[t, :(w + 1) // 2], V[c, :(w + 1) // 2], near))
    u, v = np.array(u_rows), np.array(v_rows)
    yy = (Y.astype(np.int64) * 19077) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    r = clip8(yy + ((v * 26149) >> 8) - 14234)
    g = clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def decode_vp8(payload: bytes) -> np.ndarray:
    """A VP8 key frame -> [h, w, 3] uint8 RGB, as libwebp's RGBA output
    with fancy upsampling gives it."""
    return _fancy_upsample(*_vp8_frame(payload))


# --------------------------------------------------------------------- #
# the RIFF container and the first frame on the canvas
# --------------------------------------------------------------------- #

_ALPHA_FLAG, _ANIMATION_FLAG, _VALID_FLAGS = 0x10, 0x02, 0x3E


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload start, payload size, next chunk) of each chunk in
    data[pos:end]; a chunk that runs past ``end`` raises."""
    while pos < end:
        if end - pos < 8:
            raise ValueError("WebP: a truncated chunk header")
        fourcc = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        padded = size + (size & 1)
        if pos + 8 + padded > end:
            raise ValueError("WebP: a chunk runs past the end of the file")
        yield fourcc, pos + 8, size, pos + 8 + padded
        pos += 8 + padded


def _vp8_size(payload: bytes) -> Tuple[int, int]:
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP lossy: bad frame header")
    bits = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= len(payload):
        raise ValueError("WebP lossy: bad frame header")
    w = (payload[6] | (payload[7] << 8)) & 0x3FFF
    h = (payload[8] | (payload[9] << 8)) & 0x3FFF
    if not w or not h:
        raise ValueError("WebP lossy: empty frame")
    return w, h


def _vp8l_size(payload: bytes) -> Tuple[int, int]:
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        raise ValueError("WebP lossless: bad header")
    bits = int.from_bytes(payload[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _frame(data: bytes, pos: int, end: int) -> dict:
    """The image chunks at data[pos:end]: an optional ALPH, then VP8 or
    VP8L (libwebp's StoreFrame); the image's size is read from its chunk
    as its size field gives it, its bitstream with the pad byte."""
    frame = {"alph": None, "image": None}
    for fourcc, start, size, _ in _chunks(data, pos, end):
        payload = data[start:start + size]
        if fourcc == b"ALPH" and frame["alph"] is None and frame["image"] is None:
            frame["alph"] = payload
        elif fourcc in (b"VP8 ", b"VP8L") and frame["image"] is None:
            if fourcc == b"VP8L" and frame["alph"] is not None:
                raise ValueError("WebP: an ALPH chunk before a lossless image")
            # the decoder reads the chunk with its pad byte, as libwebp's
            # demuxer hands it over: the last partition, or the lossless
            # bitstream, may end in it
            frame["image"] = (fourcc, data[start:start + size + (size & 1)])
            frame["size"] = (_vp8_size if fourcc == b"VP8 " else _vp8l_size)(payload)
        else:
            break
    if frame["image"] is None:
        raise ValueError("WebP: a frame without an image")
    return frame


def _check_alpha(alph: bytes, w: int, h: int) -> None:
    """An ALPH chunk decoded as libwebp decodes it, for its validity only."""
    if not alph:
        raise ValueError("WebP: an empty ALPH chunk")
    method, filt, pre, rsrv = alph[0] & 3, (alph[0] >> 2) & 3, (alph[0] >> 4) & 3, alph[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError("WebP: a bad ALPH header")
    if method == 0:
        if len(alph) - 1 < w * h:
            raise ValueError("WebP: a truncated ALPH chunk")
    else:
        _decode_lossless_stream(_LosslessBits(alph, 1), w, h)


def _decode_frame(frame: dict, check_alpha: bool) -> np.ndarray:
    fourcc, payload = frame["image"]
    w, h = frame["size"]
    if fourcc == b"VP8L":
        argb = decode_vp8l(payload)
        rgb = np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF], axis=-1)
        return rgb.astype(np.uint8)
    rgb = decode_vp8(payload)
    if check_alpha and frame["alph"] is not None:
        _check_alpha(frame["alph"], w, h)
    return rgb


def decode_webp(data: bytes) -> np.ndarray:
    """The bytes of a WebP file -> [h, w, 3] uint8: the first frame on the
    canvas, as Pillow's ``Image.open(...).convert("RGB")``."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    riff_size = struct.unpack("<I", data[4:8])[0]
    if riff_size < 12 or riff_size + 8 > len(data):
        raise ValueError("WebP: the file is shorter than its RIFF header says")
    end = riff_size + 8
    first = data[12:16]
    if first != b"VP8X":
        frame = _frame(data, 12, end)
        check_pixels(*frame["size"])
        return _decode_frame(frame, check_alpha=False)
    chunks = iter(_chunks(data, 12, end))
    _, start, size, pos = next(chunks)
    if size < 10:
        raise ValueError("WebP: a short VP8X chunk")
    flags = data[start]
    if flags & ~_VALID_FLAGS:
        raise ValueError("WebP: unknown VP8X flags")
    cw = int.from_bytes(data[start + 4:start + 7], "little") + 1
    ch = int.from_bytes(data[start + 7:start + 10], "little") + 1
    check_pixels(cw, ch)
    animated = bool(flags & _ANIMATION_FLAG)
    has_anim, first_frame = False, None
    for fourcc, start, size, nxt in chunks:
        if fourcc == b"VP8X":
            raise ValueError("WebP: a second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if has_anim or animated or first_frame is not None:
                raise ValueError("WebP: a still image in an animation")
            first_frame = dict(_frame(data, start - 8, end), x=0, y=0)
            break
        if fourcc == b"ANIM":
            if size < 6:
                raise ValueError("WebP: a short ANIM chunk")
            has_anim = True
        elif fourcc == b"ANMF":
            if not has_anim:
                raise ValueError("WebP: an ANMF chunk before ANIM")
            if size < 16:
                raise ValueError("WebP: a short ANMF chunk")
            x = 2 * int.from_bytes(data[start:start + 3], "little")
            y = 2 * int.from_bytes(data[start + 3:start + 6], "little")
            frame = dict(_frame(data, start + 16, start + size), x=x, y=y)
            if animated and first_frame is None:
                first_frame = frame
    if first_frame is None:
        raise ValueError("WebP: no image")
    w, h = first_frame["size"]
    x, y = first_frame["x"], first_frame["y"]
    if not animated and (x, y, w, h) != (0, 0, cw, ch) or x + w > cw or y + h > ch:
        raise ValueError("WebP: a frame outside its canvas")
    rgb = _decode_frame(first_frame, check_alpha=bool(flags & _ALPHA_FLAG))
    if (w, h) == (cw, ch):
        return rgb
    # the animation's canvas starts transparent black; the first frame is a
    # key frame, drawn at its offset without blending
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[y:y + h, x:x + w] = rgb
    return canvas
