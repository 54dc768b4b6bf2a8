"""DDS (DirectDraw Surface) decoder on numpy, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``DdsImagePlugin`` and its C ``BcnDecode``: the pixels
start right after the 128-byte header (and the DX10 header, or the
256-entry RGBA palette), as Pillow's ``load_seek`` does not move.

* Uncompressed RGB(A) with channel masks, each channel
  ``int(value / max * 255)`` in float64, wrapped to 8 bits; Pillow reads
  past the end of the data as zeros, so a short file reads black.
* Luminance at 8 bits, luminance and alpha at 16, 8-bit palette indices,
  and DX10's R8G8B8A8.
* Block compression BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4 (ATI1) and BC5
  (ATI2, and signed BC5S, whose blue Pillow sets to 128), BC6H unsigned
  and signed (DX10 formats 95 and 96: its 14 modes, reserved ones black,
  the delta endpoints, the unquantize step, then Pillow's half float
  clamped to [0, 1] and truncated to 8 bits) and BC7's eight modes
  (partitions, p-bits, rotations, the index-selection bit), by FourCC or
  DX10 format, in 4 x 4 blocks that the image's edge may cut.

A header size other than 124, a FourCC or DXGI format Pillow does not
know and data cut short raise a ``ValueError``, as Pillow fails on them.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels

_ALPHAPIXELS, _FOURCC, _PAL8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
_FOURCCS = {b"DXT1": 1, b"DXT3": 2, b"DXT5": 3, b"BC4U": 4, b"ATI1": 4, b"BC5U": 5,
            b"ATI2": 5, b"BC5S": -5}
_DXGI = {70: 1, 71: 1, 73: 2, 74: 2, 76: 3, 77: 3, 79: 4, 80: 4, 82: 5, 83: 5, 84: -5,
         95: 6, 96: -6, 97: 7, 98: 7, 99: 7, 27: 0, 28: 0, 29: 0}
_BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}


def _565(c: np.ndarray) -> np.ndarray:
    """[n] 5-6-5 words -> [n, 3] int64, BcnDecode's decode_565."""
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | (r >> 5), g | (g >> 6), b | (b >> 5)], -1)


def _bc1_colors(blk: np.ndarray, four: bool) -> np.ndarray:
    """[n, 8] colour blocks -> [n, 16, 3] uint8 (decode_bc1_color; ``four``:
    always the four-colour mode, as BC2 and BC3 read their colour)."""
    b = blk.astype(np.int64)
    c0 = b[:, 0] | (b[:, 1] << 8)
    c1 = b[:, 2] | (b[:, 3] << 8)
    lut = b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16) | (b[:, 7] << 24)
    p0, p1 = _565(c0), _565(c1)
    four_mode = ((c0 > c1) | four)[:, None]
    p2 = np.where(four_mode, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four_mode, (p0 + 2 * p1) // 3, 0)
    pal = np.stack([p0, p1, p2, p3], 1)  # [n, 4, 3]
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1).astype(np.uint8)


def _bc3_alpha(blk: np.ndarray, signed: bool = False) -> np.ndarray:
    """[n, 8] alpha blocks -> [n, 16] uint8 (decode_bc3_alpha)."""
    b = blk.astype(np.int64)
    a0, a1 = b[:, 0], b[:, 1]
    if signed:
        a0 = (a0 ^ 0x80) & 0xFF  # an int8 plus 128
        a1 = (a1 ^ 0x80) & 0xFF
    big = (a0 > a1)[:, None]
    k = np.arange(1, 7)
    eight = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    k4 = np.arange(1, 5)
    six = np.concatenate([((5 - k4) * a0[:, None] + k4 * a1[:, None]) // 5,
                          np.zeros_like(a0)[:, None], np.full_like(a0, 255)[:, None]], 1)
    pal = np.concatenate([a0[:, None], a1[:, None], np.where(big, eight, six)], 1)
    lut = [b[:, 2] | (b[:, 3] << 8) | (b[:, 4] << 16), b[:, 5] | (b[:, 6] << 8) | (b[:, 7] << 16)]
    idx = np.concatenate([(x[:, None] >> (3 * np.arange(8))) & 7 for x in lut], 1)
    return np.take_along_axis(pal, idx, 1).astype(np.uint8)

# BC7 (BPTC): per mode (subsets, partition bits, rotation bits, index-selection
# bits, colour bits, alpha bits, p-bits per endpoint, p-bits per subset,
# index bits, second index bits)
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
_BC7_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
                4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}
# the 64 partitions of 2 and of 3 subsets: pixel i's subset in bits 2i, 2i + 1
_BC7_P2 = (
    0x50505050, 0x40404040, 0x54545454, 0x54505040, 0x50404000, 0x55545450, 0x55545040,
    0x54504000, 0x50400000, 0x55555450, 0x55544000, 0x54400000, 0x55555440, 0x55550000,
    0x55555500, 0x55000000, 0x55150100, 0x00004054, 0x15010000, 0x00405054, 0x00004050,
    0x15050100, 0x05010000, 0x40505054, 0x00404050, 0x05010100, 0x14141414, 0x05141450,
    0x01155440, 0x00555500, 0x15014054, 0x05414150, 0x44444444, 0x55005500, 0x11441144,
    0x05055050, 0x05500550, 0x11114444, 0x41144114, 0x44111144, 0x15055054, 0x01055040,
    0x05041050, 0x05455150, 0x14414114, 0x50050550, 0x41411414, 0x00141400, 0x00041504,
    0x00105410, 0x10541000, 0x04150400, 0x50410514, 0x41051450, 0x05415014, 0x14054150,
    0x41050514, 0x41505014, 0x40011554, 0x54150140, 0x50505500, 0x00555050, 0x15151010,
    0x54540404)
_BC7_P3 = (
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0,
    0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4,
    0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454,
    0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444,
    0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254)
# the pixel of each partition whose index is a bit shorter: subset 1's of
# 2, subsets 1 and 2's of 3 (subset 0's is pixel 0)
_BC7_A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8,
    8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15,
    15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_BC7_A3A = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8,
    8, 6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3,
    15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_BC7_A3B = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15,
    8, 3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6,
    6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)


def _bc7_block(blk: bytes) -> list:
    """One BC7 block -> 16 pixels' (R, G, B), row by row (BcnDecode's
    decode_bc7_block; a block with no mode bit in its first byte is black)."""
    v = int.from_bytes(blk, "little")
    mode = (v & -v).bit_length() - 1
    if not 0 <= mode < 8:
        return [(0, 0, 0)] * 16
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    pos = mode + 1

    def take(n: int) -> int:
        nonlocal pos
        x = (v >> pos) & ((1 << n) - 1)
        pos += n
        return x

    part, rot, sel = take(pb), take(rb), take(isb)
    ep = [[[0, 0, 0, 255] for _ in range(2)] for _ in range(ns)]
    for ch in range(4 if ab else 3):
        for s in range(ns):
            for e in range(2):
                ep[s][e][ch] = take(cb if ch < 3 else ab)
    pbits = ([[take(1), take(1)] for _ in range(ns)] if epb else
             [[p, p] for p in (take(1) for _ in range(ns))] if spb else None)
    for s in range(ns):
        for e in range(2):
            for ch in range(4 if ab else 3):
                n = cb if ch < 3 else ab
                x = ep[s][e][ch]
                if pbits:
                    x, n = (x << 1) | pbits[s][e], n + 1
                ep[s][e][ch] = (x << (8 - n)) | (x >> (2 * n - 8))
    if ns == 1:
        subset, anchors = [0] * 16, (0,)
    elif ns == 2:
        subset = [(_BC7_P2[part] >> (2 * i)) & 3 for i in range(16)]
        anchors = (0, _BC7_A2[part])
    else:
        subset = [(_BC7_P3[part] >> (2 * i)) & 3 for i in range(16)]
        anchors = (0, _BC7_A3A[part], _BC7_A3B[part])
    idx = [take(ib - (i == anchors[subset[i]])) for i in range(16)]
    idx2 = [take(ib2 - (i == 0)) for i in range(16)] if ib2 else idx
    cbits, abits = ib, (ib2 or ib)
    if sel:  # mode 4: the 3-bit indices for colour, the 2-bit for alpha
        idx, idx2, cbits, abits = idx2, idx, abits, cbits
    wc, wa = _BC7_WEIGHTS[cbits], _BC7_WEIGHTS[abits]
    out = []
    for i in range(16):
        e0, e1 = ep[subset[i]]
        c, a = wc[idx[i]], wa[idx2[i]]
        px = [((64 - c) * e0[ch] + c * e1[ch] + 32) >> 6 for ch in range(3)]
        px.append(((64 - a) * e0[3] + a * e1[3] + 32) >> 6)
        if rot:
            px[rot - 1], px[3] = px[3], px[rot - 1]
        out.append(tuple(px[:3]))
    return out


# BC6H: per mode, in Pillow's order (the 2-bit modes 0 and 1, then the 5-bit
# ones 2, 6, ..., 30 and 3, 7, 11, 15): (regions, transformed, endpoint
# bits, delta bits of r, g, b) and where each endpoint bit lies, in the
# order the block stores them after the mode bits (D3D's table of BC6H
# endpoint layouts; a field [9:0] is stored from bit 0 up, [10:15] from bit
# 15 down).  Endpoints r0 g0 b0 (w), r1 g1 b1 (x), r2 g2 b2 (y), r3 g3 b3 (z).
_BC6_MODES = (
    (2, 1, 10, 5, 5, 5, "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] "
     "g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    (2, 1, 7, 6, 6, 6, "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] "
     "g2[4] b0[6:0] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] "
     "r2[5:0] r3[5:0]"),
    (2, 1, 11, 5, 4, 4, "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] "
     "b3[0] g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    (2, 1, 11, 4, 5, 4, "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] "
     "g0[10] g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] g2[4] b3[3]"),
    (2, 1, 11, 4, 4, 5, "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] "
     "g0[10] b3[0] g3[3:0] b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] b3[4] b3[3]"),
    (2, 1, 9, 5, 5, 5, "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] "
     "g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    (2, 1, 8, 6, 5, 5, "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] "
     "r1[5:0] g2[3:0] g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]"),
    (2, 1, 8, 5, 6, 5, "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] "
     "r1[4:0] g3[4] g2[3:0] g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] "
     "b3[3]"),
    (2, 1, 8, 5, 5, 6, "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] "
     "r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] r3[4:0] "
     "b3[3]"),
    (2, 0, 6, 6, 6, 6, "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] "
     "b0[5:0] g3[5] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] "
     "r2[5:0] r3[5:0]"),
    (1, 0, 10, 10, 10, 10, "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]"),
    (1, 1, 11, 9, 9, 9, "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]"),
    (1, 1, 12, 8, 8, 8, "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] "
     "b1[7:0] b0[10:11]"),
    (1, 1, 16, 4, 4, 4, "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] "
     "b1[3:0] b0[10:15]"))


def _bc6_layout(text: str) -> list:
    """A layout string -> [(endpoint 0..11, bit)] in stored order."""
    out = []
    for field in text.split():
        name, bits = field[:2], field[3:-1].split(":")
        k = "rgb".index(name[0]) + 3 * int(name[1])
        hi, lo = int(bits[0]), int(bits[-1])
        out += [(k, b) for b in range(lo, hi + (1 if hi >= lo else -1), 1 if hi >= lo else -1)]
    return out


_BC6_LAYOUTS = [_bc6_layout(m[6]) for m in _BC6_MODES]


def _sign_extend(v: np.ndarray, bits: int) -> np.ndarray:
    return np.where(v & (1 << (bits - 1)), v - (1 << bits), v)


def _bc6_unquantize(v: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    """BcnDecode.c's bc6_unquantize of endpoints at ``prec`` bits."""
    if not signed:
        if prec >= 15:
            return v
        q = ((v << 15) + 0x4000) >> (prec - 1)
        return np.where(v == 0, 0, np.where(v == (1 << prec) - 1, 0xFFFF, q))
    v = _sign_extend(v & 0xFFFF, 16)  # the endpoints are UINT16, read as INT16
    if prec >= 16:
        return v
    a = np.abs(v)
    q = np.where(a >= (1 << (prec - 1)) - 1, 0x7FFF, ((a << 15) + 0x4000) >> (prec - 1))
    q = np.where(a == 0, 0, q)
    return np.where(v < 0, -q, q)


def _bc6_blocks(blk: np.ndarray, signed: bool) -> np.ndarray:
    """[n, 16] BC6H blocks -> [n, 16, 3] uint8 (BcnDecode's
    decode_bc6_block, then Pillow's half float to 8 bits)."""
    bits = np.unpackbits(blk, axis=1, bitorder="little")  # [n, 128]
    two = (blk[:, 0] & 3).astype(np.int64)
    five = (blk[:, 0] & 31).astype(np.int64)
    mode = np.where(two < 2, two, np.where(two == 2, 2 + (five >> 2), 10 + (five >> 2)))
    px = np.zeros((len(blk), 16, 3), np.uint8)  # a reserved mode is black
    for m, (ns, tr, epb, rb, gb, bb, _) in enumerate(_BC6_MODES):
        sel = np.nonzero(mode == m)[0]
        if not len(sel):
            continue
        b = bits[sel].astype(np.int64)
        pos = 2 if m < 2 else 5
        ep = np.zeros((len(sel), 12), np.int64)
        for k, bit in _BC6_LAYOUTS[m]:
            ep[:, k] |= b[:, pos] << bit
            pos += 1
        nep = 6 * ns
        if signed:
            ep[:, :3] = _sign_extend(ep[:, :3], epb)
        if signed or tr:
            for i, db in enumerate((rb, gb, bb) * (ns * 2 - 1)):
                ep[:, 3 + i] = _sign_extend(ep[:, 3 + i], db)
        if tr:  # the sum is not sign-extended again (bc6_unquantize's INT16 cast aside)
            ep[:, 3:nep] = (ep[:, 3:nep] + np.tile(ep[:, :3], ns * 2 - 1)) & ((1 << epb) - 1)
        ep = _bc6_unquantize(ep[:, :nep], epb, signed)
        if ns == 2:
            part = sum(b[:, pos + i] << i for i in range(5))
            pos += 5
            subset = (np.array(_BC7_P2)[part][:, None] >> (2 * np.arange(16))) & 3
            anchor = np.array(_BC7_A2)[part]
            ib = 3
        else:
            subset = np.zeros((len(sel), 16), np.int64)
            anchor = np.zeros(len(sel), np.int64)
            ib = 4
        at = np.full(len(sel), pos)
        idx = np.zeros((len(sel), 16), np.int64)
        for i in range(16):
            width = ib - ((i == 0) | (anchor == i))  # an anchor's index is a bit shorter
            for t in range(ib):
                bit = b[np.arange(len(sel)), np.minimum(at + t, 127)]
                idx[:, i] |= np.where(t < width, bit << t, 0)
            at = at + width
        weights = np.array(_BC7_WEIGHTS[ib])[idx]
        ep3, rows = ep.reshape(-1, ns * 2, 3), np.arange(len(sel))[:, None]
        e0, e1 = ep3[rows, 2 * subset], ep3[rows, 2 * subset + 1]
        v = (e0 * (64 - weights[..., None]) + e1 * weights[..., None]) >> 6
        if signed:
            half = np.where(v < 0, 0x8000 | (((-v) * 31) >> 5), (v * 31) >> 5)
        else:
            half = (v * 31) >> 6
        f = half.astype(np.uint16).view(np.float16).astype(np.float32)
        px[sel] = np.where(f < 0, 0, np.where(f > 1, 255, f * np.float32(255))).astype(np.uint8)
    return px


def bcn_decode(data: bytes, pos: int, w: int, h: int, n: int) -> np.ndarray:
    """Block-compressed pixels from ``pos`` -> [h, w, 3] uint8."""
    bw, bh = -(-w // 4), -(-h // 4)
    size = _BLOCK_BYTES[abs(n)]
    body = data[pos:pos + bw * bh * size]
    if len(body) < bw * bh * size:
        raise ValueError("corrupt DDS: image file is truncated")
    blk = np.frombuffer(body, np.uint8).reshape(bw * bh, size)
    if n == 1:
        px = _bc1_colors(blk, False)
    elif n in (2, 3):
        px = _bc1_colors(blk[:, 8:], True)
    elif n == 4:
        px = np.repeat(_bc3_alpha(blk)[..., None], 3, axis=2)
    elif abs(n) == 6:
        px = _bc6_blocks(blk, n < 0)
    elif n == 7:
        px = np.array([_bc7_block(b.tobytes()) for b in blk], np.uint8).reshape(-1, 16, 3)
    else:
        red, green = _bc3_alpha(blk[:, :8], n < 0), _bc3_alpha(blk[:, 8:], n < 0)
        blue = np.full_like(red, 128 if n < 0 else 0)  # Pillow's blue of BC5S and BC5
        px = np.stack([red, green, blue], -1)
    img = px.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, 3)
    return np.ascontiguousarray(img[:h, :w])


def _masked(data: bytes, pos: int, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """DdsRgbDecoder: little-endian pixels of bitcount // 8 bytes, each
    channel int(masked value / its maximum * 255) wrapped to 8 bits.  Past
    the end of the data Pillow reads zeros: those pixels are black.  The
    masks are 32-bit, so only a pixel's first 4 bytes count."""
    nbytes = bitcount // 8
    n = w * h
    out = np.zeros((n, 3), np.uint8)
    k = min(nbytes, 4)
    avail = max(0, len(data) - pos)
    m = min(n, -(-avail // nbytes)) if nbytes else 0  # the pixels the data reaches
    buf = np.frombuffer(data[pos:] + bytes(k), np.uint8)
    b = buf[(np.arange(m, dtype=np.int64) * nbytes)[:, None] + np.arange(k)]
    px = np.zeros(m, np.uint64)
    for i in range(k):
        px |= b[:, i].astype(np.uint64) << np.uint64(8 * i)
    for c, mask in enumerate(masks[:3]):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            v = ((px & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
            out[:m, c] = ((v / (mask >> shift)) * 255).astype(np.int64).astype(np.uint8)
    return out.reshape(h, w, 3)


def _raw(data: bytes, pos: int, w: int, h: int, k: int) -> np.ndarray:
    body = data[pos:pos + w * h * k]
    if len(body) < w * h * k:
        raise ValueError("corrupt DDS: image file is truncated")
    return np.frombuffer(body, np.uint8).reshape(h, w, k)


def decode_dds(data: bytes) -> np.ndarray:
    """The bytes of a DDS file -> [h, w, 3] uint8."""
    if len(data) < 8 or struct.unpack_from("<I", data, 4)[0] != 124:
        raise ValueError("DDS: unsupported header size")
    if len(data) < 128:
        raise ValueError("corrupt DDS: incomplete header")
    h, w = struct.unpack_from("<II", data, 12)
    if w <= 0 or h <= 0:  # Pillow's "not identified by this driver"
        raise NotThisFormat(f"corrupt DDS: size {w} x {h}")
    check_pixels(w, h)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    if pfflags & _RGB:
        masks = struct.unpack_from("<4I", data, 92)
        return _masked(data, 128, w, h, bitcount, masks)
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            return np.repeat(_raw(data, 128, w, h, 1), 3, axis=2)
        if bitcount == 16 and pfflags & _ALPHAPIXELS:
            return np.repeat(_raw(data, 128, w, h, 2)[..., :1], 3, axis=2)
        raise ValueError(f"DDS: unsupported luminance bit count {bitcount}")
    if pfflags & _PAL8:
        pal = np.frombuffer(data[128:128 + 1024], np.uint8)
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(pal) // 4] = pal[:len(pal) // 4 * 4].reshape(-1, 4)[:, :3]
        return palette[_raw(data, 128 + len(pal), w, h, 1)[..., 0]]
    if not pfflags & _FOURCC:
        raise ValueError(f"DDS: unknown pixel format flags {pfflags}")
    pos = 128
    if fourcc == b"DX10":
        if len(data) < 148:
            raise ValueError("corrupt DDS: short DX10 header")
        dxgi = struct.unpack_from("<I", data, 128)[0]
        pos = 148
        if dxgi not in _DXGI:
            raise ValueError(f"DDS: unimplemented DXGI format {dxgi}")
        n = _DXGI[dxgi]
    elif fourcc in _FOURCCS:
        n = _FOURCCS[fourcc]
    else:
        raise ValueError(f"DDS: unimplemented pixel format {fourcc!r}")
    if n == 0:
        return np.ascontiguousarray(_raw(data, pos, w, h, 4)[..., :3])
    return bcn_decode(data, pos, w, h, n)
