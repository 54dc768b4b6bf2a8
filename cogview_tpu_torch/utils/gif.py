"""GIF decoder on numpy: the first frame, equal to Pillow 12.1's
``Image.open(...).convert("RGB")``.

Follows Pillow's ``GifImagePlugin`` for frame 0: the logical screen grows to
hold a frame that overhangs it; the frame's local palette, else the global
one, else none (a gray image of the indices); a palette whose every entry i
is (i, i, i) is dropped as Pillow drops it (the same pixels); the canvas
outside the frame holds the graphic control extension's transparent index
where there is one, else index 0; the transparent index is not applied,
since ``convert("RGB")`` of a "P" image ignores it.  The LZW stream is
decoded as Pillow's ``GifDecode.c`` does (LSB-first codes across data
sub-blocks, a clear code resets the table, the code size grows to 12 bits
and then stays, a data sub-block is read only once the file holds all of
it), and interlaced frames write their rows in the four passes 0::8,
4::8, 2::4 and 1::2.  The frame is done when its last pixel is written,
and only then: a zero-length block does not end it (``GifDecode.c`` reads
the bytes after it as further sub-blocks), and an end code before the
last pixel leaves it undone, so that Pillow's ``ImageFile.load`` meets
the end of the file and raises "image file is truncated", as it does
where the data run out; a code that the table does not yet hold is a
broken stream.  Both raise a ``ValueError``.
"""

from __future__ import annotations

import numpy as np

from .image_errors import check_pixels


def _palette_needed(p: bytes) -> bool:
    """Pillow's ``_is_palette_needed``: False when entry i is (i, i, i)."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


def _sub_blocks(data: bytes, pos: int, past_zero: bool = False) -> bytes:
    """Data sub-blocks from ``pos`` -> their bytes joined: up to a
    zero-length block, or with ``past_zero`` on through the rest of the
    file; a block the file holds only part of is not read."""
    out = bytearray()
    n = len(data)
    while pos < n:
        size = data[pos]
        if pos + 1 + size > n or not (size or past_zero):
            break
        out += data[pos + 1:pos + 1 + size]
        pos += 1 + size
    return bytes(out)


def _skip_sub_blocks(data: bytes, pos: int) -> int:
    while pos < len(data) and data[pos]:
        pos += 1 + data[pos]
    return pos + 1


def _lzw(stream: bytes, bits: int, npix: int):
    """The LZW codes in ``stream`` -> (up to ``npix`` pixel values,
    whether the end code stopped the decode)."""
    clear, end = 1 << bits, (1 << bits) + 1
    table = [bytes([i & 0xFF]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    size, mask = bits + 1, (1 << (bits + 1)) - 1
    prev = None
    acc = nacc = 0
    for byte in stream:
        acc |= byte << nacc
        nacc += 8
        while nacc >= size:
            code = acc & mask
            acc >>= size
            nacc -= size
            if code == clear:
                del table[end + 1:]
                size, mask = bits + 1, (1 << (bits + 1)) - 1
                prev = None
                continue
            if code == end:
                return out[:npix], True
            if prev is None:
                if code >= len(table):
                    raise ValueError("corrupt GIF: bad first LZW code")
                entry = table[code]
            else:
                if code < len(table):
                    entry = table[code]
                    new = prev + entry[:1]
                elif code == len(table):
                    entry = new = prev + prev[:1]
                else:
                    raise ValueError("corrupt GIF: LZW code past the table")
                if len(table) < 4096:
                    table.append(new)
                    if len(table) - 1 == mask and size < 12:
                        size += 1
                        mask = (1 << size) - 1
            out += entry
            prev = entry
            if len(out) >= npix:
                return out[:npix], False
    return out, False


def decode_gif(data: bytes) -> np.ndarray:
    """The bytes of a GIF file -> its first frame as [h, w, 3] uint8."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    if len(data) < 13:
        raise ValueError("corrupt GIF: truncated header")
    sw, sh = data[6] | data[7] << 8, data[8] | data[9] << 8
    pos = 13
    global_pal = None
    if data[10] & 128:
        n = 3 << ((data[10] & 7) + 1)
        p = data[pos:pos + n]
        pos += n
        if _palette_needed(p):
            global_pal = p
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("corrupt GIF: no image in the file")
        s = data[pos]
        pos += 1
        if s == 0x21:  # extension
            label = data[pos] if pos < len(data) else 0
            pos += 1
            size = data[pos] if pos < len(data) else 0
            block = data[pos + 1:pos + 1 + size] if size else None
            if label == 249 and block is not None and len(block) >= 4 and block[0] & 1:
                transparency = block[3]
            pos = _skip_sub_blocks(data, pos)
        elif s == 0x2C:  # image descriptor
            d = data[pos:pos + 9]
            if len(d) < 9:
                raise ValueError("corrupt GIF: truncated image descriptor")
            x0, y0 = d[0] | d[1] << 8, d[2] | d[3] << 8
            fw, fh = d[4] | d[5] << 8, d[6] | d[7] << 8
            flags = d[8]
            pos += 9
            local_pal = None
            if flags & 128:
                n = 3 << ((flags & 7) + 1)
                p = data[pos:pos + n]
                pos += n
                local_pal = p if _palette_needed(p) else False
            if pos >= len(data):
                raise ValueError("corrupt GIF: truncated image descriptor")
            bits = data[pos]
            pos += 1
            break
    if bits > 12:
        raise ValueError(f"corrupt GIF: LZW code size {bits}")
    x1, y1 = x0 + fw, y0 + fh
    w, h = max(sw, x1), max(sh, y1)
    if w == 0 or h == 0:
        raise ValueError(f"corrupt GIF: size {w} x {h}")
    check_pixels(w, h)
    pal = local_pal if local_pal is not None else global_pal
    canvas = np.full((h, w), transparency or 0, np.uint8)
    if fw and fh:
        px, ended = _lzw(_sub_blocks(data, pos), bits, fw * fh)
        if len(px) < fw * fh and not ended:  # on past a zero-length block
            px, ended = _lzw(_sub_blocks(data, pos, True), bits, fw * fh)
        if len(px) < fw * fh:
            raise ValueError("corrupt GIF: the frame ends before its last pixel (Pillow: "
                             "image file is truncated)")
        frame = canvas[y0:y1, x0:x1]
        rows = [r for start, step in ((0, 8), (4, 8), (2, 4), (1, 2)) for r in range(start, fh, step)]
        rows = rows if flags & 64 else list(range(fh))
        flat = np.frombuffer(bytes(px), np.uint8)
        for k in range(len(flat) // fw + (len(flat) % fw > 0)):
            seg = flat[k * fw:(k + 1) * fw]
            frame[rows[k], :len(seg)] = seg
    if not pal:
        return np.repeat(canvas[..., None], 3, axis=2)
    table = np.zeros((256, 3), np.uint8)
    k = min(len(pal) // 3, 256)
    table[:k] = np.frombuffer(pal[:3 * k], np.uint8).reshape(k, 3)
    return table[canvas]
