"""Autodesk FLI/FLC animation decoder, equal to Pillow 12.1's
``Image.open(...).convert("RGB")`` (the first frame).

Follows Pillow's ``FliImagePlugin`` and its C ``fli`` decoder.  The
128-byte header (magic 0xAF11 for FLI or 0xAF12 for FLC, zeros in its
reserved bytes) gives the size; ``_open`` looks for a palette in the first
frame (after a prefix chunk 0xF100 if there is one): the first COLOR chunk,
64-colour (11, each value shifted left by 2 and kept to 8 bits) or
256-colour (4), else a gray ramp.  The frame that is decoded is the one
at byte 128, whatever it is: a file that starts with a prefix chunk fails.
Its subchunks: BLACK (13), BRUN (15, byte runs of every row), COPY (16,
raw pixels), LC (12, byte deltas of a band of rows), SS2 (7, word deltas
with line skips and a last byte for odd widths), and the COLOR (4, 11)
and PSTAMP (18) chunks, which it skips, all over a black image.  Where the
decoder finds a run past a row or a frame's end past the data, an unknown
chunk or a chunk of length 0, or the frame is cut short, Pillow fails to
load the file: a ``ValueError`` here.  A header Pillow refuses, or a
palette chunk past index 255 or cut short, raises :class:`NotThisFormat`.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import NotThisFormat, check_pixels


def _u16(data, pos: int) -> int:
    return data[pos] | (data[pos + 1] << 8)


def _s32(data, pos: int) -> int:
    return struct.unpack_from("<i", data, pos)[0]


def _palette(data: bytes, pos: int, shift: int) -> np.ndarray:
    """FliImagePlugin._palette over the gray ramp -> [256, 3] uint8.  An
    index past 255 or a packet cut short is its IndexError, and a count
    cut short its struct.error: Pillow then takes the file as no FLI."""
    pal = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, axis=1)
    i = 0
    if pos + 2 > len(data):
        raise NotThisFormat("not an FLI/FLC file: a palette cut short")
    count = _u16(data, pos)
    pos += 2
    for _ in range(count):
        s = data[pos:pos + 2]
        pos += len(s)
        if len(s) < 2:
            raise NotThisFormat("not an FLI/FLC file: a palette packet cut short")
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            if k + 2 >= len(s) or i > 255:
                raise NotThisFormat("not an FLI/FLC file: a palette past index 255 or cut short")
            pal[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1
    return (pal & 255).astype(np.uint8)


def _header(data: bytes) -> tuple:
    """FliImageFile._open -> (w, h, palette [256, 3], the first frame's
    size word)."""
    if (len(data) < 128 or data[20:22] != bytes(2) or data[42:80] != bytes(38)
            or data[88:128] != bytes(40)):
        raise NotThisFormat("not an FLI/FLC file")
    w, h = struct.unpack_from("<HH", data, 8)
    palette = None
    try:
        pos = 128
        if struct.unpack_from("<H", data, pos + 4)[0] == 0xF100:  # a prefix chunk
            pos += struct.unpack_from("<I", data, pos)[0]
        if struct.unpack_from("<H", data, pos + 4)[0] == 0xF1FA:  # a frame: its palette
            pos += 16
            size = None
            for _ in range(struct.unpack_from("<H", data, pos - 10)[0]):
                if size is not None:
                    pos += size - 6
                kind = struct.unpack_from("<H", data, pos + 4)[0]
                if kind in (4, 11):
                    palette = _palette(data, pos + 6, 2 if kind == 11 else 0)
                    break
                size = struct.unpack_from("<I", data, pos)[0]
                pos += 6
                if not size:
                    break
        if len(data) < 129:  # seek(0): the first frame's size word
            raise EOFError
        frame = struct.unpack_from("<I", data, 128)[0]
    except (struct.error, IndexError, EOFError):
        raise NotThisFormat("not an FLI/FLC file: a chunk cut short") from None
    if w <= 0 or h <= 0:
        raise NotThisFormat("FLI: a size of 0, which Pillow identifies as no image")
    if palette is None:
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    return w, h, palette, frame


def _frame(buf: bytes, img: bytearray, w: int, h: int):
    """FliDecode.c on the bytes handed to it -> where it needs more, the
    bytes it consumed (0, or the offset of a COPY chunk whose pixels run
    past them); True at the frame's end; a ``ValueError`` where it fails."""
    n = len(buf)
    if n < 4:
        return 0
    if n + (n % 2) < _s32(buf, 0):  # one pad byte may follow the frame
        return 0
    if n < 8:
        raise ValueError("FLI: a frame header cut short")
    if _u16(buf, 4) != 0xF1FA:
        raise ValueError("FLI: the first frame is no frame chunk")
    ptr, left = 16, n - 16
    for _ in range(_u16(buf, 6)):
        if left < 10:
            raise ValueError("FLI: a chunk header cut short")
        end = ptr + left  # the decoder's bound on every read: the end of the bytes

        def need(at: int) -> None:
            if at > end:
                raise ValueError("FLI: a chunk's data past the end of the frame")

        kind = _u16(buf, ptr + 4)
        d = ptr + 6
        if kind == 7:  # SS2: word deltas
            lines = _u16(buf, d)
            d += 2
            y = done = 0
            while done < lines and y < h:
                row = y * w
                need(d + 2)
                packets = _u16(buf, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets  # skip lines
                        if y >= h:
                            raise ValueError("FLI: SS2 skips past the last row")
                        row = y * w
                    else:
                        img[row + w - 1] = packets & 255  # the last byte of an odd row
                    need(d + 2)
                    packets = _u16(buf, d)
                    d += 2
                x = p = 0
                while p < packets:
                    need(d + 2)
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        i = 256 - buf[d + 1]
                        if x + 2 * i > w:
                            break
                        need(d + 4)
                        img[row + x:row + x + 2 * i] = buf[d + 2:d + 4] * i
                        d += 4
                        x += 2 * i
                    else:
                        i = 2 * buf[d + 1]
                        if x + i > w:
                            break
                        need(d + 2 + i)
                        img[row + x:row + x + i] = buf[d + 2:d + 2 + i]
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                done += 1
                y += 1
            if done < lines:
                raise ValueError("FLI: SS2 lines past the frame")
        elif kind == 12:  # LC: byte deltas
            y = _u16(buf, d)
            ymax = y + _u16(buf, d + 2)
            d += 4
            while y < ymax and y < h:
                row = y * w
                need(d + 1)
                packets = buf[d]
                d += 1
                x = p = 0
                while p < packets:
                    need(d + 2)
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        i = 256 - buf[d + 1]
                        if x + i > w:
                            break
                        need(d + 3)
                        img[row + x:row + x + i] = buf[d + 2:d + 3] * i
                        d += 3
                    else:
                        i = buf[d + 1]
                        if x + i > w:
                            break
                        need(d + 2 + i)
                        img[row + x:row + x + i] = buf[d + 2:d + 2 + i]
                        d += 2 + i
                    x += i
                    p += 1
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise ValueError("FLI: LC lines past the frame")
        elif kind == 13:  # BLACK
            img[:] = bytes(len(img))
        elif kind == 15:  # BRUN: byte runs
            for y in range(h):
                row = y * w
                d += 1  # the packet count, unused
                x = 0
                while x < w:
                    need(d + 2)
                    c = buf[d]
                    if c & 0x80:
                        i = 256 - c
                        if x + i > w:
                            break
                        need(d + i + 1)
                        img[row + x:row + x + i] = buf[d + 1:d + 1 + i]
                        d += i + 1
                    else:
                        i = c
                        if x + i > w:
                            break
                        img[row + x:row + x + i] = buf[d + 1:d + 2] * i
                        d += 2
                    x += i
                if x != w:
                    raise ValueError("FLI: a BRUN row that does not fill its width")
        elif kind == 16:  # COPY
            if d + w * h > end:
                return ptr  # the decoder asks for more from this chunk on
            img[:] = buf[d:d + w * h]
        elif kind not in (4, 11, 18):
            raise ValueError(f"FLI: unknown chunk type {kind}")
        advance = _s32(buf, ptr)
        if advance == 0:
            raise ValueError("FLI: a chunk of length 0")
        if advance < 0 or advance > left:
            raise ValueError("FLI: a chunk past the end of the frame")
        ptr += advance
        left -= advance
    return True


def decode_fli(data: bytes) -> np.ndarray:
    """The bytes of an FLI or FLC file -> its first frame, [h, w, 3] uint8."""
    w, h, palette, block = _header(data)
    check_pixels(w, h)
    img = bytearray(w * h)
    pos, buf = 128, b""
    while True:  # ImageFile.load: blocks of the frame's size until the decoder is done
        s = data[pos:pos + block]
        pos += len(s)
        if not s:
            raise ValueError("FLI: image file is truncated")
        buf += s
        got = _frame(buf, img, w, h)
        if got is True:
            break
        buf = buf[got:]
    return palette[np.frombuffer(bytes(img), np.uint8).reshape(h, w)]
