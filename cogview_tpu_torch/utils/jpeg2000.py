"""The header checks of Pillow 12.1's ``Jpeg2KImagePlugin._open``.

The port does not decode JPEG 2000: a file whose header Pillow opens
raises ``UnsupportedImageError`` naming it (outcome (b) of
``utils/image_errors.py``), and this module decides which files those
are.  :func:`check_jpeg2000` reads what ``_open`` reads: a codestream's
SIZ segment and its markers up to the first tile, or a JP2 file's boxes
up to its ``jp2h`` header box, the ``ihdr``, ``colr``, ``pclr`` and
``res `` boxes inside it, then the first markers of the codestream that
follows.  Where ``_open`` refuses the header (a ``SyntaxError``, or an
``IndexError`` or ``struct.error`` that Pillow turns into one) it raises
:class:`NotThisFormat`, and ``Image.open`` goes on to its next plugin;
where ``_open`` fails another way (a box cut short raises ``OSError``, a
palette of more than 256 colours ``ValueError``) it raises a
``ValueError``.  Last comes Pillow's decompression-bomb check.
"""

from __future__ import annotations

import struct

from .image_errors import NotThisFormat, check_pixels

CODESTREAM = b"\xff\x4f\xff\x51"  # SOC, then SIZ
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


class _Stream:
    """A file position over bytes that reads and seeks as ``io.BytesIO``."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:] if n < 0 else self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def skip(self, n: int) -> None:
        self.pos += n


def _u16(b: bytes) -> int:
    if len(b) < 2:  # Pillow's i16be: struct.error
        raise NotThisFormat("a JPEG 2000 marker cut short")
    return struct.unpack_from(">H", b)[0]


class _Boxes:
    """Pillow's BoxReader: boxes inside ``length`` bytes (-1: no end)."""

    def __init__(self, fp: _Stream, length: int = -1):
        self.fp, self.length, self.remaining = fp, length, -1

    def _can_read(self, n: int) -> bool:
        if self.length >= 0 and self.fp.pos + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise NotThisFormat("not enough data in a JPEG 2000 header box")
        data = self.fp.read(n)
        if len(data) < n:
            raise ValueError(f"a JPEG 2000 header box cut short ({len(data)} of {n} bytes)")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def inner(self) -> "_Boxes":
        size = self.remaining
        return _Boxes(_Stream(self.read(size)), size)

    def has_next(self) -> bool:
        return self.length < 0 or self.fp.pos + self.remaining < self.length

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.fp.skip(self.remaining)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise NotThisFormat("invalid JPEG 2000 header length")
        self.remaining = lbox - hlen
        return tbox


def _markers(fp: _Stream) -> None:
    """_parse_comment: the marker segments up to a tile, the end or a comment."""
    while True:
        marker = fp.read(2)
        if not marker:
            return
        if len(marker) < 2:
            raise NotThisFormat("a JPEG 2000 marker cut short")
        if marker[1] in (0x90, 0xD9):
            return
        length = _u16(fp.read(2))
        if marker[1] == 0x64:
            return
        fp.skip(length - 2)


def _codestream(fp: _Stream) -> tuple:
    """_parse_codestream: the SIZ segment -> (width, height)."""
    hdr = fp.read(2)
    siz = hdr + fp.read(_u16(hdr) - 2)
    if len(siz) < 38:
        raise NotThisFormat("a JPEG 2000 SIZ segment cut short")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    if csiz not in (1, 2, 3, 4) or (csiz == 1 and len(siz) < 39):
        raise NotThisFormat("unable to determine J2K image mode")
    return xsiz - xosiz, ysiz - yosiz


def _palette(header: _Boxes, entries: int, npc: int) -> None:
    """The pclr box's colours as ImagePalette.getcolor adds them: a new
    colour past index 255 raises ValueError."""
    width = 4 if npc == 4 else 3  # the palette's mode, RGBA or RGB
    pal, seen = bytearray(), set()
    for _ in range(entries):
        color = header.fields(">" + "B" * npc)
        if color in seen:
            continue
        index = len(pal) // width
        if index >= 256:
            raise ValueError("a JPEG 2000 palette of more than 256 colours")
        seen.add(color)
        pal[index * width:index * width + width] = bytes(color)


def _jp2_header(fp: _Stream) -> tuple:
    """_parse_jp2_header -> (width, height)."""
    reader = _Boxes(fp)
    while True:
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.inner()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    size = mode = nc = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and bpc & 0x7F > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            header.fields(">BBBI")
        elif tbox == b"pclr" and mode in ("L", "LA"):
            entries, npc = header.fields(">HB")
            if max(header.fields(">" + "B" * npc), default=0) <= 8:
                _palette(header, entries, npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.inner()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise NotThisFormat("malformed JP2 header")
    return size


def check_jpeg2000(data: bytes) -> None:
    """Raise as Pillow's ``_open`` and decompression-bomb check do for a
    JPEG 2000 file's header, and a ``ValueError`` for a file whose
    codestream OpenJPEG cannot load because it is cut short; return where
    Pillow opens the file."""
    fp = _Stream(data, 4)
    if data[:4] == CODESTREAM:
        w, h = _codestream(fp)
        _markers(fp)
        start = 0
    elif data[:12] == JP2_SIGNATURE:
        fp.pos = 12
        w, h = _jp2_header(fp)
        start = _codestream_box(data, fp.pos)
        if fp.read(12).endswith(b"jp2c" + CODESTREAM):
            fp.skip(_u16(fp.read(2)) - 2)
            _markers(fp)
    else:
        raise NotThisFormat("not a JPEG 2000 file")
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_pixels(w, h)
    if start is None or not _whole(data, start + 2):
        raise ValueError("a JPEG 2000 file cut short: Pillow cannot load it")


def _codestream_box(data: bytes, pos: int):
    """Where the codestream box's body starts, among a JP2 file's boxes
    after its header; None where there is none."""
    while pos + 8 <= len(data):
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1 and pos + 16 <= len(data):
            lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
        if tbox == b"jp2c":
            return pos + hlen
        if lbox < 8:
            return None
        pos += lbox
    return None


def _whole(data: bytes, at: int) -> bool:
    """Whether OpenJPEG loads the codestream whose main header starts at
    ``at`` (past SOC): its segments to the first tile part, the tile parts
    by their lengths, then the end marker.  A codestream cut short loads
    only where it ends just after a tile part's SOT marker code, which
    OpenJPEG takes as the end; a layout this walk does not follow is left
    to load."""
    while data[at:at + 2] != b"\xff\x90":  # the main header
        if at + 4 > len(data):
            return False
        at += 2 + struct.unpack_from(">H", data, at + 2)[0]
    while True:  # the tile parts
        if at + 2 > len(data):
            return False
        if data[at:at + 2] != b"\xff\x90" or at + 2 == len(data):
            return True
        if at + 10 > len(data):
            return False
        psot = struct.unpack_from(">I", data, at + 6)[0]
        if psot == 0:
            return True
        at += psot
