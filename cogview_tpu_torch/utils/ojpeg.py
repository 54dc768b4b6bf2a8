"""Old-style JPEG in TIFF (compression 6) as libtiff 4.7's ``tif_ojpeg.c``
reads it for Pillow 12.1.

libtiff reads the whole image as one JPEG stream that it writes itself:
SOI, the quantization and Huffman tables, a DRI where there is a restart
interval, SOF and SOS, then the entropy-coded bytes, a restart marker
between one strip's bytes and the next, and EOI.  The tables, frame and
scan come from a JPEG header, read marker by marker (APPn and COM
skipped) from the JPEGInterchangeFormat bytes (tags 513/514) and on into
the strips, or, where the data start with no marker, from the tags:
JPEGQTables (519: 64 bytes a component), JPEGDCTables and JPEGACTables
(520, 521: 16 counts and their symbols a component), one component of the
YCbCrSubsampling factors and the rest 1 x 1, the image's size.  Before
that, the header's first frame sets the subsampling (libtiff trusts it
over the tag).  The stream is as wide as a strip or tile and each strip or
tile is the next band of its rows; with several, each is a restart
interval of ceil(width / 8h) x (rows / 8v) MCUs.

libjpeg then gives the components at their own sampling (raw data, no
upsampling, no colour conversion), libtiff lays them out as TIFF's YCbCr
blocks, and Pillow reads YCbCr through libtiff's RGBA interface
(``tiff_rgba``); one component is read as gray.  A header libtiff or
libjpeg refuses fails the image; damaged entropy-coded data are read as
libjpeg-turbo reads them (``jpeg.py``).  Tiles side by side are read as
libtiff reads them, each the next band of the one stream (past its end, a
tile keeps the rows read before); one sample in planes is read as in one
plane, three in planes as three streams of one component each, from the
header's scan and each SOS marker found after it, converted as YCbCr at
1 x 1.  One case stays named: planes whose second scan's SOS marker is
corrupt where the first plane has more than one strip or tile (libtiff
reads the first plane's later strips from where its search for that
marker stopped).
"""

from __future__ import annotations

import struct

import numpy as np

from .image_errors import UnsupportedImageError


class _Source:
    """libtiff's OJPEG byte source: the JPEGInterchangeFormat bytes, then
    each strip's bytes in turn (a strip at offset 0 or past the file read
    as empty, a byte count of 0 as the rest of the file, both clipped to
    the file)."""

    def __init__(self, data: bytes, lt):
        n = len(data)
        self.chunks = []  # (bytes, strip index or -1 for the JPEGInterchangeFormat)
        at, length = lt.jif_offset, lt.jif_length
        if at and at < n:
            if not length or at + length > n:
                length = n - at
            self.chunks.append((data[at:at + length], -1))
        for k in range(lt.nstrips):
            off = lt.offsets[k] if k < len(lt.offsets) else 0
            count = lt.counts[k] if k < len(lt.counts) else 0
            if not off or off >= n:
                continue
            togo = n - off if count == 0 or off + count > n else count
            self.chunks.append((data[off:off + togo], k))
        self.nstrips = lt.nstrips
        self.ci, self.at = 0, 0

    def _fill(self) -> bool:
        while self.ci < len(self.chunks) and self.at >= len(self.chunks[self.ci][0]):
            self.ci, self.at = self.ci + 1, 0
        return self.ci < len(self.chunks)

    def peek(self):
        return self.chunks[self.ci][0][self.at] if self._fill() else None

    def byte(self) -> int:
        if not self._fill():
            raise ValueError("old-style JPEG data end inside its header")
        b = self.chunks[self.ci][0][self.at]
        self.at += 1
        return b

    def word(self) -> int:
        return (self.byte() << 8) | self.byte()

    def block(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def skip(self, n: int) -> None:
        """OJPEGReadSkip: within the current chunk only."""
        if self._fill():
            self.at = min(self.at + n, len(self.chunks[self.ci][0]))

    def rest(self) -> bytes:
        """The entropy-coded bytes from here on, a restart marker after each
        strip that has a strip after it (counting from RST0), then EOI."""
        out, rst = [], 0
        ci, at = self.ci, self.at
        while ci < len(self.chunks):
            chunk, strip = self.chunks[ci]
            out.append(chunk[at:])
            if strip >= 0 and strip + 1 < self.nstrips:
                out.append(bytes([0xFF, 0xD0 + rst]))
                rst = (rst + 1) & 7
            ci, at = ci + 1, 0
        out.append(b"\xff\xd9")
        return b"".join(out)


class _Header:
    def __init__(self):
        self.qt, self.dc, self.ac = [None] * 4, [None] * 4, [None] * 4
        self.sof = None  # (marker, y, x, [(id, hv, tq)])
        self.sos = None  # [(id, tda)]
        self.restart = None


def _read_header(src: _Source, spp: int, sub, image, correct: bool, h: _Header,
                 in_scan: int = 0):
    """OJPEGReadHeaderInfoSec from ``src``: the markers up to SOS (in
    ``correct`` mode, OJPEGSubsamplingCorrect's pass, up to the first SOF,
    returning its sampling or None); ``image`` is (strip or tile width,
    image length), ``in_scan`` the components a scan holds (``spp``, or 1
    in planes)."""
    in_scan = in_scan or spp
    width, length = image
    while True:
        m = src.peek()
        if m != 0xFF:
            return None
        src.byte()
        m = src.byte()
        while m == 0xFF:
            m = src.byte()
        if m == 0xD8:
            continue
        if m == 0xFE or 0xE0 <= m <= 0xEF:
            n = src.word()
            if n < 2:
                raise ValueError("corrupt old-style JPEG data")
            if n > 2:
                src.skip(n - 2)
        elif m == 0xDD:
            if src.word() != 4:
                raise ValueError("corrupt DRI marker in old-style JPEG data")
            h.restart = src.word()
        elif m == 0xDB:
            n = src.word()
            if n <= 2:
                raise ValueError("corrupt DQT marker in old-style JPEG data")
            if correct:
                src.skip(n - 2)
                continue
            n -= 2
            while n > 0:
                if n < 65:
                    raise ValueError("corrupt DQT marker in old-style JPEG data")
                table = src.block(65)
                if table[0] & 15 > 3:
                    raise ValueError("corrupt DQT marker in old-style JPEG data")
                h.qt[table[0] & 15] = b"\xff\xdb\x00\x43" + table
                n -= 65
        elif m == 0xC4:
            n = src.word()
            if n <= 2:
                raise ValueError("corrupt DHT marker in old-style JPEG data")
            if correct:
                src.skip(n - 2)
                continue
            body = src.block(n - 2)
            o = body[0]
            if o & 0xF0 not in (0, 16) or o & 15 > 3:
                raise ValueError("corrupt DHT marker in old-style JPEG data")
            seg = b"\xff\xc4" + struct.pack(">H", n) + body
            (h.dc if o & 0xF0 == 0 else h.ac)[o & 15] = seg
        elif m in (0xC0, 0xC1, 0xC3):
            if h.sof is not None:
                raise ValueError("corrupt old-style JPEG data: a second SOF")
            n = src.word()
            if n < 11 or (n - 8) % 3:
                raise ValueError("corrupt SOF marker in old-style JPEG data")
            ncomp = (n - 8) // 3
            if not correct and ncomp != spp:
                raise ValueError("old-style JPEG of an unexpected number of samples")
            if src.byte() != 8:
                raise ValueError("old-style JPEG of other than 8 bits a sample")
            if correct:
                src.skip(4)
            else:
                y = src.word()
                if y < length:
                    raise ValueError("old-style JPEG data of an unexpected height")
                x = src.word()
                if x < width or x > width:
                    raise ValueError("old-style JPEG data of an unexpected width")
            if src.byte() != ncomp:
                raise ValueError("corrupt SOF marker in old-style JPEG data")
            comps = []
            for q in range(ncomp):
                cid, hv, tq = src.byte(), src.byte(), src.byte()
                if correct:
                    if q == 0:
                        found = (hv >> 4, hv & 15)
                    elif hv != 0x11:
                        found = None
                    continue
                want = (sub[0] << 4 | sub[1]) if q == 0 else 0x11
                if hv != want:
                    raise ValueError("old-style JPEG data of unexpected subsampling values")
                comps.append((cid, hv, tq))
            if correct:
                return found if found in {(a, b) for a in (1, 2, 4) for b in (1, 2, 4)} else None
            h.sof = (m, y, x, comps)
        elif m == 0xDA:
            if correct:
                return None
            if h.sof is None:
                raise ValueError("corrupt SOS marker in old-style JPEG data")
            if src.word() != 6 + 2 * in_scan or src.byte() != in_scan:
                raise ValueError("corrupt SOS marker in old-style JPEG data")
            h.sos = [(src.byte(), src.byte()) for _ in range(in_scan)]
            src.skip(3)  # Ss, Se, Ah and Al: written as 0, 63, 0
            return None
        else:
            raise ValueError(f"unknown marker {m:#x} in old-style JPEG data")


def _tag_tables(data: bytes, lt, spp: int, sub, size, h: _Header) -> None:
    """OJPEGReadHeaderInfoSecTables*: the tables the tags point at, and a
    frame and scan of component ids 0, 1, 2 on tables 0, 1, 2 (a component
    whose offset repeats the one before shares its table)."""
    n = len(data)

    def read(at: int, k: int) -> bytes:
        if at + k > n:
            raise ValueError("old-style JPEG tables past the end of the file")
        return data[at:at + k]

    for name in ("qtables", "dctables", "actables"):
        offs = getattr(lt, name)
        if not offs or not offs[0]:
            raise ValueError("old-style JPEG with no JPEG tables")
    tq, tda = [0] * spp, [0] * spp
    for kind, offs in (("q", lt.qtables), ("dc", lt.dctables), ("ac", lt.actables)):
        offs = list(offs) + [0] * (spp - len(offs))
        for m in range(spp):
            if not (offs[m] and (m == 0 or offs[m] != offs[m - 1])):
                if kind == "q":
                    tq[m] = tq[m - 1]
                else:
                    tda[m] = tda[m - 1]
                continue
            if any(offs[m] == offs[k] for k in range(m - 1)):
                raise ValueError("corrupt old-style JPEG table tag")
            if kind == "q":
                h.qt[m] = b"\xff\xdb\x00\x43" + bytes([m]) + read(offs[m], 64)
                tq[m] = m
                continue
            counts = read(offs[m], 16)
            symbols = read(offs[m] + 16, sum(counts))
            seg = (b"\xff\xc4" + struct.pack(">H", 19 + len(symbols))
                   + bytes([(0 if kind == "dc" else 16) | m]) + counts + symbols)
            if kind == "dc":
                h.dc[m] = seg
                tda[m] = m << 4
            else:
                h.ac[m] = seg
                tda[m] |= m
    hv = [sub[0] << 4 | sub[1]] + [0x11] * (spp - 1)
    h.sof = (0xC0, size[1], size[0], [(m, hv[m], tq[m]) for m in range(spp)])
    h.sos = [(m, tda[m]) for m in range(spp)]


def _secondary_sos(src: _Source, h: _Header) -> None:
    """OJPEGReadSecondarySos: the next SOS marker from ``src`` on (through
    any bytes), a scan of one component, into ``h.sos``."""
    while True:
        if src.byte() != 0xFF:
            continue
        m = src.byte()
        while m == 0xFF:
            m = src.byte()
        if m == 0xDA:
            break
    if src.word() != 8 or src.byte() != 1:
        raise ValueError("corrupt SOS marker in old-style JPEG data")
    h.sos = [(src.byte(), src.byte())]
    src.skip(3)


def _decode_stream(head: _Header, comps, restart: int, data: bytes, sw: int, sub,
                   block_rows: bool = False):
    """libtiff's stream of ``comps`` (SOI, every table, DRI, SOF, SOS, then
    ``data``) through libjpeg -> (decoder, its planes, the first row of
    the iMCU row a restart marker stopped, or None); ``block_rows`` keeps
    each plane's rows to its last whole block row, as raw reads give them."""
    from .jpeg import _broken, _TiffDecoder

    marker, y, x, _ = head.sof
    n = len(comps)
    parts = [b"\xff\xd8"] + [t for t in head.qt if t] + [t for t in head.dc if t] + [
        t for t in head.ac if t]
    if restart:
        parts.append(b"\xff\xdd\x00\x04" + struct.pack(">H", restart))
    parts.append(bytes([0xFF, marker]) + struct.pack(">HBHHB", 8 + 3 * n, 8, y, x, n)
                 + b"".join(bytes(c) for c in comps))
    parts.append(b"\xff\xda" + struct.pack(">HB", 6 + 2 * n, n)
                 + b"".join(bytes(c) for c in head.sos) + b"\x00\x3f\x00")
    d = _TiffDecoder(b"".join(parts) + data, None)
    d.resync_fails = True
    d.block_rows = block_rows
    if d._read_markers() == 0xD9:
        raise _broken("an old-style JPEG stream of no scan")
    if d.size[1] != sw:
        raise ValueError("old-style JPEG whose frame is not its strips' or tiles' width: "
                         "libtiff refuses it")
    if (max(c["h"] for c in d.comps), max(c["v"] for c in d.comps)) != tuple(sub):
        raise ValueError("old-style JPEG whose sampling is not its subsampling: libtiff "
                         "refuses it")
    d._setup()
    d.single = len(d.scan[0]) == len(d.comps) and d.process != "progressive"
    while True:
        d._decode_scan()
        if d.single or d._read_markers() == 0xD9:
            break
    planes = d._planes()
    first = None
    if d.failed_part is not None:
        first = d.failed_part * d.restart // -(-x // (8 * sub[0])) * 8 * sub[1]
    return d, planes, first


def _place(lines: np.ndarray, y: int, sw: int, sl: int, width: int, height: int, unit: int,
           fresh_rows: bool) -> np.ndarray:
    """The image from the stream's decoded ``lines`` (the first ``y`` of
    them real): strip or tile m is lines m*sl on, read ``unit`` lines at a
    time (1, or an iMCU row in libtiff's raw reads) into one buffer.  A
    read past the stream's end writes nothing, so those lines keep what
    the tile read before left there, zeros where the buffer is new: Pillow
    keeps one buffer for the image, libtiff's RGBA interface one for each
    row of tiles (``fresh_rows``); a raw read copies its last iMCU row
    again."""
    across = -(-width // sw)
    if across == 1:
        return lines[:height, :width]
    out = np.zeros((height, width) + lines.shape[2:], np.uint8)
    buf = np.zeros((sl, sw) + lines.shape[2:], np.uint8)
    for m in range(across * -(-height // sl)):
        r, c = divmod(m, across)
        if fresh_rows and not c:
            buf[:] = 0
        for i in range(0, sl, unit):
            at = m * sl + i
            if at < y:
                buf[i:i + unit] = lines[at:at + unit]
            elif unit > 1:  # libjpeg's raw read returns nothing: the last iMCU row again
                last = (y - 1) // unit * unit
                buf[i:i + unit] = lines[last:last + unit]
        part = out[r * sl:(r + 1) * sl, c * sw:(c + 1) * sw]
        part[:] = buf[:part.shape[0], :part.shape[1]]
    return out


def decode_ojpeg(data: bytes, lt, width: int, height: int) -> np.ndarray:
    """The image as Pillow reads it: [h, w, 3] uint8 of YCbCr, or [h, w]
    of one component."""
    from .tiff_rgba import _check_tables, ycbcr_to_rgb

    spp = lt.spp
    # a strip or tile is a band of one stream as wide as the strip or tile
    if lt.tiled:
        sw, sl = lt.tw, lt.th
        total = -(-height // sl) * sl
    else:
        sw, sl = width, height if lt.rps == 2 ** 32 - 1 else lt.rps
        total = height
    if spp not in (1, 3):
        raise ValueError(f"old-style JPEG of {spp} samples: libtiff refuses it")
    if spp == 3 and lt.photometric != 6:  # RGB is read as YCbCr (libtiff's OJPEG hack)
        raise ValueError("old-style JPEG of three samples not in YCbCr: Pillow's buffer and "
                         "libtiff's rows disagree, and it fails")
    if spp == 1 and lt.photometric == 6:
        raise ValueError("old-style JPEG of one YCbCr sample: libtiff's RGBA interface "
                         "cannot convert it")
    sub = (1, 1)
    if spp == 3:  # OJPEGSubsamplingCorrect: the first frame's sampling wins
        sub = lt.subsampling
        try:
            found = _read_header(_Source(data, lt), spp, sub, (sw, height), True, _Header())
        except ValueError:
            found = None
        if found is not None:
            sub = found
    restart = lt.ojpeg_restart
    if sl < height:
        if sl % (8 * sub[1]):
            raise ValueError("old-style JPEG strips or tiles of a height the subsampling does "
                             "not divide: libtiff refuses them")
        restart = -(-sw // (8 * sub[0])) * (sl // (8 * sub[1]))
    src = _Source(data, lt)
    head = _Header()
    in_planes = spp == 3 and lt.planar == 2
    _read_header(src, spp, sub, (sw, height), False, head, 1 if in_planes else spp)
    if head.sof is None:
        _tag_tables(data, lt, spp, sub, (sw, total), head)
    if head.restart is not None:
        restart = head.restart
    y = head.sof[1]
    last = -(-width // sw) * -(-height // sl) - 1  # a plane's last strip or tile
    if in_planes:
        return _decode_planes(src, head, restart, lt, sw, sl, width, height, sub, last)
    side_by_side = spp == 3 and sw < width
    d, planes, first = _decode_stream(head, head.sof[3], restart, src.rest(), sw, sub,
                                      side_by_side)
    if first is not None:
        # libjpeg stopped at a restart marker it did not expect: Pillow's strip
        # read fails a gray image; in YCbCr (libtiff's RGBA interface) the iMCU
        # row of that interval's first MCU and every row after it stay zeros,
        # and where a strip follows, libtiff's skip to it fails the image
        if spp == 1:
            raise ValueError("old-style JPEG whose restart markers fail a strip")
        if first // sl < last:
            raise ValueError("old-style JPEG whose restart markers fail a strip before the "
                             "last: libtiff cannot skip to the next")
        for c, plane in zip(d.comps, planes):
            plane[first * c["v"] // sub[1]:] = 0
    if spp == 1:
        return np.ascontiguousarray(_place(planes[0], y, sw, sl, width, height, 1, False))
    sh, sv = sub
    unit = 8 * sv
    cols = planes[0].shape[1]
    if side_by_side:
        # libtiff's raw reads, whole iMCU rows: where the last has rows of no
        # block libjpeg leaves the buffer's rows of the iMCU row before (with
        # one iMCU row, rows no tile shows)
        imcu = -(-y // unit)
        lines = np.zeros((imcu * unit, cols, 3), np.uint8)
        for k, (plane, up) in enumerate(zip(planes, ((1, 1), (sh, sv), (sh, sv)))):
            got = np.repeat(np.repeat(plane, up[1], 0), up[0], 1)[:, :cols]
            lines[:len(got), :got.shape[1], k] = got
            if len(got) < len(lines) and imcu > 1:
                lines[len(got):, :, k] = lines[len(got) - unit:len(lines) - unit, :, k]
    else:
        rows = planes[0].shape[0]
        lines = np.stack([planes[0]] + [np.repeat(np.repeat(p, sv, 0), sh, 1)[:rows, :cols]
                                        for p in planes[1:]], -1)
    ycc = _place(lines, y, sw, sl, width, height, unit, False)
    return ycbcr_to_rgb(_check_tables(lt), ycc[..., 0], ycc[..., 1], ycc[..., 2])


def _decode_planes(src: _Source, head: _Header, restart: int, lt, sw: int, sl: int,
                   width: int, height: int, sub, last: int) -> np.ndarray:
    """Three samples in planes: each plane its own stream of one component
    from the scan its SOS marker starts (the first from the header, each
    next found after the one before), read as gray and converted as YCbCr
    at 1 x 1 by libtiff's RGBA interface.  A plane whose SOS marker is not
    found leaves zeros, and one libjpeg cannot start (a component the frame
    lacks) fails the image where it is the first, and leaves zeros where
    it is another; but where the first plane has more than one strip or
    tile, such a failure spoils libtiff's next read of the first plane (it
    fails, or reads on from where the search stopped).  A restart marker
    libjpeg does not expect zeros that plane from its iMCU row on, and
    fails the image where the first plane has a strip or tile after it."""
    from .tiff_rgba import _check_tables, ycbcr_to_rgb

    if tuple(sub) != (1, 1):
        raise ValueError("planar YCbCr TIFF subsampled: libtiff cannot handle it")
    tables = _check_tables(lt)
    y = head.sof[1]
    head.sos = head.sos[:1]  # the tags' tables name a scan of every component
    out = []
    for s in range(3):
        if s:
            try:
                _secondary_sos(src, head)
            except ValueError:
                if s == 1 and last:
                    # libjpeg's session for the first plane goes on, its next
                    # strips or tiles read from where this search stopped
                    if src.peek() is None:
                        raise ValueError("old-style JPEG planes whose second scan is not "
                                         "found: libtiff's first plane runs out of data, and "
                                         "Pillow fails") from None
                    raise UnsupportedImageError(
                        "TIFF with old-style JPEG compression (6) in planes whose second "
                        "scan's SOS marker is corrupt is not read by this package: libtiff "
                        "reads the first plane's next strips from where its search "
                        "stopped") from None
                out += [np.zeros((height, width), np.uint8)] * (3 - s)
                break
        try:
            _, planes, first = _decode_stream(head, head.sof[3][s:s + 1], restart, src.rest(),
                                              sw, (1, 1))
        except ValueError:
            if not s or last:  # libtiff's next read of the first plane fails too
                raise
            out.append(np.zeros((height, width), np.uint8))
            continue
        plane = planes[0]
        if first is not None:
            if not s and first // sl < last:
                raise ValueError("old-style JPEG whose restart markers fail a strip before "
                                 "the last: libtiff cannot skip to the next")
            plane[first:] = 0
        out.append(_place(plane, y, sw, sl, width, height, 1, True))
    return ycbcr_to_rgb(tables, *out)
