"""CCITT fax decoding as libtiff 4.7's ``tif_fax3.c`` does it for Pillow.

Modified Huffman runs (TIFF compression 2, CCITT RLE, each row ending on
a byte; 32771, RLEW, on a 16-bit word), Group 3 (3: each row after an
EOL, coded 1-D, or 1-D or 2-D by its tag bit where T4Options bit 0 is
set) and Group 4 (4: every row 2-D against the row above, the first
against a white row).  The decoder is libtiff's macros run code by code:
its bit accumulator (bits taken least significant first from bytes whose
bits were reversed, which reads FillOrder 1 data most significant bit
first), its lookup tables as ``mkg3states.c`` fills them (an EOL matches
11 zero bits in the 1-D tables and 7 in the 2-D one; a pattern no code
matches consumes nothing), its zero padding at the end of the data, and
its two run arrays, which persist across the strips of an image and are
read as they are where damaged codes walk past a row's runs.

A row is its runs: white, black, white, ..., summing to the row's width.
A row that ends early (an EOL, a code word no table holds) is completed
as ``CLEANUP_RUNS`` completes it, white to the end; one that runs long is
cut back a run at a time.  Where the data end before the last row, RLE
and Group 3 return -1, as does Group 4 in a strip's first row
(``return sp->line ? 1 : -1``), with the rows decoded and the row in hand
written; a run past the run arrays returns -1 at once.  Pillow fails on
a strip that returns -1 and keeps a tile that does, since
``TIFFReadEncodedTile`` tests its decoder's result for zero only.  Each
row is filled from its runs with numpy and packed into the strip's
bytes: a set bit is black, as libtiff's decoder writes it whatever the
photometric interpretation.
"""

from __future__ import annotations

import numpy as np

# T.4's code words, most significant bit first: run length -> code
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
               "000000011111").split()  # 1792 .. 2560, either colour

(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB,
 S_MAKEUP, S_EOL) = range(13)

WHITE_CODES = {n: c for n, c in enumerate(_WHITE_TERM)}
WHITE_CODES.update({64 * (i + 1): c for i, c in enumerate(_WHITE_MAKEUP)})
WHITE_CODES.update({1792 + 64 * i: c for i, c in enumerate(_EXT_MAKEUP)})
BLACK_CODES = {n: c for n, c in enumerate(_BLACK_TERM)}
BLACK_CODES.update({64 * (i + 1): c for i, c in enumerate(_BLACK_MAKEUP)})
BLACK_CODES.update({1792 + 64 * i: c for i, c in enumerate(_EXT_MAKEUP)})
# 2-D modes: (state, parameter) -> code
MODE_CODES = {(S_PASS, 0): "0001", (S_HORIZ, 0): "001", (S_V0, 0): "1", (S_VR, 1): "011",
              (S_VR, 2): "000011", (S_VR, 3): "0000011", (S_VL, 1): "010", (S_VL, 2): "000010",
              (S_VL, 3): "0000010"}
EOL = "000000000001"


def _table(size: int, fills) -> list:
    """mkg3states.c's FillTable: each code, its bits reversed, fills every
    index of ``size`` bits whose low bits are the code -> [(state, width,
    parameter)], (S_NULL, 0, 0) where no code matches."""
    table = [(S_NULL, 0, 0)] * (1 << size)
    for state, codes in fills:
        for param, code in codes:
            width = len(code)
            for i in range(int(code[::-1], 2), 1 << size, 1 << width):
                table[i] = (state, width, param)
    return table


def _split(codes: dict, term_state: int, makeup_state: int):
    return [(makeup_state, [(n, c) for n, c in codes.items() if 64 <= n < 1792]),
            (S_MAKEUP, [(n, c) for n, c in codes.items() if n >= 1792]),
            (term_state, [(n, c) for n, c in codes.items() if n < 64])]


_WHITE = _table(12, _split(WHITE_CODES, S_TERMW, S_MAKEUPW) + [(S_EOL, [(0, "0" * 11)])])
_BLACK = _table(13, _split(BLACK_CODES, S_TERMB, S_MAKEUPB) + [(S_EOL, [(0, "0" * 11)])])
_MAIN = _table(7, [(state, [(p, c)]) for (state, p), c in MODE_CODES.items()]
               + [(S_EXT, [(0, "0000001")]), (S_EOL, [(0, "0000000")])])
_REV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


class _EOF(Exception):
    """The data ran out where a code was needed (libtiff's eoflab)."""


class _Overflow(Exception):
    """A run past the run arrays (SETVALUE, CHECK_b1): libtiff returns -1."""


class _Runs(dict):
    """libtiff's two run arrays of 2 * nruns zeros, holding only the entries
    written, for rows wider than any page (damaged tile tags), where a
    list of them all would not fit in memory."""

    def __missing__(self, i: int) -> int:
        return 0


class FaxDecoder:
    """libtiff's Fax3 codec state for one image: ``decode`` is its
    decodestrip on one strip's (or tile's) bytes."""

    def __init__(self, comp: int, options: int, rowpixels: int, rowbytes: int):
        if rowbytes < (rowpixels + 7) // 8:
            raise ValueError("CCITT TIFF rows of fewer bytes than pixels: libtiff refuses them")
        self.comp, self.rowpixels, self.rowbytes = comp, rowpixels, rowbytes
        self.noeol = False  # FAXMODE_NOEOL, set once Group 3 data are found to lack EOLs
        self.two_d = comp == 4 or (comp == 3 and options & 1)
        x = (rowpixels + 1) & 0xFFFFFFFF  # Fax3SetupState's unsigned 32-bit sizes
        n = -(-x // 32) * 32 if x < 0xFFFFFFFF - 31 else 0
        self.nruns = 2 * n if self.two_d else n
        if not self.nruns or 2 * self.nruns > 0xFFFFFFFF:
            raise ValueError("CCITT row pixels integer overflow: libtiff fails")
        self.runs = [0] * (2 * self.nruns) if self.nruns <= 1 << 21 else _Runs()

    # ---- the bit accumulator (NeedBits8, NeedBits16, GetBits, ClrBits) ----

    def _need(self, n: int) -> None:
        if self.avail >= n:
            return
        if self.cp >= self.ep:
            if self.avail == 0:
                raise _EOF
            self.avail = n  # pad with zeros
            return
        self.acc |= self.src[self.cp] << self.avail
        self.cp += 1
        self.avail += 8
        if self.avail < n:  # NeedBits16's second byte
            if self.cp >= self.ep:
                self.avail = n
            else:
                self.acc |= self.src[self.cp] << self.avail
                self.cp += 1
                self.avail += 8

    def _clr(self, n: int) -> None:
        self.avail -= n
        self.acc >>= n

    def _lookup(self, width: int, table: list):
        self._need(width)
        ent = table[self.acc & ((1 << width) - 1)]
        self._clr(ent[1])
        return ent

    # ---- runs (SETVALUE, CLEANUP_RUNS) ------------------------------------

    def _set(self, x: int) -> None:
        if self.pa >= self.thisrun + self.nruns:
            raise _Overflow("CCITT run buffer overflow: libtiff returns -1")
        self.runs[self.pa] = self.run_length + x
        self.pa += 1
        self.a0 += x
        self.run_length = 0

    def _cleanup(self) -> None:
        if self.run_length:
            self._set(0)
        lastx = self.rowpixels
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > self.thisrun:
                self.pa -= 1
                self.a0 -= self.runs[self.pa]
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.thisrun) & 1:
                    self._set(0)
                self._set(lastx - self.a0)
            elif self.a0 > lastx:
                self._set(lastx)
                self._set(0)

    def _fill(self, out: np.ndarray, row: int) -> None:
        """_TIFFFax3fillruns: the runs (unsigned 32-bit) to bits, each
        clamped to the row's end, the clamp written back as the next row's
        reference sees it."""
        runs, start, end = self.runs, self.thisrun, self.pa
        if (end - start) & 1:
            runs[end] = 0
            end += 1
        span = range(start, end)
        r = runs[start:end] if isinstance(runs, list) else [runs[i] for i in span]
        r = np.array(r, np.int64) & 0xFFFFFFFF
        lengths = np.diff(np.minimum(np.cumsum(r), self.rowpixels), prepend=0)
        if isinstance(runs, list):
            runs[start:end] = lengths.tolist()
        else:
            runs.update(zip(span, lengths.tolist()))
        colours = np.zeros(len(lengths), np.uint8)
        colours[1::2] = 1
        bits = np.packbits(np.repeat(colours, lengths))
        out[row, :len(bits)] = bits

    # ---- the row decoders (EXPAND1D, EXPAND2D, SYNC_EOL) -------------------

    def _sync_eol(self) -> None:
        """SYNC_EOL: on to the next EOL's 11 zeros, then past the zeros and
        the one after them.  Where the data end among those zeros, there
        was no EOL: libtiff warns "Try to decode ... without EOL", goes back
        to the first byte of the strip (or tile) and decodes this row from
        there, and syncs no later row of the image."""
        if self.noeol:
            return
        if self.eolcnt == 0:
            while True:
                self._need(11)
                if self.acc & 0x7FF == 0:
                    break
                self._clr(1)
        try:
            while True:
                self._need(8)
                if self.acc & 0xFF:
                    break
                self._clr(8)
        except _EOF:
            self.acc = self.avail = self.cp = 0
            self.noeol = True
            return
        while self.acc & 1 == 0:
            self._clr(1)
        self._clr(1)
        self.eolcnt = 0

    def _run(self, table: list, term: int, makeup: int) -> bool:
        """One colour's run: makeup codes, then a terminating code -> True,
        or False where an EOL or a bad code word ends the row."""
        while True:
            state, _, param = self._lookup(12 if table is _WHITE else 13, table)
            if state == term:
                self._set(param)
                return True
            if state in (makeup, S_MAKEUP):
                self.a0 += param
                self.run_length += param
                continue
            if state == S_EOL:
                self.eolcnt = 1
            return False

    def _expand1d(self) -> None:
        lastx = self.rowpixels
        try:
            while True:
                if not self._run(_WHITE, S_TERMW, S_MAKEUPW) or self.a0 >= lastx:
                    break
                if not self._run(_BLACK, S_TERMB, S_MAKEUPB) or self.a0 >= lastx:
                    break
                if self.runs[self.pa - 1] == 0 and self.runs[self.pa - 2] == 0:
                    self.pa -= 2
        except _EOF:
            self._cleanup()
            raise
        self._cleanup()

    def _expand2d(self) -> None:
        """EXPAND2D for one row.  The state lives in locals while the codes
        are read (the macros' own registers) and goes back to the object
        before anything else reads it."""
        lastx, runs, src, ep = self.rowpixels, self.runs, self.src, self.ep
        thisrun = self.thisrun
        pa_end, pb_end = thisrun + self.nruns, self.refruns + self.nruns
        acc, avail, cp = self.acc, self.avail, self.cp
        a0, pa, pb, b1, rl = self.a0, self.pa, self.pb, self.b1, self.run_length
        white, black, main = _WHITE, _BLACK, _MAIN
        bad = eof = False
        try:
            while a0 < lastx:
                if pa >= pa_end:
                    raise _Overflow("CCITT run buffer overflow: libtiff returns -1")
                if avail < 7:  # NeedBits8(7)
                    if cp >= ep:
                        if avail == 0:
                            eof = True
                            break
                        avail = 7
                    else:
                        acc |= src[cp] << avail
                        cp += 1
                        avail += 8
                state, width, param = main[acc & 0x7F]
                acc >>= width
                avail -= width
                if state == S_HORIZ:
                    for table, size, term, makeup in (
                            ((black, 13, S_TERMB, S_MAKEUPB), (white, 12, S_TERMW, S_MAKEUPW))
                            if (pa - thisrun) & 1 else
                            ((white, 12, S_TERMW, S_MAKEUPW), (black, 13, S_TERMB, S_MAKEUPB))):
                        while True:  # LOOKUP16(size): makeup codes, then a terminating one
                            if avail < size:
                                if cp >= ep:
                                    if avail == 0:
                                        eof = True
                                        break
                                    avail = size
                                else:
                                    acc |= src[cp] << avail
                                    cp += 1
                                    avail += 8
                                    if avail < size:
                                        if cp >= ep:
                                            avail = size
                                        else:
                                            acc |= src[cp] << avail
                                            cp += 1
                                            avail += 8
                            state, width, param = table[acc & ((1 << size) - 1)]
                            acc >>= width
                            avail -= width
                            if state == term:
                                if pa >= pa_end:
                                    raise _Overflow("CCITT run buffer overflow: libtiff returns -1")
                                runs[pa] = rl + param
                                pa += 1
                                a0 += param
                                rl = 0
                                break
                            if state == makeup or state == S_MAKEUP:
                                a0 += param
                                rl += param
                                continue
                            bad = True  # a bad code word, or an EOL: the row ends
                            break
                        if eof or bad:
                            break
                    if eof or bad:
                        break
                    state = S_HORIZ
                elif state == S_EXT or state == S_EOL:
                    runs[pa] = lastx - a0
                    pa += 1
                    if state == S_EOL:
                        if avail < 4:  # NeedBits8(4), then ClrBits(4)
                            if cp >= ep:
                                if avail == 0:
                                    eof = True
                                    break
                                avail = 4
                            else:
                                acc |= src[cp] << avail
                                cp += 1
                                avail += 8
                        acc >>= 4
                        avail -= 4
                        self.eolcnt = 1
                    break
                elif state == S_NULL:
                    break  # a bad code word: the row ends
                if pa != thisrun:  # CHECK_b1
                    while b1 <= a0 and b1 < lastx:
                        if pb + 1 >= pb_end:
                            raise _Overflow("CCITT reference run overflow: libtiff returns -1")
                        b1 += runs[pb] + runs[pb + 1]
                        pb += 2
                if state == S_V0 or state == S_VR:
                    if pa >= pa_end:
                        raise _Overflow("CCITT run buffer overflow: libtiff returns -1")
                    x = b1 - a0 + (param if state == S_VR else 0)
                    runs[pa] = rl + x
                    pa += 1
                    a0 += x
                    rl = 0
                    if pb >= pb_end:
                        raise _Overflow("CCITT reference run overflow: libtiff returns -1")
                    b1 += runs[pb]
                    pb += 1
                elif state == S_VL:
                    if b1 < a0 + param:
                        break  # unexpected: the row ends
                    if pa >= pa_end:
                        raise _Overflow("CCITT run buffer overflow: libtiff returns -1")
                    x = b1 - a0 - param
                    runs[pa] = rl + x
                    pa += 1
                    a0 += x
                    rl = 0
                    pb -= 1
                    b1 -= runs[pb]
                elif state == S_PASS:
                    if pb + 1 >= pb_end:
                        raise _Overflow("CCITT reference run overflow: libtiff returns -1")
                    b1 += runs[pb]
                    pb += 1
                    rl += b1 - a0
                    a0 = b1
                    b1 += runs[pb]
                    pb += 1
            else:
                if rl:
                    if rl + a0 < lastx:  # expect a final V0
                        if avail < 1:
                            if cp >= ep:
                                eof = True
                            else:
                                acc |= src[cp] << avail
                                cp += 1
                                avail += 8
                        if not eof:
                            if acc & 1:
                                acc >>= 1
                                avail -= 1
                            else:
                                bad = True
                    if not eof and not bad:
                        if pa >= pa_end:
                            raise _Overflow("CCITT run buffer overflow: libtiff returns -1")
                        runs[pa] = rl
                        pa += 1
                        rl = 0
        finally:
            self.acc, self.avail, self.cp = acc, avail, cp
            self.a0, self.pa, self.pb, self.b1, self.run_length = a0, pa, pb, b1, rl
        self._cleanup()
        if eof:
            raise _EOF

    # ---- decodestrip -------------------------------------------------------

    def decode(self, src: bytes, rows: int, offset_odd: bool = False):
        """Fax3PreDecode and the codec's decodestrip over ``rows`` rows ->
        (the rows' bytes, the number of rows libtiff wrote, None or why
        it returned -1).  A strip that returns -1 fails; a tile does not
        (``TIFFReadEncodedTile`` tests the result for zero only), and keeps
        the rows written."""
        self.src, self.cp, self.ep = bytes(src).translate(_REV), 0, len(src)
        self.acc = self.avail = self.eolcnt = 0
        self.thisrun = 0
        self.refruns = self.nruns
        if self.two_d:
            self.runs[self.refruns] = self.rowpixels
            self.runs[self.refruns + 1] = 0
        out = np.zeros((rows, self.rowbytes), np.uint8)
        line = 0
        try:  # a run overflow returns -1 at once, the row in hand unwritten
            try:
                for line in range(rows):
                    self.a0 = self.run_length = 0
                    self.pa = self.thisrun
                    if self.comp in (2, 32771):
                        self._expand1d()
                        self._fill(out, line)
                        if self.comp == 2:
                            self._clr(self.avail & 7)
                        else:
                            self._clr(self.avail & 15)
                            if self.avail == 0 and (self.cp + offset_odd) & 1:
                                self.cp += 1
                        continue
                    if self.comp == 3:
                        try:
                            self._sync_eol()
                            is1d = True
                            if self.two_d:
                                self._need(1)
                                is1d = bool(self.acc & 1)
                                self._clr(1)
                        except _EOF:
                            self._cleanup()  # EOF1D / EOF2D
                            raise
                    else:
                        is1d = False
                    self.pb = self.refruns
                    self.b1 = self.runs[self.pb]
                    self.pb += 1
                    if is1d:
                        self._expand1d()
                    else:
                        self._expand2d()
                        if self.comp == 4 and self.eolcnt:
                            return self._end(out, line)
                    self._fill(out, line)
                    if self.two_d:
                        if self.pa < self.thisrun + self.nruns:
                            self._set(0)  # the imaginary change of the reference line
                        self.thisrun, self.refruns = self.refruns, self.thisrun
            except _EOF:
                if self.comp == 4:
                    return self._end(out, line)
                self._fill(out, line)
                return (out[:line + 1].tobytes(), line + 1,
                        "CCITT data cut short: libtiff returns -1")
        except _Overflow as err:
            return out[:line].tobytes(), line, str(err)
        return out.tobytes(), rows, None

    def _end(self, out: np.ndarray, line: int):
        """Group 4's EOFB, or the end of its data, before the last row: the
        row in hand filled, the rows after it left as they were; -1 in the
        first row (``sp->line ? 1 : -1``)."""
        self._fill(out, line)
        return (out[:line + 1].tobytes(), line + 1,
                None if line else "CCITT Group 4 data ended in the first row: libtiff returns -1")
