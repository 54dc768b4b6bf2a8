"""Damaged GIF, WebP, PNG, TIFF, BMP and QOI files end in the port as they
end in Pillow 12.1, and phase 23c's table of Pillow's outcomes holds.

As in ``tests/test_torch_image_damage_jpeg.py``: a seeded picture saved by
Pillow, 1 to 3 bytes at offsets 20 and on overwritten from
``RandomState(1000 + seed)``; each file is read byte-equal to Pillow or
skipped where Pillow raises.  The rules the readers follow, one
hand-built file each: Pillow's GIF decoder finishes a frame only at its
last pixel (a zero-length sub-block does not end it, an early end code
leaves it undone, a sub-block the file holds only part of is not read);
libwebp reads a VP8L chunk with its pad byte and sends a lossy block
whose tokens reach past position 3 through its SSE2 transform, whose sums
wrap at 16 bits; Pillow checks the CRC of every PNG chunk before the first
IDAT and reads the run of IDAT chunks from there.

``chip_smoke.py``'s phase 23c decodes damaged files on the card's host,
without Pillow, against a table of Pillow's outcomes embedded in the
script; the last test rebuilds those files with the script's writers and
holds the table to live Pillow.
"""

import hashlib
import importlib.util
import os
import struct
import sys
import zlib

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

sys.path.insert(0, os.path.dirname(__file__))

from cogview_tpu_torch.utils.image_formats import decode_image  # noqa: E402
from test_torch_image_damage_jpeg import (damaged, ends_as_in_pillow, picture,  # noqa: E402
                                          pillow, saved)
from test_torch_image_formats import _png_chunk  # noqa: E402
from test_torch_image_io import _picture, _webp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --------------------------------------------------------------------- #
# the sweep
# --------------------------------------------------------------------- #

def _rgba() -> np.ndarray:
    arr = picture(64, 96)
    return np.dstack([arr, (arr[..., 0] // 2 + 100).astype(np.uint8)])


VARIANTS = {  # variant -> (writer, files); 20 seeds a case
    "GIF": (lambda: saved(picture(), "GIF"), 200),
    "lossy WebP": (lambda: saved(picture(64, 96), "WEBP", quality=80), 100),
    "lossy WebP with alpha": (lambda: saved(_rgba(), "WEBP", quality=80), 20),
    "lossless WebP": (lambda: saved(picture(64, 96), "WEBP", lossless=True), 60),
    "TIFF LZW": (lambda: saved(picture(), "TIFF", compression="tiff_lzw"), 100),
    "PNG": (lambda: saved(picture(), "PNG"), 100),
    "BMP": (lambda: saved(picture(), "BMP"), 40),
    "QOI": (lambda: saved(picture(), "QOI"), 40),
}
CHUNK = 20
SWEEP = [(name, start) for name, (_, n) in VARIANTS.items() for start in range(0, n, CHUNK)]
_BASES = {}


@pytest.mark.parametrize("variant,start", SWEEP, ids=[f"{v}-{s}" for v, s in SWEEP])
def test_damaged_file_ends_as_in_pillow(variant, start):
    """20 damaged files of one variant: each read byte-equal to Pillow, or
    skipped where Pillow raises."""
    if variant not in _BASES:
        _BASES[variant] = VARIANTS[variant][0]()
    for seed in range(start, start + CHUNK):
        ends_as_in_pillow(damaged(_BASES[variant], seed))


# --------------------------------------------------------------------- #
# one rule each
# --------------------------------------------------------------------- #

_GIF_BLOCKS = 13 + 768 + 10 + 1  # _gif_file's first sub-block size byte


def _gif(img: np.ndarray) -> bytes:
    return _chip_smoke()._gif_file(img)


def _gif_end_code_early() -> bytes:
    """A frame whose LZW data hold the top half of its rows and then the
    end code: Pillow never finishes it and raises "image file is
    truncated"."""
    img = picture(24, 32)
    data = bytearray(_gif(img[:12]))
    for at in (8, 13 + 768 + 7):  # the screen's and the frame's heights
        data[at:at + 2] = struct.pack("<H", 24)
    return bytes(data)


def _gif_sub_blocks(data: bytes):
    at, blocks = _GIF_BLOCKS, []
    while data[at]:
        blocks.append(at)
        at += 1 + data[at]
    return blocks


def _gif_zero_block_inside() -> bytes:
    """A zero-length sub-block between two data sub-blocks: Pillow's
    decoder reads on past it, and the frame reads whole."""
    data = _gif(picture(40, 48))
    at = _gif_sub_blocks(data)[2]
    return data[:at] + b"\x00" + data[at:]


def _gif_partial_block() -> bytes:
    """The last sub-block cut by the end of the file: Pillow reads no
    sub-block it does not hold whole, and the frame is left undone."""
    data = _gif(picture(40, 48))
    return data[:-3]


def _lossless_webp_in_its_pad_byte() -> bytes:
    """A VP8L chunk one byte shorter than its bitstream, whose last byte is
    0: the chunk's pad byte (0) holds it, and libwebp reads the bitstream
    with the pad byte."""
    data = saved(picture(16, 16, 0), "WEBP", lossless=True)
    size = struct.unpack("<I", data[16:20])[0]
    assert size % 2 == 0 and data[20 + size - 1] == 0
    return data[:16] + struct.pack("<I", size - 1) + data[20:]


def _lossy_webp_wrapping(at: int, bit: int) -> bytes:
    """A flipped bit that gives a lossy block coefficients past what an
    encoder writes: libwebp's SSE2 transform wraps them at 16 bits."""
    data = _webp(_picture(40, 48, 13), quality=70)
    return data[:at] + bytes([data[at] ^ (1 << bit)]) + data[at + 1:]


def _png(chunks) -> bytes:
    return b"\x89PNG\r\n\x1a\n" + b"".join(_png_chunk(*c) for c in chunks)


def _png_parts():
    arr = picture(8, 12)
    raw = b"".join(b"\x00" + row.tobytes() for row in arr)
    z = zlib.compress(raw)
    return [(b"IHDR", struct.pack(">IIBBBBB", 12, 8, 8, 2, 0, 0, 0)), (b"gAMA", b"\0\0\xb1\x8f"),
            (b"IDAT", z[:40]), (b"IDAT", z[40:]), (b"IEND", b"")]


def _png_bad_crc(index: int) -> bytes:
    data = bytearray(_png(_png_parts()))
    at = 8
    for _ in range(index + 1):
        at += 12 + struct.unpack(">I", data[at:at + 4])[0]
    data[at - 1] ^= 0x20
    return bytes(data)


def _png_idat_run_broken() -> bytes:
    """IDAT, tEXt, IDAT: Pillow's image data end at the tEXt chunk."""
    parts = _png_parts()
    return _png(parts[:3] + [(b"tEXt", b"k\0v")] + parts[3:])


RULES = {
    "GIF: end code before the last pixel": (_gif_end_code_early, "skipped"),
    "GIF: zero-length sub-block inside the data": (_gif_zero_block_inside, "read"),
    "GIF: the last sub-block cut short": (_gif_partial_block, "skipped"),
    "lossless WebP ending in its pad byte": (_lossless_webp_in_its_pad_byte, "read"),
    "lossy WebP through the SSE2 transform (luma)": (lambda: _lossy_webp_wrapping(241, 5),
                                                     "read"),
    "lossy WebP through the SSE2 transform (chroma)": (lambda: _lossy_webp_wrapping(855, 4),
                                                       "read"),
    "PNG: IHDR's CRC": (lambda: _png_bad_crc(0), "skipped"),
    "PNG: an ancillary chunk's CRC": (lambda: _png_bad_crc(1), "skipped"),
    "PNG: the run of IDAT chunks": (_png_idat_run_broken, "skipped"),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_reader_rule(rule):
    """One hand-built file for each rule: Pillow ends it as the case says,
    and the port ends it so too."""
    build, outcome = RULES[rule]
    assert ends_as_in_pillow(build()) == outcome


# --------------------------------------------------------------------- #
# phase 23c's table
# --------------------------------------------------------------------- #


def _sha(arr) -> str:
    if arr is None:
        return "skip"
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_chip_smoke_damaged_files_table_is_pillows():
    """chip_smoke.py's phase 23c files, rebuilt here by its own writers:
    DAMAGED_OUTCOMES names each one and gives Pillow's outcome (skip, or
    the SHA-256 of the RGB array it reads), and the port's outcome is the
    same; the table holds files Pillow reads and files it skips."""
    cs = _chip_smoke()
    files = cs._damaged_files()
    assert sorted(files) == sorted(cs.DAMAGED_OUTCOMES)
    for name, data in files.items():
        assert _sha(pillow(data)) == cs.DAMAGED_OUTCOMES[name], name
        try:
            got = decode_image(data)
        except ValueError:
            got = None
        assert _sha(got) == cs.DAMAGED_OUTCOMES[name], name
    outcomes = list(cs.DAMAGED_OUTCOMES.values())
    assert "skip" in outcomes and len(set(outcomes)) > 10
