"""The port's JPEG decoder's peak host memory: each file decoded by
``chip_smoke.py --jpeg-memory-child`` in a process of its own (the way a
preprocessing worker reads a file), its peak RSS growth over the decode
held to ``BOUND`` bytes a declared pixel for every process JPEG has
(baseline 4:2:0 and 4:4:4, progressive, arithmetic-coded, lossless) and
for a TIFF tile whose JPEG stream declares a 2048 x 2048 tile; each array
read is Pillow's (SHA-256).  An LZMA TIFF strip that expands far past the
strip's size is held to a fixed growth: the decoder stops where the strip
is full, as libtiff does.

``python tests/test_torch_image_memory.py`` prints each file's growth.
"""

import hashlib
import json
import lzma
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_image_damage_jpeg import picture, pillow, saved  # noqa: E402
from test_torch_image_formats import JFIF, _arith_jpeg, _lossless_jpeg  # noqa: E402
from test_torch_image_tiff import cs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = cs.JPEG_BYTES_PER_PIXEL  # bytes a declared pixel, the decoder's peak host RSS growth


def _tile_2048() -> bytes:
    """A 2048 x 2048 TIFF of one JPEG tile whose stream declares the whole
    tile and holds one MCU of data (libtiff's fake EOI ends it: the rest
    are zero blocks)."""
    small = bytearray(cs._jpeg_file(picture(16, 16, 2), abbreviated=True))
    struct.pack_into(">HH", small, small.find(b"\xff\xc0") + 5, 2048, 2048)
    sos = small.find(b"\xff\xda")
    scan = bytes(small[sos:sos + 2 + struct.unpack_from(">H", small, sos + 2)[0]])
    tile = bytes(small[:sos]) + scan + b"\x55" * 40 + b"\xff\xd9"
    fields = {256: (4, [2048]), 257: (4, [2048]), 258: (3, [8, 8, 8]), 259: (3, [7]),
              262: (3, [6]), 277: (3, [3]), 322: (3, [2048]), 323: (3, [2048]),
              347: (7, cs._jpeg_tables()), 530: (3, [2, 2])}
    return cs._tiff_file(fields, [tile], tiled=True)


FILES = {
    "baseline-420": lambda: saved(picture(768, 1024, 1), "JPEG", quality=90),
    "baseline-444": lambda: saved(picture(768, 1024, 1), "JPEG", quality=90, subsampling=0),
    "progressive": lambda: saved(picture(768, 1024, 1), "JPEG", quality=90, progressive=True),
    "arithmetic": lambda: _arith_jpeg(list(picture(192, 256, 3).transpose(2, 0, 1)),
                                      ((2, 2), (1, 1), (1, 1)), app=JFIF),
    "lossless": lambda: _lossless_jpeg(list(picture(256, 320, 4).transpose(2, 0, 1)),
                                       ((1, 1), (1, 1), (1, 1)), predictor=4),
    "tiff-tile-2048": _tile_2048,
}


def grown(data: bytes) -> dict:
    """The child's report on ``data``: growth_kib, pixels, bytes_per_pixel,
    ms, sha256."""
    fd, path = tempfile.mkstemp(suffix=".img")
    try:
        os.write(fd, data)
        os.close(fd)
        out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                              "--jpeg-memory-child", json.dumps({"path": path})], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])
    finally:
        os.unlink(path)


@pytest.mark.parametrize("name", list(FILES))
def test_jpeg_peak_host_memory_is_bounded(name):
    """At most BOUND bytes a declared pixel of peak RSS growth, where the
    decoder took about 100 before its coefficients went to 16 bits and its
    transforms to bands of rows; the array read is Pillow's."""
    data = FILES[name]()
    got = grown(data)
    want = pillow(data)
    assert got["pixels"] == want.shape[0] * want.shape[1]
    assert got["bytes_per_pixel"] <= BOUND, got
    assert got["sha256"] == hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest()


BOMB_MIB = 128  # what the LZMA strip below expands to
BOMB_BOUND_KIB = 8 * 1024  # peak RSS growth allowed for its 3-byte strip


def _lzma_bomb() -> bytes:
    """A 1 x 1 RGB TIFF whose one LZMA strip (about 20 KB) holds its pixel
    and then BOMB_MIB MiB of zeros."""
    enc = lzma.LZMACompressor(lzma.FORMAT_XZ, preset=0)
    parts = [enc.compress(b"\x10\x20\x30")]
    zeros = bytes(1 << 20)
    parts += [enc.compress(zeros) for _ in range(BOMB_MIB)]
    parts.append(enc.flush())
    fields = {256: (4, [1]), 257: (4, [1]), 258: (3, [8, 8, 8]), 259: (3, [34925]),
              262: (3, [2]), 277: (3, [3]), 278: (4, [1])}
    return cs._tiff_file(fields, [b"".join(parts)])


def test_lzma_strip_that_expands_past_its_size_is_bounded():
    """Pillow reads the 3 bytes the strip holds; the port reads the same
    and its peak RSS grows by less than BOMB_BOUND_KIB, where decoding the
    whole stream would take BOMB_MIB MiB."""
    data = _lzma_bomb()
    got = grown(data)
    want = pillow(data)
    assert want.tolist() == [[[0x10, 0x20, 0x30]]]
    assert got["growth_kib"] < BOMB_BOUND_KIB, got
    assert got["sha256"] == hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest()


def main() -> None:
    for name, make in FILES.items():
        got = grown(make())
        print(f"{name}: +{got['growth_kib']} KiB peak RSS, {got['bytes_per_pixel']:.2f} bytes "
              f"a declared pixel ({got['pixels']} pixels), {got['ms']:.0f} ms")
    got = grown(_lzma_bomb())
    print(f"lzma strip of {BOMB_MIB} MiB in a 1 x 1 TIFF: +{got['growth_kib']} KiB peak RSS, "
          f"{got['ms']:.0f} ms")


if __name__ == "__main__":
    sys.exit(main())
