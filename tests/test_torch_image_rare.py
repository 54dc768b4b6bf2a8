"""The rarer formats the port reads, held against Pillow 12.1
(``Image.open(...).convert("RGB")``) with no tolerance: FLI and FLC
(``utils/fli.py``), IPTC/NAA (``utils/iptc.py``), Kodak PhotoCD
(``utils/pcd.py``), DDS in BC6H (``utils/dds.py``), PSD in Lab
(``utils/psd.py``), IM in YCC and at ``L*n`` depths (``utils/im.py``) and
BLP1 holding a CMYK JPEG (``utils/blp.py``); a seeded damage sweep of each
(cuts, overwritten bytes, lengthened or zeroed lengths), every file ending
as Pillow ends it; and phase 23f's files in ``chip_smoke.py``.

PCD's and IM's colour conversions are per pixel: the tests hold a seeded
sample of (Y, C1, C2) triples against Pillow's own conversions; the
script holds all 2**24:

    PYTHONPATH=. python tests/test_torch_image_rare.py --exhaustive

and without the flag times each reader against Pillow on the same bytes
(host CPU, best of 3).
"""

import io
import os
import struct
import sys
import time
import warnings

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

sys.path.insert(0, os.path.dirname(__file__))

from cogview_tpu_torch.preprocess import raw_datasets as raw  # noqa: E402
from cogview_tpu_torch.utils.im import YCBCR_TABLES  # noqa: E402
from cogview_tpu_torch.utils.image_errors import UnsupportedImageError  # noqa: E402
from cogview_tpu_torch.utils.image_formats import decode_image  # noqa: E402
from cogview_tpu_torch.utils.pcd import YCC_TABLES  # noqa: E402
from cogview_tpu_torch.utils.tiff_rgba import ycbcr_to_rgb  # noqa: E402
from test_torch_image_formats import _dds, _dx10, _im, _psd  # noqa: E402
from test_torch_image_io import JFIF, _adobe, _encode_jpeg  # noqa: E402
from test_torch_image_tiff import _sha, cs  # noqa: E402


def _pillow(data: bytes):
    """Pillow's (format, RGB array), or None where it cannot open or load."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(io.BytesIO(data))
            return im.format, np.asarray(im.convert("RGB"))
    except Exception:
        return None


def ends_as_in_pillow(data: bytes, fmt: str = None) -> str:
    """Assert the port ends ``data`` as Pillow does -> "read" or "skipped"
    (``fmt``: the format Pillow must read it as)."""
    want = _pillow(data)
    if want is None:
        with pytest.raises(raw.DECODE_ERRORS) as err:
            decode_image(data)
        assert not isinstance(err.value, UnsupportedImageError), err.value
        return "skipped"
    if fmt is not None:
        assert want[0] == fmt
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want[1].shape
    np.testing.assert_array_equal(got, want[1])
    return "read"


def apart(data: bytes) -> bool:
    """Whether the port ends ``data`` otherwise than Pillow does."""
    want = _pillow(data)
    try:
        got = decode_image(data)
    except UnsupportedImageError:
        return True
    except raw.DECODE_ERRORS:
        return want is not None
    return want is None or not np.array_equal(got, want[1])


def sweep(base: bytes, rng, n: int, lengths=(), start: int = 0) -> int:
    """``n`` damaged copies of ``base`` -> how many end apart from Pillow:
    cut short, 1-5 bytes overwritten past ``start``, or one of the
    little-endian 32-bit ``lengths`` (offsets) lengthened or zeroed."""
    count = 0
    for _ in range(n):
        data = bytearray(base)
        how = rng.randint(3 if lengths else 2)
        if how == 0:
            data = data[:rng.randint(1, len(data))]
        elif how == 1:
            for _ in range(rng.randint(1, 6)):
                data[rng.randint(start, len(data))] = rng.randint(256)
        else:
            at, fmt = lengths[rng.randint(len(lengths))]
            most = (1 << (8 * struct.calcsize(fmt))) - 1
            longer = min(most, struct.unpack_from(fmt, data, at)[0] + int(rng.randint(1, 40)))
            struct.pack_into(fmt, data, at, 0 if rng.rand() < 0.3 else longer)
        count += apart(bytes(data))
    return count


def _picture(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _saved(arr: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


# --------------------------------------------------------------------- #
# FLI and FLC
# --------------------------------------------------------------------- #


def _fli(w, h, chunks, magic=0xAF11, prefix=b"") -> bytes:
    """An FLI or FLC of one frame of ``chunks`` [(type, body)], after a
    prefix chunk's body where one is given."""
    body = b""
    for kind, data in chunks:
        data += bytes(len(data) % 2)
        body += struct.pack("<IH", 6 + len(data), kind) + data
    frame = struct.pack("<IHH", 16 + len(body), 0xF1FA, len(chunks)) + bytes(8) + body
    if prefix:
        frame = struct.pack("<IHH", 8 + len(prefix), 0xF100, 0) + prefix + frame
    head = struct.pack("<IHHHHHHI", 128 + len(frame), magic, 1, w, h, 8, 0, 5)
    return head.ljust(128, b"\0") + frame


def _palette_chunk(rng, kind: int):
    packets, body = int(rng.randint(1, 4)), b""
    for _ in range(packets):
        n = int(rng.randint(0, 90))
        body += bytes([int(rng.randint(0, 8)), n]) + rng.randint(
            0, 256, 3 * (n or 256)).astype(np.uint8).tobytes()
    return kind, struct.pack("<H", packets) + body


def _brun(img, rng) -> bytes:
    out = b""
    for row in img:
        out += b"\0"
        x = 0
        while x < len(row):
            n = int(rng.randint(1, min(127, len(row) - x) + 1))
            if rng.rand() < 0.5:
                out += bytes([n, row[x]])
            else:
                out += bytes([256 - n]) + row[x:x + n].tobytes()
            x += n
    return out


def _lc(img, rng) -> bytes:
    h, w = img.shape
    y0 = int(rng.randint(0, h))
    n = int(rng.randint(0, h - y0 + 1))
    out = struct.pack("<HH", y0, n)
    for row in img[y0:y0 + n]:
        packets, x, body = 0, 0, b""
        while x < w and packets < 255:
            skip = int(rng.randint(0, min(5, w - x) + 1))
            x += skip
            k = int(rng.randint(0, min(127, w - x) + 1))
            if rng.rand() < 0.5 and k:
                body += bytes([skip, 256 - k, int(rng.randint(256))])
            else:
                body += bytes([skip, k]) + row[x:x + k].tobytes()
            x += k
            packets += 1
        out += bytes([packets]) + body
    return out


def _ss2(img, rng) -> bytes:
    h, w = img.shape
    lines = int(rng.randint(0, h + 1))
    out = struct.pack("<H", lines)
    for _ in range(lines):
        if rng.rand() < 0.3:
            out += struct.pack("<H", 65536 - int(rng.randint(1, 3)))  # skip lines
        if rng.rand() < 0.3:
            out += struct.pack("<H", 0x8000 | int(rng.randint(256)))  # an odd row's last byte
        body, x, packets = b"", 0, 0
        while x < w - 1 and packets < 10:
            skip = int(rng.randint(0, 3))
            if x + skip >= w - 1:
                break
            x += skip
            k = int(rng.randint(1, max(1, (w - x) // 2) + 1))
            if rng.rand() < 0.5:
                body += bytes([skip, 256 - k]) + rng.randint(0, 256, 2).astype(np.uint8).tobytes()
            else:
                body += bytes([skip, k]) + rng.randint(0, 256, 2 * k).astype(np.uint8).tobytes()
            x += 2 * k
            packets += 1
        out += struct.pack("<H", packets) + body
    return out


# BLACK is 6 bytes or 10: Pillow's decoder fails on a chunk with fewer than
# 10 bytes left in the frame
_FLI_CHUNKS = {7: _ss2, 12: _lc, 13: lambda img, rng: bytes(4 * rng.randint(2)), 15: _brun,
               16: lambda img, rng: img.tobytes(), 18: lambda img, rng: bytes(10)}


def _fli_file(rng, kinds, magic=0xAF11) -> bytes:
    w, h = int(rng.randint(1, 40)), int(rng.randint(1, 20))
    img = rng.randint(0, 256, (h, w)).astype(np.uint8)
    chunks = [_palette_chunk(rng, 11 if rng.rand() < 0.5 else 4)] if rng.rand() < 0.6 else []
    chunks += [(k, _FLI_CHUNKS[k](img, rng)) for k in kinds]
    return _fli(w, h, chunks, magic)


@pytest.mark.parametrize("kind", sorted(_FLI_CHUNKS))
@pytest.mark.parametrize("magic", [0xAF11, 0xAF12], ids=["FLI", "FLC"])
def test_fli_chunks(kind, magic):
    """Frames of each chunk type, alone and after others (a 64- or
    256-colour palette or the gray ramp), on seeded pictures of random
    sizes: each read byte-equal, or skipped where Pillow's decoder fails
    (SS2 and LC runs past a row, lines past the frame)."""
    rng = np.random.RandomState(kind * 7 + magic)
    outcomes = set()
    for _ in range(30):
        kinds = [kind] if rng.rand() < 0.5 else list(rng.choice(sorted(_FLI_CHUNKS), 2)) + [kind]
        outcomes.add(ends_as_in_pillow(_fli_file(rng, kinds, magic)))
    assert "read" in outcomes


def test_fli_headers():
    """The palette search after a prefix chunk, and the frame at byte 128
    that is decoded whatever it is (so a file with a prefix chunk fails in
    Pillow), a frame of no chunks (black), one cut short (skipped), and
    64-colour values past 63 (kept to 8 bits)."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (5, 9)).astype(np.uint8)
    pal = struct.pack("<HBB", 1, 0, 2) + bytes([100, 7, 255, 1, 2, 3])
    assert ends_as_in_pillow(_fli(9, 5, [(11, pal), (16, img.tobytes())]), "FLI") == "read"
    assert ends_as_in_pillow(_fli(9, 5, [(11, pal), (16, img.tobytes())],
                                  prefix=bytes(8))) == "skipped"
    assert ends_as_in_pillow(_fli(9, 5, []), "FLI") == "read"
    data = _fli(9, 5, [(15, _brun(img, rng))])
    for cut in (len(data) - 1, len(data) - 9, 140):
        assert ends_as_in_pillow(data[:cut]) == "skipped"


def test_fli_damage_sweep():
    """200 damaged FLI and FLC files (frames of every chunk type): none
    apart from Pillow."""
    rng = np.random.RandomState(3)
    total = 0
    for _ in range(40):
        base = _fli_file(rng, list(rng.choice(sorted(_FLI_CHUNKS), 2)), 0xAF11 + rng.randint(2))
        total += sweep(base, rng, 5, [(128, "<I"), (144, "<I")], 128)
    assert total == 0


# --------------------------------------------------------------------- #
# IPTC/NAA
# --------------------------------------------------------------------- #


def _field(record: int, tag: int, value: bytes) -> bytes:
    return bytes([0x1C, record, tag]) + struct.pack(">H", len(value)) + value


def _iptc(w, h, layers, component, compression, body, band=None, parts=1) -> bytes:
    out = (_field(3, 60, bytes([layers, component])) + _field(3, 20, struct.pack(">H", w))
           + _field(3, 30, struct.pack(">H", h)) + _field(3, 120, bytes([compression])))
    if band is not None:
        out += _field(3, 65, bytes([band]))
    step = -(-len(body) // parts) or 1
    return out + b"".join(_field(8, 10, body[i:i + step])
                          for i in range(0, len(body), step)) + bytes(5)


@pytest.mark.parametrize("layout", ["gray", "rgb", "cmyk"])
def test_iptc_raw_and_banded(layout):
    """Raw data (a PGM in Pillow) in one image record and in several, gray
    or one band of RGB or CMYK (the default band, each band, a band past
    the mode's), cut short."""
    rng = np.random.RandomState(len(layout))
    layers = {"gray": 1, "rgb": 3, "cmyk": 4}[layout]
    for h, w in ((3, 5), (16, 16), (7, 2)):
        body = rng.randint(0, 256, w * h).astype(np.uint8).tobytes()
        bands = [None] if layers == 1 else [None, 0, 1, 2, 3, 4, 5]
        for band in bands:
            ends_as_in_pillow(_iptc(w, h, layers, int(layers > 1), 1, body, band,
                                    parts=1 + (band or 0) % 3))
        assert ends_as_in_pillow(_iptc(w, h, layers, int(layers > 1), 1, body), "IPTC") == "read"
        assert ends_as_in_pillow(_iptc(w, h, layers, int(layers > 1), 1, body[:-1])) == "skipped"


def test_iptc_jpeg():
    """Compression 5: a colour JPEG, a gray one and a PNG in a gray file
    (read as the file it holds), a gray JPEG in each band of RGB and CMYK
    (read), a colour JPEG or a PNG in a band (skipped: Pillow's merge
    refuses them), a JPEG cut short."""
    for h, w in ((9, 13), (16, 16)):
        pic = _picture(h, w, 3)
        colour, gray = _saved(pic, "JPEG"), _saved(pic[..., 0], "JPEG")
        png = _saved(pic, "PNG")
        for inner in (colour, gray, png):
            assert ends_as_in_pillow(_iptc(w, h, 1, 0, 5, inner), "IPTC") == "read"
        for band in (0, 1, 2):
            assert ends_as_in_pillow(_iptc(w, h, 3, 1, 5, gray, band), "IPTC") == "read"
            assert ends_as_in_pillow(_iptc(w, h, 3, 1, 5, colour, band)) == "skipped"
            assert ends_as_in_pillow(_iptc(w, h, 3, 1, 5, png, band)) == "skipped"
        assert ends_as_in_pillow(_iptc(w, h, 4, 1, 5, gray, 3), "IPTC") == "read"
        assert ends_as_in_pillow(_iptc(w, h, 1, 0, 5, colour[:-20])) == "skipped"


def test_iptc_fields():
    """The field rules of Pillow's ``_open`` and ``load``: extended
    lengths, a repeated or empty field, no compression or an unknown one,
    no image record, a field after the image that is none (skipped), one
    that is (read)."""
    body = bytes(range(15))
    head = (_field(3, 60, bytes([1, 0])) + _field(3, 20, struct.pack(">H", 5))
            + _field(3, 30, struct.pack(">H", 3)))
    comp = _field(3, 120, bytes([1]))
    image = _field(8, 10, body)
    extended = bytes([0x1C, 2, 5, 0x82]) + struct.pack(">H", 3) + b"abc"
    cases = {
        "extended length": extended + head + comp + image + bytes(5),
        "repeated size": head + _field(3, 20, b"\x05") + comp + image,
        "empty compression": head + bytes([0x1C, 3, 120, 0x80]) + image,
        "no compression": head + image,
        "compression 3": head + _field(3, 120, bytes([3])) + image,
        "no image record": head + comp + bytes(5),
        "junk after the image": head + comp + image + b"\x1c",
        "a field after the image": head + comp + image + _field(2, 5, b"x"),
        "a field length past 132": head + comp + image[:3] + bytes([0x85]) + body,
    }
    for name, data in cases.items():
        ends_as_in_pillow(data)


def test_iptc_damage_sweep():
    """200 damaged IPTC files, raw and JPEG: none apart from Pillow."""
    rng = np.random.RandomState(4)
    pic = _picture(6, 7, 1)
    total = 0
    for base in (_iptc(7, 6, 1, 0, 1, pic[..., 0].tobytes(), parts=2),
                 _iptc(7, 6, 3, 1, 1, pic[..., 0].tobytes(), band=2),
                 _iptc(7, 6, 1, 0, 5, _saved(pic, "JPEG")),
                 _iptc(7, 6, 3, 1, 5, _saved(pic[..., 1], "JPEG"), band=1)):
        total += sweep(base, rng, 50, [(3, ">H"), (10, ">H"), (17, ">H"), (30, ">H")])
    assert total == 0


# --------------------------------------------------------------------- #
# Kodak PhotoCD
# --------------------------------------------------------------------- #


def _pcd(rng, orientation: int) -> bytes:
    head = bytearray(2048 + 1539)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation | (int(rng.randint(64)) << 2)
    body = rng.randint(0, 256, 768 * 512 * 3 // 2).astype(np.uint8).tobytes()
    return bytes(head).ljust(96 * 2048, b"\0") + body


@pytest.mark.parametrize("orientation", [0, 1, 2, 3])
def test_pcd_orientations(orientation):
    """The base image upright (0 and 2) and rotated by 90 (1) and 270
    (3) degrees, with bytes past it; cut inside it, skipped."""
    rng = np.random.RandomState(orientation)
    data = _pcd(rng, orientation)
    assert ends_as_in_pillow(data + b"tail", "PCD") == "read"
    assert ends_as_in_pillow(data[:-1]) == "skipped"


def test_pcd_ycc_sample():
    """PCD's ``YCC_TABLES`` against Pillow's ``YCC;P`` unpacker (the one
    its PCD decoder uses) on 2**20 seeded (Y, C1, C2) triples (the script
    holds all 2**24)."""
    v = np.random.RandomState(5).randint(0, 256, (1024, 1024, 3)).astype(np.uint8)
    want = np.asarray(Image.frombytes("RGB", (1024, 1024), v.tobytes(), "raw", "YCC;P"))
    np.testing.assert_array_equal(ycbcr_to_rgb(YCC_TABLES, v[..., 0], v[..., 1], v[..., 2]),
                                  want)


def test_pcd_damage_sweep():
    """200 damaged PCD files (the header sector and the base image): none
    apart from Pillow."""
    rng = np.random.RandomState(6)
    base = _pcd(rng, 1)
    total = 0
    for _ in range(200):
        data = bytearray(base)
        if rng.rand() < 0.5:
            data = data[:rng.randint(1, len(data))]
        else:
            at = rng.randint(2040, 2048 + 1539) if rng.rand() < 0.7 else rng.randint(len(data))
            data[at] = rng.randint(256)
        total += apart(bytes(data))
    assert total == 0


# --------------------------------------------------------------------- #
# DDS in BC6H
# --------------------------------------------------------------------- #

# the mode bits of Pillow's modes 0-13, then the four reserved ones
_BC6_MODE_BITS = [(0, 2), (1, 2)] + [(v, 5) for v in (2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15,
                                                      19, 23, 27, 31)]


def _bc6(rng, w: int, h: int, fmt: int, mode: int = None) -> bytes:
    n = -(-w // 4) * -(-h // 4)
    blk = rng.randint(0, 256, (n, 16)).astype(np.uint8)
    for i in range(n):
        v, bits = _BC6_MODE_BITS[mode if mode is not None else i % len(_BC6_MODE_BITS)]
        blk[i, 0] = (blk[i, 0] & (255 ^ ((1 << bits) - 1))) | v
    return _dds(w, h, 0x4, b"DX10", extra=_dx10(fmt), body=blk.tobytes())


@pytest.mark.parametrize("fmt", [95, 96], ids=["BC6H", "BC6HS"])
@pytest.mark.parametrize("mode", range(len(_BC6_MODE_BITS)))
def test_bc6h_every_mode(fmt, mode):
    """Seeded blocks with each mode's bits forced (the 14 modes and the 4
    reserved values, which Pillow decodes black), unsigned and signed, at
    sizes the 4 x 4 blocks do not divide."""
    rng = np.random.RandomState(fmt * 100 + mode)
    for h, w in ((4, 4), (9, 14), (32, 64)):
        assert ends_as_in_pillow(_bc6(rng, w, h, fmt, mode), "DDS") == "read"


def test_bc6h_damage_sweep():
    """200 damaged BC6H files, unsigned and signed, every mode mixed:
    none apart from Pillow."""
    rng = np.random.RandomState(7)
    total = 0
    for fmt in (95, 96):
        total += sweep(_bc6(rng, 13, 10, fmt), rng, 100, [(4, "<I"), (12, "<I"), (128, "<I")])
    assert total == 0


# --------------------------------------------------------------------- #
# PSD in Lab, IM in YCC and at L*n depths, BLP1 with a CMYK JPEG
# --------------------------------------------------------------------- #

SIZES = ((1, 1), (3, 5), (16, 16), (13, 31))


def test_psd_lab():
    """Lab composites raw and PackBits, with a fourth channel (ignored),
    and 16-bit Lab (Pillow's plugin refuses it: skipped)."""
    rng = np.random.RandomState(8)
    for h, w in SIZES:
        ch = rng.randint(0, 256, (4, h, w)).astype(np.uint8)
        for packbits in (False, True):
            assert ends_as_in_pillow(_psd(9, 8, ch[:3], packbits, rng), "PSD") == "read"
            ends_as_in_pillow(_psd(9, 8, ch, packbits, rng))
    ch16 = rng.randint(0, 256, (3, 4, 10)).astype(np.uint8)
    assert ends_as_in_pillow(_psd(9, 16, ch16, False, rng)) == "skipped"


def test_im_ycc_sample():
    """IM's ``YCBCR_TABLES`` against Pillow's ``convert("RGB")`` of mode YCbCr
    on 2**20 seeded triples (the script holds all 2**24), and IM files in
    YCC built here (line-interleaved planes, bottom-up)."""
    v = np.random.RandomState(9).randint(0, 256, (1024, 1024, 3)).astype(np.uint8)
    want = np.asarray(Image.frombytes("YCbCr", (1024, 1024), v.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(ycbcr_to_rgb(YCBCR_TABLES, v[..., 0], v[..., 1], v[..., 2]),
                                  want)
    rng = np.random.RandomState(10)
    for h, w in SIZES:
        body = rng.randint(0, 256, 3 * w * h).astype(np.uint8).tobytes()
        assert ends_as_in_pillow(_im(b"YCC image", w, h, body), "IM") == "read"
        assert ends_as_in_pillow(_im(b"YCC image", w, h, body[:-1])) == "skipped"


def _bit_rows(vals: np.ndarray, bits: int, rng) -> bytes:
    """Rows of ``vals`` [h, w] packed from the low bits up, each row padded
    to a byte with random bits, the last row first (IM is bottom-up)."""
    h, w = vals.shape
    packed = ((vals[..., None] >> np.arange(bits)) & 1).reshape(h, w * bits).astype(np.uint8)
    pad = rng.randint(0, 2, (h, -(w * bits) % 8)).astype(np.uint8)
    return np.packbits(np.concatenate([packed, pad], 1), axis=1,
                       bitorder="little")[::-1].tobytes()


@pytest.mark.parametrize("bits", [2, 3, 4, 12, 24, 31])
def test_im_bit_depths(bits):
    """``L*n`` (Pillow's bit decoder) at odd widths, the padding bits set
    (the decoder carries them into the next row's first byte), values
    around 255 (clipped), random bytes, and cut short."""
    rng = np.random.RandomState(bits)
    for h, w in ((1, 1), (3, 5), (6, 7), (5, 13)):
        vals = rng.randint(0, min(1 << bits, 300), (h, w))
        assert ends_as_in_pillow(_im(b"L*%d image" % bits, w, h, _bit_rows(vals, bits, rng)),
                                 "IM") == "read"
        noise = rng.randint(0, 256, h * ((w * bits + 7) // 8)).astype(np.uint8).tobytes()
        assert ends_as_in_pillow(_im(b"L*%d image" % bits, w, h, noise), "IM") == "read"
        assert ends_as_in_pillow(_im(b"L*%d image" % bits, w, h, noise[:-1])) == "skipped"


def _blp1(jpeg: bytes, w: int, h: int) -> bytes:
    sos = jpeg.index(b"\xff\xda")
    at = 28 + 128 + 4 + sos
    return (b"BLP1" + struct.pack("<iIIIiI", 0, 0, w, h, 5, 0)
            + struct.pack("<16I", at, *[0] * 15) + struct.pack("<16I", len(jpeg) - sos, *[0] * 15)
            + struct.pack("<I", sos) + jpeg)


@pytest.mark.parametrize("marker", ["none", "adobe0", "adobe1", "adobe2", "jfif"])
def test_blp1_cmyk(marker):
    """BLP1 holding a four-component JPEG, with no marker, an Adobe marker
    of each transform (Pillow reads the YCCK ones as CMYK too) or a JFIF
    marker, at 4:4:4 and 2 x 2 over 1 x 1, its colours as BGR; cut short."""
    app = {"none": b"", "adobe0": _adobe(0), "adobe1": _adobe(1), "adobe2": _adobe(2),
           "jfif": JFIF}[marker]
    for h, w in ((9, 13), (16, 16), (5, 3)):
        planes = list(_picture(h, w, 6).transpose(2, 0, 1)) + [_picture(h, w, 7)[..., 0]]
        for sampling in (((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2))):
            data = _blp1(_encode_jpeg(planes, sampling, app=app, ids=(1, 2, 3, 4)), w, h)
            assert ends_as_in_pillow(data, "BLP") == "read"
            assert ends_as_in_pillow(data[:-4]) == "skipped"


def test_lab_im_blp_damage_sweep():
    """Damaged PSD Lab, IM YCC and L*12, and BLP1 CMYK files, 100 each:
    none apart from Pillow."""
    rng = np.random.RandomState(11)
    ch = rng.randint(0, 256, (3, 6, 7)).astype(np.uint8)
    planes = list(_picture(8, 8, 6).transpose(2, 0, 1)) + [_picture(8, 8, 7)[..., 0]]
    bases = {
        "psd": (_psd(9, 8, ch, True, rng), [(26, ">I"), (30, ">I")]),
        "ycc": (_im(b"YCC image", 7, 6, ch.tobytes()), []),
        "l12": (_im(b"L*12 image", 7, 6, _bit_rows(ch[0].astype(np.int64) * 9, 12, rng)), []),
        "blp": (_blp1(_encode_jpeg(planes, ((1, 1),) * 4, app=_adobe(2), ids=(1, 2, 3, 4)),
                      8, 8), [(28, "<I"), (92, "<I")]),
    }
    total = 0
    for base, lengths in bases.values():
        total += sweep(base, rng, 100, lengths)
    assert total == 0


# --------------------------------------------------------------------- #
# chip_smoke.py's phase 23f
# --------------------------------------------------------------------- #


def test_chip_smoke_rare_files_table_is_pillows():
    """Phase 23f's files, rebuilt by the script's own writers: RARE_OUTCOMES
    names each and gives Pillow's outcome (skip, or the SHA-256 of the RGB
    array it reads), and the port's outcome is the same."""
    files = cs._rare_files()
    assert sorted(files) == sorted(cs.RARE_OUTCOMES)
    for name, data in files.items():
        want = _pillow(data)
        assert _sha(None if want is None else want[1]) == cs.RARE_OUTCOMES[name], name
        try:
            got = decode_image(data)
        except UnsupportedImageError:
            raise
        except raw.DECODE_ERRORS:
            got = None
        assert _sha(got) == cs.RARE_OUTCOMES[name], name


# --------------------------------------------------------------------- #
# as a script: the exhaustive colour holds, and host time against Pillow
# --------------------------------------------------------------------- #


def exhaustive() -> int:
    """PCD's ``YCC;P`` and IM's YCbCr conversions against Pillow's on every
    one of the 2**24 inputs."""
    y, c1, c2 = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    v = np.stack([y, c1, c2], -1).astype(np.uint8).reshape(4096, 4096, 3)
    for name, want, got in (
            ("PCD YCC;P", lambda: Image.frombytes("RGB", (4096, 4096), v.tobytes(), "raw",
                                                  "YCC;P"),
             lambda: ycbcr_to_rgb(YCC_TABLES, v[..., 0], v[..., 1], v[..., 2])),
            ("IM YCbCr", lambda: Image.frombytes("YCbCr", (4096, 4096), v.tobytes()).convert("RGB"),
             lambda: ycbcr_to_rgb(YCBCR_TABLES, v[..., 0], v[..., 1], v[..., 2]))):
        differ = int((np.asarray(want()) != got()).any(-1).sum())
        print(f"{name}: {differ} of 2**24 inputs differ from Pillow 12.1")
        if differ:
            return 1
    return 0


def main() -> int:
    """This machine's host-CPU time to read each reader's file against
    Pillow's on the same bytes (best of 3), byte-equal."""
    if "--exhaustive" in sys.argv:
        return exhaustive()
    rng = np.random.RandomState(12)
    pic = _picture(256, 256, 1)
    idx = (pic[..., 0] >> 2).astype(np.uint8)
    planes = list(pic.transpose(2, 0, 1)) + [pic[..., 1]]
    cases = {
        "FLI 320 x 200 (BRUN)": _fli(320, 200, [(15, _brun(
            np.tile(idx, (1, 2))[:200, :320], rng))]),
        "FLC 320 x 200 (COPY, LC)": _fli(320, 200, [(16, bytes(64000)), (12, _lc(
            np.tile(idx, (1, 2))[:200, :320], rng))], 0xAF12),
        "IPTC 256 x 256 raw": _iptc(256, 256, 1, 0, 1, idx.tobytes(), parts=4),
        "IPTC 256 x 256 JPEG": _iptc(256, 256, 1, 0, 5, _saved(pic, "JPEG"), parts=4),
        "PCD 768 x 512": _pcd(rng, 1),
        "DDS BC6H 1024 x 1024": _bc6(rng, 1024, 1024, 95),
        "DDS BC6HS 1024 x 1024": _bc6(rng, 1024, 1024, 96),
        "PSD Lab 256 x 256 PackBits": _psd(9, 8, pic.transpose(2, 0, 1).copy(), True, rng),
        "IM YCC 256 x 256": _im(b"YCC image", 256, 256, pic.tobytes()),
        "IM L*12 255 x 256": _im(b"L*12 image", 255, 256, _bit_rows(
            pic[:, :255, 0].astype(np.int64) * 3, 12, rng)),
        "BLP1 CMYK 256 x 256": _blp1(_encode_jpeg(planes, ((1, 1),) * 4, app=_adobe(2),
                                                  ids=(1, 2, 3, 4)), 256, 256),
    }
    for kind, data in cases.items():
        ours, pillow = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            got = decode_image(data)
            ours.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            want = _pillow(data)[1]
            pillow.append(time.perf_counter() - t0)
        assert np.array_equal(got, want)
        print(f"{kind} ({len(data)} bytes): {min(ours) * 1000:.2f} ms, Pillow "
              f"{min(pillow) * 1000:.2f} ms (host CPU, best of 3), byte-equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
