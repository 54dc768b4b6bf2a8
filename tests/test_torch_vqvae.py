"""Port parity: the VQ-VAE decoder (code2img) and encoder (img2code) against
cogview_tpu, float32; the PIL-free PNG reader and ``read_img``."""

import struct
import zlib

import numpy as np
import pytest
import torch

import jax

from cogview_tpu.models import vqvae as jvq
from cogview_tpu_torch.config import VQVAEConfig
from cogview_tpu_torch.models import vqvae
from cogview_tpu_torch.models.bridge import vqvae_params_from_jax
from cogview_tpu_torch.tokenization.vq_tokenizer import TorchVQTokenizer
from cogview_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(1)

SMALL = dict(channel=16, embed_dim=8, n_embed=32)


@pytest.fixture(scope="module")
def params():
    jparams = jvq.init_params(jax.random.PRNGKey(0), jvq.VQVAEConfig(**SMALL))
    return jparams, vqvae_params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("flat", [True, False])
def test_code2img_matches_jax(params, flat):
    """8x8 code grid -> 64x64x3 de-normalized image, to 1e-4."""
    jparams, tparams = params
    codes = np.random.RandomState(1).randint(0, 32, (2, 8, 8)).astype(np.int32)
    if flat:
        codes = codes.reshape(2, 64)
    want = np.asarray(jvq.code2img(jparams, codes))
    got = vqvae.code2img(tparams, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_tokenizer_decode_and_encode_match_jax(params):
    """DecodeIds to 1e-4 and EncodeAsIds identical to JaxVQTokenizer's."""
    jparams, tparams = params
    from cogview_tpu.tokenization.vq_tokenizer import JaxVQTokenizer

    jtok = JaxVQTokenizer(jparams, jvq.VQVAEConfig(**SMALL))
    codes = list(np.random.RandomState(2).randint(0, 32, 64))
    want = jtok.DecodeIds(codes)
    tok = TorchVQTokenizer(tparams, VQVAEConfig(**SMALL))
    assert len(tok) == 32
    np.testing.assert_allclose(tok.DecodeIds(codes), want, atol=1e-4)
    img = np.random.RandomState(3).randn(64, 64, 3).astype(np.float32)
    got = tok.EncodeAsIds(img)
    assert got.shape == (1, 64)
    np.testing.assert_array_equal(got, jtok.EncodeAsIds(img))


def _image(seed, n=2, side=64):
    return np.random.RandomState(seed).randn(n, side, side, 3).astype(np.float32)


def test_encode_features_match_jax(params):
    """Pre-quantization features [b, 8, 8, embed_dim] to 1e-4."""
    jparams, tparams = params
    img = _image(4)
    want = np.asarray(jvq.encode_features(jparams, img))
    got = vqvae.encode_features(tparams, torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("seed", [5, 6])
def test_img2code_codes_identical(params, seed):
    jparams, tparams = params
    img = _image(seed)
    want = np.asarray(jvq.img2code(jparams, img))
    got = vqvae.img2code(tparams, torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_array_equal(got, want)


def test_nearest_code_ties_go_to_the_lowest_index():
    embed = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0]])  # codes 0 and 2 equal
    z = torch.tensor([[[0.9, 0.1], [0.0, 1.0]]])
    assert vqvae.nearest_code(embed, z).tolist() == [[0, 1]]


def test_random_init_shapes():
    tok = TorchVQTokenizer.random_init(seed=0, cfg=VQVAEConfig(**SMALL))
    dec, enc = tok.params["decoder"], tok.params["encoder"]
    assert dec["convt0"]["w"].shape == (8, 16, 4, 4)
    assert dec["proj"]["w"].shape == (3, 16, 1, 1)
    assert enc["conv0"]["w"].shape == (16, 3, 4, 4)
    assert enc["proj"]["w"].shape == (8, 16, 1, 1)
    img = tok.DecodeIds(list(range(16)))
    assert img.shape == (1, 32, 32, 3) and np.isfinite(img).all()
    codes = tok.EncodeAsIds(img)
    assert codes.shape == (1, 16) and ((codes >= 0) & (codes < 32)).all()


def test_read_img_bit_equal_to_jax(tmp_path):
    pytest.importorskip("PIL")  # the JAX package reads images with Pillow
    path = str(tmp_path / "img.png")
    write_png(path, np.random.RandomState(8).randint(0, 256, (256, 256, 3)).astype(np.uint8))
    want = jvq.read_img(path)
    got = vqvae.read_img(path)
    assert got.shape == want.shape == (1, 256, 256, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_read_img_other_size_raises(tmp_path):
    """An image of another size no longer raises: its short side is resized
    with Pillow's bilinear filter and centre-cropped, bit-equal to the JAX
    package's ``read_img``."""
    pytest.importorskip("PIL")
    path = str(tmp_path / "img.png")
    write_png(path, np.random.RandomState(9).randint(0, 256, (128, 256, 3)).astype(np.uint8))
    got = vqvae.read_img(path)
    assert got.shape == (1, 256, 256, 3)
    np.testing.assert_array_equal(got, jvq.read_img(path))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_read_png_matches_pil(tmp_path, mode):
    """PNGs that Pillow writes (adaptive row filters) read as Pillow reads
    them, alpha dropped as by convert("RGB")."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(9)
    y, x = np.mgrid[0:96, 0:80]
    arr = np.stack([x, y, (x * y) % 256, x + y], -1).astype(np.uint8)
    arr[40:] = rng.randint(0, 256, arr[40:].shape)  # smooth rows, then noise
    arr = arr if mode == "RGBA" else arr[..., :3]
    path = str(tmp_path / "pil.png")
    Image.fromarray(np.ascontiguousarray(arr), mode).save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(read_png(path), want)


def _filter_row(line, prev, ftype, bpp):
    """PNG row filter of type ``ftype`` (the encoder side of the spec)."""
    a = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
    b = prev
    c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(line)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return (line - pred) % 256


@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_all_five_filters(tmp_path, channels):
    h, w = 10, 7
    img = np.random.RandomState(10).randint(0, 256, (h, w, channels))
    raw, prev = b"", np.zeros(w * channels, np.int64)
    for r in range(h):
        line = img[r].reshape(-1)
        ftype = r % 5
        raw += bytes([ftype]) + _filter_row(line, prev, ftype, channels).astype(np.uint8).tobytes()
        prev = line

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = 2 if channels == 3 else 6
    path = tmp_path / "f.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(read_png(str(path)), img[..., :3].astype(np.uint8))
