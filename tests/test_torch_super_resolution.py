"""Port parity for super-resolution, low-level super-resolution and ``raw``.

The JAX package is the oracle, on the same numpy weights: a tiny float32
GPT (2 layers, 1,400 positions), a channel-16 VQ-VAE of 32 codes and a
64-token stand-in text tokenizer, so nothing needs ``cog-pretrain.model``.
Low-level super-resolution and ``raw`` decode through the int8 cache (the
decode kernel's plain version, over 11 windows for low-level SR); the nine
magnify windows, whose bookkeeping is what those tests hold, through the
exact cache, which takes about a third off their time in both packages on
the CPU.  The port derives each chunk's and each magnify window's uint32
seed without ``jax.random``; the tests hand it the seeds the JAX package
derives from its split keys, so both draw the same noise and the sampled
ids are equal.  Also: the position-table extension, the cogview-sr preset,
``read_img``'s Pillow bilinear resize, and the CLI's super-resolution and
low-level super-resolution tasks on the CPU."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from cogview_tpu import config as jconfig
from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.generation import sampling as js
from cogview_tpu.generation import tasks as jtasks
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.models import vqvae as jvq
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.tokenization.unified import UnifiedTokenizer
from cogview_tpu.tokenization.vq_tokenizer import JaxVQTokenizer
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch import config as tconfig
from cogview_tpu_torch.config import VQVAEConfig, tiny_test
from cogview_tpu_torch.generation import sampling as ts
from cogview_tpu_torch.generation import tasks as ttasks
from cogview_tpu_torch.models import gpt, vqvae
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, vqvae_params_from_jax
from cogview_tpu_torch.tokenization.vq_tokenizer import TorchVQTokenizer
from cogview_tpu_torch.utils.png import read_png, write_png

# the packages export ``magnify`` the function under the module's name
jmag = importlib.import_module("cogview_tpu.generation.magnify")
tmag = importlib.import_module("cogview_tpu_torch.generation.magnify")

torch.set_num_threads(1)

VQ = dict(channel=16, embed_dim=8, n_embed=32)
POSITIONS = 1400  # a magnify window's template needs 1,318 slots, positions < 1,030


class TinyTextTok:
    num_tokens = 64

    def encode(self, s):
        return [ord(c) % 64 for c in s]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


def _split_seeds(seed: int, n: int):
    """The uint32 seeds the JAX package derives for n chunks or windows:
    split the key, then ``seed_from_key(rbg_key(sub))``."""
    rng, seeds = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        seeds.append(int(seed_from_key(rbg_key(sub))))
    return seeds


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params) of the tiny model
    with the exact cache; tests that run the int8 cache replace it."""
    jcfg = jax_tiny(max_position_embeddings=POSITIONS)
    jparams = jgpt.init_params(jax.random.PRNGKey(1), jcfg)
    tcfg = tiny_test(max_position_embeddings=POSITIONS)
    return jcfg, jparams, tcfg, gpt_params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def tokenizers():
    jvqp = jvq.init_params(jax.random.PRNGKey(2), jvq.VQVAEConfig(**VQ))
    jtok = UnifiedTokenizer(img_tokenizer=JaxVQTokenizer(jvqp, jvq.VQVAEConfig(**VQ)),
                            txt_tokenizer=TinyTextTok())
    ttok = UnifiedTokenizer(
        img_tokenizer=TorchVQTokenizer(vqvae_params_from_jax(jax.tree.map(np.asarray, jvqp)),
                                       VQVAEConfig(**VQ)),
        txt_tokenizer=TinyTextTok())
    return jtok, ttok


def _png(path, w, h, seed):
    write_png(str(path), np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8))
    return str(path)


# ------------------------------------------------------------------ #
# the position table and the preset
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("old,new", [(8, 24), (1089, 1345), (64, 48), (64, 64)],
                         ids=["divisible", "non-divisible", "truncate", "no-op"])
def test_position_embedding_extension_matches_jax(old, new):
    """``extend_position_embedding`` and ``adapt_position_embeddings``
    equal the JAX package's: a divisor tiles, a non-divisor tiles and
    truncates (1089 -> 1345 reuses rows 0-255), a shorter target truncates,
    equal lengths return the same params."""
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jax_tiny(max_position_embeddings=old))
    tparams = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    pos = tparams["embed"]["pos"]
    want = np.asarray(jgpt.extend_position_embedding(jparams["embed"]["pos"], new))
    got = gpt.extend_position_embedding(pos, new)
    assert got.shape == (new, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pos.numpy()[np.arange(new) % old])

    jadapted = jgpt.adapt_position_embeddings(jparams, jax_tiny(max_position_embeddings=new))
    adapted = gpt.adapt_position_embeddings(tparams, tiny_test(max_position_embeddings=new))
    np.testing.assert_array_equal(adapted["embed"]["pos"].numpy(),
                                  np.asarray(jadapted["embed"]["pos"]))
    assert adapted["embed"]["word"] is tparams["embed"]["word"]
    assert adapted["layers"] is tparams["layers"]
    assert (adapted is tparams) == (old == new)


def test_cogview_sr_matches_jax_field_for_field():
    want, got = jconfig.cogview_sr(), tconfig.cogview_sr()
    assert got.max_position_embeddings == 1345
    assert (got.num_layers, got.hidden_size, got.num_heads) == (48, 2560, 40)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "compute_dtype":
            a, b = str(a).replace("torch.", ""), np.dtype(b).name
        assert a == b, f.name


# ------------------------------------------------------------------ #
# read_img: Pillow's bilinear resize and the centre crop
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("h,w,out_h,out_w", [(200, 300, 256, 384), (256, 256, 128, 128),
                                             (300, 200, 384, 256), (37, 91, 50, 13),
                                             (513, 257, 128, 64)])
def test_resize_bilinear_equals_pillow(h, w, out_h, out_w):
    """Up and down, by integer and fractional factors: every byte equal to
    Pillow's ``Image.resize(BILINEAR)``."""
    img = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR))
    np.testing.assert_array_equal(vqvae.resize_bilinear(img, out_w, out_h), want)


@pytest.mark.parametrize("w,h,size", [(300, 200, 256), (200, 300, 256), (256, 256, 128),
                                      (333, 129, 128)])
def test_read_img_matches_jax(tmp_path, w, h, size):
    """Non-square PNGs and a 256 -> 128 reduction: the normalized image
    bit-equal to the JAX package's ``read_img`` (Pillow)."""
    path = _png(tmp_path / "x.png", w, h, seed=w * h)
    got = vqvae.read_img(path, size)
    want = jvq.read_img(path, size)
    assert got.shape == want.shape == (1, size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ #
# low-level super-resolution and raw
# ------------------------------------------------------------------ #


def test_low_level_sr_template(tokenizers, tmp_path):
    """A 256-pixel image is read at 128 pixels: 16 x 16 = 256 image codes,
    then [EOI1] [ROI2] [POS0] [BASE] [BOI2] and 1024 slots; the ids equal
    the JAX package's."""
    jtok, ttok = tokenizers
    raw = "ab cd\t" + _png(tmp_path / "x.png", 256, 256, seed=1)
    seq = ttasks.parse_query_line(raw, "low-level super-resolution", ttok)
    assert seq == jtasks.parse_query_line(raw, "low-level super-resolution", jtok)
    boi1, eoi1 = seq.index(ttok["[BOI1]"]), seq.index(ttok["[EOI1]"])
    assert eoi1 - boi1 - 1 == 256 and all(0 <= c < 32 for c in seq[boi1 + 1:eoi1])
    assert seq[eoi1:eoi1 + 5] == [ttok[t] for t in ("[EOI1]", "[ROI2]", "[POS0]", "[BASE]",
                                                    "[BOI2]")]
    assert seq[eoi1 + 5:] == [-1] * 1024


@pytest.mark.parametrize("task,num", [("low-level super-resolution", 2), ("raw", 3)])
def test_generate_once_matches_jax(models, tokenizers, tmp_path, monkeypatch, task, num):
    """Low-level super-resolution (1,024 image slots after a 128-pixel
    context) and ``raw`` (the line is the query; 16 image slots), in chunks
    of 2: the same ids, scores to 1e-4, images to 1e-4."""
    jcfg, jparams, tcfg, tparams = models
    jcfg, tcfg = jcfg.replace(kv_cache_dtype="int8"), tcfg.replace(kv_cache_dtype="int8")
    jtok, ttok = tokenizers
    if task == "raw":
        raw = "[ROI1] ab [BASE] [BOI1] [MASK]*16 [EOI1]"
    else:
        raw = "ab cd\t" + _png(tmp_path / "x.png", 256, 256, seed=2)
    seed, mbz = 7, 2
    want = jtasks.generate_once(jparams, jcfg, jtok, raw, task, num=num,
                                max_inference_batch_size=mbz,
                                sampling=js.SamplingParams(top_k=20, seed=seed))
    seeds = _split_seeds(seed, 2)
    monkeypatch.setattr(ttasks, "_chunk_seed", lambda s, i: seeds[i])
    got = ttasks.generate_once(tparams, tcfg, ttok, raw, task, num=num,
                               max_inference_batch_size=mbz,
                               sampling=ts.SamplingParams(top_k=20, seed=seed))
    assert got.tokens.shape == want.tokens.shape
    np.testing.assert_array_equal(got.tokens, want.tokens)
    n_gen = 1024 if task != "raw" else 16
    first = ttasks.parse_query_line(raw, task, ttok).index(-1)
    gen = got.tokens[:, first:first + n_gen]
    assert ((gen >= 0) & (gen < 32)).all()
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
    assert len(got.images) == len(want.images) == num
    side = 256 if task != "raw" else 32
    for a, b in zip(got.images, want.images):
        assert a.shape == (1, side, side, 3)
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert got.texts == want.texts


# ------------------------------------------------------------------ #
# magnify and super-resolution
# ------------------------------------------------------------------ #


def test_window_seeds_differ_and_are_uint32():
    seeds = {tmag.window_seed(1234, w) for w in range(len(tmag.WINDOWS))}
    assert tmag.WINDOWS == jmag.WINDOWS
    assert len(seeds) == 9 and all(0 <= s < 2 ** 32 for s in seeds)
    assert not seeds & {ttasks._chunk_seed(1234, i) for i in range(9)}


def test_magnify_matches_jax_at_batch_2(models, tokenizers):
    """Two 32 x 32 code grids through the nine windows, each window's
    earlier outputs fixed in its template: [2, 4096] codes equal to the JAX
    package's with the same per-window seeds (batch 1 runs end to end in
    ``test_super_resolution_matches_jax``)."""
    jcfg, jparams, tcfg, tparams = models
    jtok, ttok = tokenizers
    codes = np.random.RandomState(0).randint(0, 32, (2, 1024))
    text = jtok.parse_query("[ROI1] ab [BASE] [BOI1]")
    want = jmag.magnify(jparams, jcfg, jtok, codes, text, js.SamplingParams(seed=3, top_k=0))
    got = tmag.magnify(tparams, tcfg, ttok, codes, text, ts.SamplingParams(seed=3, top_k=0),
                       window_seeds=_split_seeds(3, 9))
    assert got.shape == want.shape == (2, 4096)
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < 32)).all() and not np.array_equal(got[0], got[1])


def test_super_resolution_matches_jax(models, tokenizers, tmp_path):
    """A 256-pixel PNG's 1,024 codes magnified at batch 1 through the nine
    windows: the [1, 4096] codes equal to the JAX package's, the 512-pixel
    image within 1e-4 (the two VQ-VAE decoders' float32 convolutions)."""
    jcfg, jparams, tcfg, tparams = models
    jtok, ttok = tokenizers
    raw = "ab cd\t" + _png(tmp_path / "x.png", 256, 256, seed=4)
    want = jtasks.super_resolution(jparams, jcfg, jtok, raw, js.SamplingParams(seed=5, top_k=0))
    got = ttasks.super_resolution(tparams, tcfg, ttok, raw, ts.SamplingParams(seed=5, top_k=0),
                                  window_seeds=_split_seeds(5, 9))
    assert got.tokens.shape == (1, 4096)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    (img,), (want_img,) = got.images, want.images
    assert img.shape == (1, 512, 512, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, want_img, atol=1e-4)


def test_cli_super_resolution_and_low_level_sr_on_cpu(tmp_path, monkeypatch, capsys):
    """The CLI on the CPU at a one-layer tiny preset with 1,400 positions
    (registered for the test), the narrow VQ-VAE and the stand-in text
    tokenizer: super-resolution writes sr-0.png at 512 x 512 pixels, and
    low-level super-resolution one 256-pixel PNG per sample and
    concat.png."""
    from cogview_tpu_torch.cli import generate

    monkeypatch.setitem(generate.PRESETS, "tiny-sr",
                        lambda: tiny_test(num_layers=1, max_position_embeddings=POSITIONS))
    small = VQVAEConfig(**VQ)
    monkeypatch.setattr(generate.TorchVQTokenizer, "random_init", classmethod(
        lambda cls, device=None: cls(vqvae.init_params(small, torch.Generator().manual_seed(0)),
                                     small, device)))
    q = tmp_path / "q.txt"
    q.write_text("ab cd\t" + _png(tmp_path / "x.png", 300, 256, seed=6) + "\n")
    common = ["--preset", "tiny-sr", "--device", "cpu", "--dtype", "float32", "--top_k", "0",
              "--input-source", str(q)]
    out = tmp_path / "sr"
    assert generate.main(["--generation-task", "super-resolution", "--output-path", str(out)]
                         + common, txt_tokenizer=TinyTextTok()) == 0
    assert read_png(str(out / "sr-0.png")).shape == (512, 512, 3)
    out = tmp_path / "llsr"
    assert generate.main(["--generation-task", "low-level super-resolution", "--batch-size",
                          "2", "--output-path", str(out)] + common,
                         txt_tokenizer=TinyTextTok()) == 0
    assert [read_png(str(out / f"{i}.png")).shape for i in range(2)] == [(256, 256, 3)] * 2
    assert read_png(str(out / "concat.png")).shape == (256, 512, 3)
    assert "saved 2 images" in capsys.readouterr().out
