"""Port parity for post-selection and image->text, float32, on the same
numpy weights in both packages.

* ``inverse_prompt_score`` on the flash path (forced, and ``auto`` with a
  small ``flash_min_seq``) and on the dense path, to 1e-4.
* ``post_selection`` of PNG candidates through a channel-32 VQ encoder,
  against the JAX package on its dense path, to 1e-4 (the port takes the
  flash path there: S = 1028 + text >= flash_min_seq).
* image->text ``generate_once``: identical ids, with the JAX package's
  chunk seeds handed to the port as tests/test_torch_slice.py does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.generation import sampling as js
from cogview_tpu.generation import scoring as jscoring
from cogview_tpu.generation import tasks as jtasks
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.models import vqvae as jvq
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.tokenization.unified import UnifiedTokenizer
from cogview_tpu.tokenization.vq_tokenizer import JaxVQTokenizer
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.config import VQVAEConfig, tiny_test
from cogview_tpu_torch.generation import sampling as ts
from cogview_tpu_torch.generation import scoring
from cogview_tpu_torch.generation import tasks as ttasks
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, vqvae_params_from_jax
from cogview_tpu_torch.ops import flash_attention as tfa
from cogview_tpu_torch.tokenization.vq_tokenizer import TorchVQTokenizer
from cogview_tpu_torch.utils.png import write_png

torch.set_num_threads(1)

VQ = dict(channel=32, embed_dim=8, n_embed=32)


class TinyTextTok:
    num_tokens = 64

    def encode(self, s):
        return [ord(c) % 64 for c in s]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.fixture(scope="module")
def gpt_weights():
    jcfg = jax_tiny(kv_cache_dtype="int8", max_position_embeddings=1088)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, gpt_params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def tokenizers():
    jvqp = jvq.init_params(jax.random.PRNGKey(1), jvq.VQVAEConfig(**VQ))
    jtok = UnifiedTokenizer(img_tokenizer=JaxVQTokenizer(jvqp, jvq.VQVAEConfig(**VQ)),
                            txt_tokenizer=TinyTextTok())
    ttok = UnifiedTokenizer(
        img_tokenizer=TorchVQTokenizer(vqvae_params_from_jax(jax.tree.map(np.asarray, jvqp)),
                                       VQVAEConfig(**VQ)),
        txt_tokenizer=TinyTextTok())
    return jtok, ttok


@pytest.mark.parametrize("mode", ["flash", "auto", "dense"])
def test_inverse_prompt_score_matches_jax(gpt_weights, mode):
    jcfg, jparams, tparams = gpt_weights
    flag, min_seq = {"flash": (True, 1024), "auto": ("auto", 16), "dense": (False, 1024)}[mode]
    B, S, botext, img_vocab = 3, 40, 20, 32
    tokens = np.random.RandomState(2).randint(0, 128, (B, S)).astype(np.int32)
    want = np.asarray(jscoring.inverse_prompt_score(
        jparams, jcfg.replace(use_flash_attention=flag, flash_min_seq=min_seq),
        jnp.asarray(tokens), img_vocab=img_vocab, botext=botext))
    calls = tfa.flash_attention_reference.calls
    got = scoring.inverse_prompt_score(
        tparams, tiny_test(use_flash_attention=flag, flash_min_seq=min_seq),
        torch.from_numpy(tokens), img_vocab=img_vocab, botext=botext)
    assert tfa.flash_attention_reference.calls - calls == (0 if mode == "dense" else 2)
    assert got.shape == (B,) and got.dtype == torch.float32
    assert (got < 0).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _pngs(tmp_path, n):
    rng = np.random.RandomState(3)
    paths = []
    for i in range(n):
        path = str(tmp_path / f"{i}.png")
        write_png(path, rng.randint(0, 256, (256, 256, 3)).astype(np.uint8))
        paths.append(path)
    return paths


def test_post_selection_matches_jax(gpt_weights, tokenizers, tmp_path):
    jcfg, jparams, tparams = gpt_weights
    jtok, ttok = tokenizers
    raw = "\t".join(["ab cd ef"] + _pngs(tmp_path, 3))
    want = jtasks.post_selection(jparams, jcfg.replace(use_flash_attention=False), jtok,
                                 raw, max_inference_batch_size=2)
    calls = tfa.flash_attention_reference.calls
    got = ttasks.post_selection(tparams, tiny_test(max_position_embeddings=1088), ttok, raw,
                                max_inference_batch_size=2)
    assert tfa.flash_attention_reference.calls - calls == 2 * 2  # 2 chunks x 2 layers
    assert got.shape == want.shape == (3,)
    assert np.isfinite(got).all() and (got < 0).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_image2text_generate_once_matches_jax(gpt_weights, tokenizers, tmp_path, monkeypatch):
    jcfg, jparams, tparams = gpt_weights
    jtok, ttok = tokenizers
    (path,) = _pngs(tmp_path, 1)
    num, mbz, seed = 3, 2, 9
    want = jtasks.generate_once(jparams, jcfg, jtok, path, "image2text", num=num,
                                max_inference_batch_size=mbz,
                                sampling=js.SamplingParams(top_k=20, seed=seed))
    rng, seeds = jax.random.PRNGKey(seed), []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        seeds.append(int(seed_from_key(rbg_key(sub))))
    monkeypatch.setattr(ttasks, "_chunk_seed", lambda s, i: seeds[i])
    got = ttasks.generate_once(tparams, tiny_test(max_position_embeddings=1088,
                                                  kv_cache_dtype="int8"), ttok, path,
                               "image2text", num=num, max_inference_batch_size=mbz,
                               sampling=ts.SamplingParams(top_k=20, seed=seed))
    assert got.tokens.shape == want.tokens.shape == (3, 1048)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    text = got.tokens[:, 1028:]  # the 20 generated slots, in the text range
    assert ((text >= 32) & (text < 32 + 64)).all()
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
    assert got.texts == want.texts
    assert len(got.images) == len(want.images) == 3  # the input image, decoded
    for a, b in zip(got.images, want.images):
        np.testing.assert_allclose(a, b, atol=1e-4)
