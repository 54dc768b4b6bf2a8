"""Port parity: the VQ-VAE decoder (code2img) against cogview_tpu, float32."""

import numpy as np
import pytest
import torch

import jax

from cogview_tpu.models import vqvae as jvq
from cogview_tpu_torch.config import VQVAEConfig
from cogview_tpu_torch.models import vqvae
from cogview_tpu_torch.models.bridge import vqvae_params_from_jax
from cogview_tpu_torch.tokenization.vq_tokenizer import TorchVQTokenizer

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


def test_tokenizer_decode_matches_and_encode_is_deferred(params):
    jparams, tparams = params
    from cogview_tpu.tokenization.vq_tokenizer import JaxVQTokenizer

    codes = list(np.random.RandomState(2).randint(0, 32, 64))
    want = JaxVQTokenizer(jparams, jvq.VQVAEConfig(**SMALL)).DecodeIds(codes)
    tok = TorchVQTokenizer(tparams, VQVAEConfig(**SMALL))
    assert len(tok) == 32
    np.testing.assert_allclose(tok.DecodeIds(codes), want, atol=1e-4)
    with pytest.raises(NotImplementedError):
        tok.EncodeAsIds(np.zeros((1, 64, 64, 3), np.float32))


def test_random_init_shapes():
    tok = TorchVQTokenizer.random_init(seed=0, cfg=VQVAEConfig(**SMALL))
    dec = tok.params["decoder"]
    assert dec["convt0"]["w"].shape == (8, 16, 4, 4)
    assert dec["proj"]["w"].shape == (3, 16, 1, 1)
    img = tok.DecodeIds(list(range(16)))
    assert img.shape == (1, 32, 32, 3) and np.isfinite(img).all()
