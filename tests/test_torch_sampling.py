"""Port parity: template compilation, logit filtering and the filling loop
against cogview_tpu's sampler (float32 tiny model, int8 KV cache)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.generation import sampling as js
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.tokenization.unified import FakeImageTokenizer, UnifiedTokenizer
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.generation import sampling as ts
from cogview_tpu_torch.models.bridge import gpt_params_from_jax

torch.set_num_threads(1)


class TinyTextTok:
    """64-token fake text vocab: 32 img + 64 txt + 27 commands <= 128."""

    num_tokens = 64

    def encode(self, s):
        return [ord(c) % 64 for c in s]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.fixture(scope="module")
def tok():
    return UnifiedTokenizer(img_tokenizer=FakeImageTokenizer(32), txt_tokenizer=TinyTextTok())


@pytest.fixture(scope="module")
def params():
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jax_tiny())
    return jparams, gpt_params_from_jax(jax.tree.map(np.asarray, jparams))


def _seqs(tok):
    return {
        "t2i": [tok["[ROI1]"], 40, 50, tok["[BASE]"], tok["[BOI1]"]] + [-1] * 8
               + [tok["[EOI1]"]] + [-1] * 3,
        "roi2": [tok["[ROI1]"], 40, tok["[ROI2]"], 50, -1, -1],
        # fork to 3 rows at the 4th generation slot, past the context
        "fork": [tok["[ROI1]"], 40, tok["[BASE]"], tok["[BOI1]"]] + [-1] * 3 + [-3]
                + [-1] * 4,
    }


@pytest.mark.parametrize("name", ["t2i", "roi2", "fork"])
def test_compile_template_arrays_equal(tok, name):
    seq = _seqs(tok)[name]
    assert ts.add_fork_marks(seq[:4] + [-1], 2) == js.add_fork_marks(seq[:4] + [-1], 2)
    want = js.compile_template(seq, tok, padded_vocab=128, pad_to=24)
    got = ts.compile_template(seq, tok, padded_vocab=128, pad_to=24)
    for f in dataclasses.fields(js.Template):
        a, b = getattr(want, f.name), getattr(got, f.name)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=f.name)


def test_top_k_and_top_p_match():
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 128) * 3).astype(np.float32)
    logits[1, :40] = ts.NEG_INF
    for k in (1, 5, 50):
        want = np.asarray(js.apply_top_k(jnp.asarray(logits), k))
        got = ts.apply_top_k(torch.from_numpy(logits), k).numpy()
        np.testing.assert_array_equal(got, want)
    for p in (0.3, 0.9):
        want = np.asarray(js.apply_top_p(jnp.asarray(logits), p))
        got = ts.apply_top_p(torch.from_numpy(logits), p).numpy()
        np.testing.assert_array_equal(got <= ts.NEG_INF, want <= js.NEG_INF)
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name,top_k,top_p,seed", [
    ("t2i", 200, 0.0, 3), ("t2i", 10, 0.9, 11), ("fork", 0, 0.0, 7)])
def test_filling_sequence_identical_tokens(tok, params, name, top_k, top_p, seed):
    """Same weights, same uint32 seed -> the same token ids, and scores to
    1e-4.  JAX derives its seed from the key as seed_from_key(rbg_key(s))."""
    jparams, tparams = params
    seq = _seqs(tok)[name]
    sp = js.SamplingParams(top_k=top_k, top_p=top_p, seed=seed)
    tpl = js.compile_template(seq, tok, padded_vocab=128)
    jcfg = jax_tiny(kv_cache_dtype="int8")
    batch = 1 if name == "fork" else 2  # a fork sets the batch to its width
    want_t, want_s = js.filling_sequence(jparams, jcfg, tpl, batch, sp)
    seed_u32 = int(seed_from_key(rbg_key(seed)))
    ttpl = ts.compile_template(seq, tok, padded_vocab=128)
    got_t, got_s = ts.filling_sequence(
        tparams, tiny_test(), ttpl, batch,
        ts.SamplingParams(top_k=top_k, top_p=top_p, seed=seed), seed_u32)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
    if name == "fork":  # rows decode in lockstep before the fork point
        assert got_t.shape[0] == 3 and ttpl.fork_at == 7
        assert (got_t[:, :7] == got_t[:1, :7]).all()


def test_filling_validates_positions(tok, params):
    _, tparams = params
    tpl = ts.compile_template([tok["[BOI1]"]] + [-1] * 70, tok, padded_vocab=128)
    with pytest.raises(ValueError):
        ts.filling_sequence(tparams, tiny_test(), tpl, 1)
