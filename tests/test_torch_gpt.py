"""Port parity: the GPT forward, the int8 KV-cache prefill + decode and the
int8 weight path against cogview_tpu, float32, on the same numpy weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops.decode_attention import columns_from_fused
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.models import gpt
from cogview_tpu_torch.models.bridge import gpt_params_from_jax

torch.set_num_threads(1)

B, S, CTX = 2, 32, 12


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny(kv_cache_dtype="int8")
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    # scale the zero-initialised biases and unit LN gains away from their
    # defaults so the parity covers every leaf
    rng = np.random.RandomState(5)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.05), jparams)
    tokens = np.random.RandomState(0).randint(0, 128, (B, S)).astype(np.int32)
    return jcfg, jparams, gpt_params_from_jax(jax.tree.map(np.asarray, jparams)), tokens


def test_forward_logits_match(weights):
    jcfg, jparams, tparams, tokens = weights
    want = np.asarray(jgpt.forward(jparams, jcfg, jnp.asarray(tokens)))
    got = gpt.forward(tparams, tiny_test(), torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _decode_run_jax(jparams, jcfg, tokens, chunks):
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    cache = jgpt.init_cache(jcfg, B, S)
    outs = []
    for a, b in zip(chunks[:-1], chunks[1:]):
        lg, cache = jgpt.forward_with_cache(jparams, jcfg, jnp.asarray(tokens[:, a:b]),
                                            pos[:, a:b], cache, a)
        outs.append(np.asarray(lg))
    step = jax.jit(jgpt.forward_with_cache, static_argnums=(1,))
    for t in range(CTX, S):
        lg, cache = step(jparams, jcfg, jnp.asarray(tokens[:, t:t + 1]), pos[:, t:t + 1],
                         cache, jnp.int32(t))
        outs.append(np.asarray(lg))
    return np.concatenate(outs, axis=1), cache


def _decode_run_torch(tparams, cfg, tokens, chunks):
    tk = torch.from_numpy(tokens).long()
    pos = torch.arange(S).expand(B, S)
    cache = gpt.init_cache(cfg, B, S)
    outs = [gpt.forward_with_cache(tparams, cfg, tk[:, a:b], pos[:, a:b], cache, a)
            for a, b in zip(chunks[:-1], chunks[1:])]
    for t in range(CTX, S):
        outs.append(gpt.forward_with_cache(tparams, cfg, tk[:, t:t + 1], pos[:, t:t + 1],
                                           cache, t))
    return torch.cat(outs, dim=1).numpy(), cache


@pytest.mark.parametrize("chunks", [(0, CTX), (0, 5, CTX)])
def test_int8_cache_prefill_and_decode_match(weights, chunks):
    """Prefill 12 (whole, or in two chunks: the second attends the gathered
    cache) + 20 decode steps (two seals): logits to 1e-4, and the
    cache bytes equal over positions < c0 + G.  The scales are absmax / 127
    of K/V columns that the two frameworks' matmuls produce equal only to
    float32 rounding, so they agree to a few float32 ulps."""
    jcfg, jparams, tparams, tokens = weights
    want, jcache = _decode_run_jax(jparams, jcfg, tokens, chunks)
    got, tcache = _decode_run_torch(tparams, tiny_test(), tokens, chunks)
    np.testing.assert_allclose(got, want, atol=1e-4)
    last = S - 1
    upto = last - last % 8 + 8
    for jc, tc in zip(columns_from_fused(jcache.kv), columns_from_fused(tcache.kv.numpy())):
        np.testing.assert_array_equal(np.asarray(tc)[..., :upto], np.asarray(jc)[..., :upto])
    for jc, tc in zip(columns_from_fused(jcache.scale),
                      columns_from_fused(tcache.scale.numpy())):
        np.testing.assert_allclose(np.asarray(tc)[..., :upto], np.asarray(jc)[..., :upto],
                                   rtol=2e-6, atol=0)
    np.testing.assert_allclose(tcache.recent.numpy(), np.asarray(jcache.recent), atol=1e-5)


def test_prefill_after_decode_raises(weights):
    _, _, tparams, tokens = weights
    cfg = tiny_test()
    cache = gpt.init_cache(cfg, B, S)
    tk = torch.from_numpy(tokens).long()
    pos = torch.arange(S).expand(B, S)
    gpt.forward_with_cache(tparams, cfg, tk[:, :4], pos[:, :4], cache, 0)
    gpt.forward_with_cache(tparams, cfg, tk[:, 4:5], pos[:, 4:5], cache, 4)
    with pytest.raises(ValueError):
        gpt.forward_with_cache(tparams, cfg, tk[:, 5:8], pos[:, 5:8], cache, 5)


def test_quantized_weights_bytes_and_logits_match(weights):
    jcfg, jparams, tparams, tokens = weights
    jq = jgpt.quantize_weights(jparams)
    tq = gpt.quantize_weights(tparams)
    jleaves = jax.tree_util.tree_leaves_with_path(jq)
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(tq)}
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        got = tflat[jax.tree_util.keystr(path)]
        assert got.dtype == {"int8": torch.int8, "float32": torch.float32}[str(leaf.dtype)]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    want = np.asarray(jgpt.forward(jq, jcfg, jnp.asarray(tokens)))
    got = gpt.forward(tq, tiny_test(), torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_only_int8_cache_is_ported():
    with pytest.raises(NotImplementedError):
        tiny_test(kv_cache_dtype="bfloat16")
