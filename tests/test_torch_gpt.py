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


@pytest.mark.parametrize("sep,logits_from,return_hidden,flash", [
    (5, None, False, False), (5, 10, False, True), (0, 7, True, True), (9, 3, True, False)])
def test_forward_sep_logits_from_hidden_match(weights, sep, logits_from, return_hidden, flash):
    """forward with a bidirectional prefix, a logits tail and the hidden
    states, on the flash path (JAX: Pallas in interpret mode; port: the
    kernel's plain version) and the dense path, to 1e-4."""
    from cogview_tpu_torch.ops import flash_attention as tfa

    jcfg, jparams, tparams, tokens = weights
    kw = dict(sep=sep, logits_from=logits_from, return_hidden=return_hidden)
    want = np.asarray(jgpt.forward(jparams, jcfg.replace(use_flash_attention=flash),
                                   jnp.asarray(tokens), **kw))
    calls = tfa.flash_attention_reference.calls
    got = gpt.forward(tparams, tiny_test(use_flash_attention=flash),
                      torch.from_numpy(tokens).long(), **kw)
    assert tfa.flash_attention_reference.calls - calls == (2 if flash else 0)
    width = 64 if return_hidden else 128
    assert got.shape == want.shape == (B, S - (logits_from or 0), width)
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
    got, tcache = _decode_run_torch(tparams, tiny_test(kv_cache_dtype="int8"), tokens, chunks)
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
    cfg = tiny_test(kv_cache_dtype="int8")
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


def test_bf16_logits_and_int8_wmul_keep_float32_outputs():
    """bf16-compute logits and the int8-weight product are the float32
    products of the bf16 operands, not rounded to bf16 (the JAX package's
    ``preferred_element_type=float32``): within 1e-5 of the largest
    magnitude, where a bf16 rounding of the output is off by ~4e-3."""
    rng = np.random.RandomState(3)
    h = rng.randn(2, 5, 64).astype(np.float32)
    word = (rng.randn(128, 64) * 0.5).astype(np.float32)
    hb = jnp.asarray(h, jnp.bfloat16)
    th = torch.from_numpy(h).bfloat16()
    want = np.asarray(jgpt._logits({"embed": {"word": jnp.asarray(word)}}, None, hb))
    got = gpt._logits({"embed": {"word": torch.from_numpy(word)}}, None, th)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 128)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()

    w8 = rng.randint(-127, 128, (64, 96)).astype(np.int8)
    s = (rng.rand(96) * 0.01).astype(np.float32)
    want = np.asarray(jgpt._wmul(hb, {"w8": jnp.asarray(w8), "s": jnp.asarray(s)},
                                 "bsh,hj->bsj", jnp.bfloat16))
    got = gpt._wmul(th, {"w8": torch.from_numpy(w8), "s": torch.from_numpy(s)}, torch.bfloat16)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("w_shape,subscripts", [((64, 3, 64), "bsh,hcj->bscj"),
                                                ((64, 256), "bsh,hj->bsj"),
                                                ((256, 64), "bsj,jh->bsh")],
                         ids=["qkv", "attn_out,mlp_in", "mlp_out"])
def test_wmul_out32_false_rounds_the_bf16_output_once(w_shape, subscripts):
    """The layer matmuls in bf16 compute (``_wmul(out32=False)``, every
    decode step's qkv, attention-out and MLP products): the float32 sums
    of the bf16 operands rounded once to bf16, as the JAX package's bf16
    einsum, and not the float32 product itself.  The two packages (and
    the port's float32 product) sum in different orders, so where a float32
    sum lies at a bf16 rounding boundary they may differ by one bf16 ulp
    (2^-7 of the value); fewer than 1% of the values may differ from the
    JAX package's."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, w_shape[0]).astype(np.float32)
    w = (rng.randn(*w_shape) * 0.1).astype(np.float32)
    want = np.asarray(jgpt._wmul(jnp.asarray(x, jnp.bfloat16), {"w": jnp.asarray(w, jnp.bfloat16)},
                                 subscripts, jnp.bfloat16, out32=False), np.float32)
    xb, leaf = torch.from_numpy(x).bfloat16(), {"w": torch.from_numpy(w).bfloat16()}
    got = gpt._wmul(xb, leaf, torch.bfloat16, out32=False)
    f32 = gpt._wmul(xb, leaf, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and f32.dtype == torch.float32
    got_np, want = got.float().numpy(), want.reshape(got.shape)
    np.testing.assert_allclose(got_np, want, rtol=2.0 ** -7, atol=0)
    assert np.count_nonzero(got_np != want) < 0.01 * want.size
    np.testing.assert_allclose(got_np, f32.bfloat16().float().numpy(), rtol=2.0 ** -7, atol=0)
    assert not torch.equal(got.float(), f32)


def test_fp16_never_routes_to_flash(monkeypatch):
    """float16 compute stays on dense attention even when flash is forced,
    as in the JAX package (tests/test_flash_attention.py); the flash kernels
    take bfloat16 and float32 only."""
    def boom(*a, **k):
        raise AssertionError("flash_attention called")

    monkeypatch.setattr(gpt, "flash_attention", boom)
    cfg16 = tiny_test(pb_relax=False, use_flash_attention=True, compute_dtype=torch.float16)
    assert not gpt.should_use_flash(cfg16, 4096)
    params = gpt.init_params(cfg16, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 24), dtype=torch.long)
    out = gpt.forward(params, cfg16, tokens)  # dense path, no raise
    assert torch.isfinite(out).all()
    with pytest.raises(AssertionError, match="flash_attention called"):
        gpt.forward(params, tiny_test(pb_relax=False, use_flash_attention=True), tokens)


@pytest.mark.parametrize("flash,remat", [(False, False), (True, True)])
def test_training_forward_with_dropout_matches(weights, flash, remat):
    """forward(train=True) with all three dropouts at 0.1 against the JAX
    package's, float32, to 1e-4: the port takes the L + 1 seeds that the
    JAX forward derives from its key (embedding first, then one per layer)
    and the same salted sites and flash seed."""
    from cogview_tpu.ops.hash_prng import seed_from_key

    _, jparams, tparams, tokens = weights
    drop = dict(embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1,
                use_flash_attention=flash)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jgpt.forward(jparams, jax_tiny(kv_cache_dtype="int8", **drop),
                                   jnp.asarray(tokens), sep=3, train=True, rng=key,
                                   remat=remat))
    rest, r_embed = jax.random.split(key)
    seeds = [int(seed_from_key(r_embed))] + [int(seed_from_key(r))
                                             for r in jax.random.split(rest, 2)]
    got = gpt.forward(tparams, tiny_test(**drop), torch.from_numpy(tokens).long(), sep=3,
                      train=True, seeds=seeds, remat=remat)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)
    plain = gpt.forward(tparams, tiny_test(**drop), torch.from_numpy(tokens).long(), sep=3)
    assert not torch.allclose(got, plain, atol=1e-3)  # dropout did something


def test_only_int8_cache_is_ported():
    """The three caches of the JAX package are ported, bfloat16 the default
    as there; any other name is refused."""
    assert tiny_test().kv_cache_dtype == "bfloat16"
    for name in ("int8", "int4", "bfloat16"):
        assert tiny_test(kv_cache_dtype=name).kv_cache_dtype == name
    with pytest.raises(ValueError):
        tiny_test(kv_cache_dtype="float8")
