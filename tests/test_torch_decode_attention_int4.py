"""Port parity for the packed int4 KV cache (K2's plain version) and the
exact bfloat16 cache, against cogview_tpu on the CPU: the int4 helpers bit
for bit, the plain version against ``decode_attention_quant4`` in interpret
mode, and a tiny model's prefill + decode and ``generate_once`` through both
caches.

The JAX kernel's seal rewrites the whole target window, and when c0 sits on
a window boundary its non-group lanes get stale staging bytes (positions
>= c0 + G, invisible until their own seal); the port writes the group's lanes
only.  Cache bytes are therefore compared over positions < c0 + G."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops import decode_attention as jda
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.models import gpt
from cogview_tpu_torch.models.bridge import gpt_params_from_jax
from cogview_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)

G = tda.SEAL_GROUP
L, B, N, D = 3, 2, 4, 16
D2 = D // 2
T = tda.pad_cache_len(200)


def _packed(rng, shape):
    """Bytes the packer can make: 16 * hi + lo + 8, hi and lo in [-7, 7]."""
    hi = rng.randint(-7, 8, shape)
    lo = rng.randint(-7, 8, shape)
    return (16 * hi + lo + 8).astype(np.int8)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, N, D).astype(np.float32)
    k4 = _packed(rng, (L, B, N, D2, T))
    v4 = _packed(rng, (L, B, N, D2, T))
    ks = (rng.rand(L, B, N, T) * 0.1).astype(np.float32)
    vs = (rng.rand(L, B, N, T) * 0.1).astype(np.float32)
    ring = rng.randn(L, G, B, 2, N, D).astype(np.float32)
    return q, k4, v4, ks, vs, ring


def _run_both(idx, q, k4, v4, ks, vs, ring, li=1, qdtype="f32"):
    jq = jnp.asarray(q).astype(jnp.bfloat16 if qdtype == "bf16" else jnp.float32)
    jctx, jkv, js = jda.decode_attention_quant4(
        jq, jda.fuse_ring(ring), jda.fused_from_columns(jnp.asarray(k4), jnp.asarray(v4)),
        jda.fused_from_columns(jnp.asarray(ks), jnp.asarray(vs)), li, idx, head_block=4)
    tq = torch.from_numpy(q).to(torch.bfloat16 if qdtype == "bf16" else torch.float32)
    tring = tda.fuse_ring(torch.from_numpy(ring))
    tkv = tda.fused_from_columns(torch.from_numpy(k4), torch.from_numpy(v4))
    ts = tda.fused_from_columns(torch.from_numpy(ks), torch.from_numpy(vs))
    before = (tda.decode_attention_quant.launches, tda.decode_attention_quant.launches_int4)
    calls = tda.decode_attention_quant_reference.calls
    tctx = tda.decode_attention_quant(tq, tring[li], tkv[li], ts[li], idx)
    # CPU: the plain version, no launch counted
    assert (tda.decode_attention_quant.launches,
            tda.decode_attention_quant.launches_int4) == before
    assert tda.decode_attention_quant_reference.calls == calls + 1
    assert tctx.dtype == tq.dtype
    return (np.asarray(jctx.astype(jnp.float32)), np.asarray(jkv), np.asarray(js),
            tctx.float().numpy(), tkv.numpy(), ts.numpy())


def _columns(jkv, js, tkv, ts):
    """(K, V, K scales, V scales) column pairs (JAX, port)."""
    return list(zip(jda.columns_from_fused(jkv) + jda.columns_from_fused(js),
                    tda.columns_from_fused(torch.from_numpy(tkv))
                    + tda.columns_from_fused(torch.from_numpy(ts))))


def test_quantize_kv4_bit_equal_to_jitted_jax():
    """Packed bytes and scales bit-equal to the jitted JAX function (which
    multiplies by float32(1/7)), an all-zero group included; the
    dequantized values equal too."""
    rng = np.random.RandomState(0)
    cols = (rng.randn(2, 64, 37) * 3.0).astype(np.float32)
    cols[0, :16, 5] = 0.0  # an all-zero (head, token) group hits the 1e-8 floor
    j4, js = jax.jit(jda.quantize_kv4, static_argnums=1)(jnp.asarray(cols), 4)
    t4, ts = tda.quantize_kv4(torch.from_numpy(cols), 4)
    assert t4.shape == (2, 4, 8, 37) and t4.dtype == torch.int8
    np.testing.assert_array_equal(t4.numpy(), np.asarray(j4))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tda.dequantize_kv4(t4, ts).numpy(),
                                  np.asarray(jda.dequantize_kv4(j4, js)))


def test_unpack4_all_225_nibble_pairs():
    hi, lo = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8), indexing="ij")
    packed = (16 * hi + lo + 8).astype(np.int8)
    th, tl = tda._unpack4(torch.from_numpy(packed))
    jh, jl = jda._unpack4(jnp.asarray(packed).astype(jnp.float32))
    np.testing.assert_array_equal(th.numpy(), hi.astype(np.float32))
    np.testing.assert_array_equal(tl.numpy(), lo.astype(np.float32))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # the CUDA kernel's integer unpack gives the same values
    b = torch.from_numpy(packed).int()
    np.testing.assert_array_equal((b >> 4).numpy(), hi)
    np.testing.assert_array_equal(((b & 15) - 8).numpy(), lo)
    np.testing.assert_array_equal(tda._pack4(torch.cat([th, tl], 0), 0).numpy(), packed)


@pytest.mark.parametrize("idx", [10, 133, 8, 15, 135, 7])
def test_int4_decode_matches_jax_kernel(idx):
    """ctx to 2e-5 (float32); the cache bit-equal over positions < c0 + G,
    unchanged on non-seal steps, and other layers untouched."""
    q, k4, v4, ks, vs, ring = _inputs(1)
    jctx, jkv, js, tctx, tkv, ts = _run_both(idx, q, k4, v4, ks, vs, ring)
    np.testing.assert_allclose(tctx, jctx, atol=2e-5)
    c0 = idx - idx % G
    for a, b in _columns(jkv, js, tkv, ts):
        np.testing.assert_array_equal(b.numpy()[..., :c0 + G], np.asarray(a)[..., :c0 + G])
    tk, tv = tda.columns_from_fused(torch.from_numpy(tkv))
    if idx % G != G - 1:
        np.testing.assert_array_equal(tk.numpy(), k4)
        np.testing.assert_array_equal(tv.numpy(), v4)
        np.testing.assert_array_equal(ts, tda.fused_from_columns(
            torch.from_numpy(ks), torch.from_numpy(vs)).numpy())
    else:  # the seal wrote the group
        assert not np.array_equal(tk.numpy()[1, ..., c0:c0 + G], k4[1, ..., c0:c0 + G])
    np.testing.assert_array_equal(tk.numpy()[[0, 2]], k4[[0, 2]])
    np.testing.assert_array_equal(tv.numpy()[[0, 2]], v4[[0, 2]])


@pytest.mark.parametrize("idx", [133, 135])
def test_int4_decode_bf16_query_stays_float32(idx):
    """With a packed cache the JAX kernel computes in float32 even for a
    bfloat16 query: the port's context equals its float32 run on the
    bf16-rounded query, rounded once to bf16, and the JAX kernel's within
    one bf16 ulp of the context."""
    q, k4, v4, ks, vs, ring = _inputs(3)
    jctx, jkv, js, tctx, tkv, ts = _run_both(idx, q, k4, v4, ks, vs, ring, qdtype="bf16")
    np.testing.assert_allclose(tctx, jctx, atol=2e-2)
    qr = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    _, _, _, f32ctx, _, _ = _run_both(idx, qr, k4, v4, ks, vs, ring)
    np.testing.assert_array_equal(
        tctx, torch.from_numpy(f32ctx).to(torch.bfloat16).float().numpy())
    c0 = idx - idx % G
    for a, b in _columns(jkv, js, tkv, ts):
        np.testing.assert_array_equal(b.numpy()[..., :c0 + G], np.asarray(a)[..., :c0 + G])


def test_int4_seal_c0_on_window_boundary():
    """index 135: c0 = 128 is window 1's first lane.  The group lands in
    lanes [0, 8) of window 1 bit-equal to the JAX seal, its scales are the
    ring columns' absmax x float32(1/7), and window 1's other lanes keep
    their bytes."""
    q, k4, v4, ks, vs, ring = _inputs(5)
    idx, li = 135, 1
    jctx, jkv, js, tctx, tkv, ts = _run_both(idx, q, k4, v4, ks, vs, ring, li=li)
    for a, b in _columns(jkv, js, tkv, ts):
        np.testing.assert_array_equal(b.numpy()[..., 128:136], np.asarray(a)[..., 128:136])
    tk, tv = tda.columns_from_fused(torch.from_numpy(tkv))
    np.testing.assert_array_equal(tk.numpy()[li, ..., 136:], k4[li, ..., 136:])
    np.testing.assert_array_equal(tv.numpy()[li, ..., :128], v4[li, ..., :128])
    tks, _ = tda.columns_from_fused(torch.from_numpy(ts))
    want = np.maximum(np.abs(ring[li, :, :, 0]).max(-1), np.float32(1e-8)) * np.float32(1 / 7)
    np.testing.assert_array_equal(tks.numpy()[li, ..., 128:136], want.transpose(1, 2, 0))


def test_int4_pack_after_scatter():
    """The seal quantizes every ring column, clips to [-7, 7] and packs
    row d2 with row d2 + D/2: each sealed byte equals quantize_kv4 of its
    column, and unpacking recovers the clipped values."""
    q, k4, v4, ks, vs, ring = _inputs(7)
    ring[1, 3, :, 1, :, 0] = 1e-9  # a tiny value in a column with a large absmax
    idx, li = 2 * G - 1, 1
    c0 = G
    jctx, jkv, js, tctx, tkv, ts = _run_both(idx, q, k4, v4, ks, vs, ring, li=li)
    tk, tv = tda.columns_from_fused(torch.from_numpy(tkv))
    for a, b in _columns(jkv, js, tkv, ts):
        np.testing.assert_array_equal(b.numpy()[..., c0:c0 + G], np.asarray(a)[..., c0:c0 + G])
    for t, got in ((0, tk), (1, tv)):
        for g in range(G):
            col = torch.from_numpy(ring[li, g, :, t]).reshape(B, N * D, 1)
            want, _ = tda.quantize_kv4(col, N)
            np.testing.assert_array_equal(got.numpy()[li, ..., c0 + g], want[..., 0].numpy())
    hi, lo = tda._unpack4(tk[li, ..., c0:c0 + G])
    assert hi.abs().max() <= 7 and lo.abs().max() <= 7


def test_int4_wrapper_shape_checks():
    """A cache whose column width is neither D nor D/2 is refused on the
    card; on the CPU the plain version runs."""
    q, k4, v4, ks, vs, ring = _inputs(4)
    tring = tda.fuse_ring(torch.from_numpy(ring))
    tkv = tda.fused_from_columns(torch.from_numpy(k4), torch.from_numpy(v4))
    ts = tda.fused_from_columns(torch.from_numpy(ks), torch.from_numpy(vs))
    out = tda.decode_attention_quant(torch.from_numpy(q), tring[0], tkv[0], ts[0], 20)
    assert out.shape == (B, N, D)
    with pytest.raises(ValueError):
        tda.decode_attention_quant(torch.from_numpy(q).to("meta"), tring[0], tkv[0], ts[0], 20)


def test_kv_codec_reads_the_format_off_the_cache_width():
    """The cache view's column width picks the quantize/dequantize pair:
    D is int8, D/2 the packed int4 cache; any other width raises, in the
    plain version too."""
    view = lambda dc: torch.zeros((2, B, 2, N, dc, tda.WRITE_WINDOW), dtype=torch.int8)
    assert tda.kv_codec(view(D), D) == (tda.quantize_kv, tda.dequantize_kv)
    assert tda.kv_codec(view(D // 2), D) == (tda.quantize_kv4, tda.dequantize_kv4)
    with pytest.raises(ValueError):
        tda.kv_codec(view(D // 4), D)
    q, _, _, _, _, ring = _inputs(4)
    with pytest.raises(ValueError):
        tda.decode_attention_quant(torch.from_numpy(q), tda.fuse_ring(torch.from_numpy(ring))[0],
                                   view(D // 4), torch.ones((2, B, 2, N, tda.WRITE_WINDOW)), 20)


# --------------------------------------------------------------------- #
# the tiny model through the int4 and the bfloat16 caches
# --------------------------------------------------------------------- #

MB, MS, CTX = 2, 32, 12


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny()
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(5)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.05), jparams)
    tokens = np.random.RandomState(1).randint(0, 128, (MB, MS)).astype(np.int32)
    return jparams, gpt_params_from_jax(jax.tree.map(np.asarray, jparams)), tokens


@pytest.mark.parametrize("kv", ["int4", "bfloat16"])
def test_tiny_model_cache_prefill_and_decode_match(weights, kv):
    """Prefill 12 + 20 decode steps (two seals on the int4 cache): float32
    logits within 1e-5 of JAX forward_with_cache, whose prefill runs jitted
    as the JAX sampler runs it.  The int4 cache bytes equal over the sealed
    positions; the bfloat16 cache (float32 here, the compute dtype) within
    float32 rounding of the K/V projections.

    The two frameworks' K/V projections differ in the last float32 bits, so
    a value within that distance of a rounding tie can quantize to the next
    int4 step and move later logits by about 1e-4; the byte comparison
    below would show such a flip.  These tokens give none."""
    jparams, tparams, tokens = weights
    jcfg = jax_tiny(kv_cache_dtype=kv, compute_dtype=jnp.float32)
    cfg = tiny_test(kv_cache_dtype=kv)
    pos = jnp.broadcast_to(jnp.arange(MS, dtype=jnp.int32), (MB, MS))
    jcache = jgpt.init_cache(jcfg, MB, MS)
    prefill = jax.jit(lambda p, t, ps, c: jgpt.forward_with_cache(p, jcfg, t, ps, c, 0))
    lg, jcache = prefill(jparams, jnp.asarray(tokens[:, :CTX]), pos[:, :CTX], jcache)
    want = [np.asarray(lg)]
    step = jax.jit(jgpt.forward_with_cache, static_argnums=(1,))
    for t in range(CTX, MS):
        lg, jcache = step(jparams, jcfg, jnp.asarray(tokens[:, t:t + 1]), pos[:, t:t + 1],
                          jcache, jnp.int32(t))
        want.append(np.asarray(lg))
    want = np.concatenate(want, axis=1)

    tk = torch.from_numpy(tokens).long()
    tpos = torch.arange(MS).expand(MB, MS)
    cache = gpt.init_cache(cfg, MB, MS)
    got = [gpt.forward_with_cache(tparams, cfg, tk[:, :CTX], tpos[:, :CTX], cache, 0)]
    for t in range(CTX, MS):
        got.append(gpt.forward_with_cache(tparams, cfg, tk[:, t:t + 1], tpos[:, t:t + 1],
                                          cache, t))
    got = torch.cat(got, dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

    if kv == "int4":
        assert tuple(cache.kv.shape) == tuple(jcache.kv.shape) == (2, 1, MB, 2, 8, 4, 128)
        upto = (MS - 1) - (MS - 1) % G
        for a, b in zip(jda.columns_from_fused(jcache.kv), tda.columns_from_fused(cache.kv)):
            np.testing.assert_array_equal(b.numpy()[..., :upto], np.asarray(a)[..., :upto])
        np.testing.assert_allclose(cache.recent.numpy(), np.asarray(jcache.recent), atol=1e-5)
    else:
        assert tuple(cache.k.shape) == tuple(jcache.k.shape) == (2, MB, 64, MS)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-5)
        np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=1e-5)


def test_bf16_cache_allows_prefill_after_decode(weights):
    """The exact cache has no sequencing contract: a chunk after decode
    steps gives the logits of one forward over the whole sequence."""
    _, tparams, tokens = weights
    cfg = tiny_test(kv_cache_dtype="bfloat16")
    tk = torch.from_numpy(tokens).long()
    pos = torch.arange(MS).expand(MB, MS)
    cache = gpt.init_cache(cfg, MB, MS)
    gpt.forward_with_cache(tparams, cfg, tk[:, :4], pos[:, :4], cache, 0)
    gpt.forward_with_cache(tparams, cfg, tk[:, 4:5], pos[:, 4:5], cache, 4)
    got = gpt.forward_with_cache(tparams, cfg, tk[:, 5:MS], pos[:, 5:MS], cache, 5)
    want = gpt.forward(tparams, cfg, tk)[:, 5:]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_generate_once_int4_matches_jax(monkeypatch):
    """text2image through the int4 cache on the tiny float32 model: the same
    tokens as the JAX package, given the JAX package's chunk seeds."""
    from cogview_tpu.generation import sampling as js
    from cogview_tpu.generation import tasks as jtasks
    from cogview_tpu.models import vqvae as jvq
    from cogview_tpu.ops.hash_prng import seed_from_key
    from cogview_tpu.tokenization.unified import UnifiedTokenizer as JaxUnified
    from cogview_tpu.tokenization.vq_tokenizer import JaxVQTokenizer
    from cogview_tpu.utils.rng import rbg_key
    from cogview_tpu_torch.config import VQVAEConfig
    from cogview_tpu_torch.generation import sampling as ts
    from cogview_tpu_torch.generation import tasks as ttasks
    from cogview_tpu_torch.models.bridge import vqvae_params_from_jax
    from cogview_tpu_torch.tokenization.unified import UnifiedTokenizer
    from cogview_tpu_torch.tokenization.vq_tokenizer import TorchVQTokenizer

    class TinyTextTok:
        num_tokens = 64

        def encode(self, s):
            return [ord(c) % 64 for c in s]

        def decode(self, ids):
            return "".join(chr(97 + (i % 26)) for i in ids)

    small = dict(channel=16, embed_dim=8, n_embed=32)
    jcfg = jax_tiny(kv_cache_dtype="int4", max_position_embeddings=1088)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    jvqp = jvq.init_params(jax.random.PRNGKey(1), jvq.VQVAEConfig(**small))
    jtok = JaxUnified(img_tokenizer=JaxVQTokenizer(jvqp, jvq.VQVAEConfig(**small)),
                      txt_tokenizer=TinyTextTok())
    seed = 5
    want = jtasks.generate_once(jparams, jcfg, jtok, "ab cd", "text2image", num=2,
                                max_inference_batch_size=2,
                                sampling=js.SamplingParams(top_k=20, seed=seed))
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    monkeypatch.setattr(ttasks, "_chunk_seed",
                        lambda s, i: int(seed_from_key(rbg_key(sub))))
    ttok = UnifiedTokenizer(
        img_tokenizer=TorchVQTokenizer(vqvae_params_from_jax(jax.tree.map(np.asarray, jvqp)),
                                       VQVAEConfig(**small)),
        txt_tokenizer=TinyTextTok())
    got = ttasks.generate_once(gpt_params_from_jax(jax.tree.map(np.asarray, jparams)),
                               tiny_test(max_position_embeddings=1088, kv_cache_dtype="int4"),
                               ttok, "ab cd", "text2image", num=2, max_inference_batch_size=2,
                               sampling=ts.SamplingParams(top_k=20, seed=seed))
    assert got.tokens.shape == want.tokens.shape == (2, 1032)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
