"""Port parity: the plain PyTorch decode attention (the CUDA kernel's twin)
and the int8 cache helpers against cogview_tpu's Pallas kernel, which runs
in interpret mode on the CPU.

On seal steps the JAX kernel rewrites the whole target window; when c0 sits
on a window boundary its non-group lanes get stale staging bytes (positions
>= c0 + G, invisible until their own seal).  Cache bytes are therefore
compared over positions < c0 + G."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cogview_tpu.ops import decode_attention as jda
from cogview_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)

G = tda.SEAL_GROUP
L, B, N, D = 3, 2, 4, 16
T = tda.pad_cache_len(200)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, N, D).astype(np.float32)
    k8 = rng.randint(-127, 128, (L, B, N, D, T)).astype(np.int8)
    v8 = rng.randint(-127, 128, (L, B, N, D, T)).astype(np.int8)
    ks = (rng.rand(L, B, N, T) * 0.1).astype(np.float32)
    vs = (rng.rand(L, B, N, T) * 0.1).astype(np.float32)
    ring = rng.randn(L, G, B, 2, N, D).astype(np.float32)
    return q, k8, v8, ks, vs, ring


def _run_both(idx, q, k8, v8, ks, vs, ring, li=1, qdtype=np.float32):
    jq = jnp.asarray(q).astype(jnp.bfloat16 if qdtype == "bf16" else jnp.float32)
    jctx, jkv, js = jda.decode_attention_quant(
        jq, jda.fuse_ring(ring), jda.fused_from_columns(jnp.asarray(k8), jnp.asarray(v8)),
        jda.fused_from_columns(jnp.asarray(ks), jnp.asarray(vs)), li, idx, head_block=4)
    tq = torch.from_numpy(q).to(torch.bfloat16 if qdtype == "bf16" else torch.float32)
    tring = tda.fuse_ring(torch.from_numpy(ring))
    tkv = tda.fused_from_columns(torch.from_numpy(k8), torch.from_numpy(v8))
    ts = tda.fused_from_columns(torch.from_numpy(ks), torch.from_numpy(vs))
    before = tda.decode_attention_quant.launches
    tctx = tda.decode_attention_quant(tq, tring[li], tkv[li], ts[li], idx)
    assert tda.decode_attention_quant.launches == before  # CPU: plain version
    return (np.asarray(jctx.astype(jnp.float32)), np.asarray(jkv), np.asarray(js),
            tctx.float().numpy(), tkv.numpy(), ts.numpy())


@pytest.mark.parametrize("idx", [10, 133, 8, 15, 135, 7])
def test_decode_matches_jax_kernel(idx):
    """ctx to 2e-5 (float32); the cache bit-equal over positions < c0 + G,
    unchanged on non-seal steps, and other layers untouched."""
    q, k8, v8, ks, vs, ring = _inputs(1)
    jctx, jkv, js, tctx, tkv, ts = _run_both(idx, q, k8, v8, ks, vs, ring)
    np.testing.assert_allclose(tctx, jctx, atol=2e-5)
    c0 = idx - idx % G
    jk, jv = jda.columns_from_fused(jkv)
    tk, tv = tda.columns_from_fused(torch.from_numpy(tkv))
    jks, jvs = jda.columns_from_fused(js)
    tks, tvs = tda.columns_from_fused(torch.from_numpy(ts))
    for a, b in ((jk, tk), (jv, tv), (jks, tks), (jvs, tvs)):
        np.testing.assert_array_equal(b.numpy()[..., :c0 + G], np.asarray(a)[..., :c0 + G])
    if idx % G != G - 1:
        np.testing.assert_array_equal(tk.numpy(), k8)
        np.testing.assert_array_equal(tvs.numpy(), vs)
    else:  # the seal wrote the group
        assert not np.array_equal(tk.numpy()[1, ..., c0:c0 + G], k8[1, ..., c0:c0 + G])
    np.testing.assert_array_equal(tk.numpy()[[0, 2]], k8[[0, 2]])
    np.testing.assert_array_equal(tks.numpy()[[0, 2]], ks[[0, 2]])


@pytest.mark.parametrize("idx", [133, 135])
def test_decode_bf16_query_matches_jax_kernel(idx):
    """bfloat16 queries take the bf16 rounding points of the JAX kernel;
    the context is bf16, so the tolerance is a few bf16 ulps."""
    q, k8, v8, ks, vs, ring = _inputs(3)
    jctx, jkv, js, tctx, tkv, ts = _run_both(idx, q, k8, v8, ks, vs, ring, qdtype="bf16")
    np.testing.assert_allclose(tctx, jctx, atol=2e-2)
    c0 = idx - idx % G
    np.testing.assert_array_equal(
        tda.columns_from_fused(torch.from_numpy(tkv))[0].numpy()[..., :c0 + G],
        np.asarray(jda.columns_from_fused(jkv)[0])[..., :c0 + G])


def test_quantize_kv_bit_exact():
    rng = np.random.RandomState(0)
    cols = (rng.randn(2, 64, 37) * 3.0).astype(np.float32)
    cols[0, :16, 5] = 0.0  # an all-zero (head, token) group hits the 1e-8 floor
    j8, js = jda.quantize_kv(jnp.asarray(cols), 4)
    t8, ts = tda.quantize_kv(torch.from_numpy(cols), 4)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tda.dequantize_kv(t8, ts).numpy(),
                               np.asarray(jda.dequantize_kv(j8, js)), rtol=0, atol=0)


@pytest.mark.parametrize("index,S", [(0, 12), (100, 60), (250, 6)])
def test_scatter_and_gather_bit_exact(index, S):
    rng = np.random.RandomState(index)
    cache = rng.randint(-127, 128, (L, 3, B, 2, N, D, 128)).astype(np.int8)
    scales = rng.rand(L, 3, B, 2, N, 128).astype(np.float32)
    kc = rng.randint(-127, 128, (B, N, D, S)).astype(np.int8)
    vc = rng.randint(-127, 128, (B, N, D, S)).astype(np.int8)
    ksc = rng.rand(B, N, S).astype(np.float32)
    vsc = rng.rand(B, N, S).astype(np.float32)
    li = 2
    jc = jda.scatter_kv_columns(jnp.asarray(cache), jnp.asarray(kc), jnp.asarray(vc), li, index)
    js = jda.scatter_kv_scales(jnp.asarray(scales), jnp.asarray(ksc), jnp.asarray(vsc), li, index)
    tc, ts = torch.from_numpy(cache.copy()), torch.from_numpy(scales.copy())
    tda.scatter_kv_columns(tc[li], torch.from_numpy(kc), torch.from_numpy(vc), index)
    tda.scatter_kv_scales(ts[li], torch.from_numpy(ksc), torch.from_numpy(vsc), index)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for a, b in zip(jda.gather_kv(jc, li), tda.gather_kv(tc[li])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jda.gather_kv_scales(js, li), tda.gather_kv_scales(ts[li])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_wrapper_rejects_int4_layout_and_counts_plain_calls():
    q, k8, v8, ks, vs, ring = _inputs(4)
    tring = tda.fuse_ring(torch.from_numpy(ring))
    tkv = tda.fused_from_columns(torch.from_numpy(k8), torch.from_numpy(v8))
    ts = tda.fused_from_columns(torch.from_numpy(ks), torch.from_numpy(vs))
    calls = tda.decode_attention_quant_reference.calls
    tda.decode_attention_quant(torch.from_numpy(q), tring[0], tkv[0], ts[0], 20)
    assert tda.decode_attention_quant_reference.calls == calls + 1
    with pytest.raises(ValueError):
        tda.decode_attention_quant(torch.from_numpy(q).to("meta"), tring[0], tkv[0], ts[0], 20)
