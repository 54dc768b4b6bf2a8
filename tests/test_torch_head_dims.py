"""Port parity at the head dims past {16, 32, 64, 128}: the plain version of
the decode kernels, and a tiny GPT's train step and cached decode, against
the JAX package on the CPU (its Pallas kernels in interpret mode), float32;
and the wrappers' choice of the CUDA kernels' tile width and library for
every head dim up to 256.  The flash plain versions' cases at these dims
are in tests/test_torch_flash_attention.py and test_torch_flash_backward.py.

The CUDA kernels themselves run every D up to 256 on a card (each built
for tile widths, the real D a run-time argument); they are held to these
plain versions there by tests/test_torch_kernels_cuda.py and phase 5b of
chip_smoke.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops import decode_attention as jda
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.training import losses as jlosses
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.models import gpt
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, gpt_params_to_numpy
from cogview_tpu_torch.ops import decode_attention as tda
from cogview_tpu_torch.ops import flash_attention as tfa
from cogview_tpu_torch.training import losses, optim

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_decode_split import split_merge  # noqa: E402

torch.set_num_threads(1)

G, W = tda.SEAL_GROUP, tda.WRITE_WINDOW

# --------------------------------------------------------------------- #
# decode attention
# --------------------------------------------------------------------- #

DL, DB, DN, NW = 2, 2, 4, 4  # layers, batch, heads, windows of the decode cases
DECODE_DIMS = (24, 80, 100, 256)


def _decode_inputs(packed, d, seed=0):
    """Numpy layers in the JAX package's column form (q, K/V bytes, scales,
    the split ring) at head dim d; dequantized values stay within about 1.3."""
    rng = np.random.RandomState(seed + d)
    T, Dc = NW * W, d // 2 if packed else d
    q = rng.randn(DB, DN, d).astype(np.float32)
    if packed:  # bytes the packer makes: 16 * hi + lo + 8, hi, lo in [-7, 7]
        k, v = ((16 * rng.randint(-7, 8, (DL, DB, DN, Dc, T))
                 + rng.randint(-7, 8, (DL, DB, DN, Dc, T)) + 8).astype(np.int8)
                for _ in range(2))
        smax = 0.18
    else:
        k, v = (rng.randint(-127, 128, (DL, DB, DN, Dc, T)).astype(np.int8) for _ in range(2))
        smax = 0.01
    ks, vs = ((rng.rand(DL, DB, DN, T) * smax).astype(np.float32) for _ in range(2))
    ring = rng.randn(DL, G, DB, 2, DN, d).astype(np.float32)
    return q, k, v, ks, vs, ring


_JAX_CTX = {}


def _jax_ctx(packed, d, index):
    key = (packed, d, index)
    if key not in _JAX_CTX:
        q, k, v, ks, vs, ring = _decode_inputs(packed, d)
        ctx, _, _ = jda.decode_attention_quant(
            jnp.asarray(q), jda.fuse_ring(ring),
            jda.fused_from_columns(jnp.asarray(k), jnp.asarray(v)),
            jda.fused_from_columns(jnp.asarray(ks), jnp.asarray(vs)), 1, index, head_block=4)
        _JAX_CTX[key] = np.asarray(ctx)
    return _JAX_CTX[key]


@pytest.mark.parametrize("splits", range(1, NW + 1))
@pytest.mark.parametrize("index", [135, 300])
@pytest.mark.parametrize("d", DECODE_DIMS)
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_decode_matches_jax_kernel_at_every_split_count(packed, d, index, splits):
    """The port's plain decode (int8 and int4 caches) and the kernels'
    split-and-merge arithmetic at every split count against the JAX kernel
    in interpret mode, float32, within 1e-5: index 135 seals on a window
    boundary, 300 leaves a split of 4 without a window."""
    q, k, v, ks, vs, ring = _decode_inputs(packed, d)
    q_t = torch.from_numpy(q)
    ring_l = tda.fuse_ring(torch.from_numpy(ring))[1]
    kv_l = tda.fused_from_columns(torch.from_numpy(k), torch.from_numpy(v))[1]
    sc_l = tda.fused_from_columns(torch.from_numpy(ks), torch.from_numpy(vs))[1]
    want = _jax_ctx(packed, d, index)
    got = tda.decode_attention_quant(q_t, ring_l.clone(), kv_l.clone(), sc_l.clone(), index,
                                     splits=splits)
    merged = split_merge(q_t, ring_l, kv_l, sc_l, index, splits)
    assert got.shape == merged.shape == (DB, DN, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(merged.numpy(), want, atol=1e-5, rtol=0)


def test_int4_refuses_an_odd_head_dim_as_the_card_does():
    """The packed cache holds D / 2 columns, so an odd D has no room for its
    last value: the plain version raises the ValueError the CUDA wrapper
    raises (both read the format through ``is_packed``)."""
    q, _, _, _, _, ring = _decode_inputs(False, 33)
    kv = torch.zeros((NW, DB, 2, DN, 16, W), dtype=torch.int8)
    with pytest.raises(ValueError, match="odd head_dim 33"):
        tda.decode_attention_quant(torch.from_numpy(q), tda.fuse_ring(torch.from_numpy(ring))[0],
                                   kv, torch.ones((NW, DB, 2, DN, W)), 20)


# --------------------------------------------------------------------- #
# the CUDA kernels' tile widths
# --------------------------------------------------------------------- #


def test_every_head_dim_up_to_256_has_a_tile_width():
    """For every D from 1 to 256 each wrapper picks the narrowest tile width
    its kernels are built for that holds D (the .cu switches are held to
    the tuples by the dispatch tests); past 256 both raise."""
    for widths, pick in ((tfa.TILE_WIDTHS, tfa.tile_width), (tda.TILE_WIDTHS, tda.tile_width)):
        for d in range(1, 257):
            t = pick(d)
            assert t in widths and t >= d
            assert all(w < d for w in widths if w < t)
        with pytest.raises(NotImplementedError, match="head_dim 257"):
            pick(257)
    assert [tfa.tile_width(d) for d in (8, 33, 64, 80, 100, 200, 256)] == [
        16, 64, 64, 96, 128, 224, 256]
    assert [tda.tile_width(d) for d in (8, 24, 64, 100, 256)] == [8, 32, 64, 128, 256]


def test_flash_calls_go_to_the_library_of_their_tile():
    """A head dim equal to a tile width of the exact library with 16-byte
    copies runs that library's kernels, D and the copy width constants (the
    code D = 16, 32, 64 and 128 always ran); every other call the library
    that holds its tile with D at run time."""
    exact = tfa.EXACT_LIBRARY
    for d in range(1, 257):
        t = tfa.tile_width(d)
        for width in (16, 8, 4, 2):
            lib = tfa._library(d, t, width)
            assert t in tfa.LIBRARIES[lib]
            assert (lib == exact) == (d == t and width == 16 and t in tfa.LIBRARIES[exact])
    assert tfa._library(64, 64, 16) == exact and tfa._library(100, 128, 8) != exact


@pytest.mark.parametrize("d,dtype,width", [(64, torch.bfloat16, 16), (100, torch.bfloat16, 8),
                                           (33, torch.bfloat16, 2), (100, torch.float32, 16),
                                           (33, torch.float32, 4)])
def test_copy_width_follows_the_head_layout(d, dtype, width):
    """The flash kernels copy with the widest of 16, 8, 4 and 2 bytes that
    every pointer, stride and head of the q, k and v slices of a fused
    projection allow: bf16 D = 100 has 200-byte heads (8), odd D plain
    2-byte loads in bf16 and 4-byte ones in float32."""
    qkv = torch.zeros((2, 5, 3, 4 * d), dtype=dtype)
    views = [qkv[:, :, i].reshape(2, 5, 4, d) for i in range(3)]
    assert tfa.copy_width(views, d) == width


# --------------------------------------------------------------------- #
# a tiny GPT at D = 100 and D = 24
# --------------------------------------------------------------------- #

MB, MS, CTX = 2, 32, 12
IMG_VOCAB = 64
TINY_DIMS = {100: dict(hidden_size=200, num_heads=2), 24: dict(hidden_size=96, num_heads=4)}


def _tiny_weights(d, **kw):
    jcfg = jax_tiny(**TINY_DIMS[d], **kw)
    assert jcfg.hidden_size // jcfg.num_heads == d
    jparams = jgpt.init_params(jax.random.PRNGKey(d), jcfg)
    rng = np.random.RandomState(5)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.05), jparams)
    return jcfg, jparams, gpt_params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("d", sorted(TINY_DIMS))
def test_tiny_gpt_train_loss_and_grads_match_jax(d):
    """A training step's loss and every gradient leaf of a 2-layer GPT
    through the flash route with the three dropouts at 0.1 (JAX: the Pallas
    kernels in interpret mode; port: the plain versions), float32, the port
    handed the dropout seeds JAX derives from its key (as the train step
    test of tests/test_torch_training.py): loss within 1e-5 relative, each
    leaf within 1e-5 of its largest magnitude (the two sum in different
    orders)."""
    drop = dict(embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1,
                use_flash_attention=True)
    jcfg, jparams, tparams = _tiny_weights(d, **drop)
    cfg = tiny_test(**TINY_DIMS[d], **drop)
    rng = np.random.RandomState(d)
    batch = {"text": rng.randint(0, 128, (MB, 64)).astype(np.int32),
             "loss_mask": (rng.rand(MB, 64) > 0.1).astype(np.float32)}
    key = rbg_key(jax.random.PRNGKey(d))
    r_layers, r_embed = jax.random.split(key)
    seeds = [int(seed_from_key(r_embed))] + [
        int(seed_from_key(r)) for r in jax.random.split(r_layers, cfg.num_layers)]
    kw = dict(img_vocab=IMG_VOCAB, txt_loss_scale=1.0, remat=False)

    def jloss(p):
        return jlosses.lm_loss(p, jcfg, batch, rng=key, train=True, **kw)[0]

    want_loss, want_grads = jax.value_and_grad(jloss)(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = list(optim.tree_leaves(tparams))
    for leaf in leaves:
        leaf.requires_grad_()
    calls = tfa.flash_attention_reference.calls
    loss, _ = losses.lm_loss(tparams, cfg, tb, train=True, seeds=seeds, **kw)
    assert tfa.flash_attention_reference.calls - calls == cfg.num_layers
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = {jax.tree_util.keystr(p): g for (p, _), g in zip(
        jax.tree_util.tree_leaves_with_path(gpt_params_to_numpy(tparams)),
        [g.numpy() for g in grads])}
    for path, w in jax.tree_util.tree_leaves_with_path(want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)], w,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("d", sorted(TINY_DIMS))
def test_tiny_gpt_cached_decode_matches_jax(d, kv):
    """Prefill 12 + 20 decode steps (two seals) of a 2-layer GPT through the
    int8 and the int4 cache, float32 logits within 1e-4 of JAX's
    forward_with_cache (as the int8 test of tests/test_torch_gpt.py: the
    two frameworks' K/V projections differ in the last float32 bits, and a
    value at a rounding tie may quantize one step apart)."""
    jcfg, jparams, tparams = _tiny_weights(d)
    jcfg = jcfg.replace(kv_cache_dtype=kv, compute_dtype=jnp.float32)
    cfg = tiny_test(**TINY_DIMS[d], kv_cache_dtype=kv)
    tokens = np.random.RandomState(1).randint(0, 128, (MB, MS)).astype(np.int32)
    pos = jnp.broadcast_to(jnp.arange(MS, dtype=jnp.int32), (MB, MS))
    jcache = jgpt.init_cache(jcfg, MB, MS)
    lg, jcache = jgpt.forward_with_cache(jparams, jcfg, jnp.asarray(tokens[:, :CTX]),
                                         pos[:, :CTX], jcache, 0)
    want = [np.asarray(lg)]
    step = jax.jit(jgpt.forward_with_cache, static_argnums=(1,))
    for t in range(CTX, MS):
        lg, jcache = step(jparams, jcfg, jnp.asarray(tokens[:, t:t + 1]), pos[:, t:t + 1],
                          jcache, jnp.int32(t))
        want.append(np.asarray(lg))

    tk = torch.from_numpy(tokens).long()
    tpos = torch.arange(MS).expand(MB, MS)
    cache = gpt.init_cache(cfg, MB, MS)
    Dc = d // 2 if kv == "int4" else d
    assert cache.kv.shape[5] == Dc and tuple(cache.kv.shape) == tuple(jcache.kv.shape)
    calls = tda.decode_attention_quant_reference.calls
    got = [gpt.forward_with_cache(tparams, cfg, tk[:, :CTX], tpos[:, :CTX], cache, 0)]
    for t in range(CTX, MS):
        got.append(gpt.forward_with_cache(tparams, cfg, tk[:, t:t + 1], tpos[:, t:t + 1],
                                          cache, t))
    assert tda.decode_attention_quant_reference.calls - calls == (MS - CTX) * cfg.num_layers
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), np.concatenate(want, axis=1),
                               atol=1e-4)
