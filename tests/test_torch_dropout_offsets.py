"""Dropout of a shard hashes global coordinates: ``hash_dropout``'s block
``origin`` in a tensor of ``full_shape``, and the flash plain versions'
(batch offset, head offset, global heads).  A shard's mask and results
equal the matching block of the unsharded ones, the unsharded call is
unchanged, and both agree with the JAX package (its hash_dropout, its
flash kernel in interpret mode) on the whole tensor.  The CUDA kernels
take the same offsets; tests/test_torch_kernels_cuda.py holds them against
these plain versions on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cogview_tpu.ops import flash_attention as jfa
from cogview_tpu.ops import hash_prng as jh
from cogview_tpu_torch.ops import flash_attention as tfa
from cogview_tpu_torch.ops import hash_prng as th

torch.set_num_threads(1)


@pytest.mark.parametrize("full,origin,block", [
    ((4, 5, 6), (2,), (2, 5, 6)),  # rows over 'data'
    ((4, 6, 5, 7), (2, 3), (2, 3, 5, 7)),  # rows and heads, attention probabilities
    ((3, 8, 9), (1, 4, 0), (1, 4, 9)),
])
def test_hash_dropout_block_is_a_slice_of_the_unsharded_mask(full, origin, block):
    x = torch.from_numpy(np.random.RandomState(0).rand(*full).astype(np.float32))
    want = np.asarray(jh.hash_dropout(jnp.asarray(x.numpy()), 0.3, jnp.uint32(77), 5))
    np.testing.assert_array_equal(th.hash_dropout(x, 0.3, 77, 5).numpy(), want)
    sl = tuple(slice(o, o + b) for o, b in zip(list(origin) + [0] * 3, block))
    got = th.hash_dropout(x[sl].contiguous(), 0.3, 77, 5, origin=origin,
                          full_shape=full[:len(origin)])
    np.testing.assert_array_equal(got.numpy(), want[sl])


def test_hash_dropout_zero_origin_is_the_unsharded_call():
    x = torch.rand((3, 4, 5), generator=torch.Generator().manual_seed(1))
    a = th.hash_dropout(x, 0.25, 9, 2)
    b = th.hash_dropout(x, 0.25, 9, 2, origin=(0, 0, 0), full_shape=(3, 4, 5))
    assert torch.equal(a, b)


def test_hash_dropout_block_index_wraps_at_2_32():
    """A block far into a tensor of more than 2^32 elements hashes its
    flat index mod 2^32, as the JAX package's wrapping uint32 does."""
    full, origin = (70000, 70000), (65000, 123)
    x = torch.ones((2, 3))
    got = th.hash_dropout(x, 0.5, 3, 1, origin=origin, full_shape=full)
    flat = np.array([[((origin[0] + i) * full[1] + origin[1] + j) % 2 ** 32 for j in range(3)]
                     for i in range(2)], np.uint32)
    keep = np.asarray(jh.hash_u32(jnp.uint32(3), jnp.asarray(flat), jnp.uint32(1),
                                  jnp.uint32(0))) >= np.uint32(2 ** 31)
    np.testing.assert_array_equal(got.numpy() != 0, keep)


B, S, N, D = 4, 40, 4, 16
SEP, RATE, SEED = 7, 0.2, 4321


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, S, N, D).astype(np.float32)) for _ in range(4)]


@pytest.mark.parametrize("b0,n0,bl,nl", [(0, 0, 4, 4), (2, 2, 2, 2), (1, 0, 3, 2), (3, 1, 1, 3)])
def test_flash_plain_versions_of_a_shard_are_blocks_of_the_unsharded(b0, n0, bl, nl):
    """o, lse, dq, dk and dv of rows [b0, b0 + bl) and heads [n0, n0 + nl)
    with the offsets equal the unsharded results' block (1e-6: the block's
    einsums run at other batch shapes); the keep masks exactly."""
    q, k, v, do = _inputs()
    full_o, full_lse = tfa.flash_attention_reference(q, k, v, SEP, RATE, SEED)
    delta = (do * full_o).sum(-1).transpose(1, 2).contiguous()
    full_dq = tfa.flash_bwd_dq_reference(q, k, v, do, full_lse, delta, SEP, RATE, SEED)
    full_dk, full_dv = tfa.flash_bwd_dkv_reference(q, k, v, do, full_lse, delta, SEP, RATE,
                                                   SEED)
    rows, heads = slice(b0, b0 + bl), slice(n0, n0 + nl)
    blk = [t[rows, :, heads].contiguous() for t in (q, k, v, do)]
    off = (b0, n0, N)
    o, lse = tfa.flash_attention_reference(*blk[:3], SEP, RATE, SEED, off)
    np.testing.assert_allclose(o.numpy(), full_o[rows, :, heads].numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), full_lse[rows, heads].numpy(), atol=1e-6)
    dl = delta[rows, heads].contiguous()
    dq = tfa.flash_bwd_dq_reference(*blk, lse, dl, SEP, RATE, SEED, off)
    dk, dv = tfa.flash_bwd_dkv_reference(*blk, lse, dl, SEP, RATE, SEED, off)
    for got, want in ((dq, full_dq), (dk, full_dk), (dv, full_dv)):
        np.testing.assert_allclose(got.numpy(), want[rows, :, heads].numpy(), atol=1e-6)
    ones = torch.ones((B, N, S, S))
    full_keep = tfa._drop(ones, RATE, SEED) != 0
    keep = tfa._drop(ones[rows, heads], RATE, SEED, off) != 0
    assert torch.equal(keep, full_keep[rows, heads])
    for b in range(bl):
        for n in range(nl):
            assert torch.equal(keep[b, n], tfa.dropout_keep_reference(
                SEED, b0 + b, n0 + n, N, S, S, RATE))


def test_flash_shard_matches_the_jax_kernel_on_the_whole_batch():
    """The sharded forward through the autograd entry point against the
    JAX Pallas kernel (interpret mode) on the whole batch, 1e-5."""
    q, k, v, _ = _inputs(3)
    want = np.asarray(jfa.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), SEP,
                                          64, 64, True, dropout_rate=RATE,
                                          dropout_seed=SEED))
    for b0, n0 in ((0, 0), (2, 0), (0, 2), (2, 2)):
        rows, heads = slice(b0, b0 + 2), slice(n0, n0 + 2)
        o, _ = tfa.flash_attention(*(t[rows, :, heads] for t in (q, k, v)), SEP,
                                   dropout_rate=RATE, dropout_seed=SEED, batch_offset=b0,
                                   head_offset=n0, num_heads=N)
        np.testing.assert_allclose(o.numpy(), want[rows, :, heads], atol=1e-5)


def test_flash_zero_offsets_are_the_unsharded_call():
    q, k, v, _ = _inputs(5)
    a, la = tfa.flash_attention(q, k, v, SEP, dropout_rate=RATE, dropout_seed=SEED)
    b, lb = tfa.flash_attention(q, k, v, SEP, dropout_rate=RATE, dropout_seed=SEED,
                                batch_offset=0, head_offset=0, num_heads=N)
    assert torch.equal(a, b) and torch.equal(la, lb)
