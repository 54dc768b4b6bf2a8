"""Port parity: the plain PyTorch flash-attention forward (the CUDA kernels'
twin) against cogview_tpu's Pallas kernel, which runs in interpret mode on
the CPU, float32, atol 1e-5 (the two sum in different orders), and in
bfloat16, the tensor-core kernel's working type (o 2e-2, lse 1e-4).

The cases are those of tests/test_flash_attention.py: causal, a
bidirectional prefix, a prefix past the block size, and hash dropout with a
prefix.  The kernels themselves are compared with the plain version on a
card by tests/test_torch_kernels_cuda.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cogview_tpu.ops import flash_attention as jfa
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.models.gpt import should_use_flash
from cogview_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

B, N, D = 2, 3, 32


def _mk(s, seed=0, d=D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, s, N, d).astype(np.float32) for _ in range(3)]


def _both(s, sep, bq, bk, seed, rate=0.0, dropout_seed=None, d=D):
    q, k, v = _mk(s, seed, d)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), sep, bq, bk, True,
                               dropout_rate=rate, dropout_seed=dropout_seed)
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), sep,
                                 dropout_rate=rate, dropout_seed=dropout_seed)
    assert tfa.flash_attention.launches == before  # CPU: the plain version
    assert o.shape == (B, s, N, d) and o.dtype == torch.float32
    assert lse.shape == (B, N, s) and lse.dtype == torch.float32
    return o.numpy(), np.asarray(want), lse.numpy(), (q, k, v)


@pytest.mark.parametrize("s,bq,bk", [(128, 64, 64), (200, 64, 64), (96, 32, 64)])
def test_forward_matches_jax_kernel(s, bq, bk):
    got, want, _, _ = _both(s, 0, bq, bk, seed=0)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("d,s,sep,rate", [(16, 128, 0, 0.0), (16, 150, 20, 0.3),
                                         (64, 200, 37, 0.0), (64, 128, 0, 0.1),
                                         (128, 96, 0, 0.0), (128, 130, 64, 0.2)]
                         + [(d, s, sep, rate) for d in (8, 33, 80, 100, 256)
                            for s, sep, rate in ((77, 0, 0.0), (130, 40, 0.2))])
def test_forward_matches_jax_kernel_at_other_head_dims(d, s, sep, rate):
    """Other head dims than the cases above (D = 32), two cases each, one
    with dropout: 16, 64 and 128, and D = 8 (in the kernels' 16-wide tile),
    33 (odd: 66-byte bf16 heads), 80, 100 (LlamaGen's 3.1B GPT, 3,200 wide
    with 32 heads) and 256, the widest."""
    got, want, _, _ = _both(s, sep, 64, 64, seed=d, rate=rate,
                            dropout_seed=55 if rate else None, d=d)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("sep,rate", [(0, 0.0), (37, 0.0), (0, 0.1), (37, 0.1)])
def test_bf16_forward_matches_jax_kernel(sep, rate):
    """bfloat16 inputs, the working type of the tensor-core kernel: the
    port's plain forward against the Pallas kernel in interpret mode on the
    same bf16 values, D = 64, S = 200.  Both sum products of bf16 values in
    float32 and round p to bf16 before p.v, but after different maxima (the
    Pallas kernel its running one, the plain version the row's), and o is
    bf16, so o agrees within 2e-2 (a few bf16 ulps of |o| < 4).  lse is
    float32 from the same products and agrees within 1e-4."""
    s, d, dseed = 200, 64, 55 if rate else None
    q, k, v = _mk(s, seed=21, d=d)
    seed = jnp.asarray([dseed or 0], dtype=jnp.uint32)
    want_o, res = jfa._flash_fwd_impl(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)),
                                      seed, sep, 64, 64, True, rate)
    want_lse = np.asarray(res[5])[:, :, :s, 0]
    o, lse = tfa.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                 sep, dropout_rate=rate, dropout_seed=dseed)
    assert o.dtype == torch.bfloat16 and o.shape == (B, s, N, d) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), np.asarray(want_o, dtype=np.float32), atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-4)


@pytest.mark.parametrize("library", sorted(tfa.LIBRARIES))
def test_head_dims_match_the_kernels_dispatch(library):
    """Each flash library's source (csrc/<library>.cu) instantiates, in its
    ``with_tile_width`` switch, exactly the tile widths ``LIBRARIES`` gives
    it, and only EXACT_LIBRARY's is built for D equal to the tile width
    (``EXACT_TILES``), so the wrapper and the C entry points cannot drift
    apart; together they are TILE_WIDTHS, every width a multiple of 16 up to 256 (wgmma's
    k-step and widest product) and past 16 a multiple of 32 (the float32
    kernels' columns: 8 threads of 4-wide vectors)."""
    src = (Path(tfa.__file__).resolve().parent.parent / "csrc" / f"{library}.cu").read_text()
    body = src[src.index("cudaError_t with_tile_width("):]
    body = body[:body.index("default:")]
    pairs = re.findall(r"case (\d+): return f\(std::integral_constant<int, (\d+)>", body)
    assert pairs and all(a == b for a, b in pairs)
    assert tuple(sorted(int(a) for a, _ in pairs)) == tfa.LIBRARIES[library]
    exact = re.search(r"constexpr bool EXACT_TILES = (true|false);", src).group(1)
    assert (exact == "true") == (library == tfa.EXACT_LIBRARY)
    assert tfa.TILE_WIDTHS == tuple(sorted({w for ws in tfa.LIBRARIES.values() for w in ws}))
    assert all(w % 16 == 0 and w <= 256 and (w == 16 or w % 32 == 0) for w in tfa.TILE_WIDTHS)


def test_sep_prefix_matches_jax_kernel():
    got, want, _, _ = _both(128, 37, 64, 64, seed=1)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("s,sep,bq,bk", [(192, 100, 32, 32), (256, 180, 64, 64)])
def test_sep_larger_than_block_matches_jax_kernel(s, sep, bq, bk):
    got, want, _, _ = _both(s, sep, bq, bk, seed=7)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("s,sep,rate", [(128, 0, 0.1), (150, 20, 0.4)])
def test_dropout_matches_jax_kernel(s, sep, rate):
    got, want, _, _ = _both(s, sep, 64, 64, seed=11, rate=rate, dropout_seed=123)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got == 0).mean() < 0.5 + rate  # dropout did not zero everything


def test_dropout_keep_mask_bit_equal():
    for b, n in ((0, 0), (1, 2)):
        want = np.asarray(jfa.dropout_keep_reference(77, b, n, N, 40, 48, 0.3))
        got = tfa.dropout_keep_reference(77, b, n, N, 40, 48, 0.3).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.6 < got.mean() < 0.8


@pytest.mark.parametrize("sep,rate", [(0, 0.0), (30, 0.0), (30, 0.25)])
def test_lse_matches_numpy_logsumexp(sep, rate):
    """lse = logsumexp of the masked, scaled logits, before dropout, to 1e-5."""
    s = 96
    _, _, lse, (q, k, _) = _both(s, sep, 32, 32, seed=3, rate=rate,
                                 dropout_seed=9 if rate else None)
    logits = np.einsum("bqnd,bknd->bnqk", q.astype(np.float64), k) / np.sqrt(D)
    pos = np.arange(s)
    visible = (pos[None, :] <= pos[:, None]) | (pos[None, :] < sep)
    logits = np.where(visible, logits, -10000.0)
    m = logits.max(-1, keepdims=True)
    want = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse, want, atol=1e-5)


@pytest.mark.parametrize("flag", [True, False, "auto"])
def test_should_use_flash_grid(flag):
    cfg = tiny_test(use_flash_attention=flag, flash_min_seq=1024)
    for seq_len in (1, 40, 1023, 1024, 1058, 1089):
        want = flag is True or (flag == "auto" and seq_len >= 1024)
        assert should_use_flash(cfg, seq_len) == want, (flag, seq_len)


def test_dropout_needs_a_seed_and_a_rate_below_one():
    q, k, v = (torch.from_numpy(a) for a in _mk(16))
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="outside"):
        tfa.flash_attention(q, k, v, dropout_rate=1.0, dropout_seed=1)
