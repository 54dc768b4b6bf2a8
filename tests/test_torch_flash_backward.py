"""Port parity: the flash-attention backward (dq, dk, dv) of the port on the
CPU, through its ``torch.autograd.Function`` and the plain versions of the
dq and dk/dv kernels, against ``jax.vjp`` of cogview_tpu's Pallas flash
attention in interpret mode.  float32, within 1e-5: the two sum in
different orders (the JAX kernels block by block, the plain versions over
whole rows).

The cases are those of tests/test_flash_attention.py's backward tests:
causal, a ragged length, a prefix inside a tile, a prefix across tiles,
asymmetric JAX blocks, and hash dropout with a fixed seed, at D = 32; and
two cases (one with dropout) at D = 16, 64 and 128 and at 8, 33, 80, 100
and 256."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.ops import flash_attention as jfa
from cogview_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

B, N, D = 2, 3, 32

CASES = [  # s, sep, JAX block_q, JAX block_k, dropout rate
    (128, 0, 64, 64, 0.0),
    (77, 0, 32, 32, 0.0),
    (130, 5, 64, 64, 0.0),
    (130, 100, 32, 32, 0.0),
    (96, 37, 32, 64, 0.0),
    (96, 20, 64, 32, 0.0),
    (130, 64, 64, 64, 0.1),
    (77, 5, 32, 32, 0.1),
]


# other head dims, two cases each: 16, 64 and 128, and D = 8, 33 (odd), 80,
# 100 and 256 (the CUDA kernels' tile widths hold every D up to 256)
HEAD_DIM_CASES = [  # d, s, sep, JAX block_q, JAX block_k, dropout rate
    (16, 96, 0, 32, 32, 0.0),
    (16, 77, 37, 32, 32, 0.1),
    (64, 130, 5, 64, 64, 0.0),
    (64, 96, 0, 32, 64, 0.1),
    (128, 77, 0, 32, 32, 0.0),
    (128, 96, 40, 64, 32, 0.1),
] + [(d, s, sep, 64, 64, rate) for d in (8, 33, 80, 100, 256)
     for s, sep, rate in ((77, 0, 0.0), (130, 40, 0.2))]


def _inputs(s, seed, d=D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, s, N, d).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("s,sep,bq,bk,rate", CASES)
def test_backward_matches_jax_vjp(s, sep, bq, bk, rate):
    _check_backward(s, sep, bq, bk, rate, D)


@pytest.mark.parametrize("d,s,sep,bq,bk,rate", HEAD_DIM_CASES)
def test_backward_matches_jax_vjp_at_other_head_dims(d, s, sep, bq, bk, rate):
    _check_backward(s, sep, bq, bk, rate, d)


def _check_backward(s, sep, bq, bk, rate, d):
    q, k, v, do = _inputs(s, seed=s + sep, d=d)
    dseed = 321 if rate else None

    def jax_fwd(q, k, v):
        return jfa.flash_attention(q, k, v, sep, bq, bk, True, dropout_rate=rate,
                                   dropout_seed=dseed)

    want_o, vjp = jax.vjp(jax_fwd, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    calls = (tfa.flash_bwd_dq_reference.calls, tfa.flash_bwd_dkv_reference.calls)
    o, lse = tfa.flash_attention(tq, tk, tv, sep, dropout_rate=rate, dropout_seed=dseed)
    got = torch.autograd.grad(o, (tq, tk, tv), grad_outputs=torch.from_numpy(do))
    # the CPU runs the plain versions of both backward kernels, once each
    assert (tfa.flash_bwd_dq_reference.calls, tfa.flash_bwd_dkv_reference.calls) == (
        calls[0] + 1, calls[1] + 1)
    assert not lse.requires_grad
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), atol=1e-5)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == (B, s, N, d) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=f"d{name}")

    # the plain versions called directly, from the forward's lse and delta
    with torch.no_grad():
        o, lse = tfa.flash_attention(*(t.detach() for t in (tq, tk, tv)), sep,
                                     dropout_rate=rate, dropout_seed=dseed)
    tdo = torch.from_numpy(do)
    delta = (tdo * o).sum(-1).transpose(1, 2).contiguous()
    args = (tq.detach(), tk.detach(), tv.detach(), tdo, lse, delta, sep, rate, dseed)
    dq = tfa.flash_bwd_dq_reference(*args)
    dk, dv = tfa.flash_bwd_dkv_reference(*args)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def test_backward_zeroes_dropped_keys_only():
    """With dropout, dv of a key is the sum over the queries that kept it:
    a key that every query dropped gets dv == 0.  The dk/dv plain version
    must respect the keep mask that the forward drew."""
    s, rate, seed = 24, 0.5, 99
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(s, seed=4))
    with torch.no_grad():
        o, lse = tfa.flash_attention(q, k, v, 0, dropout_rate=rate, dropout_seed=seed)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    _, dv = tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, 0, rate, seed)
    for b in range(B):
        for n in range(N):
            keep = tfa.dropout_keep_reference(seed, b, n, N, s, s, rate)
            causal = torch.tril(torch.ones(s, s, dtype=torch.bool))
            unseen = ~(keep & causal).any(dim=0)  # keys no query kept
            assert (dv[b, unseen, n] == 0).all()
            assert (dv[b, ~unseen, n].abs().sum(-1) > 0).all()
