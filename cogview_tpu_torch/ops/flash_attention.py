"""Causal + prefix flash attention, forward and backward (twin of
cogview_tpu/ops/flash_attention.py).

Masking is the reference's: a key is visible to a query iff
``kpos <= qpos or kpos < sep`` (a bidirectional prefix of ``sep``
positions), and a masked logit is exactly -10000, not -inf.  Logits are
``(q . k) * (1 / sqrt(D))``: the scale is applied after the dot, where
``dense_attention`` pre-scales q.  Dots take the input dtype's values with
float32 sums; the softmax is float32.

Attention-probability dropout keeps the score element (b, n, qpos, kpos)
iff ``hash_u32(seed, qpos, kpos, b * N + n) >= round(rate * 2^32)``
(ops/hash_prng.py), so the mask depends on global coordinates only and the
backward recomputes it.  ``l`` sums the softmax mass before dropout; kept
probabilities are scaled by ``1 / (1 - rate)`` and cast to v's dtype before
the product with V.

:func:`flash_attention` is the entry point and returns ``(o [B, S, N, D] in
q's dtype, lse [B, N, S] float32)`` with ``lse = m + log(l)``.  It is a
``torch.autograd.Function``: the forward saves q, k, v, o and lse; the
backward computes ``delta = rowsum(dO * O)`` in float32 and then dq through
:func:`flash_bwd_dq` and dk, dv through :func:`flash_bwd_dkv`, the two passes
of the JAX package's custom VJP.  lse has no gradient.

Each of the three passes launches a hand-written kernel of
csrc/flash_attention.cu on a CUDA tensor (bfloat16 on the tensor cores,
float32 on the CUDA cores), or raises; on a CPU tensor it runs
its plain PyTorch version (``flash_attention_reference``,
``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``).  ``.launches`` on
each wrapper counts kernel launches, ``.calls`` on each plain version counts
its calls.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ._kernels import launch
from .hash_prng import hash_u32

MASK_VALUE = -10000.0
# the head widths the CUDA kernels are built for (csrc/flash_attention.cu,
# with_head_dim); the plain versions take any
HEAD_DIMS = (16, 32, 64, 128)


def _rate_threshold(rate: float) -> int:
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def _keep_mask(seed: int, bn: torch.Tensor, sq: int, sk: int, rate: float) -> torch.Tensor:
    """[..., sq, sk] bool keep mask for (b * N + n) coordinates ``bn``
    (a tensor broadcast against [sq, sk])."""
    qpos = torch.arange(sq, device=bn.device)[:, None]
    kpos = torch.arange(sk, device=bn.device)[None, :]
    return hash_u32(seed, qpos, kpos, bn) >= _rate_threshold(rate)


def dropout_keep_reference(seed: int, b: int, n: int, num_heads: int, sq: int,
                           sk: int, rate: float, device=None) -> torch.Tensor:
    """[sq, sk] bool keep mask of head (b, n), identical to the kernels'."""
    bn = torch.tensor(b * num_heads + n, dtype=torch.int64, device=device)
    return _keep_mask(seed, bn, sq, sk, rate)


def _masked_logits(q: torch.Tensor, k: torch.Tensor, sep: int) -> torch.Tensor:
    """[B, N, S, S] float32 logits, scaled after the dot, masked to -10000."""
    S, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    visible = (pos[None, :] <= pos[:, None]) | (pos[None, :] < sep)
    return torch.where(visible, s, MASK_VALUE)


def _drop(p: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Kept probabilities of [B, N, S, S] ``p``, scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return p
    B, N, S = p.shape[0], p.shape[1], p.shape[2]
    bn = torch.arange(B * N, device=p.device).reshape(B, N, 1, 1)
    return torch.where(_keep_mask(seed, bn, S, S, rate), p / (1.0 - rate), 0.0)


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, N, D] bfloat16 or float32
    k: torch.Tensor,
    v: torch.Tensor,
    sep: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel -> (o, lse).

    One softmax over all keys replaces the kernel's per-tile online softmax
    (equal up to float32 rounding; with bfloat16 v the kernel rounds
    probabilities scaled by its running maximum, this version by the row's
    maximum)."""
    flash_attention_reference.calls += 1
    s = _masked_logits(q, k, sep)
    m = s.amax(dim=-1, keepdim=True)  # [B, N, S, 1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = _drop(p, dropout_rate, dropout_seed)
    acc = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    o = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


flash_attention_reference.calls = 0


def _bwd_terms(q, k, v, do, lse, delta, sep, rate, seed):
    """(pd, ds) [B, N, S, S] float32: the dropped probabilities and the
    logits' gradient, as both backward kernels form them."""
    p = torch.exp(_masked_logits(q, k, sep) - lse[..., None])
    dp = torch.einsum("bqnd,bknd->bnqk", do.float(), v.float())
    pd = _drop(p, rate, seed)
    ds = (pd * dp - p * delta[..., None]) * (1.0 / math.sqrt(q.shape[3]))
    return pd, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, sep: int = 0,
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: dq = ds . k, with ds cast to
    k's dtype, float32 sums, dq in q's dtype.  ``lse`` and ``delta`` are
    [B, N, S] float32."""
    flash_bwd_dq_reference.calls += 1
    _, ds = _bwd_terms(q, k, v, do, lse, delta, sep, dropout_rate, dropout_seed)
    return torch.einsum("bnqk,bknd->bqnd", ds.to(k.dtype).float(), k.float()).to(q.dtype)


flash_bwd_dq_reference.calls = 0


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, sep: int = 0,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: dv = pd^T . dO with pd cast
    to dO's dtype, dk = ds^T . q with ds cast to q's dtype, float32 sums."""
    flash_bwd_dkv_reference.calls += 1
    pd, ds = _bwd_terms(q, k, v, do, lse, delta, sep, dropout_rate, dropout_seed)
    dv = torch.einsum("bnqk,bqnd->bknd", pd.to(do.dtype).float(), do.float()).to(v.dtype)
    dk = torch.einsum("bnqk,bqnd->bknd", ds.to(q.dtype).float(), q.float()).to(k.dtype)
    return dk, dv


flash_bwd_dkv_reference.calls = 0


# --------------------------------------------------------------------- #
# CUDA launches
# --------------------------------------------------------------------- #


def _check_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"expected {shape} {dtype} on {device}")
    # the kernels take batch and sequence strides; a head row must be
    # contiguous and start 16-byte aligned (the float32 kernels read 4
    # values at a time, the bfloat16 kernels copy 16 bytes with cp.async)
    if t.stride(3) != 1 or t.stride(2) != shape[3]:
        raise ValueError(f"{name}: heads and head dims must be contiguous, "
                         f"strides {t.stride()}")
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or t.stride(0) % per16 or t.stride(1) % per16:
        raise ValueError(f"{name}: pointer or strides not 16-byte aligned, "
                         f"strides {t.stride()}")


def _cuda_operands(*named):
    """Validate [B, S, N, D] operands of one launch -> (B, S, N, D, flat
    pointer-and-stride arguments)."""
    q = named[0][1]
    if q.ndim != 4:
        raise ValueError(f"q must be [B, S, N, D], got {tuple(q.shape)}")
    B, S, N, D = q.shape
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {D}: the CUDA kernels are built for {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32")
    strides = []
    for name, t in named:
        _check_operand(name, t, (B, S, N, D), q.dtype, q.device)
        strides += [t.stride(0), t.stride(1)]
    return B, S, N, D, strides


def _check_rows(name: str, t: torch.Tensor, shape, device) -> None:
    if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                         f"contiguous {shape} float32 on {device}")


def _dropout_args(D: int, sep: int, rate: float, seed: Optional[int]):
    return (int(sep), 1.0 / math.sqrt(D), int(seed or 0) & 0xFFFFFFFF,
            _rate_threshold(rate), 1.0 - rate, int(rate > 0.0))


def _flash_fwd(q, k, v, sep, rate, seed):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sep, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, N, D, strides = _cuda_operands(("q", q), ("k", k), ("v", v))
    o = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    launch("flash_attention", "flash_attention_fwd", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
           int(q.dtype == torch.bfloat16), B, S, N, D, *strides,
           *_dropout_args(D, sep, rate, seed))
    flash_attention.launches += 1
    return o, lse


def _bwd_launch_args(q, k, v, do, lse, delta):
    B, S, N, D, strides = _cuda_operands(("q", q), ("k", k), ("v", v), ("do", do))
    _check_rows("lse", lse, (B, N, S), q.device)
    _check_rows("delta", delta, (B, N, S), q.device)
    return B, S, N, D, strides


def flash_bwd_dq(q, k, v, do, lse, delta, sep: int = 0, *, dropout_rate: float = 0.0,
                 dropout_seed: Optional[int] = None) -> torch.Tensor:
    """dq [B, S, N, D] of the backward: the dq kernel on a CUDA tensor (or
    raises), its plain version on a CPU tensor.  ``do`` is dO, ``lse`` and
    ``delta`` are [B, N, S] float32."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, sep, dropout_rate, dropout_seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    do = do.contiguous()
    B, S, N, D, strides = _bwd_launch_args(q, k, v, do, lse, delta)
    dq = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    launch("flash_attention", "flash_attention_bwd_dq", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dq.data_ptr(), int(q.dtype == torch.bfloat16), B, S, N, D,
           *strides, *_dropout_args(D, sep, dropout_rate, dropout_seed))
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, sep: int = 0, *, dropout_rate: float = 0.0,
                  dropout_seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, S, N, D] of the backward: the dk/dv kernel on a CUDA
    tensor (or raises), its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, sep, dropout_rate, dropout_seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    do = do.contiguous()
    B, S, N, D, strides = _bwd_launch_args(q, k, v, do, lse, delta)
    dk = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    launch("flash_attention", "flash_attention_bwd_dkv", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16),
           B, S, N, D, *strides, *_dropout_args(D, sep, dropout_rate, dropout_seed))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The JAX package's custom VJP: forward kernel, then the dq and dk/dv
    passes from the saved (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, sep, rate, seed):
        o, lse = _flash_fwd(q, k, v, sep, rate, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sep, ctx.rate, ctx.seed = sep, rate, seed
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # delta = rowsum(dO * O), float32, outside the kernels -> [B, N, S]
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        kw = dict(dropout_rate=ctx.rate, dropout_seed=ctx.seed)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.sep, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.sep, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, S, N, D]
    k: torch.Tensor,
    v: torch.Tensor,
    sep: int = 0,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention -> (o [B, S, N, D] in q.dtype, lse [B, N, S]), with a
    backward to q, k and v.

    q, k and v may be strided views (the slices of a fused QKV projection):
    the kernels read them through their batch and sequence strides, with no
    copy.  ``dropout_seed`` is a uint32.  A CPU tensor runs the plain
    versions; a CUDA tensor launches the kernels of csrc/flash_attention.cu
    on the current stream, or raises.  There is no fallback."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    return _FlashAttention.apply(q, k, v, int(sep), float(dropout_rate), dropout_seed)


flash_attention.launches = 0
