"""Causal + prefix flash-attention forward (twin of cogview_tpu/ops/flash_attention.py).

Masking is the reference's: a key is visible to a query iff
``kpos <= qpos or kpos < sep`` (a bidirectional prefix of ``sep``
positions), and a masked logit is exactly -10000, not -inf.  Logits are
``(q . k) * (1 / sqrt(D))``: the scale is applied after the dot, where
``dense_attention`` pre-scales q.  Dots take the input dtype's values with
float32 sums; the softmax is float32.

Attention-probability dropout keeps the score element (b, n, qpos, kpos)
iff ``hash_u32(seed, qpos, kpos, b * N + n) >= round(rate * 2^32)``
(ops/hash_prng.py), so the mask depends on global coordinates only.  ``l``
sums the softmax mass before dropout; kept probabilities are scaled by
``1 / (1 - rate)`` and cast to v's dtype before the product with V.

:func:`flash_attention` is the entry point: on a CUDA tensor it launches
the hand-written kernel of csrc/flash_attention.cu, on a CPU tensor it runs
:func:`flash_attention_reference`, the plain PyTorch version.  Both return
``(o [B, S, N, D] in q's dtype, lse [B, N, S] float32)`` with
``lse = m + log(l)``.  There is no backward yet: the wrapper raises where
autograd would need one.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .hash_prng import hash_u32

MASK_VALUE = -10000.0
HEAD_DIM = 64  # the head width the CUDA kernel is built for (cogview-base)


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
    """[sq, sk] bool keep mask of head (b, n), identical to the kernel's."""
    bn = torch.tensor(b * num_heads + n, dtype=torch.int64, device=device)
    return _keep_mask(seed, bn, sq, sk, rate)


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, N, D] bfloat16 or float32
    k: torch.Tensor,
    v: torch.Tensor,
    sep: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash kernel -> (o, lse).

    One softmax over all keys replaces the kernel's per-tile online softmax
    (equal up to float32 rounding; with bfloat16 v the kernel rounds
    probabilities scaled by its running maximum, this version by the row's
    maximum)."""
    flash_attention_reference.calls += 1
    B, S, N, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    visible = (pos[None, :] <= pos[:, None]) | (pos[None, :] < sep)
    s = torch.where(visible, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)  # [B, N, S, 1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        bn = torch.arange(B * N, device=q.device).reshape(B, N, 1, 1)
        keep = _keep_mask(dropout_seed, bn, S, S, dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    acc = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    o = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


flash_attention_reference.calls = 0


def _check_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"expected {shape} {dtype} on {device}")
    # the kernel takes batch and sequence strides; a head row must be
    # contiguous and every 4-element group 16-byte (float32) or 8-byte
    # (bfloat16) aligned
    if t.stride(3) != 1 or t.stride(2) != shape[3]:
        raise ValueError(f"{name}: heads and head dims must be contiguous, "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16 or t.stride(0) % 4 or t.stride(1) % 4:
        raise ValueError(f"{name}: pointer or strides not 4-element aligned, "
                         f"strides {t.stride()}")


def flash_attention(
    q: torch.Tensor,  # [B, S, N, D]
    k: torch.Tensor,
    v: torch.Tensor,
    sep: int = 0,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward -> (o [B, S, N, D] in q.dtype, lse [B, N, S]).

    q, k and v may be strided views (the slices of a fused QKV projection):
    the kernel reads them through their batch and sequence strides, with no
    copy.  ``dropout_seed`` is a uint32.

    A CPU tensor runs the plain version.  A CUDA tensor launches the kernel
    of csrc/flash_attention.cu on the current stream, or raises; there is
    no fallback.  Raises NotImplementedError where autograd is recording
    and an input requires grad: the backward kernels are not ported."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet (the dq / dkv kernels come "
            "with the training slice); call it under torch.no_grad()")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sep, dropout_rate, dropout_seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from . import _kernels

    if q.ndim != 4:
        raise ValueError(f"q must be [B, S, N, D], got {tuple(q.shape)}")
    B, S, N, D = q.shape
    if D != HEAD_DIM:
        raise NotImplementedError(f"head_dim {D}: the CUDA kernel is built for {HEAD_DIM}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, (B, S, N, D), q.dtype, q.device)

    o = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernels.lib("flash_attention").flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), B, S, N, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            int(sep), 1.0 / math.sqrt(D), int(dropout_seed or 0) & 0xFFFFFFFF,
            _rate_threshold(dropout_rate), 1.0 - dropout_rate, int(dropout_rate > 0.0),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
