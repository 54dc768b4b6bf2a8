"""Dense attention with the reference's masking (twin of cogview_tpu/ops/attention.py).

Scores are ``(Q/sqrt(d)) @ K^T`` and masked logits are exactly -10000, not
-inf.  Scores and softmax run in float32 whatever the compute dtype.  The
JAX package asks its dots for a float32 result from low-precision operands;
here the operands are upcast to float32 before the product, which gives the
same exact products and float32 sums.  Layout is [B, S, N, D].
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .hash_prng import hash_dropout

MASK_VALUE = -10000.0


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, *, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    train: bool = False, dropout_origin: Optional[Sequence[int]] = None,
                    dropout_full: Optional[Sequence[int]] = None) -> torch.Tensor:
    """q [B, Sq, N, D], k/v [B, Sk, N, D], mask broadcastable to
    [B, N, Sq, Sk] -> ctx [B, Sq, N, D] in v.dtype.  In training, the float32
    probabilities go through counter-hash dropout with salt 1 (seed a
    uint32) before the cast to v's dtype; a shard of the batch and heads
    passes its (b0, n0) in the global (B, N) as ``dropout_origin`` and
    ``dropout_full``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q * scale).to(q.dtype)
    scores = torch.einsum("bqnd,bknd->bnqk", qs.float(), k.float())
    scores = torch.where(mask.bool(), scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if train and dropout_rate > 0.0 and dropout_seed is not None:
        probs = hash_dropout(probs, dropout_rate, dropout_seed, salt=1,
                             origin=dropout_origin, full_shape=dropout_full)
    probs = probs.to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(v.dtype)


def dense_attention_kvT(q: torch.Tensor, kT: torch.Tensor, vT: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Attention over column-form K/V: q [B, Sq, N, D], kT/vT [B, N, D, T],
    mask broadcastable to [B, N, Sq, T] -> ctx [B, Sq, N, D] in vT.dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q * scale).to(q.dtype)
    scores = torch.einsum("bqnd,bndk->bnqk", qs.float(), kT.float())
    scores = torch.where(mask.bool(), scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(vT.dtype)
    return torch.einsum("bnqk,bndk->bqnd", probs.float(), vT.float()).to(vT.dtype)


def causal_mask(sq: int, sk: Optional[int] = None, sep: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, sq, sk] prefix-LM mask: causal over the trailing sq queries,
    with full visibility of the first ``sep`` positions and of all memory."""
    if sk is None:
        sk = sq
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    m = (kpos <= qpos) | (kpos < sep + (sk - sq))
    return m[None, None]


def decode_mask(q_positions: torch.Tensor, cache_len: int) -> torch.Tensor:
    """[B, 1, Q, T] mask against a KV cache: slot t is visible to the query
    at absolute position p iff t <= p."""
    kpos = torch.arange(cache_len, device=q_positions.device)[None, None, None, :]
    return kpos <= q_positions[:, None, :, None]
