"""Ring (sequence-parallel) attention over the mesh's 'seq' axis (twin of
cogview_tpu/ops/ring_attention.py).

Each rank holds its [B, S/c, N, D] block of Q, K and V; the K/V blocks go
round the ring of the c ranks of its 'seq' line, one hop a step through
``comm.ppermute``, while an online softmax in float32 merges the partial
attention of each block.  Activation memory per rank drops by c.

It computes what ``ops.attention.dense_attention`` computes over the whole
sequence under the causal + ``sep`` mask: masked logits are -10000 (not
-inf), q is scaled by 1/sqrt(D) and rounded to its dtype before the product,
the probabilities are rounded to v's dtype before the product with V, and
attention dropout is the dense route's counter hash (salt 1) over GLOBAL
(b, n, q, k) coordinates, with the batch and head offsets of the rank's
'data' and 'model' shards, so a ring run keeps the unsharded keep pattern.

Each step's block math runs under ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint(step)``): the [B, N, S/c, S/c] scores are not
saved for the backward but recomputed, one block at a time.  The rotation
stays outside the checkpointed part, so a recomputation never repeats a
collective.  The JAX scan rotates c times to keep its body uniform; the
last rotation's result is never read, and the loop here makes c - 1.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import comm
from ..parallel.mesh import SEQ_AXIS, current_mesh
from .attention import MASK_VALUE
from .hash_prng import hash_u32, _block_index


def keep_mask(shape, rate: float, seed: int, origin, full, device=None) -> torch.Tensor:
    """The dropout keep mask of a [B, N, Sq, Sk] score block at ``origin``
    (b, n, q, k) in the whole [B, N, S, S] of ``full``: that block of the
    dense route's ``hash_dropout`` mask (salt 1)."""
    flat = _block_index(shape, origin, full, device)
    threshold = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
    return hash_u32(seed, flat, 1, 0) >= threshold


def _block_step(qs, kb, vb, o, m, l, q_pos, k_pos, sep: int, rate: float,
                seed: Optional[int], origin, full):
    """One block of the online softmax: scores of this rank's queries
    against the K/V block at key positions ``k_pos`` -> (o, m, l)."""
    s = torch.einsum("bqnd,bknd->bnqk", qs.float(), kb.float())
    mask = (k_pos[None, :] <= q_pos[:, None]) | (k_pos[None, :] < sep)
    s = torch.where(mask, s, MASK_VALUE)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    if seed is not None:
        keep = keep_mask(p.shape, rate, seed, origin, full, p.device)
        # a 0-d divisor: CUDA divides by a Python scalar through its reciprocal
        p = torch.where(keep, p / p.new_full((), 1.0 - rate), 0.0)
    pv = torch.einsum("bnqk,bknd->bnqd", p.to(vb.dtype).float(), vb.float())
    return o * alpha[..., None] + pv, m_new, l_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sep: int = 0,
                   dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                   train: bool = False, num_heads: Optional[int] = None) -> torch.Tensor:
    """This rank's block q/k/v [B, Sc, N, D] of a sequence split over
    'seq' (block i holds positions [i Sc, (i + 1) Sc)) -> its context
    [B, Sc, N, D] in v's dtype.  ``num_heads`` is the global head count
    (N times the 'model' size by default); the batch offset is the rank's
    'data' coordinate times B, the head offset its 'model' coordinate
    times N.  The ambient mesh (``parallel.use_mesh``) gives the ring."""
    mesh = current_mesh()
    if mesh is None or mesh.seq == 1:
        raise ValueError("ring_attention needs an ambient mesh with a 'seq' axis above 1")
    B, Sc, N, D = q.shape
    c, i = mesh.seq, mesh.seq_rank
    S = c * Sc
    use_dropout = train and dropout_rate > 0.0 and dropout_seed is not None
    seed = int(dropout_seed) if use_dropout else None
    full = (B * mesh.data, num_heads or N * mesh.model, S, S)
    b0, n0 = mesh.data_rank * B, mesh.model_rank * N

    qs = (q * (1.0 / math.sqrt(D))).to(q.dtype)
    q_pos = i * Sc + torch.arange(Sc, device=q.device)
    o = torch.zeros((B, N, Sc, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, N, Sc), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, N, Sc), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])  # one rotation carries both
    for t in range(c):
        j = (i - t) % c  # the block this rank holds at step t
        k_pos = j * Sc + torch.arange(Sc, device=q.device)
        o, m, l = checkpoint(_block_step, qs, kv[0], kv[1], o, m, l, q_pos, k_pos, sep,
                             dropout_rate, seed, (b0, n0, i * Sc, j * Sc), full,
                             use_reentrant=False, preserve_rng_state=False)
        if t < c - 1:
            kv = comm.ppermute(kv, SEQ_AXIS, 1)
    out = o / l[..., None]
    return out.transpose(1, 2).to(v.dtype)
