"""Pivot + sliding-window sparse attention for training (twin of
cogview_tpu/ops/sparse_attention.py, which writes it in plain XLA; this is
plain torch on any device).

Each query attends jointly (one softmax) over:
  * a pivot set per sample (all text positions plus sampled image
    positions, ``num_pivot`` in all), masked to keys strictly below the
    query's window band (``rmask``) so the two parts never count a key
    twice, with a ``+log(S // P)`` bias for the sampled density;
  * an overlapping local window: the ``key_window_times * query_window``
    trailing keys, causal within the band.

Layout is [B, S, N, D].  Scores, the softmax and the products run in
float32, the operands upcast first, as ``ops/attention.dense_attention``
does.  With ``pivot_bias=0`` the result equals dense attention under the
union of the two masks.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .attention import MASK_VALUE
from .hash_prng import hash_dropout


def chunk_windows(x: torch.Tensor, w: int, times: int) -> torch.Tensor:
    """[B, S, N, D] -> [B, G, times * w, N, D]; chunk g holds the keys of
    positions [g * w - (times - 1) * w, (g + 1) * w), zero on the left."""
    B, S, N, D = x.shape
    if S % w:
        raise ValueError(f"seq_len {S} must be divisible by query_window {w}")
    pad = torch.cat([x.new_zeros((B, (times - 1) * w, N, D)), x], dim=1)
    return torch.stack([pad[:, g * w:g * w + times * w] for g in range(S // w)], dim=1)


def window_mask(w: int, times: int, G: int) -> np.ndarray:
    """[G, w, times * w] bool: causal within the band, the zero padding of
    the first chunks excluded."""
    T = times * w
    causal = np.arange(T)[None, :] <= np.arange(w)[:, None] + w * (times - 1)
    m = np.broadcast_to(causal, (G, w, T)).copy()
    for g in range(min(times - 1, G)):
        m[g, :, :(times - 1 - g) * w] = False
    return m


def build_rmask(s: int, w: int, times: int) -> np.ndarray:
    """[s, s] bool: True where a key is visible to the pivot part, the
    reference's recipe: the lower triangle of the block-diagonal complement
    over the first s - (times - 1) * w columns, shifted down by
    (times - 1) * w rows."""
    inner = s - (times - 1) * w
    blocks = np.zeros((inner, inner), bool)
    for i in range(s // w - times + 1):
        blocks[i * w:(i + 1) * w, i * w:(i + 1) * w] = True
    out = np.zeros((s, s), bool)
    out[(times - 1) * w:, :inner] = np.tril(~blocks)
    return out


def _gather_keys(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, N, D] at positions idx [B, P] -> [B, P, N, D]."""
    B, _, N, D = x.shape
    return torch.gather(x, 1, idx[:, :, None, None].expand(B, idx.shape[1], N, D))


def pivot_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pivot_idx: torch.Tensor, pivot_mask: torch.Tensor,
                           query_window: int = 128, key_window_times: int = 6,
                           pivot_bias: Optional[float] = None, dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None,
                           train: bool = False) -> torch.Tensor:
    """q, k, v [B, S, N, D], pivot_idx [B, P], pivot_mask [B, S, P] ->
    ctx [B, S, N, D] in v's dtype.  In training the joint [B, N, S, P + T]
    probabilities go through counter-hash dropout with salt 1."""
    B, S, N, D = q.shape
    P = pivot_idx.shape[1]
    w, times = query_window, key_window_times
    G, T = S // w, key_window_times * query_window
    if pivot_bias is None:
        pivot_bias = math.log(S // P)
    qs = (q * (1.0 / math.sqrt(D))).to(q.dtype).float()

    pk, pv = _gather_keys(k, pivot_idx), _gather_keys(v, pivot_idx)
    ps = torch.einsum("bqnd,bpnd->bnqp", qs, pk.float())
    ps = torch.where(pivot_mask.bool()[:, None], ps, MASK_VALUE) + pivot_bias

    wk, wv = chunk_windows(k, w, times), chunk_windows(v, w, times)
    wsc = torch.einsum("bgqnd,bgknd->bngqk", qs.reshape(B, G, w, N, D), wk.float())
    wm = torch.from_numpy(window_mask(w, times, G)).to(q.device)
    wsc = torch.where(wm, wsc, MASK_VALUE)

    probs = torch.softmax(torch.cat([ps, wsc.reshape(B, N, S, T)], dim=-1), dim=-1)
    if train and dropout_rate > 0.0 and dropout_seed is not None:
        probs = hash_dropout(probs, dropout_rate, dropout_seed, salt=1)
    probs = probs.to(v.dtype).float()
    out_piv = torch.einsum("bnqp,bpnd->bqnd", probs[..., :P], pv.float())
    out_win = torch.einsum("bngqk,bgknd->bgqnd", probs[..., P:].reshape(B, N, G, w, T),
                           wv.float()).reshape(B, S, N, D)
    return (out_piv + out_win).to(v.dtype)


def sparse_attention_inference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               pivot_and_window_idx: torch.Tensor) -> torch.Tensor:
    """The decode flavour (is_sparse=2): the trailing queries q [B, Sq, N, D]
    attend to the keys of k/v [B, Sk, N, D] gathered at pivot_and_window_idx
    [B, P + W], causally only within the trailing Sq keys -> float32 ctx
    [B, Sq, N, D]."""
    B, Sq, N, D = q.shape
    P = pivot_and_window_idx.shape[1]
    pk = _gather_keys(k, pivot_and_window_idx)
    pv = _gather_keys(v, pivot_and_window_idx)
    qs = (q * (1.0 / math.sqrt(D))).to(q.dtype)
    scores = torch.einsum("bqnd,bpnd->bnqp", qs.float(), pk.float())
    if Sq > 1:
        i = torch.arange(Sq, device=q.device)
        tri = torch.where(i[None, :] > i[:, None], MASK_VALUE, 0.0)
        scores = torch.cat([scores[..., :P - Sq], scores[..., P - Sq:] + tri], dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bnqp,bpnd->bqnd", probs.float(), pv.float())


def sample_pivots(generator: torch.Generator, tokens: torch.Tensor, num_pivot: int,
                  img_vocab: int, loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pivot sets [B, num_pivot], sorted: every text position (a token id >=
    img_vocab whose loss mask is on) and uniformly sampled image positions,
    by priority top-k (text 2, image a uniform draw from ``generator``).
    Needs #text <= num_pivot <= S.  The JAX package draws its uniforms with
    ``jax.random``, so one seed gives other pivots in the two packages."""
    B, S = tokens.shape
    is_txt = tokens >= img_vocab
    if loss_mask is not None:
        is_txt = is_txt & (loss_mask > 0)
    u = torch.rand((B, S), generator=generator, device=generator.device).to(tokens.device)
    priority = torch.where(is_txt, 2.0, u)
    idx = torch.topk(priority, num_pivot, dim=-1).indices
    return torch.sort(idx, dim=-1).values


def gather_pivot_mask(rmask: torch.Tensor, pivot_idx: torch.Tensor) -> torch.Tensor:
    """rmask [S, S] and pivot_idx [B, P] -> [B, S, P]."""
    return rmask[:, pivot_idx].permute(1, 0, 2)
