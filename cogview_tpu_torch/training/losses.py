"""LM loss with the reference's split image/text bookkeeping (twin of
cogview_tpu/training/losses.py).

A sample is ``text [B, S+1]`` and ``loss_mask [B, S+1]``: inputs are
text[:, :-1] and labels text[:, 1:].  A position is a *text* position when
its input token id >= img_vocab and its mask is on; text positions' mask
entries are multiplied by ``txt_loss_scale``.  The loss is the masked mean;
the img/txt means are reported separately (txt unscaled back).
:func:`lm_loss` also trains with pivot + window sparse attention and with
the dual-segment position ids of super-resolution finetuning;
:func:`lm_loss_with_mems` threads the transformer-XL memory.

Under a mesh with data > 1 the loss is the global masked mean: each rank
returns its rows' masked sum over the global mask's sum (all-reduced), so
the data all-reduce of the gradients is the gradient of the global mean,
and the metrics are the global means.  Under sequence parallelism a rank
takes its block of the shifted inputs and targets, and the sums run over
data x seq; sparse pivots are drawn over whole rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import GPTConfig
from ..models import gpt
from ..ops.sparse_attention import build_rmask, gather_pivot_mask, sample_pivots
from ..parallel import comm
from ..parallel.mesh import DATA_AXIS, SEQ_AXIS, current_mesh
from ..parallel.pipeline import data_rows


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """float32 softmax cross-entropy per position."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse - picked


def _pick_ce_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target."""
    for c in range(min(S, target), 0, -1):
        if S % c == 0:
            return c
    return S


# auto mode: full logits up to 4.5 GiB of float32, 160-token chunks above
_CE_AUTO_LOGIT_BYTES = int(4.5 * (1 << 30))


def cross_entropy_hidden(params, h: torch.Tensor, labels: torch.Tensor, *,
                         chunk_target: int = 0) -> torch.Tensor:
    """float32 softmax cross-entropy [B, S] from final-LayerNorm hidden
    states [B, S, H], with the tied vocab projection fused in.

    ``chunk_target=0`` (auto) takes full logits while [B, S, V] float32 fits
    in 4.5 GiB and 160-token chunks above.  A chunk's logits are recomputed
    in the backward (``torch.utils.checkpoint``, the twin of
    ``jax.checkpoint`` on the chunk body), so at most one chunk's [B, C, V]
    logits are live.  The math equals
    ``cross_entropy_logits(_logits(h), labels)``."""
    word = params["embed"]["word"]
    B, S, _ = h.shape
    if chunk_target == 0:
        mesh = current_mesh()
        V = (word["w8"] if isinstance(word, dict) else word).shape[0]
        V *= 1 if mesh is None else mesh.model  # the gathered logits' width
        chunk_target = S if B * S * V * 4 <= _CE_AUTO_LOGIT_BYTES else 160
    C = _pick_ce_chunk(S, chunk_target)

    def chunk_ce(h_c, lab_c):
        return cross_entropy_logits(gpt.tied_logits(params, h_c), lab_c)

    if C == S:
        return chunk_ce(h, labels)
    return torch.cat([checkpoint(chunk_ce, h[:, i:i + C], labels[:, i:i + C],
                                 use_reentrant=False, preserve_rng_state=False)
                      for i in range(0, S, C)], dim=1)


def _split_ce(ce, lmask, img_ind, txt_ind, txt_loss_scale):
    """Masked mean CE and the reference's separate img/txt losses."""
    losses = ce * lmask
    mesh = current_mesh()
    if mesh is not None and mesh.data * mesh.seq > 1:
        # the global sums, one all-reduce over data x seq
        sums = comm.all_reduce(torch.stack([
            losses.sum(), lmask.sum(), (losses * img_ind).sum(), img_ind.sum(),
            (losses * txt_ind).sum(), txt_ind.sum()]).detach(), (DATA_AXIS, SEQ_AXIS))
        denom = torch.clamp(sums[1], min=1.0)
        return losses.sum() / denom, {
            "lm_loss": sums[0] / denom,
            "img_loss": sums[2] / torch.clamp(sums[3], min=1.0),
            "txt_loss": sums[4] / torch.clamp(sums[5], min=1.0) / txt_loss_scale}
    denom = torch.clamp(lmask.sum(), min=1.0)
    loss = losses.sum() / denom
    img_loss = (losses * img_ind).sum() / torch.clamp(img_ind.sum(), min=1.0)
    txt_loss = (losses * txt_ind).sum() / torch.clamp(txt_ind.sum(), min=1.0) / txt_loss_scale
    return loss, {"lm_loss": loss, "img_loss": img_loss, "txt_loss": txt_loss}


def dual_position_ids(tokens: torch.Tensor, roi2_id: int, max_pos: int) -> torch.Tensor:
    """Dual-segment position ids of super-resolution finetuning: positions
    restart at the first [ROI2] of each row; a row without one keeps
    0..S-1 (the numpy twin in data/position_ids.py raises instead).  Clamped
    at ``max_pos - 1``."""
    B, S = tokens.shape
    is_roi2 = tokens == roi2_id
    sep = is_roi2.to(torch.int32).argmax(dim=1)  # the first occurrence
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    second = pos - sep[:, None]
    dual = torch.where(second >= 0, second, pos)
    out = torch.where(is_roi2.any(dim=1)[:, None], dual, pos)
    return torch.clamp(out, max=max_pos - 1)


def _split_batch(batch, img_vocab: int, txt_loss_scale: float):
    """-> tokens, labels, the scaled loss mask and the img/txt indicators."""
    text = batch["text"].long()
    mask = batch["loss_mask"].float()
    tokens, labels, lmask = text[:, :-1], text[:, 1:], mask[:, 1:]
    img_ind = tokens < img_vocab
    txt_ind = (~img_ind) & (lmask > 0)
    lmask = torch.where(txt_ind, lmask * txt_loss_scale, lmask)
    return tokens, labels, lmask, img_ind, txt_ind


def _positions(cfg, tokens, position_ids, dual_positions_roi2):
    if position_ids is None and dual_positions_roi2 is not None:
        return dual_position_ids(tokens, dual_positions_roi2, cfg.max_position_embeddings)
    return position_ids


def _seq_block(position_ids, *ts):
    """Under sequence parallelism, this rank's block of the shifted
    [B, S] tensors (the position ids computed on the whole rows first, and
    then the global positions of the block where there are none)."""
    mesh = current_mesh()
    if mesh is None or mesh.seq == 1:
        return (position_ids,) + ts
    S = ts[0].shape[1]
    if S % mesh.seq:
        raise ValueError(f"{S} training positions do not split over seq={mesh.seq}")
    Sc = S // mesh.seq
    sl = slice(mesh.seq_rank * Sc, (mesh.seq_rank + 1) * Sc)
    return (None if position_ids is None else position_ids[:, sl],) + tuple(
        t[:, sl] for t in ts)


def lm_loss(params, cfg: GPTConfig, batch: Dict[str, torch.Tensor], *,
            img_vocab: int = 8192, txt_loss_scale: float = 1.0,
            seeds: Optional[Sequence[int]] = None, train: bool = True,
            remat: bool = True, position_ids: Optional[torch.Tensor] = None,
            is_sparse: bool = False, dual_positions_roi2: Optional[int] = None,
            generator: Optional[torch.Generator] = None,
            pivot_idx: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, {"lm_loss", "img_loss", "txt_loss"}) of ``batch`` (``text``
    int [B, S+1], ``loss_mask`` [B, S+1], tensors on the params' device).
    ``seeds`` are the forward's L + 1 dropout seeds.

    ``is_sparse`` trains with pivot + window attention (S a multiple of
    ``cfg.query_window``): the pivots are every text position and sampled
    image positions, drawn from ``generator``, or ``pivot_idx`` [B,
    num_pivot] when given; one of the two is required.
    ``dual_positions_roi2`` is the [ROI2] id whose first occurrence
    restarts the position ids (:func:`dual_position_ids`).  Under a mesh
    ``batch`` holds this rank's rows, and the pivots are drawn for the
    global batch and sliced (``sample_pivots``); the first value returned
    is then this rank's share of the loss, the metrics the global ones."""
    tokens, labels, lmask, img_ind, txt_ind = _split_batch(batch, img_vocab, txt_loss_scale)
    position_ids = _positions(cfg, tokens, position_ids, dual_positions_roi2)
    sparse = None
    if is_sparse:
        S = tokens.shape[1]
        if S % cfg.query_window:
            raise ValueError(f"seq len {S} must be divisible by query_window "
                             f"{cfg.query_window}")
        if pivot_idx is None:
            if generator is None:
                raise ValueError("is_sparse needs a generator to draw the pivots, or pivot_idx")
            mesh = current_mesh()
            B = tokens.shape[0] * (1 if mesh is None else mesh.data)
            pivot_idx = sample_pivots(
                generator, tokens, cfg.num_pivot, img_vocab, loss_mask=lmask,
                rows=data_rows(B, cfg.pp_microbatches), global_batch=B)
        rmask = torch.from_numpy(build_rmask(S, cfg.query_window, cfg.key_window_times))
        pivot_mask = gather_pivot_mask(rmask.to(tokens.device), pivot_idx)
        sparse = gpt.SparseSpec(pivot_idx, pivot_mask, cfg.query_window, cfg.key_window_times)
    # the pivots cover whole rows; under sequence parallelism the layers
    # attend over the gathered sequence
    position_ids, tokens, labels, lmask, img_ind, txt_ind = _seq_block(
        position_ids, tokens, labels, lmask, img_ind, txt_ind)
    h = gpt.forward(params, cfg, tokens, position_ids=position_ids, train=train,
                    seeds=seeds, remat=remat, sparse=sparse, return_hidden=True)
    ce = cross_entropy_hidden(params, h, labels, chunk_target=cfg.ce_chunk_target)
    return _split_ce(ce, lmask, img_ind.float(), txt_ind.float(), txt_loss_scale)


def lm_loss_with_mems(params, cfg: GPTConfig, batch: Dict[str, torch.Tensor],
                      mems: Optional[torch.Tensor], *, max_memory_length: int,
                      img_vocab: int = 8192, txt_loss_scale: float = 1.0,
                      seeds: Optional[Sequence[int]] = None, train: bool = True,
                      remat: bool = True, position_ids: Optional[torch.Tensor] = None,
                      dual_positions_roi2: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """:func:`lm_loss` over ``gpt.forward_with_mems``: ``batch`` continues
    the segment that left ``mems`` [L + 1, B, M, H] (None at the start) ->
    (loss, metrics, the new detached mems).  Under sequence parallelism a
    rank takes its block of the positions, as in :func:`lm_loss`, and the
    mems are whole on every rank."""
    tokens, labels, lmask, img_ind, txt_ind = _split_batch(batch, img_vocab, txt_loss_scale)
    position_ids = _positions(cfg, tokens, position_ids, dual_positions_roi2)
    position_ids, tokens, labels, lmask, img_ind, txt_ind = _seq_block(
        position_ids, tokens, labels, lmask, img_ind, txt_ind)
    h, new_mems = gpt.forward_with_mems(
        params, cfg, tokens, mems, max_memory_length=max_memory_length,
        position_ids=position_ids, train=train, seeds=seeds, remat=remat,
        return_hidden=True)
    ce = cross_entropy_hidden(params, h, labels, chunk_target=cfg.ce_chunk_target)
    loss, metrics = _split_ce(ce, lmask, img_ind.float(), txt_ind.float(), txt_loss_scale)
    return loss, metrics, new_mems
