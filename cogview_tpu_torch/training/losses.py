"""LM loss with the reference's split image/text bookkeeping (twin of
cogview_tpu/training/losses.py).

A sample is ``text [B, S+1]`` and ``loss_mask [B, S+1]``: inputs are
text[:, :-1] and labels text[:, 1:].  A position is a *text* position when
its input token id >= img_vocab and its mask is on; text positions' mask
entries are multiplied by ``txt_loss_scale``.  The loss is the masked mean;
the img/txt means are reported separately (txt unscaled back).  Sparse
attention and the dual-segment position ids are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import GPTConfig
from ..models import gpt


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


def _tied_leaf(params):
    word = params["embed"]["word"]
    return word if isinstance(word, dict) else {"w": word}


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
    leaf = _tied_leaf(params)
    B, S, _ = h.shape
    if chunk_target == 0:
        V = leaf["w8" if "w8" in leaf else "w"].shape[0]
        chunk_target = S if B * S * V * 4 <= _CE_AUTO_LOGIT_BYTES else 160
    C = _pick_ce_chunk(S, chunk_target)

    def chunk_ce(h_c, lab_c):
        return cross_entropy_logits(gpt._wmul(h_c, leaf, h_c.dtype, transpose=True), lab_c)

    if C == S:
        return chunk_ce(h, labels)
    return torch.cat([checkpoint(chunk_ce, h[:, i:i + C], labels[:, i:i + C],
                                 use_reentrant=False, preserve_rng_state=False)
                      for i in range(0, S, C)], dim=1)


def _split_ce(ce, lmask, img_ind, txt_ind, txt_loss_scale):
    """Masked mean CE and the reference's separate img/txt losses."""
    losses = ce * lmask
    denom = torch.clamp(lmask.sum(), min=1.0)
    loss = losses.sum() / denom
    img_loss = (losses * img_ind).sum() / torch.clamp(img_ind.sum(), min=1.0)
    txt_loss = (losses * txt_ind).sum() / torch.clamp(txt_ind.sum(), min=1.0) / txt_loss_scale
    return loss, {"lm_loss": loss, "img_loss": img_loss, "txt_loss": txt_loss}


def lm_loss(params, cfg: GPTConfig, batch: Dict[str, torch.Tensor], *,
            img_vocab: int = 8192, txt_loss_scale: float = 1.0,
            seeds: Optional[Sequence[int]] = None, train: bool = True,
            remat: bool = True, position_ids: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, {"lm_loss", "img_loss", "txt_loss"}) of ``batch`` (``text``
    int [B, S+1], ``loss_mask`` [B, S+1], tensors on the params' device).
    ``seeds`` are the forward's L + 1 dropout seeds."""
    text = batch["text"].long()
    mask = batch["loss_mask"].float()
    tokens, labels, lmask = text[:, :-1], text[:, 1:], mask[:, 1:]
    img_ind = tokens < img_vocab
    txt_ind = (~img_ind) & (lmask > 0)
    lmask = torch.where(txt_ind, lmask * txt_loss_scale, lmask)
    h = gpt.forward(params, cfg, tokens, position_ids=position_ids, train=train,
                    seeds=seeds, remat=remat, return_hidden=True)
    ce = cross_entropy_hidden(params, h, labels, chunk_target=cfg.ce_chunk_target)
    return _split_ce(ce, lmask, img_ind.float(), txt_ind.float(), txt_loss_scale)
