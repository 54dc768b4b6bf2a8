"""Sliding-window super-resolution (twin of cogview_tpu/generation/magnify.py).

A 32x32 code grid becomes 64x64 through nine overlapping windows.  Each
window's template is ``text ++ 16x16 input codes ++ [EOI1] [ROI2] [POS0]
[BASE] [BOI2]`` followed by its cells of the magnified grid: cells that an
earlier window generated are fixed template tokens, the rest generation
slots.  Window (i, j, line) covers magnified rows 16i .. 16i + line and
columns 16j .. 16j + 32.  The windows run in sequence (later ones condition
on earlier outputs); a batch of images runs through one schedule, and every
window's template is padded to one common length with fixed [PAD] steps.
The window bookkeeping is numpy on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import GPTConfig
from ..ops.hash_prng import hash_u32
from .sampling import SamplingParams, compile_template_batch, filling_sequence

WINDOWS = [
    (0, 0, 18), (0, 1, 30), (0, 2, 30),
    (1, 1, 30), (1, 0, 30), (1, 2, 30),
    (2, 0, 32), (2, 1, 32), (2, 2, 32),
]

_WINDOW_SALT = 0x3A61


def window_seed(seed: int, window: int) -> int:
    """uint32 sampling seed of window ``window``: a counter hash of the
    user's seed.  The JAX package splits a ``jax.random`` key per window
    instead, so the two packages draw different samples from one --seed."""
    return int(hash_u32(seed, window, _WINDOW_SALT, 0))


def magnify(
    params,
    cfg: GPTConfig,
    tokenizer,
    code_tokens,  # [1024] or [B, 1024] image codes (32x32 base images)
    text_tokens,  # [T] or [B, T] '[ROI1] text [BASE] [BOI1]' prefix ids
    sampling: SamplingParams = SamplingParams(),
    window_seeds: Optional[Sequence[int]] = None,
    device=None,
) -> np.ndarray:
    """-> [B, 4096] magnified codes.  Window w samples with
    ``window_seeds[w]``, by default :func:`window_seed` of ``sampling.seed``."""
    code = np.atleast_2d(np.asarray(code_tokens, np.int64))
    B = code.shape[0]
    if code.shape[1] != 1024:
        raise ValueError(f"expected 32x32 = 1024 codes a row, got {code.shape}")
    s = 32
    code = code.reshape(B, s, s)
    text = np.atleast_2d(np.asarray(text_tokens, np.int64))
    if text.shape[0] == 1 and B > 1:
        text = np.repeat(text, B, axis=0)
    if text.shape[0] != B:
        raise ValueError(f"{text.shape[0]} text rows for {B} images")
    if window_seeds is None:
        window_seeds = [window_seed(sampling.seed, w) for w in range(len(WINDOWS))]
    if len(window_seeds) != len(WINDOWS):
        raise ValueError(f"{len(window_seeds)} window seeds for {len(WINDOWS)} windows")

    midfix = [tokenizer["[EOI1]"], tokenizer["[ROI2]"], tokenizer["[POS0]"],
              tokenizer["[BASE]"], tokenizer["[BOI2]"]]
    magnified = np.full((B, 2 * s, 2 * s), -1, np.int64)
    ctx_len = text.shape[1] + 256 + len(midfix)
    common_len = ctx_len + 1024

    for w, (i, j, line) in enumerate(WINDOWS):
        seqs = []
        for b in range(B):
            code_part = code[b, 8 * i:8 * (i + 2), 8 * j:8 * (j + 2)].reshape(-1)
            mag_part = magnified[b, 16 * i:16 * i + line, 16 * j:16 * (j + 2)].reshape(-1)
            seqs.append(text[b].tolist() + code_part.tolist() + midfix + mag_part.tolist())
        tpl = compile_template_batch(seqs, tokenizer, padded_vocab=cfg.vocab_size,
                                     pad_to=common_len)
        tokens, _ = filling_sequence(params, cfg, tpl, B, sampling, window_seeds[w], device)
        out = tokens[:, ctx_len:ctx_len + line * 32].cpu().numpy()
        magnified[:, 16 * i:16 * i + line, 16 * j:16 * (j + 2)] = out.reshape(B, line, 32)

    assert (magnified >= 0).all()
    return magnified.reshape(B, 4 * s * s)
