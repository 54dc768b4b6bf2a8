"""Generation tasks (twin of cogview_tpu/generation/tasks.py): text2image.

The query templates are the reference's; only text2image is ported so far
(image2text, super-resolution and post-selection come with later slices).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import GPTConfig
from ..ops.hash_prng import hash_u32
from .sampling import SamplingParams, compile_template, filling_sequence

QUERY_TEMPLATES = {
    "text2image": "[ROI1] {} [BASE] [BOI1] [MASK]*1024",
    "image2text": "[BASE] [BOI1] [Image]{} [EOI1] [ROI1] [MASK]*20",
    "low-level super-resolution": (
        "[ROI1] {} [BASE] [BOI1] [Image]{} [EOI1] [ROI2] [POS0] [BASE] [BOI2] [MASK]*1024"
    ),
    "super-resolution": "[ROI1] {} [BASE] [BOI1] [Image]{}",
    "post-selection": "[BASE] [BOI1] [Image]{} [EOI1] [ROI1] {}",
    "raw": "{}",
}


def task_img_size(task: str) -> int:
    # low-level SR conditions on a 128px image -> 16x16=256 codes
    return 128 if task == "low-level super-resolution" else 256


def parse_query_line(raw_text: str, task: str, tokenizer,
                     img_size: Optional[int] = None) -> List[int]:
    """reference _parse_and_to_tensor (generate_samples.py:68-73)."""
    template = QUERY_TEMPLATES[task]
    text = raw_text if task == "raw" else template.format(*raw_text.split("\t"))
    return tokenizer.parse_query(text, img_size=img_size or task_img_size(task))


@dataclasses.dataclass
class GenerationOutput:
    tokens: np.ndarray  # [B, S]
    scores: np.ndarray  # [B]
    images: List[np.ndarray]  # decoded [1, h, w, 3] arrays
    texts: List[list]  # decoded text/command streams


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _chunk_seed(seed: int, chunk: int) -> int:
    """uint32 sampling seed of batch chunk ``chunk``: a counter hash of the
    user's seed.  The JAX package splits a ``jax.random`` key per chunk
    instead, so the two packages draw different samples from one --seed."""
    return int(hash_u32(seed, chunk, 0x7E57, 0))


def generate_once(
    params,
    cfg: GPTConfig,
    tokenizer,
    raw_text: str,
    task: str = "text2image",
    num: int = 8,
    max_inference_batch_size: int = 12,
    sampling: SamplingParams = SamplingParams(),
    device=None,
    pad_bucket: int = 32,
) -> GenerationOutput:
    """text2image (generate_images_once): sample ``num`` images for one
    query in chunks of at most ``max_inference_batch_size`` rows.  Template
    lengths are bucketed to multiples of ``pad_bucket`` with fixed [PAD]
    steps.  Chunk i samples with seed ``_chunk_seed(sampling.seed, i)``."""
    if task != "text2image":
        raise NotImplementedError(
            f"task {task!r}: the port has only text2image so far")
    seq = parse_query_line(raw_text, task, tokenizer)
    tpl = compile_template(seq, tokenizer, padded_vocab=cfg.vocab_size,
                           pad_to=_round_up(len(seq), pad_bucket))

    outs, scores = [], []
    remaining, chunk = num, 0
    while remaining > 0:
        b = min(remaining, max_inference_batch_size)
        t, s = filling_sequence(params, cfg, tpl, b, sampling,
                                _chunk_seed(sampling.seed, chunk), device)
        outs.append(t.cpu().numpy())
        scores.append(s.cpu().numpy())
        remaining -= b
        chunk += 1
    tokens = np.concatenate(outs, axis=0)[:, : len(seq)]
    scores = np.concatenate(scores, axis=0)

    images, texts = [], []
    for row in tokens:
        parts, imgs = tokenizer.DecodeIds(row.tolist())
        texts.append(parts)
        if imgs:
            images.append(imgs[-1])  # the generated (last) image
    return GenerationOutput(tokens, scores, images, texts)
