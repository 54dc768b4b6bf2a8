"""Generation tasks (twin of cogview_tpu/generation/tasks.py).

The query templates are the reference's.  ``generate_once`` samples
text2image, image2text, low-level super-resolution (a 128-pixel image
context) and ``raw`` (the input line is the template-language query);
``super_resolution`` magnifies a 256-pixel image's codes to 512 pixels
through the nine windows of ``magnify``; ``post_selection`` scores
candidate images.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import GPTConfig
from ..ops.hash_prng import hash_u32
from .magnify import magnify
from .sampling import SamplingParams, compile_template, filling_sequence
from .scoring import inverse_prompt_score

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
    """text2image / image2text / low-level super-resolution / raw
    (generate_images_once): sample ``num`` rows for one query in chunks of
    at most ``max_inference_batch_size`` rows.  Template lengths are
    bucketed to multiples of ``pad_bucket`` with fixed [PAD] steps.  Chunk
    i samples with seed ``_chunk_seed(sampling.seed, i)``."""
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


def super_resolution(params, cfg: GPTConfig, tokenizer, raw_text: str,
                     sampling: SamplingParams = SamplingParams(), device=None,
                     window_seeds: Optional[List[int]] = None) -> GenerationOutput:
    """256 -> 512 pixels (generate_samples.py:223-244): parse the text and
    image context, magnify the last 1024 codes through the nine windows
    (``window_seeds``: see :func:`magnify.magnify`), and decode the first
    row's 64 x 64 codes -> tokens [1, 4096], one [1, 512, 512, 3] image."""
    seq = parse_query_line(raw_text, "super-resolution", tokenizer)
    code, text_part = seq[-1024:], seq[:-1024]
    magnified = magnify(params, cfg, tokenizer, code, text_part, sampling, window_seeds,
                        device)
    images = [tokenizer.img_tokenizer.DecodeIds(magnified[0])]
    return GenerationOutput(magnified, np.zeros((1,)), images, [])


def post_selection(params, cfg: GPTConfig, tokenizer, raw_text: str,
                   max_inference_batch_size: int = 12, device=None) -> np.ndarray:
    """Score candidate images for one prompt (generate_samples.py:246-269).

    ``raw_text`` = 'text\\timg1\\timg2...'; returns [n_candidates] float32
    scores, each the caption log-likelihood given the image."""
    parts = raw_text.split("\t")
    seqs = [parse_query_line("\t".join([cand, parts[0]]), "post-selection", tokenizer)
            for cand in parts[1:]]
    tokens = np.asarray(seqs, np.int64)
    assert tokens.ndim == 2
    assert tokens[0, 2 + 1024 + 1] == tokenizer["[ROI1]"], "unexpected post-selection layout"

    mbz = max_inference_batch_size
    out = []
    for i in range(0, len(tokens), mbz):
        chunk = torch.as_tensor(tokens[i:i + mbz], device=device)
        out.append(inverse_prompt_score(params, cfg, chunk,
                                        img_vocab=tokenizer.img_tokenizer.num_tokens)
                   .cpu().numpy())
    return np.concatenate(out, axis=0)
