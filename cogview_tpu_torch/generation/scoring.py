"""Caption-likelihood scoring for post-selection (twin of cogview_tpu/generation/scoring.py).

For sequences laid out as ``[BASE][BOI1] <1024 image codes> [EOI1] [ROI1]
<text>``, the score is the sum of the text tokens' log-probabilities given
the image: one batched causal forward, with the image codes masked out of
the softmax.  At S >= ``flash_min_seq`` the forward's attention runs
through the flash kernel.
"""

from __future__ import annotations

import torch

from ..config import GPTConfig
from ..models import gpt

BOTEXT = 2 + 1024 + 1  # [BASE][BOI1] + 1024 codes + [EOI1]


@torch.no_grad()
def inverse_prompt_score(params, cfg: GPTConfig, tokens: torch.Tensor,
                         img_vocab: int = 8192, botext: int = BOTEXT) -> torch.Tensor:
    """tokens [B, S] full sequences -> [B] float32 sums of
    log p(text_t | image, prefix) over t > botext.  The padded vocabulary
    rows past the unified vocabulary stay unmasked, as in the JAX package."""
    tokens = tokens.long()
    # logits only from botext on: the text tail is ~30 of ~1058 positions
    logits = gpt.forward(params, cfg, tokens, logits_from=botext)
    logits[..., :img_vocab] = -torch.inf
    log_probs = torch.log_softmax(logits, dim=-1)
    pred = log_probs[:, :-1]  # predicts positions botext+1..S-1
    target = tokens[:, botext + 1:]
    return pred.gather(-1, target[..., None])[..., 0].sum(dim=-1)
