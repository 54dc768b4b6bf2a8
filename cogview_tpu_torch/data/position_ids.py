"""Training-side position ids (twin of cogview_tpu/data/position_ids.py).

Standard runs use 0..S-1.  Super-resolution finetuning uses dual-segment
ids: per sample, positions restart at 0 at the first [ROI2] token and are
clamped to max_position_embeddings - 1.
"""

from __future__ import annotations

import numpy as np


def dual_segment_position_ids(tokens: np.ndarray, roi2_id: int,
                              max_position_embeddings: int) -> np.ndarray:
    """[B, S] token ids -> int32 [B, S] position ids; raises on a row
    without [ROI2]."""
    tokens = np.asarray(tokens)
    B, S = tokens.shape
    is_roi2 = tokens == roi2_id
    if not is_roi2.any(axis=1).all():
        raise ValueError("Some samples do not have [ROI2]!")
    sep = is_roi2.argmax(axis=1)  # first occurrence per row
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    second = pos - sep[:, None]
    pos = np.where(second >= 0, second, pos)
    return np.minimum(pos, max_position_embeddings - 1).astype(np.int32)
