"""Inception Score (twin of cogview_tpu/eval_utils/inception_score.py; the
reference's eval_utils/inception_score.py:10-65; framework-free).

IS = exp(E_x[ KL(p(y|x) || p(y)) ]), computed per split.  The classifier
is pluggable for the same reason as FID's extractor; pass class
probabilities directly when a classifier already ran.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def inception_score_from_probs(
    probs: np.ndarray, splits: int = 10
) -> Tuple[float, float]:
    """probs: [n, n_classes] softmax outputs -> (mean, std) over splits."""
    probs = np.asarray(probs, np.float64)
    n = len(probs)
    scores = []
    for k in range(splits):
        part = probs[k * (n // splits) : (k + 1) * (n // splits)]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(
    images: np.ndarray,
    classifier: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 32,
    splits: int = 10,
) -> Tuple[float, float]:
    probs = []
    for i in range(0, len(images), batch_size):
        probs.append(np.asarray(classifier(images[i : i + batch_size])))
    return inception_score_from_probs(np.concatenate(probs, axis=0), splits)
