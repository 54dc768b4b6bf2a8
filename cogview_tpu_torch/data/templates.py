"""Sequence templates (data_utils/templates.py rebuilt, numpy-native).

The tokenizer is passed explicitly — no process singleton — and outputs are
int64 numpy arrays ready for batching.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

TextLike = Union[str, Sequence[int], np.ndarray]


def _text_ids(tokenizer, text: TextLike, prefix_token: str = "[ROI1]") -> np.ndarray:
    if isinstance(text, str):
        ids = [tokenizer[prefix_token]] + tokenizer.EncodeAsIds(text)
        return np.asarray(ids, np.int64)
    return np.concatenate(
        ([tokenizer[prefix_token]], np.asarray(text, np.int64)), axis=0
    )


def TextCodeTemplate(tokenizer, text: TextLike, code) -> np.ndarray:
    """'[ROI1] text [SIZE][BOI1] code [EOI1]' (templates.py:52-65)."""
    text_ids = _text_ids(tokenizer, text)
    code = np.asarray(tokenizer.wrap_code(np.asarray(code, np.int64)), np.int64)
    return np.concatenate((text_ids, code), axis=0)


def Code2CodeTemplate(tokenizer, text: TextLike, code0, code1) -> np.ndarray:
    """text ++ wrap(code0, idx=1) ++ wrap(code1, idx=2) (templates.py:67-72)."""
    if isinstance(text, str):
        text_ids = np.asarray(tokenizer.parse_query(text), np.int64)
    else:
        text_ids = np.asarray(text, np.int64)
    c0 = np.asarray(tokenizer.wrap_code(np.asarray(code0, np.int64)), np.int64)
    c1 = np.asarray(tokenizer.wrap_code(np.asarray(code1, np.int64), idx=2), np.int64)
    return np.concatenate((text_ids, c0, c1), axis=0)


def PureTextTemplate(tokenizer, text: str) -> np.ndarray:
    """text ++ [SEP] (templates.py:74-76)."""
    return np.asarray(tokenizer.EncodeAsIds(text) + [tokenizer["[SEP]"]], np.int64)
