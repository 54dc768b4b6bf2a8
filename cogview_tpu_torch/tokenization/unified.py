"""Unified image+text+command vocabulary (the port's copy of
cogview_tpu/tokenization/unified.py).

Vocabulary layout (identical to the reference, data_utils/
unified_tokenizer.py:24-67):

    [0, n_img)                      image codes (VQ-VAE, n_img = 8192)
    [n_img, n_img + n_txt)          SentencePiece text ids (n_txt = 50000)
    [n_img + n_txt, ... + 27)       command tokens, in the order below

Also re-provides the two mini-languages of the reference:
``parse_query`` (unified_tokenizer.py:154-196) turning a query string of
command tokens / ``[MASK]*N`` slots / ``[Image*N]path`` references / raw
text into a template id list with -1 "generate here" slots, and
``wrap_code`` (:125-152).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .text_tokenizer import DEFAULT_MODEL_PATHS, TextTokenizer, from_pretrained


def make_text_tokenizer(model_path=None, prefer_native: bool = True):
    """The native SentencePiece runtime (``sp_cpp.py``, the same ids as the
    pure-Python one) wherever it is built or a C++ compiler can build it,
    as the JAX package prefers its own; a failed build or load raises.
    ``prefer_native=False``, or a machine with neither, gives the
    pure-Python runtime.  Without ``model_path`` the default path is
    relative to the working directory."""
    from . import sp_cpp

    if prefer_native and sp_cpp.available():
        if model_path is None:
            model_path = next((c for c in DEFAULT_MODEL_PATHS if os.path.exists(c)), None)
        if model_path is not None:
            return sp_cpp.CppTextTokenizer(model_path)
    return from_pretrained(model_path)


# (name, relative id) — order is part of the vocabulary contract.
RAW_COMMAND_TOKENS: Tuple[Tuple[str, int], ...] = (
    ("[PAD]", 0),
    ("[BOI1]", 1),
    ("[BOI2]", 2),
    ("[BOI3]", 3),
    ("[EOI1]", 4),
    ("[EOI2]", 5),
    ("[EOI3]", 6),
    ("[ROI1]", 7),
    ("[ROI2]", 8),
    ("[ROI3]", 9),
    ("[SEP]", 10),
    ("[MASK]", 11),
    ("[CLS]", 12),
    ("[ENC]", 13),
    ("[TINY]", 14),  # 8 x 8
    ("[SMALL]", 15),  # 16 x 16
    ("[BASE]", 16),  # 32 x 32
    ("[BIG]", 17),  # 64 x 64
    ("[POS0]", 18),
    ("[POS1]", 19),
    ("[POS2]", 20),
    ("[POS3]", 21),
    ("[POS4]", 22),
    ("[POS5]", 23),
    ("[POS6]", 24),
    ("[POS7]", 25),
    ("[POS8]", 26),
)

SIZE_TOKEN_BY_SIDE = {8: "[TINY]", 16: "[SMALL]", 32: "[BASE]", 64: "[BIG]"}


def sqrt_int(x: int) -> int:
    r = int(np.sqrt(x) + 1e-4)
    if r * r != x:
        raise ValueError(f"{x} is not a perfect square")
    return r


class FakeImageTokenizer:
    """Vocab-size-only stand-in (reference FakeTokenizer) used when VQ-VAE
    weights are unavailable, e.g. for pure-text pretraining or unit tests."""

    def __init__(self, num_tokens: int = 8192):
        self.num_tokens = num_tokens

    def __len__(self) -> int:
        return self.num_tokens


class UnifiedTokenizer:
    def __init__(
        self,
        img_tokenizer=None,
        txt_tokenizer: Optional[TextTokenizer] = None,
        img_tokenizer_num_tokens: Optional[int] = None,
        text_model_path: Optional[str] = None,
    ):
        if img_tokenizer is None:
            img_tokenizer = FakeImageTokenizer(img_tokenizer_num_tokens or 8192)
        self.img_tokenizer = img_tokenizer
        if txt_tokenizer is None:
            txt_tokenizer = make_text_tokenizer(text_model_path)
        self.txt_tokenizer = txt_tokenizer
        base = self.img_tokenizer.num_tokens + self.txt_tokenizer.num_tokens
        self.command_tokens = {name: base + rel for name, rel in RAW_COMMAND_TOKENS}
        self.num_tokens = base + len(RAW_COMMAND_TOKENS)
        self._command_base = base

    # -------------------------------------------------------------- #

    def __getitem__(self, command_token: str) -> int:
        return self.command_tokens[command_token]

    def __len__(self) -> int:
        return self.num_tokens

    @property
    def img_vocab(self) -> int:
        return self.img_tokenizer.num_tokens

    @property
    def txt_vocab(self) -> int:
        return self.txt_tokenizer.num_tokens

    # -------------------------------------------------------------- #

    def EncodeAsIds(self, text: str, process_fn=None) -> List[int]:
        if process_fn is not None:
            text = process_fn(text)
        offset = self.img_tokenizer.num_tokens
        return [t + offset for t in self.txt_tokenizer.encode(text)]

    def DecodeIds(self, ids: Sequence[int]):
        """Split an id stream into text/commands and decoded images.

        Returns (parts, images): ``parts`` interleaves decoded text strings
        and command token names; ``images`` collects decoded image arrays
        (an image buffer is flushed whenever an [EOI*] command appears, or
        at end of stream).
        """
        parts: List[str] = []
        images = []
        img_buffer: List[int] = []
        txt_buffer: List[int] = []
        n_img = self.img_tokenizer.num_tokens

        def flush_txt():
            if txt_buffer:
                parts.append(self.txt_tokenizer.decode([t - n_img for t in txt_buffer]))
                txt_buffer.clear()

        def flush_img():
            if img_buffer:
                images.append(self.img_tokenizer.DecodeIds(list(img_buffer)))
                img_buffer.clear()

        for x in ids:
            x = int(x)
            if x >= self._command_base:
                name = RAW_COMMAND_TOKENS[x - self._command_base][0]
                if name.startswith("[EOI"):
                    flush_img()
                flush_txt()
                parts.append(name)
            elif x < n_img:
                img_buffer.append(x)
            else:
                txt_buffer.append(x)
        flush_img()
        flush_txt()
        return parts, images

    # -------------------------------------------------------------- #

    def wrap_code(self, code: Sequence[int], idx: int = 1) -> List[int]:
        side = sqrt_int(len(code))
        prefix = SIZE_TOKEN_BY_SIDE[side]
        boi = {1: "[BOI1]", 2: "[BOI2]", 3: "[BOI3]"}[idx]
        eoi = {1: "[EOI1]", 2: "[EOI2]", 3: "[EOI3]"}[idx]
        return (
            [self.command_tokens[prefix], self.command_tokens[boi]]
            + [int(c) for c in code]
            + [self.command_tokens[eoi]]
        )

    def parse_query(self, query: str, img_size: int = 256) -> List[int]:
        """Template mini-language -> id list with -1 slots to generate.

        Space-separated parts: literal command tokens; ``[MASK]`` or
        ``[MASK]*N`` -> N generation slots; ``[Image*N]path`` -> VQ-encode
        the file and keep the first N codes (rest become -1 slots); anything
        else accumulates as text.
        """
        ret: List[int] = []
        text_buffer: List[str] = []

        def flush_text():
            if text_buffer:
                ret.extend(self.EncodeAsIds(" ".join(text_buffer)))
                text_buffer.clear()

        for part in query.split(" "):
            if part in self.command_tokens:
                flush_text()
                if part == "[MASK]":
                    ret.append(-1)
                else:
                    ret.append(self.command_tokens[part])
            elif part.startswith("[MASK]*"):
                c = int(part[7:])
                assert c > 0
                flush_text()
                ret.extend([-1] * c)
            elif part.startswith("[Image"):
                flush_text()
                spec = part[6:]
                assert spec, "malformed [Image...] part"
                num_codes_s, img_path = spec.split("]", 1)
                # reference syntax is '[ImageN]path' (its '[Image*N]' comment
                # mismatches its own parser); accept both.
                num_codes_s = num_codes_s.lstrip("*")
                num_codes = int(num_codes_s) if num_codes_s else 1024
                raw_img = self.img_tokenizer.read_img(img_path, img_size=img_size)
                img_codes = np.asarray(self.img_tokenizer.EncodeAsIds(raw_img))
                img_codes = img_codes.reshape(-1).astype(np.int64)
                img_codes[num_codes:] = -1
                ret.extend(int(c) for c in img_codes)
            else:
                text_buffer.append(part)
        flush_text()
        return ret


_TOKENIZER_SINGLETON: Optional[UnifiedTokenizer] = None


def get_tokenizer(**kwargs) -> UnifiedTokenizer:
    """Process-wide singleton, mirroring the reference get_tokenizer
    (unified_tokenizer.py:198-206).  First call fixes the configuration."""
    global _TOKENIZER_SINGLETON
    if _TOKENIZER_SINGLETON is None:
        _TOKENIZER_SINGLETON = UnifiedTokenizer(**kwargs)
    return _TOKENIZER_SINGLETON


def reset_tokenizer() -> None:
    global _TOKENIZER_SINGLETON
    _TOKENIZER_SINGLETON = None
