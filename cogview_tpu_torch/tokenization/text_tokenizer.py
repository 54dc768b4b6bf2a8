"""Text tokenizer facade with the reference Encoder_SP surface (the port's
copy of cogview_tpu/tokenization/text_tokenizer.py).

Mirrors the API of the reference wrapper (data_utils/sp_tokenizer.py:98-127:
encode / decode / tokenize / convert_*), backed by the from-scratch
SentencePiece BPE runtime instead of the C++ library.
"""

from __future__ import annotations

import os
from typing import Iterable, List

from .bpe import BpeEncoder
from .spm_proto import SpmModel, load_model

# relative to the working directory
DEFAULT_MODEL_PATHS = ("pretrained/chinese_sentencepiece/cog-pretrain.model",)


class TextTokenizer:
    def __init__(self, model_path: str):
        self.model: SpmModel = load_model(model_path)
        self.bpe = BpeEncoder(self.model)
        self.num_tokens = self.model.vocab_size

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Iterable[int]) -> str:
        return self.bpe.decode(int(t) for t in ids)

    def tokenize(self, text: str) -> List[str]:
        return self.bpe.encode_as_pieces(text)

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.bpe.piece_to_id(t) for t in tokens]

    def convert_token_to_id(self, token: str) -> int:
        return self.bpe.piece_to_id(token)

    def convert_id_to_token(self, idx: int) -> str:
        return self.model.pieces[idx]

    def __len__(self) -> int:
        return self.num_tokens


def from_pretrained(model_path: str | None = None) -> TextTokenizer:
    if model_path is None:
        for cand in DEFAULT_MODEL_PATHS:
            if os.path.exists(cand):
                model_path = cand
                break
        else:
            raise FileNotFoundError(
                "no cog-pretrain.model found; pass model_path explicitly"
            )
    return TextTokenizer(model_path)
