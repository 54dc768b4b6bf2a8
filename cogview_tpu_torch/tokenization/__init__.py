"""Tokenization of the port: the image tokenizer (``vq_tokenizer``) and the
port's own copy of the text side and the unified vocabulary
(``spm_proto``, ``normalizer``, ``bpe``, ``text_tokenizer``, ``unified``),
copied from ``cogview_tpu.tokenization`` with the pure-Python SentencePiece
runtime."""

from .text_tokenizer import TextTokenizer, from_pretrained
from .unified import FakeImageTokenizer, UnifiedTokenizer, get_tokenizer, make_text_tokenizer

__all__ = [
    "TextTokenizer",
    "from_pretrained",
    "UnifiedTokenizer",
    "FakeImageTokenizer",
    "get_tokenizer",
    "make_text_tokenizer",
]
