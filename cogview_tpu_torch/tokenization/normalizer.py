"""SentencePiece text normalization from a precompiled charsmap.

The ``nmt_nfkc`` rules shipped inside ``cog-pretrain.model`` are a
darts-clone double-array trie over UTF-8 byte prefixes plus a pool of
replacement strings.  Normalization = repeated longest-prefix match with
replacement, followed by the whitespace policy (collapse/trim, dummy
prefix, and the U+2581 LOWER ONE EIGHTH BLOCK escape).

This module implements the trie traversal and policy directly so the
framework carries no dependency on the sentencepiece C++ library while
producing identical normalized strings.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from .spm_proto import NormalizerSpec

SPACE_SYMBOL = "▁"  # ▁


class CharsMapTrie:
    """Read-only darts-clone double array with commonPrefixSearch.

    Unit encoding (darts-clone 0.32):
      has_leaf = (u >> 8) & 1
      value    = u & 0x7FFFFFFF          (on the unit reached after offset)
      label    = u & (0x80000000 | 0xFF)
      offset   = (u >> 10) << ((u & 0x200) >> 6)
    """

    __slots__ = ("units", "pool")

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            self.units: Tuple[int, ...] = ()
            self.pool = b""
            return
        (trie_size,) = struct.unpack("<I", blob[:4])
        trie_blob = blob[4 : 4 + trie_size]
        self.units = struct.unpack(f"<{trie_size // 4}I", trie_blob)
        self.pool = blob[4 + trie_size :]

    def longest_prefix_match(self, data: bytes, start: int) -> Tuple[int, Optional[bytes]]:
        """Longest key match in ``data[start:]``.

        Returns (matched_byte_length, replacement_bytes) or (0, None).
        """
        units = self.units
        if not units:
            return 0, None
        node_pos = 0
        unit = units[node_pos]
        node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
        best_len = 0
        best_value = -1
        for i in range(start, len(data)):
            c = data[i]
            node_pos ^= c
            unit = units[node_pos]
            if (unit & (0x80000000 | 0xFF)) != c:
                break
            node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
            if (unit >> 8) & 1:
                best_len = i - start + 1
                best_value = units[node_pos] & 0x7FFFFFFF
        if best_len == 0:
            return 0, None
        end = self.pool.find(b"\0", best_value)
        if end < 0:
            end = len(self.pool)
        return best_len, self.pool[best_value:end]


def _utf8_char_len(b0: int) -> int:
    if b0 < 0x80:
        return 1
    if b0 >> 5 == 0b110:
        return 2
    if b0 >> 4 == 0b1110:
        return 3
    if b0 >> 3 == 0b11110:
        return 4
    return 1  # invalid lead byte: consume one byte


class Normalizer:
    """Applies the full SentencePiece normalization pipeline.

    Equivalent to sentencepiece's Normalizer::Normalize for specs with
    ``treat_whitespace_as_suffix=false`` (the cog-pretrain case):

      1. charsmap longest-prefix replacement over the raw UTF-8 bytes
      2. collapse runs of spaces and strip edges (remove_extra_whitespaces)
      3. prepend one space (add_dummy_prefix)
      4. map ' ' -> U+2581 (escape_whitespaces)
    """

    def __init__(self, spec: NormalizerSpec):
        self.spec = spec
        self.trie = CharsMapTrie(spec.precompiled_charsmap)

    def charsmap_normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        out: List[bytes] = []
        i = 0
        n = len(data)
        while i < n:
            mlen, repl = self.trie.longest_prefix_match(data, i)
            if mlen > 0:
                out.append(repl)
                i += mlen
            else:
                clen = _utf8_char_len(data[i])
                out.append(data[i : i + clen])
                i += clen
        return b"".join(out).decode("utf-8", errors="replace")

    def normalize(self, text: str) -> str:
        s = self.charsmap_normalize(text)
        if self.spec.remove_extra_whitespaces:
            parts = [p for p in s.split(" ") if p]
            s = " ".join(parts)
        if not s:
            # empty/whitespace-only input encodes to no pieces (spm behavior)
            return ""
        if self.spec.add_dummy_prefix:
            s = " " + s
        if self.spec.escape_whitespaces:
            s = s.replace(" ", SPACE_SYMBOL)
        return s
