"""Agenda-based BPE segmentation over a SentencePiece piece table.

``cog-pretrain.model`` is a BPE model (TrainerSpec.model_type == 2): each
NORMAL piece's score is the negated merge rank, so greedy
highest-score-first merging of adjacent symbol pairs replays the exact
training-time merge order.  Tie-breaking is leftmost-first (scores are
distinct ranks, so this only matters defensively).

Pipeline per call: normalize -> initial symbols (user-defined pieces
longest-matched first, then single unicode chars) -> merge loop driven by a
heap -> ids (unknown chars map to unk_id).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List

from .normalizer import SPACE_SYMBOL, Normalizer
from .spm_proto import (
    PIECE_CONTROL,
    PIECE_NORMAL,
    PIECE_UNKNOWN,
    PIECE_USER_DEFINED,
    SpmModel,
)

DEFAULT_UNK_SURFACE = " ⁇ "


class BpeEncoder:
    def __init__(self, model: SpmModel):
        self.model = model
        self.normalizer = Normalizer(model.normalizer)
        self.unk_id = model.unk_id
        # Only NORMAL pieces participate in merges; USER_DEFINED are matched
        # up-front; CONTROL/UNKNOWN never match raw text.
        self.merge_scores: Dict[str, float] = {}
        self.matchable_ids: Dict[str, int] = {}
        for i, (piece, score, ptype) in enumerate(
            zip(model.pieces, model.scores, model.types)
        ):
            if ptype == PIECE_NORMAL:
                if piece not in self.merge_scores:
                    self.merge_scores[piece] = score
                    self.matchable_ids[piece] = i
            elif ptype == PIECE_USER_DEFINED:
                self.matchable_ids.setdefault(piece, i)
        self.user_defined = sorted(
            (p for p, t in zip(model.pieces, model.types) if t == PIECE_USER_DEFINED),
            key=len,
            reverse=True,
        )

    # ------------------------------------------------------------------ #

    def _initial_symbols(self, text: str) -> List[str]:
        symbols: List[str] = []
        i = 0
        n = len(text)
        while i < n:
            matched = False
            for ud in self.user_defined:
                if text.startswith(ud, i):
                    symbols.append(ud)
                    i += len(ud)
                    matched = True
                    break
            if not matched:
                symbols.append(text[i])
                i += 1
        return symbols

    def encode_to_pieces_normalized(self, normalized: str) -> List[str]:
        symbols = self._initial_symbols(normalized)
        n = len(symbols)
        if n <= 1:
            return symbols

        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(0, n - 1))
        alive = [True] * n
        heap: List = []

        def try_pair(left: int):
            right = nxt[left]
            if right < 0:
                return
            merged = symbols[left] + symbols[right]
            score = self.merge_scores.get(merged)
            if score is not None:
                heapq.heappush(heap, (-score, left, merged))

        for i in range(n - 1):
            try_pair(i)

        while heap:
            _, left, merged = heapq.heappop(heap)
            if not alive[left]:
                continue
            right = nxt[left]
            if right < 0 or not alive[right]:
                continue
            if symbols[left] + symbols[right] != merged:
                continue  # stale agenda entry
            symbols[left] = merged
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prv[nxt[right]] = left
            if prv[left] >= 0:
                try_pair(prv[left])
            try_pair(left)

        out = []
        i = 0
        while i != -1:
            if alive[i]:
                out.append(symbols[i])
            i = nxt[i]
        return out

    # ------------------------------------------------------------------ #

    def encode_as_pieces(self, text: str) -> List[str]:
        return self.encode_to_pieces_normalized(self.normalizer.normalize(text))

    def piece_to_id(self, piece: str) -> int:
        return self.matchable_ids.get(
            piece, self.model.piece_to_id.get(piece, self.unk_id)
        )

    def encode(self, text: str) -> List[int]:
        return [self.piece_to_id(p) for p in self.encode_as_pieces(text)]

    def decode(self, ids: Iterable[int]) -> str:
        parts: List[str] = []
        for t in ids:
            t = int(t)
            if not 0 <= t < self.model.vocab_size:
                continue
            ptype = self.model.types[t]
            if ptype == PIECE_CONTROL:
                continue
            if ptype == PIECE_UNKNOWN:
                parts.append(DEFAULT_UNK_SURFACE)
            else:
                parts.append(self.model.pieces[t])
        text = "".join(parts).replace(SPACE_SYMBOL, " ")
        if text.startswith(" "):
            text = text[1:]
        return text
