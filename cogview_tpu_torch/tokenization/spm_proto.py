"""Minimal protobuf wire-format reader for SentencePiece ``ModelProto``.

We only need four things out of the model file: the ordered piece table
(piece string, score, type), the model type, and the normalizer spec (name,
precompiled charsmap, and the three whitespace flags).  Rather than depend
on a compiled proto schema, this parses the stable protobuf wire format
directly — field numbers are taken from the public sentencepiece_model.proto.

Reference behavior being reproduced: data_utils/sp_tokenizer.py:98-127 loads
this exact file through the sentencepiece C++ library.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# sentencepiece_model.proto :: SentencePiece.Type
PIECE_NORMAL = 1
PIECE_UNKNOWN = 2
PIECE_CONTROL = 3
PIECE_USER_DEFINED = 4
PIECE_BYTE = 6
PIECE_UNUSED = 5

# sentencepiece_model.proto :: TrainerSpec.ModelType
MODEL_UNIGRAM = 1
MODEL_BPE = 2
MODEL_WORD = 3
MODEL_CHAR = 4


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, i
        shift += 7


def parse_fields(buf: bytes, start: int = 0, end: int | None = None) -> Dict[int, List]:
    """Parse one message into {field_number: [values]} with raw wire values.

    varint fields -> int, length-delimited -> bytes, fixed32 -> float,
    fixed64 -> float.  Repeated fields accumulate in order.
    """
    if end is None:
        end = len(buf)
    i = start
    fields: Dict[int, List] = {}
    while i < end:
        key, i = _read_varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            v, i = _read_varint(buf, i)
        elif wtype == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wtype == 5:
            v = struct.unpack("<f", buf[i : i + 4])[0]
            i += 4
        elif wtype == 1:
            v = struct.unpack("<d", buf[i : i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wtype} at offset {i}")
        fields.setdefault(fnum, []).append(v)
    return fields


@dataclass
class NormalizerSpec:
    name: str = ""
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


@dataclass
class SpmModel:
    """The decoded contents of a SentencePiece .model file."""

    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    model_type: int = MODEL_BPE
    unk_id: int = 0
    normalizer: NormalizerSpec = field(default_factory=NormalizerSpec)
    piece_to_id: Dict[str, int] = field(default_factory=dict)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)


def load_model(path: str) -> SpmModel:
    with open(path, "rb") as f:
        blob = f.read()
    top = parse_fields(blob)

    model = SpmModel()
    # ModelProto: 1 = repeated SentencePiece pieces, 2 = TrainerSpec,
    # 3 = NormalizerSpec.
    for raw in top.get(1, []):
        pf = parse_fields(raw)
        piece = pf[1][0].decode("utf-8")
        score = float(pf.get(2, [0.0])[0])
        ptype = int(pf.get(3, [PIECE_NORMAL])[0])
        model.pieces.append(piece)
        model.scores.append(score)
        model.types.append(ptype)

    if 2 in top:
        ts = parse_fields(top[2][0])
        # TrainerSpec: 3 = model_type, 40 = unk_id (default 0)
        model.model_type = int(ts.get(3, [MODEL_BPE])[0])
        model.unk_id = int(ts.get(40, [0])[0])

    if 3 in top:
        ns = parse_fields(top[3][0])
        spec = model.normalizer
        # NormalizerSpec: 1 = name, 2 = precompiled_charsmap,
        # 3 = add_dummy_prefix, 4 = remove_extra_whitespaces,
        # 5 = escape_whitespaces
        if 1 in ns:
            spec.name = ns[1][0].decode("utf-8")
        if 2 in ns:
            spec.precompiled_charsmap = ns[2][0]
        if 3 in ns:
            spec.add_dummy_prefix = bool(ns[3][0])
        if 4 in ns:
            spec.remove_extra_whitespaces = bool(ns[4][0])
        if 5 in ns:
            spec.escape_whitespaces = bool(ns[5][0])

    for i, p in enumerate(model.pieces):
        # first occurrence wins, matching sentencepiece's id lookup
        model.piece_to_id.setdefault(p, i)
    return model
