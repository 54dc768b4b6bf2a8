"""The port's copy of the text side and the unified vocabulary
(cogview_tpu_torch.tokenization) against cogview_tpu.tokenization.

The released cog-pretrain.model is not in the repository, so the
SentencePiece cases run on a small BPE model written here in the same
protobuf wire format: pieces of every type, merge scores, and the
normalizer's whitespace flags.  The unified-vocabulary cases of
tests/test_unified_tokenizer.py run on that model and on a stand-in text
tokenizer with the released vocabulary size."""

import struct

import numpy as np
import pytest

from cogview_tpu.tokenization import spm_proto as jproto
from cogview_tpu.tokenization import text_tokenizer as jtext
from cogview_tpu.tokenization import unified as junified
from cogview_tpu_torch import tokenization as ttok
from cogview_tpu_torch.tokenization import spm_proto as tproto
from cogview_tpu_torch.tokenization import text_tokenizer as ttext
from cogview_tpu_torch.tokenization import unified as tunified


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, wire, payload):
    key = _varint(num << 3 | wire)
    if wire == 0:
        return key + _varint(payload)
    if wire == 5:
        return key + struct.pack("<f", payload)
    return key + _varint(len(payload)) + payload


NORMAL, UNKNOWN, CONTROL, USER = 1, 2, 3, 4
# merges get negated ranks as scores, as a trained BPE model has them
PIECES = ([("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
           ("<n>", 0.0, USER), ("[X]", 0.0, USER)]
          + [(p, -float(r), NORMAL) for r, p in enumerate(
              ["▁t", "he", "▁the", "▁c", "at", "▁cat", "▁a", "▁ca", "小猫", "一只"])]
          + [(c, -100.0, NORMAL) for c in "▁thecaosdg一只小猫的"])


def _write_model(path, add_dummy_prefix=True, remove_extra_whitespaces=True):
    blob = b"".join(_field(1, 2, _field(1, 2, p.encode()) + _field(2, 5, s) + _field(3, 0, t))
                    for p, s, t in PIECES)
    blob += _field(2, 2, _field(3, 0, 2) + _field(40, 0, 0))  # BPE, unk_id 0
    blob += _field(3, 2, _field(1, 2, b"identity") + _field(3, 0, int(add_dummy_prefix))
                   + _field(4, 0, int(remove_extra_whitespaces)) + _field(5, 0, 1))
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)


TEXTS = ["the cat", "  the   cat  ", "a cat sat", "一只小猫的", "the[X]cat<n>", "zzz the",
         "", "   ", "cat\tdog", "thethe"]


@pytest.mark.parametrize("flags", [(True, True), (False, True), (True, False)])
def test_text_tokenizer_same_ids_as_jax(tmp_path, flags):
    """The model parses to the same tables, and every text encodes to the
    same ids and pieces and decodes to the same string."""
    path = _write_model(tmp_path / "m.model", *flags)
    jm, tm = jproto.load_model(path), tproto.load_model(path)
    for name in ("pieces", "scores", "types", "model_type", "unk_id", "piece_to_id"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert vars(tm.normalizer) == vars(jm.normalizer)
    jt, tt = jtext.from_pretrained(path), ttext.from_pretrained(path)
    assert tt.num_tokens == jt.num_tokens == len(PIECES)
    for s in TEXTS:
        ids = tt.encode(s)
        assert ids == jt.encode(s), s
        assert tt.tokenize(s) == jt.tokenize(s), s
        assert tt.decode(ids) == jt.decode(ids), s
    if flags[0]:  # with the dummy prefix the merges reach whole words
        assert tt.encode("the cat") == [tt.convert_token_to_id("▁the"),
                                        tt.convert_token_to_id("▁cat")]
    assert tt.decode([0, 1, 7]) == jt.decode([0, 1, 7])  # unk surface, control dropped
    assert tt.convert_id_to_token(5) == jt.convert_id_to_token(5)


def test_port_text_tokenizer_is_pure_python(tmp_path):
    """make_text_tokenizer gives the native runtime wherever it is built or
    g++ can build it, as the JAX package prefers its own, and the
    pure-Python runtime only with prefer_native=False; both with the JAX
    package's ids.  The default model path is relative to the working
    directory."""
    from cogview_tpu_torch.ops import _kernels
    from cogview_tpu_torch.tokenization import sp_cpp

    path = _write_model(tmp_path / "m.model")
    tok = tunified.make_text_tokenizer(path)
    assert sp_cpp.available() == (_kernels.host_compiler() is not None
                                  or _kernels.host_target("spm").exists())
    assert isinstance(tok, sp_cpp.CppTextTokenizer if sp_cpp.available()
                      else ttext.TextTokenizer)
    py = tunified.make_text_tokenizer(path, prefer_native=False)
    assert isinstance(py, ttext.TextTokenizer)
    want = jtext.from_pretrained(path).encode("the cat")
    assert tok.encode("the cat") == py.encode("the cat") == want
    assert ttext.DEFAULT_MODEL_PATHS == ("pretrained/chinese_sentencepiece/cog-pretrain.model",)
    assert ttok.UnifiedTokenizer is tunified.UnifiedTokenizer


class RecordingImageTokenizer:
    """Fake VQ tokenizer that fabricates deterministic codes per path."""

    num_tokens = 8192

    def read_img(self, path, img_size=256):
        return path

    def EncodeAsIds(self, img):
        rng = np.random.RandomState(sum(map(ord, img)))
        return rng.randint(0, self.num_tokens, size=(1, 1024))

    def DecodeIds(self, ids):
        return np.asarray(ids)


class WordTok:
    """Stand-in with the released text vocabulary size."""

    num_tokens = 50000

    def encode(self, s):
        return [100 + sum(map(ord, w)) % 40000 for w in s.split()]

    def decode(self, ids):
        return " ".join(map(str, ids))


def _both(txt_jax, txt_port):
    return (junified.UnifiedTokenizer(img_tokenizer=RecordingImageTokenizer(),
                                      txt_tokenizer=txt_jax),
            tunified.UnifiedTokenizer(img_tokenizer=RecordingImageTokenizer(),
                                      txt_tokenizer=txt_port))


def test_vocabulary_contract_unchanged():
    assert tunified.RAW_COMMAND_TOKENS == junified.RAW_COMMAND_TOKENS
    assert tunified.SIZE_TOKEN_BY_SIDE == junified.SIZE_TOKEN_BY_SIDE
    j, t = _both(WordTok(), WordTok())
    assert len(t) == len(j) == 58219
    assert t.command_tokens == j.command_tokens
    assert t["[PAD]"] == 58192 and t["[POS8]"] == 58218
    assert (t.img_vocab, t.txt_vocab) == (8192, 50000)
    assert len(tunified.FakeImageTokenizer(8192)) == 8192


QUERIES = [
    "[ROI1] a small cat [BASE] [BOI1] [MASK]*1024",
    "[BASE] [BOI1] [Image]somepath.png [EOI1] [ROI1] [MASK]*20",
    "[BOI2] [Image*512]somepath.png [EOI2]",
    "[ROI1] the cat [BASE] [BOI1] [Image1]other.png [EOI1] [ROI2] [POS0] [BASE] [BOI2] [MASK]*1024",
    "plain text only [MASK] more",
]


@pytest.mark.parametrize("text_model", ["words", "spm"])
def test_parse_query_decode_and_wrap_match_jax(tmp_path, text_model):
    if text_model == "spm":
        path = _write_model(tmp_path / "m.model")
        j, t = _both(jtext.from_pretrained(path), ttext.from_pretrained(path))
    else:
        j, t = _both(WordTok(), WordTok())
    for q in QUERIES:
        seq = t.parse_query(q)
        assert seq == j.parse_query(q), q
        filled = [x if x >= 0 else 7 for x in seq]
        tparts, timgs = t.DecodeIds(filled)
        jparts, jimgs = j.DecodeIds(filled)
        assert tparts == jparts
        assert len(timgs) == len(jimgs)
        for a, b in zip(timgs, jimgs):
            np.testing.assert_array_equal(a, b)
    assert t.EncodeAsIds("the cat") == j.EncodeAsIds("the cat")
    for n, idx in ((1024, 1), (4096, 2), (64, 3)):
        assert t.wrap_code(list(range(n)), idx=idx) == j.wrap_code(list(range(n)), idx=idx)


def test_get_tokenizer_singleton():
    tunified.reset_tokenizer()
    try:
        a = tunified.get_tokenizer(txt_tokenizer=WordTok())
        assert tunified.get_tokenizer() is a and len(a) == 58219
    finally:
        tunified.reset_tokenizer()
