"""The port's native host runtimes (cogview_tpu_torch/csrc/spm and
csrc/dataio, built with g++ at first use) against the JAX package's
pure-Python tokenizer and CompactBinaryDataset: the cases of
tests/test_native.py on the small BPE model of test_torch_tokenization.py
(the released cog-pretrain.model is not in the repository)."""

import subprocess

import numpy as np
import pytest

from cogview_tpu.data import datasets as jds
from cogview_tpu.tokenization import text_tokenizer as jtext
from cogview_tpu.tokenization.unified import FakeImageTokenizer as JFake
from cogview_tpu.tokenization.unified import UnifiedTokenizer as JUnified
from cogview_tpu_torch.data import native_loader
from cogview_tpu_torch.ops import _kernels
from cogview_tpu_torch.tokenization import sp_cpp
from cogview_tpu_torch.tokenization.unified import FakeImageTokenizer as TFake
from cogview_tpu_torch.tokenization.unified import UnifiedTokenizer as TUnified
from test_torch_tokenization import PIECES, TEXTS, _write_model

pytestmark = pytest.mark.skipif(_kernels.host_compiler() is None,
                                reason="no C++ compiler (g++) on the PATH")

CORPUS = TEXTS + ["一只可爱的小猫", "the cat" * 40, "ＫＧＢ①ﬁ the", "混合 mixed 一只 text ０１２",
                  "\n<n>[X] cat", "the　cat"]


@pytest.fixture(scope="module", params=[(True, True), (False, True), (True, False)],
                ids=["default", "no-dummy-prefix", "keep-whitespace"])
def toks(request, tmp_path_factory):
    path = _write_model(tmp_path_factory.mktemp("spm") / "m.model", *request.param)
    return sp_cpp.CppTextTokenizer(path), jtext.from_pretrained(path)


def test_host_library_builds_into_the_port_build_dir():
    """The libraries are built from the port's own sources, named by a hash
    of source and flags, without -march=native."""
    for name in ("spm", "dataio"):
        out = _kernels.build_host([name])[0]
        assert out.parent == _kernels.BUILD and out.exists()
        assert out == _kernels.host_target(name)
        rel, flags = _kernels.HOST_LIBS[name]
        assert (_kernels.CSRC / rel).exists()
        assert not any(f.startswith("-march") for f in flags)
    assert "-lpthread" in _kernels.HOST_LIBS["dataio"][1]


def test_native_ids_match_python(toks):
    cpp, py = toks
    assert cpp.num_tokens == py.num_tokens == len(PIECES) == len(cpp)
    for s in CORPUS:
        assert cpp.encode(s) == py.encode(s), repr(s)


def test_native_decode_matches_python(toks):
    cpp, py = toks
    for s in CORPUS:
        ids = py.encode(s)
        assert cpp.decode(ids) == py.decode(ids), repr(s)
    assert cpp.decode([0, 1, 7]) == py.decode([0, 1, 7])


def test_native_piece_lookup(toks):
    cpp, py = toks
    for piece in ["<unk>", "<n>", "[X]", "▁cat", "小猫", py.model.pieces[4],
                  py.model.pieces[10], "not-a-piece"]:
        assert cpp.convert_token_to_id(piece) == py.convert_token_to_id(piece), piece


def test_native_long_text_grows_its_buffer(toks):
    """A text whose ids outrun the first buffer is encoded again at the
    size the library asks for."""
    cpp, py = toks
    text = "一只小猫的 " * 300
    assert cpp.encode(text) == py.encode(text)


def test_native_dataio_matches_python(tmp_path):
    class WordTok:
        num_tokens = 50000

        def encode(self, s):
            return [100 + sum(map(ord, w)) % 40000 for w in s.split()]

    jtok = JUnified(img_tokenizer=JFake(8192), txt_tokenizer=WordTok())
    ttok = TUnified(img_tokenizer=TFake(8192), txt_tokenizer=WordTok())
    rng = np.random.RandomState(0)
    n = 16
    rows = np.full((n, 64 + 1024), -1, np.int32)
    for i in range(n):  # text of every length, up to the whole region
        rows[i, :4 * i] = rng.randint(8192, 58192, size=4 * i)
    rows[:, 64:] = rng.randint(0, 8192, size=(n, 1024))
    path = str(tmp_path / "c.bin")
    rows.tofile(path)

    py_ds = jds.get_dataset_by_type("CompactBinaryDataset", path, jtok, max_len=1089)
    native = native_loader.NativeCompactDataset(path, ttok, max_len=1089, n_threads=2)
    assert len(native) == len(py_ds) == n
    idx = np.asarray([0, 3, 7, 15, 15, 1], np.int64)
    nb = native.batch(idx)
    assert nb["text"].shape == nb["loss_mask"].shape == (len(idx), 1089)
    for j, i in enumerate(idx):
        ps = py_ds[int(i)]
        np.testing.assert_array_equal(nb["text"][j], ps["text"])
        np.testing.assert_array_equal(nb["loss_mask"][j], ps["loss_mask"])
    with pytest.raises(IndexError):
        native.batch(np.asarray([n], np.int64))


def test_native_loader_refuses_a_missing_file(tmp_path):
    with pytest.raises(IOError):
        native_loader.NativeCompactDataset(str(tmp_path / "missing.bin"),
                                           {k: 0 for k in ("[ROI1]", "[BASE]", "[BOI1]",
                                                           "[EOI1]", "[PAD]")})


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """With a compiler present a failed build raises, and leaves no file."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD", tmp_path / "build")
    monkeypatch.setitem(_kernels.HOST_LIBS, "bad", ("bad.cc", _kernels.HOST_FLAGS))
    with pytest.raises(subprocess.CalledProcessError):
        _kernels.build_host(["bad"])
    assert not list((tmp_path / "build").glob("*.so"))
