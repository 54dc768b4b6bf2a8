"""The port's copy of the pretraining data pipeline (cogview_tpu_torch.data)
against cogview_tpu.data: the cases of tests/test_data_pipeline.py and
tests/test_lmdb_io.py that need no file outside the repository, each run
through both packages on the same files.  The text tokenizer is a stand-in
with the released vocabulary size (cog-pretrain.model is not in the
repository); the rows of these corpora are token ids already."""

import numpy as np
import pytest

from cogview_tpu.data import datasets as jds
from cogview_tpu.data import lmdb_io as jlmdb
from cogview_tpu.data import loader as jloader
from cogview_tpu.data import templates as jtpl
from cogview_tpu.tokenization.unified import FakeImageTokenizer as JFake
from cogview_tpu.tokenization.unified import UnifiedTokenizer as JUnified
from cogview_tpu_torch.data import datasets as tds
from cogview_tpu_torch.data import lmdb_io as tlmdb
from cogview_tpu_torch.data import loader as tloader
from cogview_tpu_torch.data import templates as ttpl
from cogview_tpu_torch.tokenization.unified import FakeImageTokenizer as TFake
from cogview_tpu_torch.tokenization.unified import UnifiedTokenizer as TUnified


class WordTok:
    num_tokens = 50000

    def encode(self, s):
        return [100 + sum(map(ord, w)) % 40000 for w in s.split()]

    def decode(self, ids):
        return " ".join(map(str, ids))


@pytest.fixture(scope="module")
def toks():
    return (JUnified(img_tokenizer=JFake(8192), txt_tokenizer=WordTok()),
            TUnified(img_tokenizer=TFake(8192), txt_tokenizer=WordTok()))


def _write_compact_bin(path, n=32, text_len=8, seed=0):
    """Reference CompactBinaryDataset rows: 64 text ids (-1 padded) + 1024 codes."""
    rng = np.random.RandomState(seed)
    rows = np.full((n, 64 + 1024), -1, np.int32)
    rows[:, :text_len] = rng.randint(8192, 58192, size=(n, text_len))
    rows[:, 64:] = rng.randint(0, 8192, size=(n, 1024))
    rows.tofile(path)
    return str(path)


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_compact_binary_dataset_same_samples(toks, tmp_path):
    jtok, ttok = toks
    path = _write_compact_bin(tmp_path / "t2i_train.bin")
    jd = jds.get_dataset_by_type("CompactBinaryDataset", path, jtok, max_len=1089)
    td = tds.get_dataset_by_type("CompactBinaryDataset", path, ttok, max_len=1089)
    assert len(td) == len(jd) == 32
    for i in (0, 5, 31):
        _same_sample(td[i], jd[i])
    s = td[0]
    assert s["text"][0] == ttok["[ROI1]"] and int(s["loss_mask"].sum()) == 8 + 1 + 2 + 1024 + 1


def test_indexed_dataset_cross_read(tmp_path):
    """Files written by either package read back the same in both."""
    rows = [np.arange(i + 3, dtype=np.int32) for i in range(10)]
    tds.IndexedDataset.write(str(tmp_path / "port"), rows)
    jds.IndexedDataset.write(str(tmp_path / "jax"), rows)
    for base in ("port", "jax"):
        a, b = tds.IndexedDataset(str(tmp_path / base)), jds.IndexedDataset(str(tmp_path / base))
        assert len(a) == len(b) == 10
        for i in range(10):
            np.testing.assert_array_equal(a[i], rows[i])
            np.testing.assert_array_equal(a[i], b[i])


def test_templates_match(toks):
    jtok, ttok = toks
    code = np.arange(1024)
    np.testing.assert_array_equal(ttpl.TextCodeTemplate(ttok, "a cat", code),
                                  jtpl.TextCodeTemplate(jtok, "a cat", code))
    np.testing.assert_array_equal(ttpl.PureTextTemplate(ttok, "hello there"),
                                  jtpl.PureTextTemplate(jtok, "hello there"))
    np.testing.assert_array_equal(ttpl.Code2CodeTemplate(ttok, "a cat", code[:256], code),
                                  jtpl.Code2CodeTemplate(jtok, "a cat", code[:256], code))


def test_batch_iterator_same_batches_and_resume(toks, tmp_path):
    """The same shuffled batches over two epochs, and after fast_forward(6)
    the same batches as the uninterrupted run's 7th onwards."""
    jtok, ttok = toks
    path = _write_compact_bin(tmp_path / "a.bin", n=64)
    jd = jds.get_dataset_by_type("CompactBinaryDataset", path, jtok, max_len=1089)
    td = tds.get_dataset_by_type("CompactBinaryDataset", path, ttok, max_len=1089)
    ji, ti = iter(jloader.BatchIterator(jd, 4, seed=7)), iter(tloader.BatchIterator(td, 4, seed=7))
    ref = []
    for _ in range(20):  # 16 batches an epoch: crosses into the second
        b = next(ti)
        _same_sample(b, next(ji))
        ref.append(b)
    it = tloader.BatchIterator(td, 4, seed=7)
    it.fast_forward(6)
    assert it.state_dict() == {"epoch": 0, "start_iter": 6}
    g = iter(it)
    for i in range(4):
        _same_sample(next(g), ref[6 + i])


def test_make_loaders_split_and_oversample(toks, tmp_path):
    jtok, ttok = toks
    p1 = _write_compact_bin(tmp_path / "foo_t2i.bin", n=40, seed=1)
    p2 = _write_compact_bin(tmp_path / "bar_i2t.bin", n=12, seed=2)
    outs = []
    for mod, tok in ((tloader, ttok), (jloader, jtok)):
        cfg = mod.DataConfig(train_data=(p1, p2), batch_size=4, split=(0.8, 0.1, 0.1),
                             max_len=1089)
        outs.append(mod.make_loaders(cfg, tok))
    (ttrain, tval, ttest), (jtrain, jval, jtest) = outs
    # t2i x4 + i2t x2 = 184 rows, 147 train -> 36 batches
    assert ttrain.batches_per_epoch() == jtrain.batches_per_epoch() == 36
    for a, b in ((ttrain, jtrain), (tval, jval), (ttest, jtest)):
        _same_sample(next(iter(a)), next(iter(b)))


def test_detect_new_indexed_and_lmdb_datasets(toks, tmp_path):
    """A new IndexedDataset corpus, then a new LMDB environment, are picked
    up by both packages, with the same paths and the same first batch."""
    jtok, ttok = toks
    rows = [np.random.RandomState(i).randint(0, 5000, 40 + i) for i in range(24)]
    base1 = str(tmp_path / "corpus_a")
    tds.IndexedDataset.write(base1, rows)
    cfgs = [mod.DataConfig(train_data=(base1,), dataset_type="TokenizedDataset",
                           batch_size=2, split=(1.0, 0, 0), max_len=64)
            for mod in (tloader, jloader)]
    assert tloader.detect_new_datasets(cfgs[0], ttok, {base1})[0] is None
    tds.IndexedDataset.write(str(tmp_path / "corpus_b"), rows[:8])
    tlmdb.write_reference_corpus(str(tmp_path / "extra_lmdb"), rows[:8])
    (ti, tknown), (ji, jknown) = (tloader.detect_new_datasets(cfgs[0], ttok, {base1}),
                                  jloader.detect_new_datasets(cfgs[1], jtok, {base1}))
    assert tknown == jknown and str(tmp_path / "extra_lmdb") in tknown
    assert tds.is_lmdb_path(str(tmp_path / "extra_lmdb"))
    a, b = next(iter(ti)), next(iter(ji))
    assert a["text"].shape == (2, 64)
    _same_sample(a, b)


def test_lmdb_textcode_dataset_direct(toks, tmp_path):
    jtok, ttok = toks
    rng = np.random.RandomState(0)
    pairs = [(rng.randint(8192, 20000, 6), rng.randint(0, 8192, 64)) for _ in range(6)]
    env = str(tmp_path / "tc_lmdb")
    tlmdb.write_reference_corpus(env, pairs)
    td = tds.get_dataset_by_type("TextCodeDataset", env, ttok, max_len=128)
    jd = jds.get_dataset_by_type("TextCodeDataset", env, jtok, max_len=128)
    assert len(td) == len(jd) == 6
    for i in range(6):
        _same_sample(td[i], jd[i])


@pytest.mark.parametrize("kind", ["small", "multilevel", "overflow"])
def test_lmdb_files_cross_read(tmp_path, kind):
    """LMDB files from the port's writer are byte-identical to the JAX
    package's and read back the same items in both readers: one leaf, a
    multi-level B-tree, and overflow (big-data) values."""
    rng = np.random.RandomState(1)
    if kind == "small":
        items = [(f"k{i:03d}".encode(), f"value-{i}".encode()) for i in range(50)]
    elif kind == "multilevel":
        items = [(b"key-%08d" % int(i), rng.bytes(40)) for i in rng.permutation(3000)]
    else:
        items = [(b"big-%d" % i, rng.bytes(3000 + 4096 * i)) for i in range(4)]
        items += [(b"small-%d" % i, b"x" * 10) for i in range(3)]
    tpath = tlmdb.write_lmdb(str(tmp_path / "port"), items)
    jpath = jlmdb.write_lmdb(str(tmp_path / "jax"), items)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    with tlmdb.LMDBReader(jpath) as db:
        assert len(db) == len(items)
        assert list(db.items()) == sorted(items)
        assert db.get(b"missing") is None
    if kind == "multilevel":
        with tlmdb.LMDBReader(tpath) as db:
            assert db.depth >= 2 and db.branch_pages >= 1


def test_reference_corpus_rows(tmp_path):
    rng = np.random.RandomState(2)
    rows = [rng.randint(0, 58219, size=1088).astype(np.int64) for _ in range(12)]
    rows += [(np.arange(5, dtype=np.int64), np.arange(16, dtype=np.int64) + 100)]
    env = str(tmp_path / "corpus")
    jlmdb.write_reference_corpus(env, rows)
    reader = tlmdb.LMDBCorpusReader(env)
    assert len(reader) == 13
    for i in range(12):
        np.testing.assert_array_equal(reader[i], rows[i])
    text, code = reader[12]
    np.testing.assert_array_equal(text, rows[12][0])
    np.testing.assert_array_equal(code, rows[12][1])
    with pytest.raises(IndexError):
        reader[13]
    reader.close()
