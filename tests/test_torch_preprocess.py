"""Port parity: the preprocessing slice (cogview_tpu_torch/preprocess/ and
cli/preprocess.py) against the JAX package, on the CPU.

The image sources yield the same names and byte-equal arrays as the JAX
package's (which decodes with Pillow); the ``preprocess`` CLI's text2image
``.bin``, super-resolution and text IndexedDatasets and ``import-lmdb``
output are byte-equal to the JAX CLI's on the same images, the same
VQ-VAE file and the same text model (a small SentencePiece BPE model
written here); ``recover_grid`` writes the same pixels.  A corrupt file is
skipped and counted; a file of a format the port does not read stops the
run with a named error where the JAX package would read it.
"""

import io
import os
import tarfile
import zipfile

import numpy as np
import pytest
import torch

Image = pytest.importorskip("PIL.Image")

from cogview_tpu.cli import preprocess as jcli  # noqa: E402
from cogview_tpu.preprocess import raw_datasets as jraw  # noqa: E402
from cogview_tpu.preprocess import recover_grid as jgrid  # noqa: E402
from cogview_tpu.preprocess import tokenize_images as jtok_images  # noqa: E402
from cogview_tpu_torch.cli import preprocess as cli  # noqa: E402
from cogview_tpu_torch.data.lmdb_io import write_reference_corpus  # noqa: E402
from cogview_tpu_torch.preprocess import raw_datasets as raw  # noqa: E402
from cogview_tpu_torch.preprocess import recover_grid  # noqa: E402
from cogview_tpu_torch.preprocess import tokenize_images  # noqa: E402
from cogview_tpu_torch.preprocess.rar_reader import has_rar_support, write_stored_rar4  # noqa: E402,E501
from cogview_tpu_torch.utils.image_errors import UnsupportedImageError  # noqa: E402
from cogview_tpu_torch.utils.png import decode_png  # noqa: E402
from test_torch_eval import write_vq_file  # noqa: E402
from test_torch_tokenization import _write_model  # noqa: E402

torch.set_num_threads(1)


def _picture(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(x * 5 + y) % 256, (y * 3 + seed * 7) % 256, (x * y) % 256], -1)
    return np.clip(a + rng.randint(0, 30, a.shape), 0, 255).astype(np.uint8)


def _encoded(arr, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


def _files(n=6):
    """name -> bytes: PNG, JPEG, BMP, a GIF named .png, other sizes, a
    corrupt JPEG (skipped by both), a caption file (not an image name)."""
    out = {}
    for i in range(n):
        arr = _picture(40 + 3 * i, 48 - 2 * i, i)
        fmt, ext = [("PNG", "png"), ("JPEG", "jpg"), ("BMP", "bmp"), ("GIF", "png")][i % 4]
        out[f"img_{i}.{ext}"] = _encoded(arr, fmt)
    out["broken.jpg"] = _encoded(_picture(30, 30, 9), "JPEG")[:100]
    out["notes.txt"] = b"not an image"
    return out


def _write_sources(tmp_path, files):
    folder = tmp_path / "folder"
    folder.mkdir()
    for name, data in files.items():
        (folder / name).write_bytes(data)
    zp = tmp_path / "imgs.zip"
    with zipfile.ZipFile(zp, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    tp = tmp_path / "imgs.tar"
    with tarfile.open(tp, "w") as t:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    return {"folder": str(folder), "zip": str(zp), "tar": str(tp),
            "rar": write_stored_rar4(str(tmp_path / "imgs.rar"), files)}


@pytest.mark.parametrize("kind", ["folder", "zip", "tar", "rar"])
def test_sources_yield_what_jax_yields(tmp_path, kind):
    if kind == "rar" and not has_rar_support():
        pytest.skip("the system libarchive is not loadable")
    path = _write_sources(tmp_path, _files())[kind]
    want = list(jraw.open_image_source(path, img_size=32))
    src = raw.open_image_source(path, img_size=32)
    got = list(src)
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 6
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == (32, 32, 3)
        np.testing.assert_array_equal(g, w)
    assert src.skipped == 1  # broken.jpg, which the JAX package drops


def test_h5_source(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "imgs.h5")
    with h5py.File(path, "w") as f:
        f["images"] = np.stack([_picture(40, 52, i) for i in range(3)])
        f["names"] = np.array([b"a", b"b", b"c"])
    with h5py.File(str(tmp_path / "gray.h5"), "w") as f:
        f["images"] = np.stack([_picture(30, 20, i)[..., 0] for i in range(2)])
    for p in (path, str(tmp_path / "gray.h5")):
        want = list(jraw.open_image_source(p, img_size=16))
        got = list(raw.open_image_source(p, img_size=16))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_unread_format_stops_the_run(tmp_path):
    """A WebP or TIFF in an archive: the JAX package reads it, the port
    stops with an UnsupportedImageError naming the file."""
    files = dict(_files(2))
    files["late.png"] = _encoded(_picture(20, 20, 3), "TIFF")
    path = _write_sources(tmp_path, files)["zip"]
    assert len(list(jraw.open_image_source(path, 16))) == 3
    with pytest.raises(UnsupportedImageError, match="late.png: TIFF"):
        list(raw.open_image_source(path, 16))


def test_text_source_and_to_model_input(tmp_path):
    tsv = tmp_path / "cap.tsv"
    tsv.write_text("img_0.png\thello\nimg_1.png\tworld\n")
    js = tmp_path / "cap.json"
    js.write_text('[{"uniqueKey": "k1", "cnShortText": "t1"}, {"name": "k2", "text": "t2"}]')
    for path, names in ((tsv, ("img_0.png", "img_0", "sub/img_1.jpg", "missing.png")),
                        (js, ("k1", "k2.png", "k3"))):
        a, b = raw.TsvTextSource(str(path)), jraw.TsvTextSource(str(path))
        assert [a.lookup(n) for n in names] == [b.lookup(n) for n in names]
    arr = _picture(480, 640, 1)
    np.testing.assert_array_equal(raw.to_model_input(arr, 256),
                                  jraw.to_model_input(Image.fromarray(arr), 256))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Images in a folder, their captions, a narrow VQ-VAE file and a text
    model, shared by the CLI cases."""
    tmp = tmp_path_factory.mktemp("corpus")
    folder = tmp / "imgs"
    folder.mkdir()
    for i in range(5):
        (folder / f"img_{i}.png").write_bytes(_encoded(_picture(260 + 9 * i, 300, i), "PNG"))
    (folder / "img_5.jpg").write_bytes(_encoded(_picture(256, 256, 5), "JPEG"))
    caps = tmp / "cap.tsv"
    caps.write_text("".join(f"img_{i}\tthe cat {i}\n" for i in range(5)) + "img_5.jpg\ta cat\n",
                    encoding="utf-8")
    return {"images": str(folder), "captions": str(caps), "tmp": tmp,
            "vq": write_vq_file(tmp / "vqvae.pt"), "model": _write_model(tmp / "m.model")}


def _run_both(corpus, task, extra=()):
    """The JAX CLI and the port's (``--device cpu``) on the same inputs ->
    the two output paths."""
    outs = []
    for name, main, dev in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = str(corpus["tmp"] / f"{name}_{task}")
        assert main(["--task", task, "--image-source", corpus["images"], "--text-source",
                     corpus["captions"], "--img-tokenizer-path", corpus["vq"],
                     "--text-model-path", corpus["model"], "--output", out,
                     "--batch-size", "4", *extra, *dev]) == 0
        outs.append(out)
    return outs


def test_cli_text2image_corpus_byte_equal(corpus):
    jout, out = _run_both(corpus, "text2image")
    got, want = open(out, "rb").read(), open(jout, "rb").read()
    assert len(got) == 6 * (64 + 1024) * 4
    assert got == want
    rows = np.frombuffer(got, np.int32).reshape(6, 1088)
    assert ((rows[:, 64:] >= 0) & (rows[:, 64:] < 32)).all()


def test_cli_super_resolution_rows_equal(corpus):
    jout, out = _run_both(corpus, "super-resolution", ["--img-size", "128",
                                                        "--sampling-num", "3"])
    assert len(np.load(out + ".idx.npy")) == 6 * 3 + 1
    for ext in (".bin", ".idx.npy"):
        assert open(out + ext, "rb").read() == open(jout + ext, "rb").read(), ext


def test_cli_text_rows_equal(corpus):
    texts = corpus["tmp"] / "texts.txt"
    texts.write_text("the cat sat\n一只小猫的\n\nthe the cat\n" * 7, encoding="utf-8")
    outs = []
    for name, main, dev in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = str(corpus["tmp"] / f"{name}_text")
        assert main(["--task", "text", "--text-source", str(texts), "--text-model-path",
                     corpus["model"], "--output", out, "--seq-len", "16", *dev]) == 0
        outs.append(out)
    for ext in (".bin", ".idx.npy"):
        assert open(outs[1] + ext, "rb").read() == open(outs[0] + ext, "rb").read()


def test_cli_import_lmdb_equal(tmp_path):
    rng = np.random.RandomState(3)
    rows = [(rng.randint(0, 100, 5), rng.randint(0, 8192, 16)) for _ in range(3)]
    rows.append(rng.randint(0, 100, 9))
    lmdb = write_reference_corpus(str(tmp_path / "env"), rows)
    jcli.main(["--task", "import-lmdb", "--lmdb-path", lmdb, "--output", str(tmp_path / "j")])
    cli.main(["--task", "import-lmdb", "--lmdb-path", lmdb, "--output", str(tmp_path / "p"),
              "--device", "cpu"])
    for ext in (".bin", ".idx.npy"):
        assert (tmp_path / f"p{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()


def test_cli_needs_a_card_or_device_cpu(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="cuda"):
        cli.main(["--task", "text2image", "--image-source", corpus["images"], "--text-source",
                  corpus["captions"], "--output", str(corpus["tmp"] / "x.bin")])


class _StubVQ:
    """Deterministic numpy stand-in: the grid's own logic, not a VQ-VAE."""

    def EncodeAsIds(self, imgs):
        return (np.asarray(imgs)[..., 0] > 0).reshape(len(imgs), -1).astype(np.int64)

    def DecodeIds(self, codes):
        c = np.asarray(codes, np.float32)
        side = int(np.sqrt(c.shape[1]))
        return np.repeat(c.reshape(-1, side, side, 1) * 0.7 + 0.1, 3, axis=3)


def test_recover_grid_pixels_equal(tmp_path):
    imgs = np.stack([raw.to_model_input(_picture(30, 40, i), 16) for i in range(3)])
    got = recover_grid.write_recover_grid(_StubVQ(), imgs, str(tmp_path / "p.png"))
    want = jgrid.write_recover_grid(_StubVQ(), imgs, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (32, 48, 3)
    np.testing.assert_array_equal(decode_png((tmp_path / "p.png").read_bytes()),
                                  np.asarray(Image.open(tmp_path / "j.png").convert("RGB")))


def test_cli_recover_grid(corpus):
    path = str(corpus["tmp"] / "grid.png")
    cli.main(["--task", "text2image", "--image-source", corpus["images"], "--text-source",
              corpus["captions"], "--img-tokenizer-path", corpus["vq"], "--text-model-path",
              corpus["model"], "--output", str(corpus["tmp"] / "g.bin"), "--batch-size", "2",
              "--recover-grid", path, "--device", "cpu"])
    assert decode_png(open(path, "rb").read()).shape == (512, 512, 3)


def test_tokenize_images_is_the_jax_code():
    """The framework-free module is the JAX package's, line for line below
    its docstring."""
    body = lambda m: open(m.__file__).read().split('"""', 2)[2]  # noqa: E731
    assert body(tokenize_images) == body(jtok_images)
    assert os.path.basename(tokenize_images.__file__) == "tokenize_images.py"
