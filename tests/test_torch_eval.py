"""Port parity: FID statistics, the Frechet distance, the Inception Score,
the TSV eval stream and the ``fid`` CLI (cogview_tpu_torch/eval_utils/,
cogview_tpu_torch/cli/fid.py) against the JAX package, on the CPU.

Tolerances: StreamingStats against np.cov to 1e-10; frechet_distance to
rtol 1e-6 of the JAX package's on the same statistics; the TSV stream's
images byte-equal (the port's readers and Pillow's BICUBIC resize) with the
same rows skipped; the CLI's statistics of a folder and of a TSV of the
same images equal, and its FID with the VQ extractor to rtol 1e-4 of the
JAX CLI's on the same VQ-VAE file.
"""

import base64
import importlib
import io
import re

import numpy as np
import pytest
import torch

Image = pytest.importorskip("PIL.Image")

from cogview_tpu.cli import fid as jfid_cli  # noqa: E402
from cogview_tpu.eval_utils import dataset as jdataset  # noqa: E402
from cogview_tpu.eval_utils import fid as jfid  # noqa: E402
from cogview_tpu_torch.cli import fid as fid_cli  # noqa: E402
from cogview_tpu_torch.eval_utils import dataset, fid  # noqa: E402

# the packages re-export the function under the module's name
jis = importlib.import_module("cogview_tpu.eval_utils.inception_score")
inception_score = importlib.import_module("cogview_tpu_torch.eval_utils.inception_score")
from cogview_tpu_torch.utils.image_errors import UnsupportedImageError  # noqa: E402
from cogview_tpu_torch.utils.png import decode_png, write_png  # noqa: E402

torch.set_num_threads(1)


def test_streaming_stats_matches_np_cov():
    feats = np.random.RandomState(0).randn(47, 8)
    mu_ref, sigma_ref = fid.compute_statistics(feats)
    np.testing.assert_allclose(sigma_ref, np.cov(feats, rowvar=False), atol=0)
    stats = fid.StreamingStats()
    for i in range(0, len(feats), 5):  # ragged batches
        stats.update(feats[i:i + 5])
    mu, sigma = stats.finalize()
    assert stats.n == 47
    np.testing.assert_allclose(mu, mu_ref, atol=1e-12)
    np.testing.assert_allclose(sigma, sigma_ref, atol=1e-10)
    assert fid.statistics_from_batches([feats[:20], feats[20:]], lambda b: b)[0].shape == (8,)


def test_streaming_stats_rejects_degenerate():
    stats = fid.StreamingStats()
    with pytest.raises(ValueError):
        stats.update(np.zeros(4))  # not [n, d]
    stats.update(np.zeros((1, 4)))
    with pytest.raises(ValueError):
        stats.finalize()  # n < 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frechet_distance_equals_jax(seed):
    rng = np.random.RandomState(seed)
    a, b = rng.randn(64, 16), rng.randn(64, 16) * 1.3 + 0.2
    stats = [*fid.compute_statistics(a), *fid.compute_statistics(b)]
    got = fid.frechet_distance(*stats)
    assert got > 0
    np.testing.assert_allclose(got, jfid.frechet_distance(*stats), rtol=1e-6)
    np.testing.assert_allclose(fid.fid_from_features(a, b), jfid.fid_from_features(a, b),
                               rtol=1e-6)
    assert abs(fid.fid_from_features(a, a)) < 1e-6
    imgs = rng.rand(6, 4, 4, 3)
    feat = lambda x: x.reshape(len(x), -1)[:, :5]  # noqa: E731
    np.testing.assert_allclose(fid.fid_from_images(imgs, imgs[::-1] * 0.9, feat, 4),
                               jfid.fid_from_images(imgs, imgs[::-1] * 0.9, feat, 4), rtol=1e-6)


def test_inception_score_bounds_and_jax():
    n, k = 40, 10
    uniform = np.full((n, k), 1.0 / k)
    np.testing.assert_allclose(inception_score.inception_score_from_probs(uniform, 4)[0], 1.0,
                               atol=1e-6)
    onehot = np.eye(k)[np.arange(n) % k]
    np.testing.assert_allclose(inception_score.inception_score_from_probs(onehot, 4)[0], k,
                               rtol=1e-6)
    p = np.random.RandomState(3).dirichlet(np.ones(k), size=n)
    assert (inception_score.inception_score_from_probs(p, 5)
            == jis.inception_score_from_probs(p, 5))
    imgs = np.random.RandomState(4).rand(n, 2, 2, 3)
    clf = lambda x: np.abs(x.reshape(len(x), -1)) / np.abs(x.reshape(len(x), -1)).sum(1, keepdims=True)  # noqa: E731,E501
    assert inception_score.inception_score(imgs, clf, 7, 4) == jis.inception_score(imgs, clf, 7, 4)


def _encoded(arr, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


def _row(i, data, cap=None):
    return f"id{i}\t_\t{cap or f'caption {i}'}\t{base64.urlsafe_b64encode(data).decode()}"


def _tsv_rows(rng):
    """Rows of every kind the stream meets: 16 x 16 PNGs (no resize), other
    sizes (the BICUBIC resize), BMP, GIF, JPEG, CMYK JPEG, and rows to
    skip: too few columns, bad base64, a truncated PNG."""
    a = lambda h, w: rng.randint(0, 256, (h, w, 3)).astype(np.uint8)  # noqa: E731
    rows = [_row(0, _encoded(a(16, 16), "PNG")), _row(1, _encoded(a(20, 24), "PNG")),
            _row(2, _encoded(a(9, 40), "BMP")), _row(3, _encoded(a(30, 30), "GIF")),
            _row(4, _encoded(a(33, 17), "JPEG", quality=80)), _row(5, _encoded(a(12, 12), "PNG")),
            "id6\tshort", "id7\t_\tbad\t!!!not base64!!!",
            _row(8, _encoded(a(16, 16), "PNG")[:60]),
            _row(9, _encoded(a(16, 16), "PNG"))]
    buf = io.BytesIO()
    Image.fromarray(a(18, 18)).convert("CMYK").save(buf, "JPEG")
    rows.append(_row(10, buf.getvalue()))
    return rows


def test_tsv_stream_equals_jax(tmp_path):
    """The same images (byte-equal after /255), ids and captions, and the
    same rows skipped and counted; batches and the limit as in JAX."""
    path = tmp_path / "corpus.tsv"
    path.write_text("\n".join(_tsv_rows(np.random.RandomState(5))) + "\n", encoding="utf-8")
    want_stream = jdataset.TsvImageStream(str(path), img_size=16)
    got_stream = dataset.TsvImageStream(str(path), img_size=16)
    want, got = list(want_stream), list(got_stream)
    assert len(got) == len(want) == 8
    for (gi, gid, gc), (wi, wid, wc) in zip(got, want):
        assert (gid, gc) == (wid, wc) and gi.dtype == wi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
    assert got_stream.skipped == want_stream.skipped == 3
    gb = list(dataset.iter_tsv_image_batches(str(path), 3, img_size=16, limit=7))
    wb = list(jdataset.iter_tsv_image_batches(str(path), 3, img_size=16, limit=7))
    assert [b.shape for b in gb] == [b.shape for b in wb] == [(3, 16, 16, 3)] * 2 + [(1, 16, 16, 3)]
    for g, w in zip(gb, wb):
        np.testing.assert_array_equal(g, w)
    caps = list(dataset.TsvImageStream(str(path), img_size=8, caption_only=True))
    assert [c[1:] for c in caps] == [c[1:] for c in jdataset.TsvImageStream(
        str(path), img_size=8, caption_only=True)]


def test_tsv_stream_stops_on_a_format_the_port_does_not_read(tmp_path):
    """A TIFF row: the JAX package reads it, the port stops with a named
    error instead of dropping it."""
    path = tmp_path / "tiff.tsv"
    tiff = _encoded(np.zeros((16, 16, 3), np.uint8), "TIFF")
    path.write_text(_row(0, _encoded(np.zeros((16, 16, 3), np.uint8), "PNG")) + "\n"
                    + _row(1, tiff) + "\n", encoding="utf-8")
    assert len(list(jdataset.TsvImageStream(str(path), img_size=16))) == 2
    stream = iter(dataset.TsvImageStream(str(path), img_size=16))
    next(stream)
    with pytest.raises(UnsupportedImageError, match="TIFF"):
        next(stream)


def test_encode_image_base64_png_only():
    img = np.random.RandomState(6).rand(5, 7, 3).astype(np.float32)
    got = dataset.encode_image_base64(img)
    want = jdataset.encode_image_base64(img)
    a = decode_png(base64.urlsafe_b64decode(got))
    np.testing.assert_array_equal(a, decode_png(base64.urlsafe_b64decode(want)))
    with pytest.raises(ValueError, match="PNG only"):
        dataset.encode_image_base64(img, "JPEG")


VQ_SHAPES = {  # the reference VQ-VAE at channel 16, embed 8, 32 codes
    "enc_b.blocks.0": (16, 3, 4, 4), "enc_b.blocks.2": (16, 16, 4, 4),
    "enc_b.blocks.4": (16, 16, 4, 4), "enc_b.blocks.6": (8, 16, 1, 1),
    "dec.blocks.0": (8, 16, 4, 4), "dec.blocks.2": (16, 16, 4, 4),
    "dec.blocks.4": (16, 16, 4, 4), "dec.blocks.6": (3, 16, 1, 1),
}


def write_vq_file(path, seed=1):
    """A narrow VQ-VAE in the reference's state-dict layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in VQ_SHAPES.items():
        sd[f"{name}.weight"] = torch.randn(*shape, generator=g) * 0.2
        sd[f"{name}.bias"] = torch.randn(shape[1] if name.startswith("dec.blocks.")
                                         and name != "dec.blocks.6" else shape[0],
                                         generator=g) * 0.1
    sd["quantize_t.embed"] = torch.randn(8, 32, generator=g)
    sd["quantize_t.cluster_size"] = torch.rand(32, generator=g)
    sd["quantize_t.embed_avg"] = torch.randn(8, 32, generator=g)
    torch.save(sd, path)
    return str(path)


def _image_sets(tmp_path, n=16):
    """Two folders of n smooth images of other sizes than 256 (the BICUBIC
    resize), and a TSV of the first folder's images."""
    rng = np.random.RandomState(8)
    dirs = [tmp_path / "a", tmp_path / "b"]
    rows = []
    for k, d in enumerate(dirs):
        d.mkdir()
        for i in range(n):
            y, x = np.mgrid[0:60, 0:70]
            img = np.stack([(x * (3 + i) + 40 * k) % 256, (y * (2 + k) + 7 * i) % 256,
                            (x + y + 11 * i) % 256], -1) + rng.randint(0, 20, (60, 70, 3))
            img = np.clip(img, 0, 255).astype(np.uint8)
            write_png(str(d / f"{i:02d}.png"), img)
            if k == 0:
                rows.append(_row(i, (d / f"{i:02d}.png").read_bytes()))
    tsv = tmp_path / "a.tsv"
    tsv.write_text("\n".join(rows) + "\n", encoding="utf-8")
    return str(dirs[0]), str(dirs[1]), str(tsv)


def _jax_fid(argv, capsys):
    capsys.readouterr()
    assert jfid_cli.main(argv) == 0
    out = capsys.readouterr().out
    return float(re.search(r"FID\(vq-proxy\): ([-\d.e+]+)", out).group(1))


def test_fid_cli_folder_and_tsv_statistics_equal_and_match_jax(tmp_path, capsys):
    a, b, tsv = _image_sets(tmp_path)
    vq = write_vq_file(tmp_path / "vqvae.pt")
    base = ["--extractor", "vq", "--img-tokenizer-path", vq, "--batch-size", "5"]
    assert fid_cli.main(["--path1", a, "--path2", tsv, "--device", "cpu", *base]) == 0
    last = fid_cli.main.last
    assert last["n1"] == last["n2"] == 16
    np.testing.assert_array_equal(last["mu1"], last["mu2"])
    np.testing.assert_array_equal(last["sigma1"], last["sigma2"])
    assert abs(last["fid"]) < 1e-6
    assert fid_cli.main(["--path1", a, "--path2", b, "--device", "cpu", *base]) == 0
    got = fid_cli.main.last["fid"]
    assert got > 0
    want = _jax_fid(["--path1", a, "--path2", b, *base], capsys)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(fid_cli.load_image_dir(a, 256, 3),
                                  jfid_cli.load_image_dir(a, 256, 3))


def test_fid_cli_inception_score_and_device(tmp_path, capsys):
    """--inception-score through the port's seeded random InceptionV3
    (the fc head), finite and within [1, 1000]; without a card and without
    --device cpu the CLI fails by name."""
    a, b, _ = _image_sets(tmp_path, n=4)
    vq = write_vq_file(tmp_path / "vqvae.pt")
    assert fid_cli.main(["--path1", a, "--path2", b, "--extractor", "vq", "--img-tokenizer-path",
                         vq, "--inception-score", "--is-splits", "2", "--device", "cpu"]) == 0
    last = fid_cli.main.last
    assert np.isfinite(last["is_mean"]) and 1.0 - 1e-6 <= last["is_mean"] <= 1000
    assert "IS:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cuda"):
            fid_cli.main(["--path1", a, "--path2", b])
