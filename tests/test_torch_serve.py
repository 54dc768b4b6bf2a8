"""The port's folder-watcher server against cogview_tpu.cli.serve: done/ and
failed/ routing with .err files, new files picked up across polls, the
outputs of process_file, warmup before serving, and one real request at
the smoke preset on the CPU through the int4 cache."""

import argparse
import os

import numpy as np

from cogview_tpu.cli import serve as jserve
from cogview_tpu_torch.cli import serve
from cogview_tpu_torch.utils.png import read_png


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _routing_run(module, inp):
    inp.mkdir()
    (inp / "a.txt").write_text("a query\n")
    (inp / "b.txt").write_text("bad query\n")
    (inp / "notes.md").write_text("ignored: not .txt\n")
    seen = []

    def process(path):
        seen.append(os.path.basename(path))
        if "b.txt" in path:
            raise ValueError("boom")
        return 1

    rc = module.watch_folder(str(inp), process, time_interval=0, max_polls=1)
    return rc, seen


def test_watch_folder_routes_done_and_failed_as_jax(tmp_path):
    """Successes to done/, failures to failed/ with an .err file, non-.txt
    files untouched: the same files with the same bytes as the JAX server."""
    rc, seen = _routing_run(serve, tmp_path / "port")
    jrc, jseen = _routing_run(jserve, tmp_path / "jax")
    assert rc == jrc == 0 and sorted(seen) == sorted(jseen) == ["a.txt", "b.txt"]
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    assert set(got) == {"done/a.txt", "failed/b.txt", "failed/b.txt.err", "notes.md"}
    assert b"ValueError: boom" in got["failed/b.txt.err"]


def test_watch_folder_picks_up_new_files_across_polls(tmp_path):
    for module, name in ((serve, "port"), (jserve, "jax")):
        inp = tmp_path / name
        inp.mkdir()
        (inp / "first.txt").write_text("q\n")
        calls = []

        def process(path):
            calls.append(os.path.basename(path))
            if len(calls) == 1:  # drop a new file mid-service
                (inp / "second.txt").write_text("q2\n")
            return 1

        module.watch_folder(str(inp), process, time_interval=0, max_polls=2)
        assert calls == ["first.txt", "second.txt"]
        assert (inp / "done" / "first.txt").exists() and (inp / "done" / "second.txt").exists()


class _FakeResult:
    def __init__(self, texts=(), images=()):
        self.texts = list(texts)
        self.images = list(images)


def test_process_file_writes_outputs_as_jax(tmp_path, monkeypatch):
    """One output dir per (file, query line), captions for image2text and a
    PNG per sample for text2image, blank lines skipped: the same files as
    the JAX server, the PNGs with the same pixels."""
    qfile = tmp_path / "queries.txt"
    qfile.write_text("a cat\n\n一只狗\n")
    rng = np.random.RandomState(0)
    imgs = [rng.rand(1, 8, 8, 3).astype(np.float32) for _ in range(2)]

    def fake_generate_once(params, cfg, tokenizer, raw, task, **kw):
        if task == "image2text":
            return _FakeResult(texts=[["[ROI1]", "一只", "猫"], ["狗"]])
        return _FakeResult(images=imgs)

    monkeypatch.setattr(serve, "generate_once", fake_generate_once)
    monkeypatch.setattr(jserve, "generate_once", fake_generate_once)
    for task in ("image2text", "text2image"):
        outs = {}
        for module, name in ((serve, "port"), (jserve, "jax")):
            img_dir = tmp_path / f"{task}_{name}"
            args = argparse.Namespace(generation_task=task, batch_size=2,
                                      max_inference_batch_size=2, img_folder_path=str(img_dir))
            assert module.process_file(str(qfile), args, None, None, None, None) == 2
            outs[name] = img_dir
        got, want = _tree(outs["port"]), _tree(outs["jax"])
        assert set(got) == set(want)
        for rel in got:
            if rel.endswith(".png"):
                np.testing.assert_array_equal(read_png(str(outs["port"] / rel)),
                                              read_png(str(outs["jax"] / rel)))
            else:
                assert got[rel] == want[rel]
        assert set(got) == ({"queries-0/captions.txt", "queries-2/captions.txt"}
                            if task == "image2text" else
                            {f"queries-{q}/{i}.png" for q in (0, 2) for i in (0, 1)})


class WordTok:
    num_tokens = 50000

    def encode(self, s):
        return [100 + i for i, _ in enumerate(s.split())]

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_main_warmup_runs_before_serving(tmp_path, monkeypatch):
    """Warmup (the default): one text2image generation before the first
    poll, at the smoke preset on the CPU; --no-warmup skips it.  Generation
    is stubbed: this covers the server's wiring."""
    calls = []
    monkeypatch.setattr(serve, "generate_once",
                        lambda *a, **k: calls.append((a[3], a[4], k["device"])) or _FakeResult())
    inp, img = tmp_path / "in", tmp_path / "img"
    argv = ["--preset", "smoke", "--device", "cpu", "--input-folder-path", str(inp),
            "--img-folder-path", str(img), "--max-polls", "1", "--time-interval", "0"]
    assert serve.main(argv, txt_tokenizer=WordTok()) == 0
    assert len(calls) == 1 and "warmup" in calls[0][0] and calls[0][1] == "text2image"
    assert str(calls[0][2]) == "cpu"

    calls.clear()
    (inp / "q.txt").write_text("w0 w1\n")
    assert serve.main(argv + ["--no-warmup"], txt_tokenizer=WordTok()) == 0
    assert [c[0] for c in calls] == ["w0 w1"]
    assert (inp / "done" / "q.txt").exists()


def test_serve_int4_request_on_cpu(tmp_path):
    """One real request through the server at the smoke preset on the CPU
    with the int4 cache: the file reaches done/, failed/ stays empty, and a
    256 x 256 PNG comes out."""
    inp, img = tmp_path / "in", tmp_path / "img"
    inp.mkdir()
    (inp / "q.txt").write_text("w0 w1 w2\n")
    rc = serve.main(["--preset", "smoke", "--device", "cpu", "--kv-cache", "int4",
                     "--batch-size", "1", "--no-warmup", "--max-polls", "1",
                     "--time-interval", "0", "--input-folder-path", str(inp),
                     "--img-folder-path", str(img)], txt_tokenizer=WordTok())
    assert rc == 0
    assert os.listdir(inp / "failed") == []
    assert (inp / "done" / "q.txt").exists()
    assert read_png(str(img / "q-0" / "0.png")).shape == (256, 256, 3)
