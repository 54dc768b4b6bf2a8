"""The port's pretrain CLI on the CPU at the smoke preset (2 layers over the
real 58,240-token vocabulary) on a CompactBinary corpus written here: the
loss is finite and falls, the per-interval and eval lines are printed, the
tracker file names the saved iteration, and ``--load`` resumes there."""

import os

import numpy as np
import pytest
import torch

from cogview_tpu_torch.cli import pretrain
from cogview_tpu_torch.training import checkpointing

torch.set_num_threads(1)


class VocabOnlyTextTokenizer:
    """Pretraining on token ids needs the text vocabulary's size only."""

    num_tokens = 50000


def _corpus(path, rows=40):
    """64 text ids padded with -1, then 1,024 image codes, per row."""
    rng = np.random.RandomState(0)
    data = np.full((rows, 64 + 1024), -1, np.int32)
    data[:, :12] = rng.randint(8192, 58192, size=(rows, 12))
    data[:, 64:] = rng.randint(0, 8192, size=(rows, 1024))
    data.tofile(path)
    return str(path)


def _lm_losses(out):
    return [float(line.split("| lm loss ")[1].split(" |")[0])
            for line in out.splitlines() if line.startswith(" iteration")]


def test_pretrain_cli_trains_saves_and_resumes(tmp_path, capsys):
    data = _corpus(tmp_path / "t2i.bin")
    save = tmp_path / "ckpt"
    common = ["--preset", "smoke", "--device", "cpu", "--train-data", data,
              "--batch-size", "2", "--split", "0.9,0.1,0.0", "--log-interval", "1",
              "--lr", "3e-3", "--warmup", "0.0", "--seed", "5"]
    rc = pretrain.main(common + ["--train-iters", "5", "--save", str(save),
                                 "--save-interval", "3", "--eval-interval", "5",
                                 "--eval-iters", "1"], txt_tokenizer=VocabOnlyTextTokenizer())
    assert rc == 0
    out = capsys.readouterr().out
    losses = _lm_losses(out)
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < losses[0] - 0.02, losses
    assert "saved checkpoint at iteration 3" in out and "| skipped 0" in out
    assert " validation loss " in out and "| ppl " in out
    assert "data loader: " in out and "train step: " in out
    assert checkpointing.get_checkpoint_iteration(str(save)) == 5
    assert sorted(p.name for p in save.iterdir()) == [
        "3", "5", checkpointing.TRACKER]

    rc = pretrain.main(common + ["--train-iters", "7", "--load", str(save),
                                 "--resume-dataloader"], txt_tokenizer=VocabOnlyTextTokenizer())
    assert rc == 0
    out = capsys.readouterr().out
    assert f"loaded checkpoint from {save} at iteration 5" in out
    assert [line.split("/")[0].split()[-1] for line in out.splitlines()
            if line.startswith(" iteration")] == ["6", "7"]
    assert np.isfinite(_lm_losses(out)).all()


def test_pretrain_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        pretrain.main(["--preset", "smoke", "--device", "cuda", "--train-data",
                       _corpus(tmp_path / "x.bin", rows=4)])


@pytest.mark.parametrize("preset", [None, "expandable_segments:False", "alloc:other"])
def test_pretrain_cli_sets_expandable_segments_before_cuda(monkeypatch, preset):
    """On a CUDA device not yet used, the CLI turns on the allocator's
    expandable segments unless the environment holds an allocator setting;
    a CPU run or a process that has used CUDA already is left alone."""
    for name in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        monkeypatch.delenv(name, raising=False)
    if preset == "alloc:other":
        monkeypatch.setenv("PYTORCH_ALLOC_CONF", preset)
    elif preset is not None:
        monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", preset)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    pretrain.expandable_segments(torch.device("cuda"))
    pretrain.expandable_segments(torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    pretrain.expandable_segments(torch.device("cpu"))
    assert os.environ.get("PYTORCH_CUDA_ALLOC_CONF") == (
        None if preset == "alloc:other" else preset)
    pretrain.expandable_segments(torch.device("cuda"))
    want = preset or "expandable_segments:True"
    assert os.environ.get("PYTORCH_CUDA_ALLOC_CONF", os.environ.get("PYTORCH_ALLOC_CONF")) == want


MULTI_DEVICE_FLAGS = {"--model-parallel-size", "--fsdp", "--sequence-parallel-size",
                      "--pipeline-parallel-size", "--pipeline-microbatches", "--multihost"}


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings if s.startswith("--")}


def test_pretrain_cli_takes_every_single_device_flag_of_the_jax_cli():
    """Every flag of cogview_tpu.cli.pretrain, the multi-device ones too
    (tests/test_torch_parallel.py runs them), the same presets,
    and ``--checkpoint-activations`` on by default (the port always
    recomputes)."""
    from cogview_tpu.cli import pretrain as jax_pretrain

    jp, tp = jax_pretrain.build_parser(), pretrain.build_parser()
    assert _flags(jp) - MULTI_DEVICE_FLAGS <= _flags(tp)
    assert MULTI_DEVICE_FLAGS <= _flags(jp) & _flags(tp)
    jpreset = next(a for a in jp._actions if "--preset" in a.option_strings).choices
    assert set(jpreset) == set(pretrain.PRESETS)
    args = tp.parse_args(["--checkpoint-activations", "--is-sparse", "1", "--query-window",
                          "64", "--key-window-times", "4", "--num-pivot", "256"])
    cfg = pretrain.get_config(args)
    assert args.checkpoint_activations and tp.parse_args([]).checkpoint_activations
    assert (cfg.query_window, cfg.key_window_times, cfg.num_pivot) == (64, 4, 256)
    jcfg = jax_pretrain.get_config(jp.parse_args(["--preset", "cogview-sr"]))
    tcfg = pretrain.get_config(tp.parse_args(["--preset", "cogview-sr"]))
    assert (tcfg.max_position_embeddings, tcfg.num_layers, tcfg.hidden_size) == (
        jcfg.max_position_embeddings, jcfg.num_layers, jcfg.hidden_size) == (1345, 48, 2560)


def _recording_steps(monkeypatch, name="make_train_step"):
    """Wraps the CLI's step factory: -> the list of (factory kwargs, metrics)
    of every step run."""
    seen = []
    make = getattr(pretrain, name)

    def recording(cfg, opt, **kw):
        step = make(cfg, opt, **kw)

        def wrapped(state, batch, *a, **k):
            out = step(state, batch, *a, **k)
            seen.append((kw, out[1], state))
            return out

        return wrapped

    monkeypatch.setattr(pretrain, name, recording)
    return seen


def test_pretrain_cli_is_sparse(tmp_path, monkeypatch, capsys):
    """``--is-sparse 1`` with the reference's shipped geometry (64 / 4 / 256,
    which divides the 1,088 training tokens) at the smoke widths, one layer:
    the step is made sparse and the losses are finite (the geometry reaching
    the config is checked above, the sparse step against JAX in
    test_torch_sparse_attention.py)."""
    seen = _recording_steps(monkeypatch)
    rc = pretrain.main(["--preset", "smoke", "--num-layers", "1", "--device", "cpu",
                        "--train-data", _corpus(tmp_path / "s.bin", rows=4), "--batch-size", "1",
                        "--train-iters", "2", "--split", "1.0,0.0,0.0", "--log-interval", "1",
                        "--is-sparse", "1", "--query-window", "64", "--key-window-times", "4",
                        "--num-pivot", "256"], txt_tokenizer=VocabOnlyTextTokenizer())
    assert rc == 0
    assert [kw["is_sparse"] for kw, _, _ in seen] == [True, True]
    assert all(np.isfinite(m["lm_loss"]) for _, m, _ in seen)
    assert np.isfinite(_lm_losses(capsys.readouterr().out)).all()


def test_pretrain_cli_profile_dir(tmp_path, monkeypatch, capsys):
    """``--profile-dir`` traces steps 10-13 with torch.profiler and writes a
    Chrome trace whose events include the train step's ops."""
    import json

    prof_dir = tmp_path / "prof"
    rc = pretrain.main(["--preset", "smoke", "--num-layers", "1", "--device", "cpu",
                        "--train-data", _corpus(tmp_path / "p.bin", rows=4), "--batch-size", "1",
                        "--train-iters", "13", "--split", "1.0,0.0,0.0", "--log-interval", "13",
                        "--profile-dir", str(prof_dir)], txt_tokenizer=VocabOnlyTextTokenizer())
    assert rc == 0
    assert f"profiler trace (steps 10-13) -> {prof_dir / 'trace.json'}" in (
        capsys.readouterr().out)
    events = json.loads((prof_dir / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::mm" in n or "aten::matmul" in n for n in names)
