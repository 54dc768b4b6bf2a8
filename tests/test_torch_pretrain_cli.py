"""The port's pretrain CLI on the CPU at the smoke preset (2 layers over the
real 58,240-token vocabulary) on a CompactBinary corpus written here: the
loss is finite and falls, the per-interval and eval lines are printed, the
tracker file names the saved iteration, and ``--load`` resumes there."""

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
