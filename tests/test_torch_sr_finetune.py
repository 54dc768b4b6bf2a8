"""Super-resolution finetuning in the port against cogview_tpu, float32 on the
CPU (the mirror of tests/test_position_extension.py's finetune tests):
the dual-segment position ids against both JAX variants, three
dual-position train steps at an extended position table with dropout 0.1,
a checkpoint with another position count restored and run, and the CLI's
``--load --finetune --dual-positions`` flow (the position table fitted, the
iteration and optimizer started afresh) and a resume without
``--finetune`` (the optimizer carried on)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.data.position_ids import dual_segment_position_ids as jax_dual_np
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.training import losses as jlosses
from cogview_tpu.training import optim as jopt
from cogview_tpu.training import train_loop as jtl
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.cli import pretrain
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.data.datasets import IndexedDataset
from cogview_tpu_torch.data.position_ids import dual_segment_position_ids
from cogview_tpu_torch.models import gpt
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, gpt_params_to_numpy
from cogview_tpu_torch.training import checkpointing, losses, optim
from cogview_tpu_torch.training import train_loop as tl

torch.set_num_threads(1)

ROI2 = 100  # an id below tiny_test's vocabulary acting as [ROI2]
IMG_VOCAB = 64
DROP = dict(embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1)


def _tokens():
    """Rows with [ROI2] at 10, 40 and twice (the first counts), and one
    without."""
    rng = np.random.RandomState(0)
    t = rng.randint(0, 99, (4, 80)).astype(np.int32)
    t[0, 10] = t[1, 40] = t[2, 5] = t[2, 60] = ROI2
    return t


@pytest.mark.parametrize("max_pos", [80, 50])
def test_dual_position_ids_match_both_jax_variants(max_pos):
    """In-step ids against ``losses.dual_position_ids`` (a row without
    [ROI2] keeps 0..S-1); the numpy twin against
    ``data.position_ids.dual_segment_position_ids`` (such a row raises);
    both clamped at max_pos - 1."""
    t = _tokens()
    want = np.asarray(jlosses.dual_position_ids(jnp.asarray(t), ROI2, max_pos))
    got = losses.dual_position_ids(torch.from_numpy(t), ROI2, max_pos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 10] == 0 and got[1, 41] == 1 and got[2, 60] == min(55, max_pos - 1)
    assert int(got[3].max()) == min(79, max_pos - 1)
    np.testing.assert_array_equal(dual_segment_position_ids(t[:3], ROI2, max_pos),
                                  jax_dual_np(t[:3], ROI2, max_pos))
    np.testing.assert_array_equal(dual_segment_position_ids(t[:3], ROI2, max_pos), want[:3])
    with pytest.raises(ValueError, match=r"\[ROI2\]"):
        dual_segment_position_ids(t, ROI2, max_pos)


def _assert_params_close(tparams, jparams, atol):
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams))
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(gpt_params_to_numpy(tparams))}
    for path, leaf in jl:
        np.testing.assert_allclose(tflat[jax.tree_util.keystr(path)], leaf, atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_sr_finetune_steps_at_extended_length_match_jax():
    """A 64-position model's params fitted to 80 positions (as 1,089 ->
    1,345), then three dual-position train steps at the full 80 tokens with
    dropout 0.1 against ``make_train_step(dual_positions_roi2=...)``: loss
    and grad norm to 1e-5 relative, params to 2e-5."""
    base = jgpt.init_params(jax.random.PRNGKey(0), jax_tiny(**DROP))
    jcfg = jax_tiny(max_position_embeddings=80, **DROP)
    tcfg = tiny_test(max_position_embeddings=80, **DROP)
    jparams = jgpt.adapt_position_embeddings(base, jcfg)
    tparams = gpt.adapt_position_embeddings(
        gpt_params_from_jax(jax.tree.map(np.asarray, base)), tcfg)
    assert tparams["embed"]["pos"].shape == (80, 64)
    np.testing.assert_array_equal(tparams["embed"]["pos"].numpy(),
                                  np.asarray(jparams["embed"]["pos"]))
    kw = dict(lr=1e-3, warmup_iter=1, num_iters=10)
    tx, _ = jopt.make_optimizer(jparams, **kw)
    opt, _ = optim.make_optimizer(tparams, **kw)
    jstate = jtl.init_train_state(jparams, tx)
    tstate = tl.init_train_state(tparams, opt, torch.Generator().manual_seed(0))
    jstep = jtl.make_train_step(jcfg, tx, img_vocab=IMG_VOCAB, donate=False,
                                dual_positions_roi2=ROI2)
    tstep = tl.make_train_step(tcfg, opt, img_vocab=IMG_VOCAB, dual_positions_roi2=ROI2)
    rng, key = np.random.RandomState(0), jax.random.PRNGKey(1)
    for i in range(3):
        text = rng.randint(0, 99, (2, 81)).astype(np.int32)
        text[:, 40 + i] = ROI2  # the second segment restarts here
        batch = {"text": text, "loss_mask": np.ones((2, 81), np.float32)}
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, batch, sub)
        r, r_embed = jax.random.split(rbg_key(sub))
        seeds = [int(seed_from_key(r_embed))] + [int(seed_from_key(x)) for x in
                                                 jax.random.split(r, tcfg.num_layers)]
        tstate, tm = tstep(tstate, batch, seeds=seeds)
        np.testing.assert_allclose(tm["lm_loss"], float(jm["lm_loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=1e-5)
        _assert_params_close(tstate["params"], jstate["params"], atol=2e-5)
        assert tm["skipped"] == 0


def test_shape_mismatch_load_restores_and_runs(tmp_path):
    """A checkpoint saved at 64 positions, loaded and fitted to 96: the
    forward's logits equal the JAX package's on the JAX-fitted params to
    1e-5."""
    jbase = jgpt.init_params(jax.random.PRNGKey(0), jax_tiny())
    tbase = gpt_params_from_jax(jax.tree.map(np.asarray, jbase))
    checkpointing.save_checkpoint(str(tmp_path / "ck"), 0, {"params": tbase, "iteration": 0})
    loaded = checkpointing.load_latest(str(tmp_path / "ck"))
    tcfg, jcfg = tiny_test(max_position_embeddings=96), jax_tiny(max_position_embeddings=96)
    adapted = gpt.adapt_position_embeddings(loaded["params"], tcfg)
    tokens = np.random.RandomState(1).randint(0, 128, (1, 96)).astype(np.int32)
    got = gpt.forward(adapted, tcfg, torch.from_numpy(tokens))
    want = jgpt.forward(jgpt.adapt_position_embeddings(jbase, jcfg), jcfg, jnp.asarray(tokens))
    assert got.shape == (1, 96, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


class VocabOnlyTextTokenizer:
    num_tokens = 50000


def _sr_corpus(path, rows=6):
    """Rows laid out as cogview_tpu/preprocess/tokenize_images.py's
    make_super_resolution_rows: [ROI1] text [BASE] [BOI1] 1,024 overview
    codes [EOI1] [ROI2] [POSp] [BASE] [BOI2] 1,024 patch codes [EOI2]."""
    cmd = 8192 + 50000  # the command tokens follow the image and text ids
    roi1, boi1, eoi1, roi2, boi2, eoi2, base = (cmd + i for i in (7, 1, 4, 8, 2, 5, 16))
    rng = np.random.RandomState(0)
    out = []
    for _ in range(rows):
        text = rng.randint(8192, 58192, rng.randint(8, 20))
        out.append(np.concatenate([[roi1], text, [base, boi1], rng.randint(0, 8192, 1024),
                                   [eoi1, roi2, cmd + 18 + rng.randint(9), base, boi2],
                                   rng.randint(0, 8192, 1024), [eoi2]]).astype(np.int32))
    IndexedDataset.write(path, out)
    return path


def _t2i_corpus(path, rows=4):
    rng = np.random.RandomState(1)
    data = np.full((rows, 64 + 1024), -1, np.int32)
    data[:, :8] = rng.randint(8192, 58192, size=(rows, 8))
    data[:, 64:] = rng.randint(0, 8192, size=(rows, 1024))
    data.tofile(path)
    return str(path)


def test_pretrain_cli_finetune_from_base_checkpoint(tmp_path, monkeypatch, capsys):
    """The JAX CLI's ``--preset cogview-sr --load <base> --finetune
    --dual-positions`` at the smoke widths, one layer: a 1,089-position run
    saves; the 1,345-position run loads it with --finetune, starts at
    iteration 0 with a fresh optimizer, its position table the saved one
    tiled (``extend_position_embedding``), its step made with [ROI2]'s id;
    a second --load of the finetune's checkpoint without --finetune resumes
    its iteration and optimizer count."""
    common = ["--preset", "smoke", "--num-layers", "1", "--device", "cpu", "--batch-size", "1",
              "--split", "1.0,0.0,0.0", "--log-interval", "1", "--warmup", "0.0"]
    tok = VocabOnlyTextTokenizer()
    base = str(tmp_path / "base")
    assert pretrain.main(common + ["--train-data", _t2i_corpus(tmp_path / "t2i.bin"),
                                   "--train-iters", "1", "--save", base],
                         txt_tokenizer=tok) == 0
    saved_pos = checkpointing.load_latest(base)["params"]["embed"]["pos"]
    assert saved_pos.shape == (1089, 64)

    seen = []
    make = pretrain.make_train_step

    def recording(cfg, opt, **kw):
        step = make(cfg, opt, **kw)

        def wrapped(state, batch, *a, **k):
            seen.append(dict(kw=kw, pos=state["params"]["embed"]["pos"].detach().clone(),
                             count=state["opt_state"]["count"], text=batch["text"]))
            return step(state, batch, *a, **k)

        return wrapped

    monkeypatch.setattr(pretrain, "make_train_step", recording)
    sr_data = _sr_corpus(str(tmp_path / "sr"))
    sr = ["--max-position-embeddings", "1345", "--dataset-type", "TokenizedDataset",
          "--train-data", sr_data, "--dual-positions", "--save", str(tmp_path / "sr_ck")]
    capsys.readouterr()
    assert pretrain.main(common + sr + ["--train-iters", "2", "--load", base, "--finetune"],
                         txt_tokenizer=tok) == 0
    out = capsys.readouterr().out
    assert f"loaded checkpoint from {base} at iteration 0" in out
    assert [ln.split("/")[0].split()[-1] for ln in out.splitlines()
            if ln.startswith(" iteration")] == ["1", "2"]
    first = seen[0]
    assert first["count"] == 0 and seen[1]["count"] == 1
    assert first["kw"]["dual_positions_roi2"] == 8192 + 50000 + 8
    assert first["text"].shape == (1, 1345)
    assert torch.equal(first["pos"][:1089], saved_pos)
    assert torch.equal(first["pos"], gpt.extend_position_embedding(saved_pos, 1345))

    seen.clear()
    assert pretrain.main(common + sr + ["--train-iters", "3", "--load", str(tmp_path / "sr_ck")],
                         txt_tokenizer=tok) == 0
    out = capsys.readouterr().out
    assert "at iteration 2" in out and seen[0]["count"] == 2
    assert [ln.split("/")[0].split()[-1] for ln in out.splitlines()
            if ln.startswith(" iteration")] == ["3"]
    assert os.path.isdir(tmp_path / "sr_ck" / "3")
