"""Port parity for the transformer-XL memory in training against cogview_tpu,
float32 on the CPU, on the same numpy weights, batches and seeds (the mirror
of tests/test_train_mems.py): ``update_mems`` and ``forward_with_mems``,
three train steps that thread the memory past S with dropout 0.1, the
memory advancing on a skipped step, the float16 step with mems, sparse
attention with mems refused, and the CLI's ``--max-memory-length``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.training import optim as jopt
from cogview_tpu.training import train_loop as jtl
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.cli import pretrain
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.models import gpt
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, gpt_params_to_numpy
from cogview_tpu_torch.training import losses, optim
from cogview_tpu_torch.training import train_loop as tl

torch.set_num_threads(1)

IMG_VOCAB = 64
MEM_LEN = 80  # > S = 64, so the memory grows over two segments
DROP = dict(embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1)


def _jparams(seed=0, **kw):
    return jgpt.init_params(jax.random.PRNGKey(seed), jax_tiny(**kw))


def _to_torch(jparams):
    return gpt_params_from_jax(jax.tree.map(np.asarray, jparams))


def _batches(n, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    S = 64
    return [{"text": rng.randint(0, 128, (batch, S + 1)).astype(np.int32),
             "loss_mask": np.ones((batch, S + 1), np.float32)} for _ in range(n)]


def _step_seeds(sub, num_layers):
    """The dropout seeds the JAX train step derives from its key ``sub``."""
    rng, r_embed = jax.random.split(rbg_key(sub))
    return [int(seed_from_key(r_embed))] + [int(seed_from_key(r))
                                            for r in jax.random.split(rng, num_layers)]


def _assert_params_close(tparams, jparams, atol):
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams))
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(gpt_params_to_numpy(tparams))}
    for path, leaf in jl:
        np.testing.assert_allclose(tflat[jax.tree_util.keystr(path)], leaf, atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("M,S,cap", [(0, 6, 4), (0, 6, 9), (5, 6, 8), (5, 6, 20), (5, 6, 3)])
def test_update_mems_matches_jax(M, S, cap):
    rng = np.random.RandomState(M + S + cap)
    hid = rng.randn(3, 2, S, 4).astype(np.float32)
    mems = rng.randn(3, 2, M, 4).astype(np.float32) if M else None
    want = jgpt.update_mems(jnp.asarray(hid), None if mems is None else jnp.asarray(mems), cap)
    got = gpt.update_mems(torch.from_numpy(hid), None if mems is None else
                          torch.from_numpy(mems), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.requires_grad


def test_forward_with_mems_matches_jax():
    """Two segments in eval mode: logits to 1e-5 and the memory to 1e-5; the
    second segment attends to the first's 48 remembered positions."""
    jparams = _jparams(1)
    tparams = _to_torch(jparams)
    cfg, jcfg = tiny_test(), jax_tiny()
    rng = np.random.RandomState(2)
    jm = tm = None
    for seg in range(2):
        tokens = rng.randint(0, 128, (2, 40)).astype(np.int32)
        want, jm = jgpt.forward_with_mems(jparams, jcfg, jnp.asarray(tokens), jm,
                                          max_memory_length=48)
        got, tm = gpt.forward_with_mems(tparams, cfg, torch.from_numpy(tokens), tm,
                                        max_memory_length=48)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
        assert tm.shape == (cfg.num_layers + 1, 2, 40 if seg == 0 else 48, cfg.hidden_size)


def test_train_step_threads_mems_like_jax():
    """Three train steps with dropout 0.1 at every site and the memory capped
    at 80 > S: loss and grad norm to 1e-5 relative and params to 2e-5 after
    each step (test_torch_training.py's tolerances), the memory to 1e-4 (it
    holds hidden states of order 1 computed from those params) and its
    shape growing to the cap."""
    cfg_kw = dict(DROP)
    jcfg, tcfg = jax_tiny(**cfg_kw), tiny_test(**cfg_kw)
    jparams = _jparams(0, **cfg_kw)
    kw = dict(lr=1e-3, warmup_iter=1, num_iters=10)
    tx, _ = jopt.make_optimizer(jparams, **kw)
    tparams = _to_torch(jparams)
    opt, _ = optim.make_optimizer(tparams, **kw)
    jstate = jtl.init_train_state(jparams, tx)
    tstate = tl.init_train_state(tparams, opt, torch.Generator().manual_seed(0))
    jstep = jtl.make_train_step(jcfg, tx, img_vocab=IMG_VOCAB, donate=False,
                                max_memory_length=MEM_LEN)
    tstep = tl.make_train_step(tcfg, opt, img_vocab=IMG_VOCAB, max_memory_length=MEM_LEN)
    key = jax.random.PRNGKey(1)
    jm = tm = None
    L, H = tcfg.num_layers, tcfg.hidden_size
    for i, batch in enumerate(_batches(3)):
        key, sub = jax.random.split(key)
        jstate, jmet, jm = jstep(jstate, batch, sub, jm)
        tstate, tmet, tm = tstep(tstate, batch, _step_seeds(sub, L), tm)
        np.testing.assert_allclose(tmet["lm_loss"], float(jmet["lm_loss"]), rtol=1e-5)
        np.testing.assert_allclose(tmet["grad_norm"], float(jmet["grad_norm"]), rtol=1e-5)
        _assert_params_close(tstate["params"], jstate["params"], atol=2e-5)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)
        assert tm.shape == (L + 1, 2, min(MEM_LEN, 64 * (i + 1)), H)
        assert tstate["step"] == i + 1


def test_second_segment_loss_equals_lm_loss_with_mems():
    """Without dropout, the step's loss on the second segment equals
    lm_loss_with_mems on the same params and memory in eval mode."""
    tparams = _to_torch(_jparams(3))
    cfg = tiny_test()
    opt, _ = optim.make_optimizer(tparams, lr=1e-3, warmup_iter=1, num_iters=10)
    state = tl.init_train_state(tparams, opt, torch.Generator().manual_seed(0))
    step = tl.make_train_step(cfg, opt, img_vocab=IMG_VOCAB, max_memory_length=MEM_LEN)
    b0, b1 = _batches(2, seed=4)
    state, _, mems = step(state, b0)
    with torch.no_grad():
        want, _, want_mems = losses.lm_loss_with_mems(
            state["params"], cfg, {k: torch.from_numpy(v) for k, v in b1.items()}, mems,
            max_memory_length=MEM_LEN, img_vocab=IMG_VOCAB, train=False, remat=False)
    state, metrics, mems = step(state, b1, mems=mems)
    np.testing.assert_allclose(metrics["lm_loss"], float(want), rtol=2e-5)
    assert torch.equal(mems, want_mems)


def test_mems_advance_even_on_skipped_step():
    """An out-of-range token makes the loss NaN: the update is skipped,
    params stay bit-equal, and the memory still advances."""
    tparams = _to_torch(_jparams(0))
    before = gpt_params_to_numpy(tparams)
    opt, _ = optim.make_optimizer(tparams, lr=1e-3, warmup_iter=1, num_iters=10)
    state = tl.init_train_state(tparams, opt, torch.Generator().manual_seed(0))
    step = tl.make_train_step(tiny_test(), opt, img_vocab=IMG_VOCAB, max_memory_length=MEM_LEN)
    (bad,) = _batches(1)
    bad["loss_mask"][:, 3] = np.nan
    state, metrics, mems = step(state, bad)
    assert metrics["skipped"] == 1 and state["skipped"] == 1 and state["step"] == 0
    assert mems is not None and mems.shape[2] == 64
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(
            gpt_params_to_numpy(state["params"]))):
        np.testing.assert_array_equal(a, b)


def test_fp16_step_threads_mems_like_jax():
    """Two float16 steps with the memory against the JAX package's: loss and
    grad norm to 1e-3, the scale equal, params within 2 * lr after the
    second step (test_torch_training.py's float16 tolerances), the memory
    grown to the cap."""
    jparams = _jparams(4)
    kw = dict(lr=1e-3, warmup_iter=1, num_iters=50)
    tx, _ = jopt.make_optimizer(jparams, **kw)
    tparams = _to_torch(jparams)
    opt, _ = optim.make_optimizer(tparams, **kw)
    jstate = jtl.init_fp16_train_state(jparams, tx, init_scale=2.0 ** 10)
    tstate = tl.init_fp16_train_state(tparams, opt, torch.Generator().manual_seed(0),
                                      init_scale=2.0 ** 10)
    jstep = jtl.make_fp16_train_step(jax_tiny(), tx, img_vocab=IMG_VOCAB, donate=False,
                                     max_memory_length=MEM_LEN)
    tstep = tl.make_fp16_train_step(tiny_test(), opt, img_vocab=IMG_VOCAB,
                                    max_memory_length=MEM_LEN)
    jm = tm = None
    for i, batch in enumerate(_batches(2, seed=3)):
        sub = jax.random.PRNGKey(10 + i)
        jstate, jmet, jm = jstep(jstate, batch, sub, jm)
        tstate, tmet, tm = tstep(tstate, batch, _step_seeds(sub, 2), tm)
        np.testing.assert_allclose(tmet["lm_loss"], float(jmet["lm_loss"]), rtol=1e-3)
        np.testing.assert_allclose(tmet["grad_norm"], float(jmet["grad_norm"]), rtol=1e-3)
        assert tmet["loss_scale"] == float(jmet["loss_scale"]) and tmet["skipped"] == 0
        assert tm.dtype == torch.float16
        _assert_params_close(tstate["params"], jstate["params"], atol=2e-3 * i)
    assert tm.shape[2] == MEM_LEN == jm.shape[2]


def test_sparse_plus_mems_rejected():
    opt, _ = optim.make_optimizer(_to_torch(_jparams()), lr=1e-3)
    for make in (tl.make_train_step, tl.make_fp16_train_step):
        with pytest.raises(ValueError, match="no mems path"):
            make(tiny_test(), opt, is_sparse=True, max_memory_length=4)


class VocabOnlyTextTokenizer:
    num_tokens = 50000


def test_pretrain_cli_max_memory_length(tmp_path, monkeypatch, capsys):
    """``--max-memory-length 128`` at the smoke preset (one layer) on the CPU:
    the CLI threads the memory it gets back into the next step, which grows
    to the cap, and the losses are finite."""
    rng = np.random.RandomState(0)
    rows = np.full((8, 64 + 1024), -1, np.int32)
    rows[:, :8] = rng.randint(8192, 58192, size=(8, 8))
    rows[:, 64:] = rng.randint(0, 8192, size=(8, 1024))
    path = str(tmp_path / "mems_t2i.bin")
    rows.tofile(path)
    seen = []
    make = pretrain.make_train_step

    def recording(cfg, opt, **kw):
        step = make(cfg, opt, **kw)

        def wrapped(state, batch, seeds=None, mems=None):
            seen.append(None if mems is None else tuple(mems.shape))
            return step(state, batch, seeds, mems)

        return wrapped

    monkeypatch.setattr(pretrain, "make_train_step", recording)
    rc = pretrain.main(["--preset", "smoke", "--num-layers", "1", "--device", "cpu",
                        "--train-data", path, "--train-iters", "3", "--batch-size", "1",
                        "--max-memory-length", "128", "--log-interval", "1",
                        "--split", "1.0,0.0,0.0"], txt_tokenizer=VocabOnlyTextTokenizer())
    assert rc == 0
    assert seen == [None, (2, 1, 128, 64), (2, 1, 128, 64)]
    out = capsys.readouterr().out
    lm = [float(ln.split("| lm loss ")[1].split(" |")[0]) for ln in out.splitlines()
          if ln.startswith(" iteration")]
    assert len(lm) == 3 and np.isfinite(lm).all()
