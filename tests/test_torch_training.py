"""Port parity for the training slice against cogview_tpu, float32 on the
CPU, on the same numpy weights, batches and seeds: the LM loss and its
img/txt split, the chunked CE, the LR schedule, the weight-decay mask, the
optimizer against optax, the loss scaler, whole train steps with dropout
through the flash and the dense routes, the NaN-skip, the float16 step, and
a bit-equal resume from a checkpoint."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.data.loader import BatchIterator
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.training import loss_scaler as jls
from cogview_tpu.training import losses as jlosses
from cogview_tpu.training import optim as jopt
from cogview_tpu.training import train_loop as jtl
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.models import gpt
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, gpt_params_to_numpy
from cogview_tpu_torch.training import checkpointing, loss_scaler, losses, optim
from cogview_tpu_torch.training import train_loop as tl

torch.set_num_threads(1)

IMG_VOCAB = 64  # of tiny_test's 128: ids >= 64 are text positions
DROP = dict(embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1)


def _jparams(seed=0, **kw):
    return jgpt.init_params(jax.random.PRNGKey(seed), jax_tiny(**kw))


def _to_torch(jparams):
    return gpt_params_from_jax(jax.tree.map(np.asarray, jparams))


def _batch(rng, b=2, s=64):
    return {"text": rng.randint(0, 128, (b, s)).astype(np.int32),
            "loss_mask": (rng.rand(b, s) > 0.1).astype(np.float32)}


def _seeds_of(sub, num_layers):
    """The dropout seeds the JAX train step derives from its key ``sub``."""
    rng, r_embed = jax.random.split(rbg_key(sub))
    return [int(seed_from_key(r_embed))] + [int(seed_from_key(r))
                                            for r in jax.random.split(rng, num_layers)]


def _assert_params_close(tparams, jparams, atol):
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams))
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(gpt_params_to_numpy(tparams))}
    assert len(jl) == len(tflat)
    for path, leaf in jl:
        np.testing.assert_allclose(tflat[jax.tree_util.keystr(path)], leaf, atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("txt_loss_scale", [1.0, 2.5])
def test_lm_loss_and_split_match_jax(txt_loss_scale):
    """lm_loss and its img/txt split, eval mode, to 1e-5."""
    jparams = _jparams(2)
    batch = _batch(np.random.RandomState(1))
    _, want = jlosses.lm_loss(jparams, jax_tiny(), batch, img_vocab=IMG_VOCAB,
                              txt_loss_scale=txt_loss_scale, train=False, remat=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, got = losses.lm_loss(_to_torch(jparams), tiny_test(), tb, img_vocab=IMG_VOCAB,
                            txt_loss_scale=txt_loss_scale, train=False, remat=False)
    for name in ("lm_loss", "img_loss", "txt_loss"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5,
                                   err_msg=name)
    assert float(got["img_loss"]) != float(got["txt_loss"])


@pytest.mark.parametrize("S,target", [(64, 16), (60, 16), (64, 64)])
def test_cross_entropy_hidden_chunked_matches_full(S, target):
    """Chunked CE equals full-logits CE in value (1e-5) and gradient (1e-5
    relative: the word gradient sums over chunks in another order), and the
    JAX package's chunked CE."""
    rng = np.random.RandomState(S + target)
    h = rng.randn(2, S, 64).astype(np.float32)
    labels = rng.randint(0, 128, (2, S))
    word = (rng.randn(128, 64) * 0.1).astype(np.float32)
    want = np.asarray(jlosses.cross_entropy_hidden({"embed": {"word": jnp.asarray(word)}},
                                                   jnp.asarray(h), jnp.asarray(labels),
                                                   chunk_target=target))
    grads, values = [], []
    for tgt in (target, S):
        w = torch.from_numpy(word).requires_grad_()
        th = torch.from_numpy(h).requires_grad_()
        ce = losses.cross_entropy_hidden({"embed": {"word": w}}, th,
                                         torch.from_numpy(labels), chunk_target=tgt)
        grads.append(torch.autograd.grad(ce.sum(), (w, th)))
        values.append(ce.detach().numpy())
    np.testing.assert_allclose(values[0], want, atol=1e-5)
    np.testing.assert_allclose(values[0], values[1], atol=1e-5)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_ce_chunk_auto_rule(monkeypatch):
    """chunk_target=0: full logits while [B, S, V] float32 fits in 4.5 GiB,
    checkpointed 160-token chunks above."""
    assert losses._pick_ce_chunk(1088, 160) == 136
    assert losses._pick_ce_chunk(17, 16) == 1
    h = torch.zeros(1, 320, 4)
    calls = []
    monkeypatch.setattr(losses, "checkpoint", lambda fn, *a, **k: calls.append(1) or fn(*a))
    for v, chunked in ((256, False), ((5 << 30) // (320 * 4), True)):
        calls.clear()
        word = torch.zeros(1, 4).expand(v, 4)  # no memory behind the rows
        losses.cross_entropy_hidden({"embed": {"word": word}}, h,
                                    torch.zeros(1, 320, dtype=torch.long))
        assert bool(calls) == chunked


@pytest.mark.parametrize("style", ["linear", "cosine", "constant", None])
def test_annealing_lr_matches_jax(style):
    want = jopt.annealing_lr(4e-4, 20, 200, style, 0.1)
    got = optim.annealing_lr(4e-4, 20, 200, style, 0.1)
    for t in (0, 1, 10, 19, 20, 21, 50, 150, 219, 220, 300):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6, err_msg=str(t))
    assert got(0) == 0.0


def test_weight_decay_mask_matches_jax():
    jparams = _jparams()
    want = jax.tree_util.tree_leaves_with_path(jopt.weight_decay_mask(jparams))
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        optim.weight_decay_mask(_to_torch(jparams)))}
    assert {jax.tree_util.keystr(p): bool(v) for p, v in want} == got
    assert not got["['layers']['qkv']['b']"] and not got["['ln_final']['g']"]
    assert got["['embed']['word']"] and got["['layers']['mlp_in']['w']"]


def test_optimizer_matches_optax():
    """Five updates with the same gradients against the optax chain, among
    them step 0 (lr 0 under warmup) and two steps whose global norm
    triggers the clip: params to 1e-6."""
    jparams = _jparams(3)
    kw = dict(lr=1e-3, warmup_iter=2, num_iters=10, weight_decay=0.1, grad_clip=1.0)
    tx, _ = jopt.make_optimizer(jparams, **kw)
    opt, _ = optim.make_optimizer(_to_torch(jparams), **kw)
    tparams = _to_torch(jparams)
    jstate, tstate = tx.init(jparams), opt.init(tparams)
    rng = np.random.RandomState(0)
    for i, gscale in enumerate((0.01, 0.01, 1.0, 0.001, 1.0)):
        g = jax.tree.map(lambda a: (rng.randn(*a.shape) * gscale).astype(np.float32), jparams)
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update(_to_torch(g), tstate, tparams)
        _assert_params_close(tparams, jparams, atol=1e-6)
        if i == 0:
            _assert_params_close(tparams, _jparams(3), atol=0)
    assert tstate["count"] == 5


def test_loss_scaler_matches_jax():
    flags = [True, False, True, True, False, False, False, True, False, False, False, False]
    js, ts = jls.init_loss_scale(2.0 ** 10, 2), loss_scaler.init_loss_scale(2.0 ** 10, 2)
    kw = dict(scale_factor=2.0, scale_window=3, min_scale=1.0, hysteresis=2)
    scales = []
    for f in flags:
        js, japply = jls.update_loss_scale(js, jnp.bool_(f), **kw)
        ts, tapply = loss_scaler.update_loss_scale(ts, f, **kw)
        assert (float(js.scale), int(js.good_steps), int(js.hysteresis_left)) == tuple(ts)
        assert bool(japply) == tapply == (not f)
        scales.append(ts.scale)
    assert min(scales) < 2.0 ** 10 < max(scales)


@pytest.mark.parametrize("flash", [True, False])
def test_train_step_matches_jax(flash):
    """Three whole train steps at tiny_test with all three dropouts at 0.1,
    remat on, float32, through the flash route (JAX: Pallas in interpret
    mode; port: the plain versions of the three kernels) or the dense route.
    The port takes the seeds the JAX step derives.  Loss and grad norm to
    1e-5 relative; every param leaf to 2e-5 absolute after each step (Adam
    divides each gradient by its own RMS, so a float32 rounding difference
    in a near-zero gradient moves its param by up to lr * 1e-2).  The first
    step applies lr 0 (optax reads the schedule before counting)."""
    cfg_kw = dict(DROP, use_flash_attention=flash)
    jcfg, tcfg = jax_tiny(**cfg_kw), tiny_test(**cfg_kw)
    jparams = _jparams(0, **cfg_kw)
    kw = dict(lr=1e-3, warmup_iter=1, num_iters=10)
    tx, _ = jopt.make_optimizer(jparams, **kw)
    tparams = _to_torch(jparams)
    opt, _ = optim.make_optimizer(tparams, **kw)
    jstate = jtl.init_train_state(jparams, tx)
    tstate = tl.init_train_state(tparams, opt, torch.Generator().manual_seed(0))
    jstep = jtl.make_train_step(jcfg, tx, img_vocab=IMG_VOCAB, remat=True, donate=False)
    tstep = tl.make_train_step(tcfg, opt, img_vocab=IMG_VOCAB, remat=True)
    rng, key = np.random.RandomState(0), jax.random.PRNGKey(1)
    for i in range(3):
        batch = _batch(rng)
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, batch, sub)
        tstate, tm = tstep(tstate, batch, seeds=_seeds_of(sub, tcfg.num_layers))
        np.testing.assert_allclose(tm["lm_loss"], float(jm["lm_loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=1e-5)
        _assert_params_close(tstate["params"], jstate["params"], atol=2e-5)
        assert tstate["step"] == int(jstate["step"]) == i + 1 and tstate["skipped"] == 0


def test_nan_skip_leaves_state_and_counts():
    """A poisoned batch (NaN loss mask) leaves params and optimizer state
    bit-equal and adds one to ``skipped``, as the JAX step does."""
    jparams = _jparams()
    jcfg, tcfg = jax_tiny(), tiny_test()
    tx, _ = jopt.make_optimizer(jparams, lr=1e-3, warmup_iter=1, num_iters=10)
    tparams = _to_torch(jparams)
    opt, _ = optim.make_optimizer(tparams, lr=1e-3, warmup_iter=1, num_iters=10)
    tstate = tl.init_train_state(tparams, opt, torch.Generator().manual_seed(0))
    tstep = tl.make_train_step(tcfg, opt, img_vocab=IMG_VOCAB)
    rng = np.random.RandomState(5)
    tstate, _ = tstep(tstate, _batch(rng))  # one good step: nonzero moments
    before = gpt_params_to_numpy(tstate["params"])
    mu = gpt_params_to_numpy(tstate["opt_state"]["mu"])
    bad = _batch(rng)
    bad["loss_mask"][0, 3] = np.nan
    tstate, m = tstep(tstate, bad)
    assert m["skipped"] == 1 and tstate["skipped"] == 1 and tstate["step"] == 1
    assert not np.isfinite(m["lm_loss"]) and tstate["opt_state"]["count"] == 1
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(
            gpt_params_to_numpy(tstate["params"]))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(mu), jax.tree.leaves(
            gpt_params_to_numpy(tstate["opt_state"]["mu"]))):
        np.testing.assert_array_equal(a, b)
    jstate = jtl.init_train_state(jparams, tx)
    jstate, jm = jtl.make_train_step(jcfg, tx, img_vocab=IMG_VOCAB, donate=False)(
        jstate, bad, jax.random.PRNGKey(0))
    assert int(jm["skipped"]) == 1 and int(jstate["skipped"]) == 1


def test_fp16_step_matches_jax_and_scale_moves_both_ways():
    """Two scaled float16 steps against the JAX package's: loss and grad
    norm to 1e-3 (float16 activations round at the same points, but sums
    run in another order), the loss scale equal, params equal after the
    first step (lr 0) and within 2 * lr after the second (Adam turns a
    near-zero gradient that float16 rounds differently into an update of up
    to +-lr).  Then the port's scale shrinks on overflow and grows after
    ``scale_window`` good steps."""
    jparams = _jparams(4)
    kw = dict(lr=1e-3, warmup_iter=1, num_iters=50)
    tx, _ = jopt.make_optimizer(jparams, **kw)
    tparams = _to_torch(jparams)
    opt, _ = optim.make_optimizer(tparams, **kw)
    jstate = jtl.init_fp16_train_state(jparams, tx, init_scale=2.0 ** 10, hysteresis=1)
    tstate = tl.init_fp16_train_state(tparams, opt, torch.Generator().manual_seed(0),
                                      init_scale=2.0 ** 10, hysteresis=1)
    skw = dict(img_vocab=IMG_VOCAB, scale_window=3, hysteresis=1)
    jstep = jtl.make_fp16_train_step(jax_tiny(), tx, donate=False, **skw)
    tstep = tl.make_fp16_train_step(tiny_test(), opt, **skw)
    rng = np.random.RandomState(2)
    batch = _batch(rng)
    for i in range(2):
        sub = jax.random.PRNGKey(10 + i)
        jstate, jm = jstep(jstate, batch, sub)
        tstate, tm = tstep(tstate, batch, seeds=_seeds_of(sub, 2))
        np.testing.assert_allclose(tm["lm_loss"], float(jm["lm_loss"]), rtol=1e-3)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=1e-3)
        assert tm["loss_scale"] == float(jm["loss_scale"]) and tm["skipped"] == 0
        _assert_params_close(tstate["params"], jstate["params"], atol=2e-3 * i)

    # a scale of 2^30 overflows float16 gradients: the step is skipped and
    # the scale halves until it fits; three good steps later it doubles
    tstate["loss_scale"] = loss_scaler.LossScaleState(2.0 ** 30, 0, 1)
    scales, skipped = [], []
    for _ in range(30):
        tstate, tm = tstep(tstate, batch)
        scales.append(tm["loss_scale"])
        skipped.append(tm["skipped"])
    diffs = np.diff([2.0 ** 30] + scales)
    assert (diffs < 0).any() and (diffs > 0).any(), scales
    assert skipped[0] == 1 and tstate["skipped"] == sum(skipped) and 0 in skipped


def test_resume_from_checkpoint_is_bit_equal(tmp_path):
    """6 steps straight == 3 steps / save / load into a fresh state / 3
    steps: params bit-equal on the CPU (params, optimizer state, the
    generator that draws the dropout seeds, and the loader position are
    all in the checkpoint)."""
    rng = np.random.RandomState(0)
    ds = [{"text": rng.randint(0, 128, 64).astype(np.int32),
           "loss_mask": np.ones(64, np.float32)} for _ in range(32)]
    cfg = tiny_test(**DROP)
    jparams = _jparams(1, **DROP)

    def fresh():
        params = _to_torch(jparams)
        opt, _ = optim.make_optimizer(params, lr=1e-3, warmup_iter=1, num_iters=10)
        return tl.init_train_state(params, opt, torch.Generator().manual_seed(9)), opt

    def run(state, opt, it, n):
        step, data = tl.make_train_step(cfg, opt, img_vocab=IMG_VOCAB), iter(it)
        for _ in range(n):
            state, _ = step(state, next(data))
        return state

    a, opt_a = fresh()
    a = run(a, opt_a, BatchIterator(ds, 4, seed=3, prefetch=0), 6)

    b, opt_b = fresh()
    b = run(b, opt_b, BatchIterator(ds, 4, seed=3, prefetch=0), 3)
    checkpointing.save_checkpoint(str(tmp_path), 3, {
        "params": b["params"], "opt_state": b["opt_state"], "iteration": 3,
        "generator": b["generator"].get_state(), "loader_consumed": 3})
    assert (tmp_path / checkpointing.TRACKER).read_text() == "3"
    assert checkpointing.get_checkpoint_iteration(str(tmp_path)) == 3

    c, opt_c = fresh()
    loaded = checkpointing.load_latest(str(tmp_path))
    with torch.no_grad():
        optim.tree_map(lambda d, s: d.copy_(s), c["params"], loaded["params"])
        for k in ("mu", "nu"):
            optim.tree_map(lambda d, s: d.copy_(s), c["opt_state"][k], loaded["opt_state"][k])
    c["opt_state"]["count"] = loaded["opt_state"]["count"]
    c["generator"].set_state(loaded["generator"])
    it = BatchIterator(ds, 4, seed=3, prefetch=0)
    it.fast_forward(loaded["loader_consumed"])
    c = run(c, opt_c, it, 3)
    for x, y in zip(optim.tree_leaves(a["params"]), optim.tree_leaves(c["params"])):
        assert torch.equal(x, y)
    (tmp_path / checkpointing.TRACKER).write_text("release")
    assert checkpointing.get_checkpoint_iteration(str(tmp_path)) == 0


def test_sliced_optimizer_update_is_bit_equal_to_the_whole_leaf(monkeypatch):
    """AdamW works through each leaf in runs of whole rows (layers of a
    stacked leaf): with slices of 1,000 elements and with every leaf whole,
    four updates (two of them clipped, weight decay on) leave params, mu and
    nu bit-equal."""
    jparams = _jparams(5)
    g_rng = np.random.RandomState(1)
    grads = [_to_torch(jax.tree.map(lambda a: (g_rng.randn(*a.shape) * s).astype(np.float32),
                                    jparams)) for s in (0.01, 1.0, 0.001, 1.0)]
    out = []
    for elems in (1000, 1 << 40):
        monkeypatch.setattr(optim, "UPDATE_SLICE_ELEMS", elems)
        params = _to_torch(jparams)
        opt, _ = optim.make_optimizer(params, lr=1e-3, warmup_iter=1, num_iters=10,
                                      weight_decay=0.1)
        state = opt.init(params)
        for g in grads:
            opt.update(g, state, params)
        out.append([*optim.tree_leaves(params), *optim.tree_leaves(state["mu"]),
                    *optim.tree_leaves(state["nu"])])
        if elems == 1000:  # qkv.w [2, 64, 3, 64]: one layer a slice
            assert len(optim._row_slices(params["layers"]["qkv"]["w"])) == 2
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flash", [True, False])
def test_layer_views_by_unbind_keep_gradients_bit_equal(monkeypatch, flash):
    """The layer views ``gpt._layers`` makes with one unbind per stacked leaf
    give the same loss and gradients, bit for bit, as a select per layer
    (the views before), with dropout and remat, through the flash and dense
    routes."""
    cfg = tiny_test(**DROP, use_flash_attention=flash)
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.RandomState(2)).items()}

    def selects(params):
        return [{k: {kk: vv[li] for kk, vv in v.items()} for k, v in params["layers"].items()}
                for li in range(cfg.num_layers)]

    got = []
    for views in (gpt._layers, selects):
        monkeypatch.setattr(gpt, "_layers", views)
        params = optim.tree_map(lambda p: p.requires_grad_(True), _to_torch(_jparams(6, **DROP)))
        loss, _ = losses.lm_loss(params, cfg, batch, img_vocab=IMG_VOCAB, seeds=[1, 2, 3])
        got.append([loss, *torch.autograd.grad(loss, list(optim.tree_leaves(params)))])
    for a, b in zip(*got):
        assert torch.equal(a, b)
