"""Port parity for pivot + window sparse attention against cogview_tpu, float32
on the CPU, on the same numpy inputs (the mirror of
tests/test_sparse_attention.py): the windows and masks exact, the attention
and its dropout to 2e-5, equality with dense attention under the union mask
without the bias (values and gradients), the bias, the inference gather,
the pivots, and a sparse ``lm_loss`` and three sparse train steps with
dropout 0.1 on JAX's pivots (the port draws its own from a
``torch.Generator``, so the tests hand it the JAX package's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops import sparse_attention as jsa
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.training import losses as jlosses
from cogview_tpu.training import optim as jopt
from cogview_tpu.training import train_loop as jtl
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, gpt_params_to_numpy
from cogview_tpu_torch.ops import sparse_attention as sa
from cogview_tpu_torch.ops.attention import dense_attention
from cogview_tpu_torch.training import losses, optim
from cogview_tpu_torch.training import train_loop as tl

torch.set_num_threads(1)

B, N, D = 2, 4, 16
S, W, TIMES = 256 + 64, 64, 2
P = 96
IMG_VOCAB = 64
# the sparse geometry of the model tests: 64 training tokens, 8-token windows
SPARSE = dict(max_position_embeddings=65, query_window=8, key_window_times=2, num_pivot=16)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(0)
    return [rng.rand(B, S, N, D).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def pivots():
    """Text positions 0..31 and 0..9, then random image positions."""
    rng = np.random.RandomState(1)
    idx = []
    for txt_len in (32, 10):
        img = rng.choice(np.arange(txt_len, S - TIMES * W), P - txt_len, replace=False)
        idx.append(np.sort(np.concatenate([np.arange(txt_len), img])))
    return np.stack(idx)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _masks(pivots):
    rmask = sa.build_rmask(S, W, TIMES)
    return torch.from_numpy(rmask), sa.gather_pivot_mask(torch.from_numpy(rmask),
                                                         torch.from_numpy(pivots))


def _dense_union_mask(pivots):
    """(not rmask) | the pivot columns, lower-triangular: [B, 1, S, S]."""
    m = np.broadcast_to(~sa.build_rmask(S, W, TIMES), (B, S, S)).copy()
    for i in range(B):
        m[i][:, pivots[i]] = True
    return torch.from_numpy(m & np.tril(np.ones((S, S), bool)))[:, None]


@pytest.mark.parametrize("s,w,times", [(S, W, TIMES), (1088, 64, 4), (64, 8, 2), (48, 8, 3)])
def test_masks_and_windows_equal_jax(s, w, times, qkv):
    np.testing.assert_array_equal(sa.build_rmask(s, w, times), jsa.build_rmask(s, w, times))
    np.testing.assert_array_equal(sa.window_mask(w, times, s // w),
                                  jsa.window_mask(w, times, s // w))
    k = np.random.RandomState(s).rand(1, s, 2, 4).astype(np.float32)
    got = sa.chunk_windows(torch.from_numpy(k), w, times)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsa.chunk_windows(jnp.asarray(k),
                                                                            w, times)))
    assert got.shape == (1, s // w, times * w, 2, 4)


def test_window_chunking(qkv):
    k = torch.from_numpy(qkv[1])
    wins = sa.chunk_windows(k, W, TIMES)
    assert wins.shape == (B, S // W, TIMES * W, N, D)
    assert torch.equal(wins[:, 2, -W:], k[:, 2 * W:3 * W])  # chunk g ends at (g+1)w - 1
    assert float(wins[:, 0, :(TIMES - 1) * W].abs().max()) == 0.0  # left padding
    with pytest.raises(ValueError, match="divisible"):
        sa.chunk_windows(k[:, :S - 1], W, TIMES)


@pytest.mark.parametrize("bias,rate", [(None, 0.0), (0.0, 0.0), (None, 0.1)])
def test_pivot_window_attention_matches_jax(qkv, pivots, bias, rate):
    """The default log(S // P) bias, none, and dropout 0.1 on the joint
    probabilities (the same hash bits as the JAX package's, salt 1)."""
    rmask, pmask = _masks(pivots)
    kw = dict(pivot_bias=bias, dropout_rate=rate, dropout_seed=77 if rate else None,
              train=bool(rate))
    want = jsa.pivot_window_attention(
        *map(jnp.asarray, qkv), jnp.asarray(pivots),
        jsa.gather_pivot_mask(jnp.asarray(rmask.numpy()), jnp.asarray(pivots)), W, TIMES,
        **{**kw, "dropout_seed": jnp.uint32(77) if rate else None})
    got = sa.pivot_window_attention(*_t(*qkv), torch.from_numpy(pivots), pmask, W, TIMES,
                                    **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_sparse_equals_dense_without_bias(qkv, pivots):
    _, pmask = _masks(pivots)
    q, k, v = _t(*qkv)
    got = sa.pivot_window_attention(q, k, v, torch.from_numpy(pivots), pmask, W, TIMES,
                                    pivot_bias=0.0)
    want = dense_attention(q, k, v, _dense_union_mask(pivots))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)


def test_sparse_gradients_match_dense(qkv, pivots):
    _, pmask = _masks(pivots)
    dmask = _dense_union_mask(pivots)
    grads = []
    for fn in (lambda q, k, v: sa.pivot_window_attention(q, k, v, torch.from_numpy(pivots),
                                                         pmask, W, TIMES, pivot_bias=0.0),
               lambda q, k, v: dense_attention(q, k, v, dmask)):
        args = [t.clone().requires_grad_() for t in _t(*qkv)]
        grads.append(torch.autograd.grad(fn(*args).mean(), args))
    for gs, gd in zip(*grads):
        np.testing.assert_allclose(gs.numpy(), gd.numpy(), atol=3e-6)


def test_pivot_bias_reweights(qkv, pivots):
    _, pmask = _masks(pivots)
    args = _t(*qkv) + [torch.from_numpy(pivots), pmask, W, TIMES]
    diff = float((sa.pivot_window_attention(*args)
                  - sa.pivot_window_attention(*args, pivot_bias=0.0)).abs().max())
    assert 0 < diff < 1.0


def test_inference_gather_matches_jax(qkv, pivots):
    """The trailing query (and a trailing block of 3, causal among the last 3
    keys) over the pivot + window keys, against the JAX function."""
    for sq in (1, 3):
        window = np.broadcast_to(np.arange(S - TIMES * W, S), (B, TIMES * W))
        idx = np.concatenate([pivots, window], axis=-1)
        q = qkv[0][:, -sq:]
        want = jsa.sparse_attention_inference(jnp.asarray(q), jnp.asarray(qkv[1]),
                                              jnp.asarray(qkv[2]), jnp.asarray(idx))
        got = sa.sparse_attention_inference(*_t(q, qkv[1], qkv[2], idx))
        assert got.shape == (B, sq, N, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_sample_pivots_includes_all_text():
    tokens = np.full((2, S), 5, np.int64)  # image codes
    tokens[0, :40] = 9000  # text
    tokens[1, :7] = 9000
    mask = np.ones((2, S), np.float32)
    mask[1, 3] = 0.0  # a text position off the loss need not be a pivot
    idx = sa.sample_pivots(torch.Generator().manual_seed(0), *_t(tokens), P, img_vocab=8192,
                           loss_mask=torch.from_numpy(mask))
    assert idx.shape == (2, P) and bool((idx[:, 1:] > idx[:, :-1]).all())  # sorted, distinct
    assert set(range(40)) <= set(idx[0].tolist())
    assert set(range(7)) - {3} <= set(idx[1].tolist())
    again = sa.sample_pivots(torch.Generator().manual_seed(0), *_t(tokens), P, img_vocab=8192,
                             loss_mask=torch.from_numpy(mask))
    assert torch.equal(idx, again)


def _jparams(seed=0, **kw):
    return jgpt.init_params(jax.random.PRNGKey(seed), jax_tiny(**kw))


def _batch(rng, b=2, s=65):
    return {"text": rng.randint(0, 128, (b, s)).astype(np.int32),
            "loss_mask": (rng.rand(b, s) > 0.1).astype(np.float32)}


def _lmask(batch):
    """The scaled loss mask lm_loss hands sample_pivots (txt_loss_scale 1)."""
    return jnp.asarray(batch["loss_mask"][:, 1:])


def _jax_pivots(key, batch, cfg):
    return np.array(jsa.sample_pivots(key, jnp.asarray(batch["text"][:, :-1]),
                                        cfg.num_pivot, IMG_VOCAB, loss_mask=_lmask(batch)))


def test_sparse_lm_loss_matches_jax():
    """lm_loss(is_sparse=True) in training with dropout 0.1 at every site,
    the JAX package's pivots and dropout seeds: loss and its split to 1e-5,
    and the loss without pivot_idx is finite (the port's own draw)."""
    kw = dict(SPARSE, embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1)
    jcfg, tcfg = jax_tiny(**kw), tiny_test(**kw)
    jparams = _jparams(2, **kw)
    batch = _batch(np.random.RandomState(3))
    key = jax.random.PRNGKey(5)
    _, want = jlosses.lm_loss(jparams, jcfg, batch, img_vocab=IMG_VOCAB, rng=key,
                              train=True, remat=False, is_sparse=True)
    rng, r_embed = jax.random.split(key)
    seeds = [int(seed_from_key(r_embed))] + [int(seed_from_key(r)) for r in
                                             jax.random.split(rng, tcfg.num_layers)]
    tparams = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pivots = torch.from_numpy(_jax_pivots(key, batch, jcfg)).long()
    _, got = losses.lm_loss(tparams, tcfg, tb, img_vocab=IMG_VOCAB, seeds=seeds, remat=False,
                            is_sparse=True, pivot_idx=pivots)
    for name in ("lm_loss", "img_loss", "txt_loss"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5,
                                   err_msg=name)
    own, _ = losses.lm_loss(tparams, tcfg, tb, img_vocab=IMG_VOCAB, seeds=seeds, remat=False,
                            is_sparse=True, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(own)) and float(own) != float(got["lm_loss"])
    with pytest.raises(ValueError, match="query_window"):
        losses.lm_loss(tparams, tcfg.replace(query_window=7), tb, img_vocab=IMG_VOCAB,
                       is_sparse=True, pivot_idx=pivots)


def test_sparse_lm_loss_needs_a_pivot_source():
    """Sparse lm_loss draws its pivots from the caller's generator or takes
    them as pivot_idx; with neither it raises rather than draw the same
    pivots on every call."""
    cfg = tiny_test(**SPARSE)
    params = gpt_params_from_jax(jax.tree.map(np.asarray, _jparams(2, **SPARSE)))
    tb = {k: torch.from_numpy(v) for k, v in _batch(np.random.RandomState(3)).items()}
    with pytest.raises(ValueError, match="generator"):
        losses.lm_loss(params, cfg, tb, img_vocab=IMG_VOCAB, train=False, remat=False,
                       is_sparse=True)


def _assert_params_close(tparams, jparams, atol):
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams))
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(gpt_params_to_numpy(tparams))}
    for path, leaf in jl:
        np.testing.assert_allclose(tflat[jax.tree_util.keystr(path)], leaf, atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_sparse_train_step_matches_jax():
    """Three train steps with is_sparse and dropout 0.1, remat on, against
    ``make_train_step(is_sparse=True)``: the port takes the JAX step's seeds
    and pivots.  Loss and grad norm to 1e-5 relative, params to 2e-5."""
    kw = dict(SPARSE, embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1)
    jcfg, tcfg = jax_tiny(**kw), tiny_test(**kw)
    jparams = _jparams(0, **kw)
    okw = dict(lr=1e-3, warmup_iter=1, num_iters=10)
    tx, _ = jopt.make_optimizer(jparams, **okw)
    tparams = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    opt, _ = optim.make_optimizer(tparams, **okw)
    jstate = jtl.init_train_state(jparams, tx)
    tstate = tl.init_train_state(tparams, opt, torch.Generator().manual_seed(0))
    jstep = jtl.make_train_step(jcfg, tx, img_vocab=IMG_VOCAB, donate=False, is_sparse=True)
    tstep = tl.make_train_step(tcfg, opt, img_vocab=IMG_VOCAB, is_sparse=True)
    rng, key = np.random.RandomState(0), jax.random.PRNGKey(1)
    for i in range(3):
        batch = _batch(rng)
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, batch, sub)
        r = rbg_key(sub)
        rr, r_embed = jax.random.split(r)
        seeds = [int(seed_from_key(r_embed))] + [int(seed_from_key(x)) for x in
                                                 jax.random.split(rr, tcfg.num_layers)]
        pivots = torch.from_numpy(_jax_pivots(r, batch, jcfg)).long()
        tstate, tm = tstep(tstate, batch, seeds=seeds, pivot_idx=pivots)
        np.testing.assert_allclose(tm["lm_loss"], float(jm["lm_loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=1e-5)
        _assert_params_close(tstate["params"], jstate["params"], atol=2e-5)
        assert tstate["step"] == i + 1 and tstate["skipped"] == 0
