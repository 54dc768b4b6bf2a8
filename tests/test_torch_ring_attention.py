"""Ring attention and sequence-parallel training of the port
(cogview_tpu_torch/ops/ring_attention.py) on gloo CPU processes against
the JAX package's dense attention and its unsharded train step, in float32.

One spawn of 4 ranks runs every attention case (the ring on seq 4, sep 0
and 17; the dropout keep pattern under data 2 x seq 2 and seq 2 x model 2;
the gradients of sum(o * o)) and hands back the gathered outputs; the
model's forward and 3 train steps with dropout 0.1 run on (dp, sp, mp,
fsdp) = (1, 2, 2, yes) with remat on, so each layer's recomputation
re-runs the ring and its rotations in the backward.  Sparse attention and
the transformer-XL memory under 'seq' take the gather route: the JAX
package's own SP step equals its unsharded step there (bit for bit), and
the port's SP steps and CLI runs match the JAX step and one process.
Tolerances: the ring
to 2e-5 (as tests/test_ring_attention.py), its gradients to 5e-4 as there,
the train steps as tests/test_torch_parallel.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.models import gpt as jgpt
from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.ops.attention import causal_mask, dense_attention
from cogview_tpu_torch.parallel.spawn import run_ranks

import torch_parallel_workers as workers
from test_torch_parallel import (DROP, IMG_VOCAB, OPT, TIMEOUT, _batches, _cli_argv, _compare,
                                 _corpus, _jax_run, _leaves)

torch.set_num_threads(1)

B, S, N, D = 2, 64, 8, 8
SEED = 98765
CASES = {
    # name: (dp, sp, mp), sep, dropout rate
    "seq4-sep0": ((1, 4, 1), 0, 0.0),
    "seq4-sep17": ((1, 4, 1), 17, 0.0),
    "data2-seq2-dropout": ((2, 2, 1), 5, 0.1),
    "seq2-model2-dropout": ((1, 2, 2), 5, 0.1),
    "seq4-grads": ((1, 4, 1), 3, 0.0),
}


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(0)
    return tuple(rng.randn(B, S, N, D).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def ring_out(qkv, tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    torch.save({"q": torch.from_numpy(qkv[0]), "k": torch.from_numpy(qkv[1]),
                "v": torch.from_numpy(qkv[2]),
                "cases": [{"mesh": m, "sep": sep, "rate": rate, "seed": SEED}
                          for m, sep, rate in CASES.values()]}, d / "in.pt")
    run_ranks(workers.ring_cases, 4, str(d), str(d), timeout=TIMEOUT)
    return dict(zip(CASES, torch.load(d / "out.pt", weights_only=False)))


def _dense(qkv, sep, rate):
    q, k, v = (jnp.asarray(x) for x in qkv)
    kw = dict(dropout_rate=rate, dropout_seed=jnp.uint32(SEED), train=True) if rate else {}
    return dense_attention(q, k, v, causal_mask(S, sep=sep), **kw)


@pytest.mark.parametrize("name", ["seq4-sep0", "seq4-sep17"])
def test_ring_matches_jax_dense(qkv, ring_out, name):
    _, sep, rate = CASES[name]
    want = np.asarray(_dense(qkv, sep, rate))
    assert np.abs(ring_out[name]["o"].numpy() - want).max() < 2e-5


@pytest.mark.parametrize("name", ["data2-seq2-dropout", "seq2-model2-dropout"])
def test_ring_dropout_keeps_the_dense_pattern(qkv, ring_out, name):
    """The keep mask hashes global (b, n, q, k): data-, head- and
    sequence-split runs reproduce the unsharded dense mask, so the output
    equals dense attention's with dropout (a wrong keep pattern moves it
    by O(1))."""
    _, sep, rate = CASES[name]
    want = np.asarray(_dense(qkv, sep, rate))
    assert np.abs(want - np.asarray(_dense(qkv, sep, 0.0))).max() > 0.1
    assert np.abs(ring_out[name]["o"].numpy() - want).max() < 2e-5


def test_ring_gradients_match_jax_vjp(qkv, ring_out):
    _, sep, _ = CASES["seq4-grads"]
    q, k, v = (jnp.asarray(x) for x in qkv)
    o, vjp = jax.vjp(lambda q, k, v: dense_attention(q, k, v, causal_mask(S, sep=sep)),
                     q, k, v)
    want = vjp(2.0 * o)
    got = ring_out["seq4-grads"]["grads"]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < 5e-4


@functools.lru_cache(maxsize=None)
def _jax_steps():
    cfg_kw = dict(DROP)
    batches = _batches(3, 4, 64)
    return (cfg_kw, batches) + _jax_run(cfg_kw, {}, batches)


def test_sp_forward_and_train_steps_match_unsharded_jax(tmp_path):
    """(dp, sp, mp, fsdp) = (1, 2, 2, yes): inference logits against JAX's
    unsharded forward (1e-5 of the largest), then 3 train steps with every
    dropout at 0.1 through the ring against the JAX step."""
    cfg_kw, batches, params0, seeds, _, want = _jax_steps()
    torch.save({"mesh": (1, 2, True), "sp": 2, "cfg": cfg_kw, "forward": True,
                "step": dict(img_vocab=IMG_VOCAB), "opt": OPT, "params": params0,
                "batches": batches, "seeds": seeds}, tmp_path / "in.pt")
    run_ranks(workers.train_steps, 4, str(tmp_path), str(tmp_path), timeout=TIMEOUT)
    out = torch.load(tmp_path / "out.pt", weights_only=False)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jax_tiny(**cfg_kw))
    ref = np.asarray(jgpt.forward(jparams, jax_tiny(**cfg_kw),
                                  jnp.asarray(batches[0]["text"][:, :-1])))
    got = out["logits"].numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    _compare(out["steps"], want)


def test_pretrain_cli_sequence_parallel_matches_one_process(tmp_path, monkeypatch):
    """``cli.pretrain`` as 2 ranks with --sequence-parallel-size 2 (a
    float32 smoke preset, each row's 64 positions split in two) saves the
    full leaves of the one-process run, to the train-step tolerance."""
    from cogview_tpu_torch.cli import pretrain

    monkeypatch.setattr(pretrain, "PRESETS", dict(pretrain.PRESETS))
    workers.register_presets(pretrain.PRESETS)
    data = _corpus(tmp_path / "c.bin")
    sharded, single = tmp_path / "sp", tmp_path / "one"
    torch.save({"argv": _cli_argv(data, "--train-iters", "2", "--save", str(sharded),
                                  "--sequence-parallel-size", "2")}, tmp_path / "in.pt")
    run_ranks(workers.pretrain_cli, 2, str(tmp_path), str(tmp_path), timeout=TIMEOUT)

    class VocabOnly:
        num_tokens = 50000

    assert pretrain.main(_cli_argv(data, "--train-iters", "2", "--save", str(single)),
                         txt_tokenizer=VocabOnly()) == 0
    st_a, a = _leaves(sharded)
    st_b, b = _leaves(single)
    assert st_a["iteration"] == st_b["iteration"] == 2
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5 if "params" in k else 1e-4,
                                   rtol=1e-4, err_msg=k)


SP_ROUTES = {
    # name: config, step flags, rows of the global batch, (dp, sp, mp)
    "sparse": (dict(max_position_embeddings=65, query_window=8, key_window_times=2,
                    num_pivot=16), dict(is_sparse=True), 4, (2, 2, 1)),
    "mems": ({}, dict(max_memory_length=80), 2, (1, 2, 1)),
}


@pytest.mark.parametrize("route", list(SP_ROUTES))
def test_jax_sp_step_matches_its_unsharded_step(route):
    """The JAX package with seq 2 on a ('data', 'seq') mesh: its layers
    take sparse attention or a memory ahead of the ring, on the whole
    sequence, so the loss, every gradient and the new mems equal the
    unsharded step's.  This is what the port's gather route mirrors."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from cogview_tpu.training.losses import lm_loss, lm_loss_with_mems

    cfg_kw, step_kw, rows, _ = SP_ROUTES[route]
    cfg = jax_tiny(**cfg_kw, **DROP)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    batch = _batches(1, rows, 64)[0]
    mems = jnp.asarray(np.random.RandomState(5).randn(
        cfg.num_layers + 1, rows, 16, cfg.hidden_size).astype(np.float32))
    rng = jax.random.PRNGKey(3)

    def step(c, b):
        def f(p):
            if step_kw.get("max_memory_length"):
                loss, (_, new) = lm_loss_with_mems(p, c, b, mems, max_memory_length=80,
                                                   img_vocab=IMG_VOCAB, rng=rng)
                return loss, new
            return lm_loss(p, c, b, img_vocab=IMG_VOCAB, rng=rng, is_sparse=True)[0], mems
        return jax.jit(jax.value_and_grad(f, has_aux=True))(params)

    (l_ref, m_ref), g_ref = step(cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "seq"))
    with jax.set_mesh(mesh):
        cfg_sp = cfg.replace(sp_axis="seq", sp_num_shards=2, sp_data_axis="data")
        (l_sp, m_sp), g_sp = step(cfg_sp, {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                                           for k, v in batch.items()})
    assert float(l_sp) == float(l_ref)
    np.testing.assert_array_equal(np.asarray(m_sp), np.asarray(m_ref))
    for a, b in zip(jax.tree.leaves(g_sp), jax.tree.leaves(g_ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@functools.lru_cache(maxsize=None)
def _jax_route_steps(route):
    cfg_kw, step_kw, rows, _ = SP_ROUTES[route]
    cfg_kw = dict(DROP, **cfg_kw)
    batches = _batches(3, rows, 64)
    return (cfg_kw, batches) + _jax_run(cfg_kw, step_kw, batches)


@pytest.mark.parametrize("route", list(SP_ROUTES))
def test_sp_sparse_and_mems_train_steps_match_unsharded_jax(route, tmp_path):
    """Sequence parallelism with sparse attention (data 2 x seq 2) and with
    a transformer-XL memory (seq 2): each layer gathers the sequence over
    'seq', attends as the unsharded layer does and keeps its block; 3 train
    steps with every dropout at 0.1 match the JAX step (losses, grad norms,
    params and the mems)."""
    _, step_kw, _, (dp, sp, mp) = SP_ROUTES[route]
    cfg_kw, batches, params0, seeds, pivots, want = _jax_route_steps(route)
    torch.save({"mesh": (dp, mp, False), "sp": sp, "cfg": cfg_kw,
                "step": dict(img_vocab=IMG_VOCAB, **step_kw), "opt": OPT, "params": params0,
                "batches": batches, "seeds": seeds, "pivots": pivots}, tmp_path / "in.pt")
    run_ranks(workers.train_steps, dp * sp * mp, str(tmp_path), str(tmp_path),
              timeout=TIMEOUT)
    _compare(torch.load(tmp_path / "out.pt", weights_only=False), want)


@pytest.mark.parametrize("route,argv", [
    ("mems", ["--max-memory-length", "32"]),
    ("sparse", ["--is-sparse", "1", "--query-window", "16", "--key-window-times", "2",
                "--num-pivot", "24"]),
])
def test_pretrain_cli_sequence_parallel_routes_match_one_process(tmp_path, monkeypatch,
                                                                 route, argv):
    """``cli.pretrain`` takes --sequence-parallel-size 2 with
    --max-memory-length and with --is-sparse 1, as the JAX CLI does: 2
    iterations on 2 ranks save the full leaves of the one-process run."""
    from cogview_tpu_torch.cli import pretrain

    monkeypatch.setattr(pretrain, "PRESETS", dict(pretrain.PRESETS))
    workers.register_presets(pretrain.PRESETS)
    data = _corpus(tmp_path / "c.bin")
    sharded, single = tmp_path / "sp", tmp_path / "one"
    torch.save({"argv": _cli_argv(data, "--train-iters", "2", "--save", str(sharded),
                                  "--sequence-parallel-size", "2", *argv)}, tmp_path / "in.pt")
    run_ranks(workers.pretrain_cli, 2, str(tmp_path), str(tmp_path), timeout=TIMEOUT)

    class VocabOnly:
        num_tokens = 50000

    assert pretrain.main(_cli_argv(data, "--train-iters", "2", "--save", str(single), *argv),
                         txt_tokenizer=VocabOnly()) == 0
    _, a = _leaves(sharded)
    _, b = _leaves(single)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5 if "params" in k else 1e-4,
                                   rtol=1e-4, err_msg=k)
