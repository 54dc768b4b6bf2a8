"""GPipe pipeline parallelism of the port (cogview_tpu_torch/parallel/
pipeline.py) on gloo CPU processes, mirroring tests/test_pipeline.py.

One spawn of 4 ranks (4 stages of a 4-layer tiny model, one layer each)
runs the forward and the gradients with dropout off against JAX's
unpipelined ``gpt.forward``, the sparse forward and gradients, bf16
gradients (finite), and the forward with every dropout at 0.1 against
JAX's own pipelined ``gpt.forward`` (``pp_axis="pipe"`` on four host
devices): the per-microbatch seed derivation.  A second spawn trains 3
steps on pipe 2 x model 2 against JAX's unsharded train step.  Tolerances
as tests/test_pipeline.py (forward 2e-5 of the largest logit, loss 2e-5,
gradients 5e-4) and tests/test_torch_parallel.py (train steps)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops import sparse_attention as jsa
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, gpt_params_to_numpy
from cogview_tpu_torch.parallel.pipeline import microbatch_seed
from cogview_tpu_torch.parallel.spawn import run_ranks

import torch_parallel_workers as workers
from test_torch_parallel import (IMG_VOCAB, OPT, TIMEOUT, _batches, _cli_argv, _compare,
                                 _corpus, _jax_run, _leaves, _seeds)

torch.set_num_threads(1)

CFG = dict(num_layers=4, vocab_size=128, max_position_embeddings=64)
SPARSE = dict(query_window=16, key_window_times=2)
DROP = dict(embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1)
KEY = 7


def _jcfg(**kw):
    return jax_tiny(**dict(CFG, **kw))


@pytest.fixture(scope="module")
def jparams():
    return jgpt.init_params(jax.random.PRNGKey(0), _jcfg())


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(0).randint(0, 128, (8, 64)).astype(np.int32)


@pytest.fixture(scope="module")
def pivots(tokens):
    return jsa.sample_pivots(jax.random.key(2, impl="rbg"), jnp.asarray(tokens), 32, 100)


def _sparse_spec(pivot_idx):
    cfg = _jcfg(**SPARSE)
    rmask = jnp.asarray(jsa.build_rmask(64, cfg.query_window, cfg.key_window_times))
    return jgpt.SparseSpec(pivot_idx, jsa.gather_pivot_mask(rmask, pivot_idx),
                           cfg.query_window, cfg.key_window_times)


def _loss(lg, tokens):
    oh = jax.nn.one_hot(jnp.roll(tokens, -1, 1), 128)
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(lg) * oh, -1))


def _jax_grads(jparams, tokens, **fw):
    cfg = _jcfg(**fw.pop("cfg", {}))
    toks = jnp.asarray(tokens)
    return jax.value_and_grad(lambda p: _loss(jgpt.forward(
        p, cfg, toks, train=True, rng=jax.random.PRNGKey(KEY), remat=True, **fw), toks))(
            jparams)


CASES = {
    # name: config, microbatches, forward kwargs
    "forward": dict(cfg={}, M=4, sep=5),
    "grads": dict(cfg={}, M=2, sep=5, train=True, remat=True, grads=True),
    "sparse-forward": dict(cfg=SPARSE, M=4, sparse=True),
    "sparse-grads": dict(cfg=SPARSE, M=2, sparse=True, train=True, remat=True, grads=True),
    "bf16-grads": dict(cfg=dict(compute_dtype=torch.bfloat16), M=2, sep=5, train=True,
                       remat=True, grads=True, loss="square"),
    "dropout-forward": dict(cfg=DROP, M=2, sep=5, train=True),
    # data 2 x pipe 2: each data rank takes its shard of each microbatch
    "dp2-dropout-forward": dict(cfg=DROP, M=2, dp=2, sep=5, train=True),
    "dp2-dropout-grads": dict(cfg=DROP, M=2, dp=2, sep=5, train=True, remat=True,
                              grads=True),
}


@pytest.fixture(scope="module")
def pipe_out(jparams, tokens, pivots, tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    seeds = _seeds(jax.random.PRNGKey(KEY), CFG["num_layers"])
    cases = []
    for c in CASES.values():
        case = {"cfg": dict(CFG, **c["cfg"], pp_microbatches=c["M"]), "sep": c.get("sep", 0),
                "train": c.get("train", False), "remat": c.get("remat", False),
                "grads": c.get("grads", False), "loss": c.get("loss"),
                "seeds": seeds if c.get("train") else None, "dp": c.get("dp", 1)}
        if c.get("sparse"):
            case["pivots"] = torch.from_numpy(np.array(pivots)).long()
        cases.append(case)
    torch.save({"params": gpt_params_from_jax(jax.tree.map(np.asarray, jparams)),
                "tokens": torch.from_numpy(tokens).long(), "cases": cases}, d / "in.pt")
    run_ranks(workers.pipe_cases, 4, str(d), str(d), timeout=TIMEOUT)
    return dict(zip(CASES, torch.load(d / "out.pt", weights_only=False)))


def _close_logits(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-5


def _close_grads(out, l_ref, g_ref):
    assert abs(out["loss"] - float(l_ref)) < 2e-5
    got = gpt_params_to_numpy(out["grads"])
    errs = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()), g_ref, got)
    assert max(jax.tree.leaves(errs)) < 5e-4


def test_pp_forward_matches(pipe_out, jparams, tokens):
    want = np.asarray(jgpt.forward(jparams, _jcfg(), jnp.asarray(tokens), sep=5))
    _close_logits(pipe_out["forward"]["logits"].numpy(), want)


def test_pp_grads_match(pipe_out, jparams, tokens):
    """The backward through the ticks (remat on) equals the unpipelined
    gradients, and microbatch 0's warm-up activations keep them finite."""
    l_ref, g_ref = _jax_grads(jparams, tokens, sep=5)
    _close_grads(pipe_out["grads"], l_ref, g_ref)


def test_pp_sparse_forward_matches(pipe_out, jparams, tokens, pivots):
    want = np.asarray(jgpt.forward(jparams, _jcfg(**SPARSE), jnp.asarray(tokens),
                                   sparse=_sparse_spec(pivots)))
    _close_logits(pipe_out["sparse-forward"]["logits"].numpy(), want)


def test_pp_sparse_grads_match(pipe_out, jparams, tokens, pivots):
    l_ref, g_ref = _jax_grads(jparams, tokens, cfg=SPARSE, sparse=_sparse_spec(pivots))
    _close_grads(pipe_out["sparse-grads"], l_ref, g_ref)


def test_pp_bf16_compute_grads_finite(pipe_out):
    out = pipe_out["bf16-grads"]
    assert np.isfinite(out["loss"])
    leaves = jax.tree.leaves(gpt_params_to_numpy(out["grads"]))
    assert all(np.isfinite(a).all() for a in leaves)
    assert any(np.abs(a).max() > 0 for a in leaves)


def test_pp_dropout_matches_the_jax_pipeline(pipe_out, jparams, tokens):
    """Every dropout at 0.1: the port's pipelined forward equals JAX's
    pipelined one (the same per-microbatch layer seeds), and differs from
    the unpipelined one (the seeds do change)."""
    cfg = _jcfg(**DROP)
    cfg_pp = cfg.replace(pp_axis="pipe", pp_num_stages=4, pp_microbatches=2)
    toks = jnp.asarray(tokens)
    fw = dict(sep=5, train=True, rng=jax.random.PRNGKey(KEY))
    with jax.set_mesh(Mesh(np.array(jax.devices()[:4]), ("pipe",))):
        want = np.asarray(jax.jit(lambda p, t: jgpt.forward(p, cfg_pp, t, **fw))(
            jparams, toks))
    unpiped = np.asarray(jgpt.forward(jparams, cfg, toks, **fw))
    got = pipe_out["dropout-forward"]["logits"].numpy()
    _close_logits(got, want)
    assert np.abs(got - unpiped).max() / np.abs(unpiped).max() > 1e-3


def _jax_dp_pp(fn, *args):
    """``fn(*args)`` jitted on a data 2 x pipe 2 mesh of host devices, the
    [B, ...] arguments placed over 'data' as the JAX CLI places a batch."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "pipe"))
    with jax.set_mesh(mesh):
        placed = [jax.device_put(a, NamedSharding(mesh, P("data"))) if isinstance(a, jax.Array)
                  and a.ndim == 2 else a for a in args]
        return jax.jit(fn)(*placed)


def _cfg_dp_pp(**kw):
    return _jcfg(**DROP, **kw).replace(pp_axis="pipe", pp_num_stages=2, pp_microbatches=2)


def test_dp_pp_dropout_forward_matches_the_jax_pipeline(pipe_out, jparams, tokens):
    """data 2 x pipe 2, every dropout at 0.1: data rank d runs its shard of
    each microbatch (the JAX rows), so its masks hash the JAX coordinates."""
    cfg = _cfg_dp_pp()
    fw = dict(sep=5, train=True, rng=jax.random.PRNGKey(KEY))
    want = np.asarray(_jax_dp_pp(lambda p, t: jgpt.forward(p, cfg, t, **fw), jparams,
                                 jnp.asarray(tokens)))
    _close_logits(pipe_out["dp2-dropout-forward"]["logits"].numpy(), want)


def test_dp_pp_dropout_grads_match_the_jax_pipeline(pipe_out, jparams, tokens):
    cfg = _cfg_dp_pp()

    def loss(p, t):
        return _loss(jgpt.forward(p, cfg, t, sep=5, train=True, rng=jax.random.PRNGKey(KEY),
                                  remat=True), t)

    l_ref, g_ref = _jax_dp_pp(jax.value_and_grad(loss), jparams, jnp.asarray(tokens))
    _close_grads(pipe_out["dp2-dropout-grads"], l_ref, jax.tree.map(np.asarray, g_ref))


def test_data_rows_are_the_jax_microbatch_shards():
    """``data_rows`` is the row order of the JAX pipeline's sharding: the
    global batch cut into M microbatches, each split over 'data'."""
    from cogview_tpu_torch.parallel.mesh import Mesh as TMesh
    from cogview_tpu_torch.parallel.pipeline import data_rows

    B, M, dp = 24, 3, 4
    mesh = Mesh(np.array(jax.devices()[:dp]), ("data",))
    ids = jax.device_put(jnp.arange(B).reshape(M, B // M), NamedSharding(mesh, P(None, "data")))
    for d, shard in enumerate(sorted(ids.addressable_shards, key=lambda x: x.device.id)):
        tmesh = TMesh(data=dp, model=1, rank=2 * d, fsdp=False, device=torch.device("cpu"),
                      groups={}, pipe=2)
        assert data_rows(B, M, tmesh).tolist() == np.asarray(shard.data).reshape(-1).tolist()
        flat = TMesh(data=dp, model=1, rank=d, fsdp=False, device=torch.device("cpu"),
                     groups={})
        assert data_rows(B, M, flat).tolist() == list(range(d * B // dp, (d + 1) * B // dp))


def test_data_rows_split_uneven_microbatches_in_rank_order():
    """Microbatches of 5 rows over 3 data ranks: shards of 1, 2 and 2 rows,
    one after another, each rank's rows chunking into its M shards.
    Microbatches of 2 rows over 3 ranks leave rank 0 empty shards, as
    GSPMD pads them; a batch that does not split into M microbatches is
    refused."""
    from cogview_tpu_torch.parallel.mesh import Mesh as TMesh
    from cogview_tpu_torch.parallel.pipeline import data_rows

    B, M, dp = 15, 3, 3
    shards = [data_rows(B, M, TMesh(data=dp, model=1, rank=2 * d, fsdp=False,
                                    device=torch.device("cpu"), groups={}, pipe=2))
              for d in range(dp)]
    assert [len(r) // M for r in shards] == [1, 2, 2]
    for m in range(M):
        got = torch.cat([r.reshape(M, -1)[m] for r in shards]).tolist()
        assert got == list(range(m * 5, (m + 1) * 5))
    shards = [data_rows(4, 2, TMesh(data=dp, model=1, rank=2 * d, fsdp=False,
                                    device=torch.device("cpu"), groups={}, pipe=2)).tolist()
              for d in range(dp)]
    assert shards == [[], [0, 2], [1, 3]]
    with pytest.raises(ValueError, match="do not split"):
        data_rows(5, 2, TMesh(data=dp, model=1, rank=0, fsdp=False,
                              device=torch.device("cpu"), groups={}, pipe=2))


@pytest.mark.parametrize("seed", [0, 1, 0x89ABCDEF, 0xFFFFFFFF])
@pytest.mark.parametrize("m", [0, 1, 2, 7])
def test_microbatch_seed_is_the_jax_key_derivation(seed, m):
    """seed_from_key of the layer key's words each xored with m."""
    from cogview_tpu.ops.hash_prng import seed_from_key

    words = np.array([seed & 0xFFFF, seed >> 3, 17, seed], np.uint32)
    base = int(seed_from_key(jnp.asarray(words)))
    want = int(seed_from_key(jnp.asarray(words ^ np.uint32(m))))
    assert microbatch_seed(base, m) == want


@functools.lru_cache(maxsize=None)
def _jax_steps():
    cfg_kw = dict(num_layers=4)
    batches = _batches(3, 4, 64)
    return (cfg_kw, batches) + _jax_run(cfg_kw, {}, batches)


def test_pp_train_steps_match_unsharded_jax(tmp_path):
    """pipe 2 x model 2, 2 microbatches, dropout off: 3 train steps against
    the JAX unsharded step (the stages' layer gradients, the replicated
    leaves' whole gradients, the global norm over both)."""
    cfg_kw, batches, params0, seeds, _, want = _jax_steps()
    torch.save({"mesh": (1, 2, False), "pp": 2, "cfg": dict(cfg_kw, pp_microbatches=2),
                "step": dict(img_vocab=IMG_VOCAB), "opt": OPT, "params": params0,
                "batches": batches, "seeds": seeds}, tmp_path / "in.pt")
    run_ranks(workers.train_steps, 4, str(tmp_path), str(tmp_path), timeout=TIMEOUT)
    _compare(torch.load(tmp_path / "out.pt", weights_only=False), want)


@functools.lru_cache(maxsize=None)
def _jax_dp_pp_steps(B):
    """Two JAX train steps on data 2 x pipe 2 (2 microbatches) at a global
    batch of ``B``, every dropout at 0.1 -> (cfg, batches, params0, seeds,
    results)."""
    from cogview_tpu.parallel.sharding import gpt_param_specs, shard_params
    from cogview_tpu.training import optim as jopt
    from cogview_tpu.training import train_loop as jtl
    from cogview_tpu.utils.rng import rbg_key

    cfg_kw = dict(DROP, num_layers=4)
    jcfg = jax_tiny(**cfg_kw)
    cfg_pp = jcfg.replace(pp_axis="pipe", pp_num_stages=2, pp_microbatches=2)
    batches = _batches(2, B, 64)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    params0 = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    tx, _ = jopt.make_optimizer(jparams, **OPT)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1), ("data", "pipe", "model"))
    key, seeds, res = jax.random.PRNGKey(1), [], []
    with jax.set_mesh(mesh):
        state = jtl.init_train_state(
            shard_params(jparams, mesh, gpt_param_specs(pp_axis="pipe")), tx)
        step = jtl.make_train_step(cfg_pp, tx, img_vocab=IMG_VOCAB, donate=False)
        for batch in batches:
            key, sub = jax.random.split(key)
            state, m = step(state, {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                                    for k, v in batch.items()}, sub)
            seeds.append(_seeds(rbg_key(sub), 4))
            res.append({"lm_loss": float(m["lm_loss"]), "grad_norm": float(m["grad_norm"]),
                        "params": jax.tree.map(np.asarray, state["params"]), "mems": None})
    return cfg_kw, batches, params0, seeds, res


@pytest.mark.parametrize("B", [8, 6])
def test_dp_pp_dropout_train_steps_match_the_jax_pipeline_and_data_1(tmp_path, B):
    """Two train steps on data 2 x pipe 2 with every dropout at 0.1 match
    the JAX pipelined steps on data 2 x pipe 2, and the port's own data 1 x
    pipe 2 steps on the same global batches: the masks do not depend on
    the data sharding.  At a batch of 6 each microbatch of 3 rows splits
    unevenly over 'data' (GSPMD pads it; the port's ranks hold 2 and 1
    rows)."""
    cfg_kw, batches, params0, seeds, want = _jax_dp_pp_steps(B)
    out = {}
    for dp in (2, 1):
        d = tmp_path / f"dp{dp}"
        d.mkdir()
        torch.save({"mesh": (dp, 1, False), "pp": 2, "cfg": dict(cfg_kw, pp_microbatches=2),
                    "step": dict(img_vocab=IMG_VOCAB), "opt": OPT, "params": params0,
                    "batches": batches, "seeds": seeds}, d / "in.pt")
        run_ranks(workers.train_steps, 2 * dp, str(d), str(d), timeout=TIMEOUT)
        out[dp] = torch.load(d / "out.pt", weights_only=False)
    _compare(out[2], want)
    same = [{"lm_loss": o["metrics"]["lm_loss"], "grad_norm": o["metrics"]["grad_norm"],
             "params": gpt_params_to_numpy(o["params"]), "mems": None} for o in out[1]]
    _compare(out[2], same)


def test_pretrain_cli_refuses_microbatches_smaller_than_the_data_axis(tmp_path, monkeypatch):
    """The layout this test once found refused now trains: data 2 x pipe 2
    with one row a microbatch (a batch of 2 in 2 microbatches), where the
    first data rank holds an empty shard of each microbatch and GSPMD pads
    it.  Two train steps with every dropout at 0.1 match the JAX pipelined
    steps on a data 2 x pipe 2 host mesh (losses 1e-5, params as the data
    x pipe tests hold them); ``cli.pretrain`` on 4 ranks at that layout
    saves the leaves of the one-process run of the same 2 iterations."""
    from cogview_tpu_torch.cli import pretrain

    cfg_kw, batches, params0, seeds, want = _jax_dp_pp_steps(2)
    torch.save({"mesh": (2, 1, False), "pp": 2, "cfg": dict(cfg_kw, pp_microbatches=2),
                "step": dict(img_vocab=IMG_VOCAB), "opt": OPT, "params": params0,
                "batches": batches, "seeds": seeds}, tmp_path / "in.pt")
    run_ranks(workers.train_steps, 4, str(tmp_path), str(tmp_path), timeout=TIMEOUT)
    out = torch.load(tmp_path / "out.pt", weights_only=False)
    for o, w in zip(out, want):
        np.testing.assert_allclose(o["metrics"]["lm_loss"], w["lm_loss"], rtol=1e-5)
    _compare(out, want)

    monkeypatch.setattr(pretrain, "PRESETS", dict(pretrain.PRESETS))
    workers.register_presets(pretrain.PRESETS)
    data = _corpus(tmp_path / "c.bin")
    argv = _cli_argv(data, "--num-layers", "2", "--batch-size", "2", "--train-iters", "2")
    pp = ["--pipeline-parallel-size", "2", "--pipeline-microbatches", "2"]
    _cli(tmp_path, 4, argv + ["--save", str(tmp_path / "pp"), *pp])
    _cli(tmp_path, 1, argv + ["--save", str(tmp_path / "one")])
    _same_leaves(tmp_path / "pp", tmp_path / "one")


def test_jax_pipeline_runs_uneven_microbatch_shards(jparams):
    """The JAX pipeline accepts a batch of 6 in 2 microbatches on data 2 (3
    rows a microbatch), and its dropout forward there equals its data 1
    run; so the port takes such batches too (the train step test at B =
    6)."""
    cfg = _cfg_dp_pp()
    toks = jnp.asarray(np.random.RandomState(1).randint(0, 128, (6, 64)), jnp.int32)
    fw = dict(sep=5, train=True, rng=jax.random.PRNGKey(KEY))
    got = np.asarray(_jax_dp_pp(lambda p, t: jgpt.forward(p, cfg, t, **fw), jparams, toks))
    with jax.set_mesh(Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "pipe"))):
        want = np.asarray(jax.jit(lambda p, t: jgpt.forward(p, cfg, t, **fw))(jparams, toks))
    np.testing.assert_array_equal(got, want)


class VocabOnly:
    num_tokens = 50000


def _cli(tmp_path, world, argv):
    """``cli.pretrain.main(argv)`` on ``world`` ranks (one: in this process)."""
    from cogview_tpu_torch.cli import pretrain

    if world == 1:
        assert pretrain.main(argv, txt_tokenizer=VocabOnly()) == 0
        return
    torch.save({"argv": argv}, tmp_path / "in.pt")
    run_ranks(workers.pretrain_cli, world, str(tmp_path), str(tmp_path), timeout=TIMEOUT)


def _same_leaves(a_dir, b_dir):
    _, a = _leaves(a_dir)
    _, b = _leaves(b_dir)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], atol=1e-5 if "params" in k else 1e-4,
                                   rtol=1e-4, err_msg=k)


def test_pretrain_cli_pipeline_checkpoints_load_across_layouts(tmp_path, capsys,
                                                               monkeypatch):
    """``cli.pretrain`` as 2 ranks with --pipeline-parallel-size 2
    --pipeline-microbatches 2 (a float32 smoke preset, 2 layers) saves full
    leaves equal to the one-process run's; the pp = 2 checkpoint resumes on
    one process, the one-process checkpoint at pp = 2, and the two resumes
    agree."""
    from cogview_tpu_torch.cli import pretrain

    monkeypatch.setattr(pretrain, "PRESETS", dict(pretrain.PRESETS))
    workers.register_presets(pretrain.PRESETS)
    data = _corpus(tmp_path / "c.bin")
    pp = ["--pipeline-parallel-size", "2", "--pipeline-microbatches", "2"]

    def argv(*extra):
        return _cli_argv(data, *extra, "--num-layers", "2")

    _cli(tmp_path, 2, argv("--train-iters", "2", "--save", str(tmp_path / "pp"), *pp))
    _cli(tmp_path, 1, argv("--train-iters", "2", "--save", str(tmp_path / "one")))
    _same_leaves(tmp_path / "pp", tmp_path / "one")
    _cli(tmp_path, 2, argv("--train-iters", "3", "--load", str(tmp_path / "one"),
                           "--save", str(tmp_path / "pp_r"), *pp))
    _cli(tmp_path, 1, argv("--train-iters", "3", "--load", str(tmp_path / "pp"),
                           "--save", str(tmp_path / "one_r")))
    assert f"loaded checkpoint from {tmp_path / 'pp'} at iteration 2" in capsys.readouterr().out
    _same_leaves(tmp_path / "pp_r", tmp_path / "one_r")


@pytest.mark.parametrize("fsdp", [False, True])
def test_pipe_param_specs_are_the_jax_package_specs(fsdp):
    """``gpt_param_specs(pipe=True)`` is the JAX package's
    ``gpt_param_specs(pp_axis='pipe')``, dim for dim; a stage's shard of a
    layer leaf is its block of layers."""
    from cogview_tpu.parallel import sharding as jsh
    from cogview_tpu_torch.config import tiny_test
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.parallel import sharding
    from cogview_tpu_torch.parallel.mesh import Mesh

    want = jsh.gpt_param_specs(fsdp_axis="data" if fsdp else None, pp_axis="pipe")
    got = sharding.gpt_param_specs(fsdp=fsdp, pipe=True)
    params = gpt.init_params(tiny_test(num_layers=4), torch.Generator().manual_seed(0))
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in flat_w:
        keys = [p.key for p in path]
        leaf, mine = params, got
        for k in keys:
            leaf, mine = leaf[k], mine[k]
        assert tuple(spec) + (None,) * (leaf.dim() - len(spec)) == mine, keys
    mesh = Mesh(data=1, model=1, rank=1, fsdp=False, device=torch.device("cpu"), groups={},
                pipe=2)
    local = sharding.shard_params(params, mesh)
    assert torch.equal(local["layers"]["qkv"]["w"], params["layers"]["qkv"]["w"][2:])
    assert torch.equal(local["embed"]["word"], params["embed"]["word"])
