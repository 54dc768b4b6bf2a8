"""The port's DP x TP x FSDP training (cogview_tpu_torch/parallel) on 2 and
4 gloo CPU processes against the JAX package's *unsharded* train step, at
tiny_test widths in float32 with every dropout at 0.1.

Each case hands the ranks the JAX step's numpy params, batches, dropout
seeds (and pivots), runs three steps on a (dp, mp, fsdp) mesh and compares
the loss, the grad norm and every updated leaf, gathered, after each step.
Tolerances: the loss and the grad norm to 1e-5 relative, every param to
1e-5 absolute (lr 1e-3: Adam divides each gradient by its own RMS, so a
float32 rounding difference in a near-zero gradient, summed in another
order across ranks, could move its param by up to 2 lr; none does here).
The pretrain CLI case compares two float32 runs of the port, the Adam
moments to 1e-4.  Groups live on a FileStore under tmp_path and every
spawn has its own time limit."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops import sparse_attention as jsa
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.training import optim as jopt
from cogview_tpu.training import train_loop as jtl
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, gpt_params_to_numpy
from cogview_tpu_torch.parallel.spawn import run_ranks
from cogview_tpu_torch.training import checkpointing

import torch_parallel_workers as workers

torch.set_num_threads(1)

IMG_VOCAB = 64
ROI2 = 100
DROP = dict(embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1)
SPARSE = dict(max_position_embeddings=65, query_window=8, key_window_times=2, num_pivot=16)
OPT = dict(lr=1e-3, warmup_iter=1, num_iters=10)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
TIMEOUT = 240


def _seeds(r, num_layers):
    rr, r_embed = jax.random.split(r)
    return [int(seed_from_key(r_embed))] + [int(seed_from_key(x))
                                            for x in jax.random.split(rr, num_layers)]


def _batches(n, B, S, seed=0, roi2=False):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        text = rng.randint(0, 128, (B, S + 1)).astype(np.int32)
        if roi2:
            text[:, 20 + 3 * np.arange(B) + i] = ROI2  # a restart in every row
        out.append({"text": text, "loss_mask": (rng.rand(B, S + 1) > 0.1).astype(np.float32)})
    return out


@functools.lru_cache(maxsize=None)
def _jax_run_cached(case):
    _, cfg_kw, step_kw, B = CASES[case]
    cfg_kw = dict(DROP, **cfg_kw)
    batches = _batches(3, B, 64, roi2=bool(step_kw.get("dual_positions_roi2")))
    return (cfg_kw, batches) + _jax_run(cfg_kw, step_kw, batches)


def _jax_run(cfg_kw, step_kw, batches, key=1):
    """Three unsharded JAX steps -> (params0, seeds, pivots, results)."""
    jcfg = jax_tiny(**cfg_kw)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    params0 = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    tx, _ = jopt.make_optimizer(jparams, **OPT)
    state = jtl.init_train_state(jparams, tx)
    step = jtl.make_train_step(jcfg, tx, img_vocab=IMG_VOCAB, donate=False, **step_kw)
    key = jax.random.PRNGKey(key)
    seeds, pivots, res, mems = [], [], [], None
    for batch in batches:
        key, sub = jax.random.split(key)
        if step_kw.get("max_memory_length"):
            state, m, mems = step(state, batch, sub, mems)
        else:
            state, m = step(state, batch, sub)
        r = rbg_key(sub)
        seeds.append(_seeds(r, cfg_kw.get("num_layers", 2)))
        if step_kw.get("is_sparse"):
            piv = jsa.sample_pivots(r, jnp.asarray(batch["text"][:, :-1]),
                                    jcfg.num_pivot, IMG_VOCAB,
                                    loss_mask=jnp.asarray(batch["loss_mask"][:, 1:]))
            pivots.append(torch.from_numpy(np.array(piv)).long())
        res.append({"lm_loss": float(m["lm_loss"]), "grad_norm": float(m["grad_norm"]),
                    "params": jax.tree.map(np.asarray, state["params"]),
                    "mems": None if mems is None else np.asarray(mems)})
    return params0, seeds, (pivots or None), res


def _compare(out, want):
    assert len(out) == len(want)
    for i, (o, w) in enumerate(zip(out, want)):
        np.testing.assert_allclose(o["metrics"]["lm_loss"], w["lm_loss"], rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(o["metrics"]["grad_norm"], w["grad_norm"],
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        assert o["step"] == i + 1 and o["skipped"] == 0
        got = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_leaves_with_path(gpt_params_to_numpy(o["params"]))}
        jl = jax.tree_util.tree_leaves_with_path(w["params"])
        assert len(jl) == len(got)
        for path, leaf in jl:
            k = jax.tree_util.keystr(path)
            assert got[k].shape == leaf.shape, k
            np.testing.assert_allclose(got[k], leaf, atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"step {i} {k}")
        if w["mems"] is not None:
            np.testing.assert_allclose(o["mems"].numpy(), w["mems"], atol=1e-4)


CASES = {
    # (dp, mp, fsdp), config, step flags, rows of the global batch
    "dp2": ((2, 1, False), {}, {}, 4),
    "tp2": ((1, 2, False), {}, {}, 4),
    "dp2-tp2": ((2, 2, False), {}, {}, 4),
    "dp2-tp2-fsdp-flash": ((2, 2, True), dict(use_flash_attention=True), {}, 4),
    "dp2-tp2-sparse-dual": ((2, 2, False), SPARSE,
                            dict(is_sparse=True, dual_positions_roi2=ROI2), 4),
    "tp2-mems": ((1, 2, False), {}, dict(max_memory_length=80), 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_steps_match_unsharded_jax(name, tmp_path):
    mesh, _, step_kw, _ = CASES[name]
    # the three dense cases share one JAX run
    same = "dp2" if CASES[name][1:] == CASES["dp2"][1:] else name
    cfg_kw, batches, params0, seeds, pivots, want = _jax_run_cached(same)
    torch.save({"mesh": mesh, "cfg": cfg_kw, "step": dict(img_vocab=IMG_VOCAB, **step_kw),
                "opt": OPT, "params": params0, "batches": batches, "seeds": seeds,
                "pivots": pivots}, tmp_path / "in.pt")
    run_ranks(workers.train_steps, mesh[0] * mesh[1], str(tmp_path), str(tmp_path),
              timeout=TIMEOUT)
    _compare(torch.load(tmp_path / "out.pt", weights_only=False), want)


def _corpus(path, rows=16):
    rng = np.random.RandomState(0)
    data = np.full((rows, 64 + 1024), -1, np.int32)
    data[:, :12] = rng.randint(8192, 58192, size=(rows, 12))
    data[:, 64:] = rng.randint(0, 8192, size=(rows, 1024))
    data.tofile(path)
    return str(path)


def _cli_argv(data, *extra):
    return ["--preset", "smoke-f32", "--num-layers", "1", "--device", "cpu",
            "--train-data", data, "--batch-size", "4", "--split", "1,0,0",
            "--log-interval", "1", "--lr", "1e-5", "--warmup", "0.0", "--seed", "5",
            "--max-position-embeddings", "65",
            "--save-interval", "1000", *extra]


def _leaves(save_dir):
    st = checkpointing.load_latest(str(save_dir))
    flat = jax.tree_util.tree_leaves_with_path(
        {k: st[k] for k in ("params",)} | {"mu": st["opt_state"]["mu"],
                                           "nu": st["opt_state"]["nu"]})
    return st, {jax.tree_util.keystr(p): v.numpy() for p, v in flat}


def test_pretrain_cli_checkpoints_load_across_layouts(tmp_path, capsys, monkeypatch):
    """``cli.pretrain`` as 4 ranks at (dp, mp) = (2, 2) with --fsdp saves
    full leaves: they load unsharded, equal (to the train-step tolerance)
    those of the same 2 iterations run on one process, and a resume of the
    unsharded checkpoint on the 2 x 2 mesh matches the unsharded resume."""
    from cogview_tpu_torch.cli import pretrain

    monkeypatch.setattr(pretrain, "PRESETS", dict(pretrain.PRESETS))
    workers.register_presets(pretrain.PRESETS)
    data = _corpus(tmp_path / "c.bin")
    sharded, single = tmp_path / "sharded", tmp_path / "single"
    torch.save({"argv": _cli_argv(data, "--train-iters", "2", "--save", str(sharded),
                                  "--model-parallel-size", "2", "--fsdp")},
               tmp_path / "in.pt")
    run_ranks(workers.pretrain_cli, 4, str(tmp_path), str(tmp_path), timeout=TIMEOUT)

    class VocabOnly:
        num_tokens = 50000

    assert pretrain.main(_cli_argv(data, "--train-iters", "2", "--save", str(single)),
                         txt_tokenizer=VocabOnly()) == 0
    st_a, a = _leaves(sharded)
    st_b, b = _leaves(single)
    assert st_a["iteration"] == st_b["iteration"] == 2
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], atol=PARAM_ATOL if "params" in k else 1e-4,
                                   rtol=1e-4, err_msg=k)

    # an unsharded checkpoint resumed on the mesh and on one process
    capsys.readouterr()
    torch.save({"argv": _cli_argv(data, "--train-iters", "3", "--load", str(single),
                                  "--save", str(tmp_path / "r_sharded"),
                                  "--model-parallel-size", "2", "--fsdp")},
               tmp_path / "in.pt")
    run_ranks(workers.pretrain_cli, 4, str(tmp_path), str(tmp_path), timeout=TIMEOUT)
    assert pretrain.main(_cli_argv(data, "--train-iters", "3", "--load", str(single),
                                   "--save", str(tmp_path / "r_single")),
                         txt_tokenizer=VocabOnly()) == 0
    out = capsys.readouterr().out
    assert f"loaded checkpoint from {single} at iteration 2" in out
    _, a = _leaves(tmp_path / "r_sharded")
    _, b = _leaves(tmp_path / "r_single")
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=PARAM_ATOL if "params" in k else 1e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("argv,msg", [
    (["--sequence-parallel-size", "2", "--pipeline-parallel-size", "2"], "mutually exclusive"),
    (["--pipeline-parallel-size", "2", "--pipeline-microbatches", "3", "--num-layers", "2"],
     "not divisible by 3 pipeline microbatches"),
    (["--pipeline-parallel-size", "2"], "num_layers 1 not divisible by --pipeline-parallel-size 2"),
])
def test_pretrain_cli_refuses_unported_parallelism(tmp_path, argv, msg, monkeypatch):
    """The JAX CLI's refusals of a layout, on a 2-rank world (the checks
    run before the group is joined): sequence with pipeline parallelism,
    a batch that the microbatches do not divide, a depth that the stages
    do not divide."""
    from cogview_tpu_torch.cli import pretrain

    monkeypatch.setattr(pretrain, "PRESETS", dict(pretrain.PRESETS))
    workers.register_presets(pretrain.PRESETS)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=msg):
        pretrain.main(_cli_argv(_corpus(tmp_path / "c.bin", rows=4), *argv))


def test_pretrain_cli_batch_must_split_over_data(tmp_path, monkeypatch):
    """The JAX CLI's message when the data axis does not divide the batch
    (a 4-rank world with mp 1 is a data axis of 4; the check runs before
    the group is joined only where it can, so a stub group stands in)."""
    from cogview_tpu_torch.cli import pretrain

    monkeypatch.setattr(pretrain, "PRESETS", dict(pretrain.PRESETS))
    workers.register_presets(pretrain.PRESETS)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    with pytest.raises(SystemExit, match="must be divisible by the data axis"):
        pretrain.main(_cli_argv(_corpus(tmp_path / "c.bin", rows=4), "--batch-size", "6"))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--multihost"):
        pretrain.main(_cli_argv(_corpus(tmp_path / "c.bin", rows=4)))


@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_are_the_jax_package_specs(fsdp):
    """The port's spec tree is the JAX package's ``gpt_param_specs`` (with
    ``fsdp_axis='data'``), dim for dim, padded with None to each leaf's
    rank; shard_params slices every leaf by it."""
    from cogview_tpu.parallel import sharding as jsh
    from cogview_tpu_torch.config import tiny_test
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.parallel import sharding
    from cogview_tpu_torch.parallel.mesh import Mesh

    want = jsh.gpt_param_specs(fsdp_axis="data" if fsdp else None)
    got = sharding.gpt_param_specs(fsdp=fsdp)
    params = gpt.init_params(tiny_test(), torch.Generator().manual_seed(0))
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in flat_w:
        keys = [p.key for p in path]
        leaf, mine = params, got
        for k in keys:
            leaf, mine = leaf[k], mine[k]
        assert tuple(spec) + (None,) * (leaf.dim() - len(spec)) == mine, keys
    for dr, mr in ((0, 0), (1, 1), (1, 0)):
        mesh = Mesh(data=2, model=2, rank=2 * dr + mr, fsdp=fsdp,
                    device=torch.device("cpu"), groups={})
        local = sharding.shard_params(params, mesh)
        qkv = params["layers"]["qkv"]["w"]
        H = qkv.shape[1]
        rows = slice(dr * H // 2, (dr + 1) * H // 2) if fsdp else slice(None)
        want_qkv = qkv[:, rows, :, mr * H // 2:(mr + 1) * H // 2]
        assert torch.equal(local["layers"]["qkv"]["w"], want_qkv)


@pytest.mark.parametrize("kv", ["int8", "int4", "bfloat16"])
def test_cache_spec_slices_the_unsharded_cache(kv):
    """A rank's cache (``init_cache`` of its rows under the mesh) has the
    shape of the unsharded cache sliced by ``cache_spec``: rows over
    'data', whole heads over 'model'."""
    from cogview_tpu_torch.config import tiny_test
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.parallel import sharding
    from cogview_tpu_torch.parallel.mesh import Mesh, use_mesh

    cfg = tiny_test(kv_cache_dtype=kv)
    full = gpt.init_cache(cfg, 4, 24)
    mesh = Mesh(data=2, model=2, rank=3, fsdp=False, device=torch.device("cpu"), groups={})
    with use_mesh(mesh):
        local = gpt.init_cache(cfg, 2, 24)
    for name, spec in sharding.cache_spec(full).items():
        sliced = sharding.shard_leaf(getattr(full, name), spec, mesh)
        assert sliced.shape == getattr(local, name).shape, name
        assert torch.equal(sliced, getattr(local, name)), name
