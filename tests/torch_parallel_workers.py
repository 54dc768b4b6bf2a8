"""Rank functions of tests/test_torch_parallel*.py, spawned by
``cogview_tpu_torch.parallel.spawn.run_ranks``.  Each reads its inputs from
``<dir>/in.pt`` (written by the test from the JAX package's numbers), runs
the port on its part of the mesh and, on rank 0, writes the gathered
results to ``<dir>/out.pt``.  This module imports no jax, so the spawned
ranks stay small."""

import os

import torch

from cogview_tpu_torch import config as C
from cogview_tpu_torch.generation import sampling
from cogview_tpu_torch.models import gpt
from cogview_tpu_torch.parallel import comm
from cogview_tpu_torch.parallel.mesh import DATA_AXIS, create_mesh, use_mesh
from cogview_tpu_torch.parallel.sharding import gather_params, shard_params
from cogview_tpu_torch.training import optim
from cogview_tpu_torch.training import train_loop as tl


def _load(path):
    return torch.load(os.path.join(path, "in.pt"), weights_only=False)


def _save(rank, path, out):
    if rank == 0:
        torch.save(out, os.path.join(path, "out.pt"))


def train_steps(rank, world, path):
    """The train steps of ``in.pt`` on a (dp, mp, fsdp) mesh: the metrics,
    the gathered params after each step and, with mems, the memory."""
    inp = _load(path)
    dp, mp, fsdp = inp["mesh"]
    cfg = C.tiny_test(**inp["cfg"])
    mem_len = inp["step"].get("max_memory_length", 0)
    with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp, fsdp=fsdp)) as mesh:
        params = shard_params(inp["params"], mesh)
        opt, _ = optim.make_optimizer(params, **inp["opt"])
        state = tl.init_train_state(params, opt, torch.Generator().manual_seed(0))
        step = tl.make_train_step(cfg, opt, **inp["step"])
        out, mems = [], None
        for i, batch in enumerate(inp["batches"]):
            rows = batch["text"].shape[0] // dp
            b0 = mesh.data_rank * rows
            local = {k: v[b0:b0 + rows] for k, v in batch.items()}
            kw = dict(seeds=inp["seeds"][i])
            if inp.get("pivots") is not None:
                kw["pivot_idx"] = inp["pivots"][i][b0:b0 + rows]
            if mem_len:
                state, metrics, mems = step(state, local, mems=mems, **kw)
            else:
                state, metrics = step(state, local, **kw)
            rec = {"metrics": metrics, "params": gather_params(state["params"], mesh),
                   "step": state["step"], "skipped": state["skipped"]}
            if mems is not None:
                rec["mems"] = comm.all_gather(mems, DATA_AXIS, 1)
            out.append(rec)
    _save(rank, path, out)


def decode_steps(rank, world, path):
    """Prefill and teacher-forced decode steps on a (dp, mp) mesh: the
    float32 logits of every step, gathered over 'data'."""
    inp = _load(path)
    dp, mp = inp["mesh"]
    cfg = C.tiny_test(**inp["cfg"])
    with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp)) as mesh:
        params = inp["params"]
        if inp.get("int8_weights"):
            params = gpt.quantize_weights(params)
        params = shard_params(params, mesh)
        toks, pos = inp["tokens"], inp["positions"]
        rows = toks.shape[0] // dp
        toks = toks[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
        pos = pos[:rows]
        ctx, S = inp["ctx"], toks.shape[1]
        cache = gpt.init_cache(cfg, rows, S)
        logits = [gpt.forward_with_cache(params, cfg, toks[:, :ctx], pos[:, :ctx], cache, 0)]
        for t in range(ctx, S):
            logits.append(gpt.forward_with_cache(params, cfg, toks[:, t:t + 1],
                                                 pos[:, t:t + 1], cache, t))
        out = [comm.all_gather(lg, DATA_AXIS, 0) for lg in logits]
    _save(rank, path, out)


def fill(rank, world, path):
    """``sampling.filling_sequence`` on a (dp, mp) mesh -> tokens, scores."""
    inp = _load(path)
    dp, mp = inp["mesh"]
    cfg = C.tiny_test(**inp["cfg"])
    with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp)) as mesh:
        params = shard_params(inp["params"], mesh)
        tokens, scores = sampling.filling_sequence(
            params, cfg, inp["template"], batch_size=inp["batch"],
            sampling=inp["sampling"], seed_u32=inp["seed"])
    _save(rank, path, {"tokens": tokens, "scores": scores})


def pretrain_cli(rank, world, path):
    """``cli.pretrain.main`` as one torchrun rank of ``world``: the group is
    the one the spawner joined."""
    from cogview_tpu_torch.cli import pretrain

    inp = _load(path)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    register_presets(pretrain.PRESETS)

    class VocabOnly:
        num_tokens = 50000

    assert pretrain.main(inp["argv"], txt_tokenizer=VocabOnly()) == 0


def register_presets(presets):
    """smoke-f32: the smoke preset in float32, so a sharded run and a
    single-process one differ by float32 rounding only."""
    presets["smoke-f32"] = lambda: C.smoke(compute_dtype=torch.float32)
