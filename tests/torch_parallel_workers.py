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
from cogview_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, create_mesh,
                                             use_mesh)
from cogview_tpu_torch.parallel.pipeline import data_rows
from cogview_tpu_torch.parallel.sharding import gather_params, shard_params
from cogview_tpu_torch.training import optim
from cogview_tpu_torch.training import train_loop as tl


def _load(path):
    return torch.load(os.path.join(path, "in.pt"), weights_only=False)


def _save(rank, path, out):
    if rank == 0:
        torch.save(out, os.path.join(path, "out.pt"))


def _gather_rows(x, mesh, seq_dim=None):
    """A rank's block of a [B, ...] result gathered over 'data' (dim 0)
    and, with ``seq_dim``, over 'seq' along it."""
    if seq_dim is not None:
        x = comm.all_gather(x.contiguous(), SEQ_AXIS, seq_dim)
    return comm.all_gather(x.contiguous(), DATA_AXIS, 0)


def train_steps(rank, world, path):
    """The train steps of ``in.pt`` on a (dp, mp, fsdp) mesh, with ``sp``
    or ``pp`` when given: the metrics, the gathered params after each step
    and, with mems, the memory; with ``forward``, first the inference
    logits of the first batch's inputs."""
    inp = _load(path)
    dp, mp, fsdp = inp["mesh"]
    cfg = C.tiny_test(**inp["cfg"])
    mem_len = inp["step"].get("max_memory_length", 0)
    with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp, fsdp=fsdp,
                              seq_parallel=inp.get("sp", 1),
                              pipe_parallel=inp.get("pp", 1))) as mesh:
        params = shard_params(inp["params"], mesh)
        logits = None
        if inp.get("forward"):
            text = inp["batches"][0]["text"]
            rows = text.shape[0] // dp
            toks = torch.as_tensor(text[mesh.data_rank * rows:(mesh.data_rank + 1) * rows,
                                        :-1]).long()
            if mesh.seq > 1:
                Sc = toks.shape[1] // mesh.seq
                toks = toks[:, mesh.seq_rank * Sc:(mesh.seq_rank + 1) * Sc]
            with torch.no_grad():
                logits = _gather_rows(gpt.forward(params, cfg, toks), mesh, seq_dim=1)
        opt, _ = optim.make_optimizer(params, **inp["opt"])
        state = tl.init_train_state(params, opt, torch.Generator().manual_seed(0))
        step = tl.make_train_step(cfg, opt, **inp["step"])
        out, mems = [], None
        for i, batch in enumerate(inp["batches"]):
            rows = data_rows(batch["text"].shape[0], cfg.pp_microbatches).numpy()
            local = {k: v[rows] for k, v in batch.items()}
            kw = dict(seeds=inp["seeds"][i])
            if inp.get("pivots") is not None:
                kw["pivot_idx"] = inp["pivots"][i][rows]
            if mem_len:
                state, metrics, mems = step(state, local, mems=mems, **kw)
            else:
                state, metrics = step(state, local, **kw)
            rec = {"metrics": metrics, "params": gather_params(state["params"], mesh),
                   "step": state["step"], "skipped": state["skipped"]}
            if mems is not None:
                rec["mems"] = comm.all_gather(mems, DATA_AXIS, 1)
            out.append(rec)
    if logits is not None:
        out = {"steps": out, "logits": logits}
    _save(rank, path, out)


def ring_cases(rank, world, path):
    """Ring attention over 'seq' for each case of ``in.pt`` (its mesh
    (dp, sp, mp), sep, dropout rate and seed) on this rank's rows, block of
    positions and heads of the whole q/k/v: the output and the gradients
    of sum(o * o), gathered into the whole [B, S, N, D]."""
    from cogview_tpu_torch.ops.ring_attention import ring_attention

    inp = _load(path)
    out = []
    for case in inp["cases"]:
        dp, sp, mp = case["mesh"]
        with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp,
                                  seq_parallel=sp)) as mesh:
            B, S, N, _ = inp["q"].shape
            b, s, n = B // dp, S // sp, N // mp
            blk = (slice(mesh.data_rank * b, (mesh.data_rank + 1) * b),
                   slice(mesh.seq_rank * s, (mesh.seq_rank + 1) * s),
                   slice(mesh.model_rank * n, (mesh.model_rank + 1) * n))
            q, k, v = (inp[x][blk].clone().requires_grad_(True) for x in "qkv")
            o = ring_attention(q, k, v, sep=case["sep"], dropout_rate=case["rate"],
                               dropout_seed=case["seed"], train=case["rate"] > 0.0,
                               num_heads=N)
            grads = torch.autograd.grad((o * o).sum(), (q, k, v))

            def whole(x):
                return _gather_rows(comm.all_gather(x.contiguous(), MODEL_AXIS, 2), mesh,
                                    seq_dim=1)

            out.append({"o": whole(o.detach()), "grads": [whole(g) for g in grads]})
    _save(rank, path, out)


def pipe_cases(rank, world, path):
    """GPipe forwards on a data x pipe x model mesh for each case of
    ``in.pt``: the logits (and, with ``grads``, the loss of the JAX pipeline
    test and the gathered gradients), with the case's microbatches, dropout
    seeds, sparse pivots and compute dtype.  Under 'data' a rank takes the
    rows ``data_rows`` gives it; the logits come back in global row order,
    and the loss and gradients are the global batch's (the mean of the
    ranks' equal shares)."""
    from cogview_tpu_torch.ops.sparse_attention import build_rmask, gather_pivot_mask

    inp = _load(path)
    out = []
    for case in inp["cases"]:
        cfg = C.tiny_test(**case["cfg"])
        mp, dp = case.get("mp", 1), case.get("dp", 1)
        with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp,
                                  pipe_parallel=world // (mp * dp))) as mesh:
            params = shard_params(inp["params"], mesh)
            optim.tree_map(lambda p: p.requires_grad_(True), params)
            rows = data_rows(inp["tokens"].shape[0], cfg.pp_microbatches)
            order = torch.argsort(comm.all_gather(rows, DATA_AXIS, 0))
            toks = inp["tokens"][rows]
            sparse = None
            if case.get("pivots") is not None:
                piv = case["pivots"][rows]
                rmask = torch.from_numpy(build_rmask(toks.shape[1], cfg.query_window,
                                                     cfg.key_window_times))
                sparse = gpt.SparseSpec(piv, gather_pivot_mask(rmask, piv),
                                        cfg.query_window, cfg.key_window_times)
            lg = gpt.forward(params, cfg, toks, sep=case.get("sep", 0),
                             train=case.get("train", False), seeds=case.get("seeds"),
                             remat=case.get("remat", False), sparse=sparse)
            rec = {"logits": comm.all_gather(lg.detach().float(), DATA_AXIS, 0)[order]}
            if case.get("grads"):
                if case.get("loss") == "square":
                    loss = (lg.float() ** 2).mean()
                else:
                    oh = torch.nn.functional.one_hot(torch.roll(toks, -1, 1), lg.shape[-1])
                    loss = -(torch.log_softmax(lg, -1) * oh).sum(-1).mean()
                leaves = list(optim.tree_leaves(params))
                g = torch.autograd.grad(loss, leaves)
                g = [comm.all_reduce(x.float(), DATA_AXIS) / dp for x in g]
                grads = tl._unflatten(params, g)
                rec.update(loss=float(comm.all_reduce(loss.detach(), DATA_AXIS)) / dp,
                           grads=gather_params(grads, mesh))
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


def vq_steps(rank, world, path):
    """The VQ-VAE train steps of ``in.pt`` on a 'data' axis of every rank,
    for each mode (ST + EMA, gumbel soft, gumbel hard): each rank takes its
    rows of the global batch and of the step's global gumbel noise -> the
    global metrics and the params after the last step, as the JAX
    package's numpy layouts."""
    from cogview_tpu_torch.models.bridge import vqvae_params_to_numpy
    from cogview_tpu_torch.training import vqvae_train as vt

    inp = _load(path)
    out = {}
    with use_mesh(create_mesh(model_parallel=1, data_parallel=world)) as mesh:
        rows = data_rows(inp["batches"][0].shape[0], mesh=mesh)
        for mode in inp["modes"]:
            params = optim.tree_map(torch.clone, inp["params"])
            tx = vt.make_adam(params, inp["lr"])
            state = vt.init_vqvae_train_state(params, tx)
            if mode == "st":
                step = vt.make_vqvae_train_step(tx, latent_weight=0.25, decay=0.99)
            else:
                step = vt.make_vqvae_gumbel_train_step(tx, kl_weight=0.25,
                                                       hard=mode == "gumbel-hard")
            metrics = []
            for i, batch in enumerate(inp["batches"]):
                b = torch.from_numpy(batch)[rows]
                if mode == "st":
                    m = step(state, b)
                else:
                    noise = inp["noise"][i]
                    noise = noise.reshape(b.shape[0] * world, -1, noise.shape[-1])[rows]
                    m = step(state, b, temperature=inp["temps"][i],
                             noise=noise.reshape(-1, noise.shape[-1]))
                metrics.append({k: float(v) for k, v in m.items()})
            out[mode] = {"metrics": metrics, "params": vqvae_params_to_numpy(state["params"]),
                         "step": state["step"]}
    _save(rank, path, out)


def vqtrain_cli(rank, world, path):
    """``cli.vqtrain.main`` as one torchrun rank of ``world`` (the group is
    the one the spawner joined); each checkpoint a rank writes leaves a
    ``saved-by-<rank>`` file, and ``decodes-<rank>`` holds the number of
    images the rank decoded."""
    from cogview_tpu_torch.cli import vqtrain
    from cogview_tpu_torch.preprocess import raw_datasets
    from cogview_tpu_torch.training import checkpointing

    inp = _load(path)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    save = checkpointing.save_checkpoint

    def recorded(*a, **kw):
        open(os.path.join(path, f"saved-by-{rank}"), "a").close()
        return save(*a, **kw)

    checkpointing.save_checkpoint = recorded
    decode, decodes = raw_datasets.decode_image, []

    def counted(data):
        decodes.append(1)
        return decode(data)

    raw_datasets.decode_image = counted
    assert vqtrain.main(inp["argv"]) == 0
    with open(os.path.join(path, f"decodes-{rank}"), "w") as f:
        f.write(str(len(decodes)))
