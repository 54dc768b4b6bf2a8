"""Multi-rank dry run of the port (twin of the JAX package's
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` spawns ``n`` ranks (``n`` even, at least 2) on
the card, or on the CPU where the caller asks for it, and runs, on meshes
of them:

1. a DP x TP train step (the reference's production parallelism);
2. DP x TP with pivot + window sparse attention and dual-segment
   position ids, in bfloat16;
3. int8-cache decode with the batch over 'data';
4. int8-cache decode with heads over 'model' and rows over 'data';
5. DP x SP x TP: a train step with ring attention over 'seq', FSDP, in
   bfloat16 with attention dropout 0.1;
6. DP x PP x TP: a GPipe train step, 4 layers in 2 stages, 2 microbatches,
   in bfloat16 with attention dropout 0.1.

Passes 5 and 6 run on the JAX package's 2 x 2 x 2 meshes with 8 ranks, on
seq 2 x model 2 and pipe 2 x model 2 with 4, and without 'model' with 2.

Each pass checks that its numbers are finite; rank 0 writes one line per
pass, which the caller prints and returns.  The ranks join one group with
the backend ``parallel.comm.backend_for`` picks: NCCL where each rank has
a card of its own, gloo where ranks share a card or run on the CPU.

  python -m cogview_tpu_torch.dryrun 8                # on the card
  python -m cogview_tpu_torch.dryrun 4 --device cpu   # gloo CPU processes
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List

import numpy as np
import torch

from . import config as C
from .models import gpt
from .parallel.mesh import create_mesh, use_mesh
from .parallel.sharding import shard_params
from .parallel.spawn import run_ranks
from .training.optim import make_optimizer
from .training.train_loop import init_train_state, make_train_step


def _dp_mp(world: int):
    mp = 2 if world % 2 == 0 else 1
    return world // mp, mp


def _say(rank: int, out: str, msg: str) -> None:
    if rank == 0:
        with open(out, "a") as f:
            f.write(msg + "\n")


def _init(cfg, mesh, seed: int):
    dev = mesh.device
    return shard_params(gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                        device=dev), mesh)


def _train_pass(cfg, mesh, text, seed: int, **step_kw) -> float:
    params = _init(cfg, mesh, seed)
    opt, _ = make_optimizer(params, lr=1e-4, warmup_iter=10, num_iters=100)
    state = init_train_state(params, opt, torch.Generator().manual_seed(seed + 1))
    step = make_train_step(cfg, opt, **step_kw)
    rows = text.shape[0] // mesh.data
    b0 = mesh.data_rank * rows
    batch = {"text": text[b0:b0 + rows], "loss_mask": np.ones_like(text[b0:b0 + rows],
                                                                     np.float32)}
    _, metrics = step(state, batch)
    loss = metrics["lm_loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun loss not finite: {loss}")
    return loss


def _decode_pass(cfg, mesh, seed: int) -> None:
    params = _init(cfg, mesh, seed)
    B, S, dev = mesh.data, 16, mesh.device
    toks = torch.from_numpy(np.random.RandomState(seed).randint(0, 256, (B, S)))
    toks = toks[mesh.data_rank:mesh.data_rank + 1].to(dev)
    pos = torch.arange(S, device=dev).expand(1, S)
    cache = gpt.init_cache(cfg, 1, S, device=dev)
    gpt.forward_with_cache(params, cfg, toks[:, :8], pos[:, :8], cache, 0)
    lg = gpt.forward_with_cache(params, cfg, toks[:, 8:9], pos[:, 8:9], cache, 8)
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("sharded decode logits not finite")


def passes(rank: int, world: int, out: str, device: str) -> None:
    """Passes 1-6 on this rank of a group of ``world`` ranks on ``device``;
    rank 0 appends one line a pass to ``out``."""
    dp, mp = _dp_mp(world)
    dev = torch.device(device)
    with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp, device=dev)) as mesh:
        cfg = C.tiny_test(num_heads=8, vocab_size=256, max_position_embeddings=32)
        text = np.random.RandomState(0).randint(0, 256, size=(dp * 2, 17)).astype(np.int64)
        loss = _train_pass(cfg, mesh, text, 0, img_vocab=64, txt_loss_scale=5.0)
        _say(rank, out, f"dryrun_multichip ok: mesh=({dp}x{mp}) loss={loss:.4f}")

        cfg = C.tiny_test(num_layers=2, hidden_size=512, num_heads=8, vocab_size=1024,
                          max_position_embeddings=64, query_window=16, key_window_times=2,
                          num_pivot=24, compute_dtype=torch.bfloat16)
        roi2 = 900
        text = np.random.RandomState(1).randint(0, 512, size=(dp, 65)).astype(np.int64)
        text[:, 5] = 800  # a text token, so the pivots hold text positions
        text[:, 8] = roi2  # the dual positions restart here
        loss = _train_pass(cfg, mesh, text, 2, img_vocab=512, txt_loss_scale=5.0,
                           is_sparse=True, dual_positions_roi2=roi2)
        _say(rank, out, f"dryrun_multichip ok: mesh=({dp}x{mp}) sparse+dual loss={loss:.4f}")

    with use_mesh(create_mesh(model_parallel=1, data_parallel=world, device=dev)) as mesh:
        cfg = C.tiny_test(num_heads=8, vocab_size=256, max_position_embeddings=32,
                          kv_cache_dtype="int8")
        _decode_pass(cfg, mesh, 4)
        _say(rank, out, f"dryrun_multichip ok: mesh=({world}x1) int8-KV sharded decode")

    with use_mesh(create_mesh(model_parallel=2, data_parallel=world // 2, device=dev)) as mesh:
        cfg = C.tiny_test(num_heads=8, vocab_size=256, max_position_embeddings=32,
                          kv_cache_dtype="int8")
        _decode_pass(cfg, mesh, 5)
        _say(rank, out, f"dryrun_multichip ok: mesh=({world // 2}x2) TP+DP head-sharded "
                   "int8 decode")

    mp = 2 if world % 4 == 0 else 1
    dp = world // (2 * mp)
    with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp, seq_parallel=2,
                              fsdp=True, device=dev)) as mesh:
        cfg = C.tiny_test(num_layers=2, hidden_size=256, num_heads=8, vocab_size=1024,
                          max_position_embeddings=65, compute_dtype=torch.bfloat16,
                          attention_dropout=0.1)
        text = np.random.RandomState(7).randint(0, 1024, (2 * dp, 65)).astype(np.int64)
        loss = _train_pass(cfg, mesh, text, 6, img_vocab=512)
        _say(rank, out, f"dryrun_multichip ok: mesh=({dp}x2x{mp} data x seq x model) "
                        f"ring-attention SP + FSDP train step loss={loss:.4f}")

    with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp, pipe_parallel=2,
                              device=dev)) as mesh:
        cfg = C.tiny_test(num_layers=4, hidden_size=256, num_heads=8, vocab_size=1024,
                          max_position_embeddings=65, compute_dtype=torch.bfloat16,
                          attention_dropout=0.1, pp_microbatches=2)
        text = np.random.RandomState(10).randint(0, 1024, (2 * dp, 65)).astype(np.int64)
        loss = _train_pass(cfg, mesh, text, 9, img_vocab=512)
        _say(rank, out, f"dryrun_multichip ok: mesh=({dp}x2x{mp} data x pipe x model) "
                        f"GPipe train step loss={loss:.4f}")


def dryrun_multichip(n: int = 4, device: str = "cuda", timeout: float = 300.0) -> List[str]:
    """Passes 1-6 on ``n`` ranks on ``device`` ("cuda": every rank on
    ``cuda:<rank % cards>``; "cpu": gloo CPU processes) -> their lines,
    printed; raises if any fails or hangs."""
    if n < 2 or n % 2:
        raise ValueError(f"dryrun_multichip needs an even number of ranks >= 2, got {n}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on CPU processes")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "passes.txt")
        run_ranks(passes, n, d, out, device, device=device, timeout=timeout)
        with open(out) as f:
            lines = f.read().splitlines()
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=4, help="ranks (even, at least 2)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    dryrun_multichip(args.n, args.device)
