"""Stage-1 VQ-VAE trainer (twin of cogview_tpu/cli/vqtrain.py) on a
'data' mesh of CUDA devices: one card, or one torchrun rank a card.

  python -m cogview_tpu_torch.cli.vqtrain --data images/ --train-iters 20000 \\
      --batch-size 32 --save checkpoints/vqvae
  torchrun --nproc-per-node 4 -m cogview_tpu_torch.cli.vqtrain --data images/ ...

Every flag of the JAX CLI, the same cycling batcher and the same gumbel
temperature schedule.  Two codebook modes: straight-through + EMA codebook
(default) and the gumbel relaxation (--gumbel [--gumbel-hard]) with an
exponentially annealed temperature.  As the JAX CLI shards the batch over
every device, under torchrun (``WORLD_SIZE`` > 1) the process joins the
group and trains on a 'data' axis of every rank: ``--batch-size`` is the
global batch, which the axis must divide; every rank cycles the same
source and data rank d trains rows [d B/n, (d + 1) B/n) of each batch,
decoding only those images (which images failed to decode is shared over
the axis, so every rank cuts the same batches).  The step averages the
gradients and sums the EMA codebook statistics over the axis
(training/vqvae_train.py), so every rank holds the same model; rank 0
alone logs, writes summaries and saves, and its checkpoint is the
one-card format.  The ranks must share one host: the JAX CLI has no
``--multihost``.  The initial weights are drawn from ``--seed`` by a CPU
``torch.Generator`` (not the JAX package's ``PRNGKey`` stream), the gumbel
noise by a generator on the device seeded with ``--seed + 1 + d`` on data
rank d, which draws the noise of its own rows only (the JAX CLI splits one
key for the whole batch; neither draw is the other's).

Runs on a CUDA device by default and fails if there is none; ``--device
cpu`` runs on the CPU.  Each log line gives the milliseconds per iteration
over the log interval (CUDA events on the card, the host clock on the
CPU), images per second and, on the card, the peak device memory.
Checkpoints go through training/checkpointing.py.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("cogview-tpu-torch vqtrain")
    p.add_argument("--data", required=True,
                   help="image source: folder, .zip, .tar(.gz), .rar, or "
                        ".h5 (preprocess/raw_datasets.py)")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--train-iters", type=int, default=20000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--latent-weight", type=float, default=0.25,
                   help="commitment loss weight (ST mode)")
    p.add_argument("--ema-decay", type=float, default=0.99)
    p.add_argument("--gumbel", action="store_true",
                   help="gumbel-relaxed codebook instead of ST+EMA")
    p.add_argument("--gumbel-hard", action="store_true",
                   help="hard lookup + EMA inside the gumbel mode")
    p.add_argument("--kl-weight", type=float, default=0.25,
                   help="KL(q||uniform) weight (gumbel mode)")
    p.add_argument("--temp", type=float, default=1.0,
                   help="initial gumbel temperature")
    p.add_argument("--temp-min", type=float, default=0.0625)
    p.add_argument("--temp-decay", type=float, default=1e-4,
                   help="temp = max(temp_min, temp * exp(-decay * step))")
    # model size overrides (defaults = the released tokenizer's geometry)
    p.add_argument("--channel", type=int, default=512)
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--n-embed", type=int, default=8192)
    p.add_argument("--save", default=None, help="checkpoint directory")
    p.add_argument("--save-interval", type=int, default=1000)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--summary-dir", default=None)
    p.add_argument("--experiment-name", default="vqtrain")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def _cycle(source, source_path: str):
    """(pass, name, load) of the source's entries, pass after pass."""
    p = 0
    while True:
        n = 0
        for name, load in source.candidates():
            yield p, name, load
            n += 1
        if n == 0:
            raise SystemExit(f"--data {source_path}: no decodable images")
        p += 1


def _batches(source_path: str, img_size: int, batch: int, rows=None, device=None):
    """Cycle the image source forever, yielding the ``rows`` (all by
    default) of each batch of ``batch`` images, [len(rows), S, S, 3]
    float32.  A rank decodes only the images that land in its rows; which
    of them failed to decode is summed over 'data' (one all-reduce a batch,
    one more after each failure), so every rank cuts the same batches, and
    an image that a failure moves into another rank's rows is decoded
    there."""
    import torch

    from ..parallel import comm
    from ..parallel.mesh import DATA_AXIS
    from ..preprocess.raw_datasets import open_image_source

    mine = {int(r): i for i, r in enumerate(range(batch) if rows is None else rows)}
    stream = _cycle(open_image_source(source_path, img_size=img_size), source_path)
    out, filled, last_ok = [None] * len(mine), 0, -1
    while True:
        cands = [next(stream) for _ in range(batch - filled)]
        got = [load() if filled + i in mine else None for i, (_, _, load) in enumerate(cands)]
        ok = comm.all_reduce(torch.tensor([a is not None for a in got], dtype=torch.int32,
                                          device=device), DATA_AXIS).tolist()
        for (p, _, load), a, good in zip(cands, got, ok):
            if good:
                last_ok = p
                if filled in mine:
                    out[mine[filled]] = a if a is not None else load()
                filled += 1
        if filled == batch:
            yield np.stack(out)
            filled = 0
        elif cands[-1][0] >= last_ok + 2:  # a whole pass without a decodable image
            raise SystemExit(f"--data {source_path}: no decodable images")


class _Clock:
    """Milliseconds over a window of iterations: CUDA events on the card
    (the stream's time from the window's first launch to its last), the
    host clock elsewhere."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.torch = torch
        self.start()

    def start(self):
        if self.cuda:
            self.t0 = self.torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            t1 = self.torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1)
        return (time.perf_counter() - self.t0) * 1000.0


def main(argv=None) -> int:
    """Trains, and returns 0; the last log line's numbers are kept in
    ``main.last`` for callers that drive the CLI in-process."""
    args = build_parser().parse_args(argv)
    import torch

    from ..ops.precision import set_fp32_precision
    from ..parallel import comm
    from ..parallel.mesh import create_mesh, use_mesh

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    set_fp32_precision()
    world, _, _, local_world = comm.torchrun_env()
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} must be divisible "
                         f"by the {world}-device data axis")
    mesh, joined = None, False
    if world > 1:
        if local_world != world:
            raise SystemExit(f"{world} ranks, {local_world} on this host: vqtrain's data "
                             "axis runs on one host (the JAX CLI has no --multihost)")
        device, joined = comm.join_torchrun(device)
        mesh = create_mesh(model_parallel=1, data_parallel=world, device=device)
    try:
        with use_mesh(mesh):
            return _train(args, device, mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, device, mesh) -> int:
    import torch

    from ..config import VQVAEConfig
    from ..models import vqvae
    from ..parallel.pipeline import data_rows
    from ..training.checkpointing import save_checkpoint
    from ..training.vqvae_train import (
        init_vqvae_train_state,
        make_adam,
        make_vqvae_gumbel_train_step,
        make_vqvae_train_step,
    )
    from ..utils.memory import device_memory_stats
    from ..utils.metrics import MetricsWriter

    rank, d = (0, 0) if mesh is None else (mesh.rank, mesh.data_rank)
    rows = data_rows(args.batch_size, mesh=mesh).numpy()  # this rank's share
    cfg = VQVAEConfig(channel=args.channel, embed_dim=args.embed_dim, n_embed=args.n_embed)
    params = vqvae.init_params(cfg, torch.Generator().manual_seed(args.seed))
    params = vqvae.with_ema_buffers(vqvae.tree_to(params, device))
    tx = make_adam(params, args.lr)
    state = init_vqvae_train_state(params, tx)
    if args.gumbel:
        step = make_vqvae_gumbel_train_step(tx, kl_weight=args.kl_weight,
                                            hard=args.gumbel_hard, decay=args.ema_decay)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1 + d)
    else:
        step = make_vqvae_train_step(tx, latent_weight=args.latent_weight,
                                     decay=args.ema_decay)

    writer = MetricsWriter(args.summary_dir if rank == 0 else None, args.experiment_name)
    batches = _batches(args.data, args.img_size, args.batch_size, rows,
                       None if mesh is None else device)
    clock = _Clock(device)
    window = 0
    main.last = {}
    for it in range(1, args.train_iters + 1):
        batch = torch.from_numpy(next(batches)).to(device, non_blocking=True)
        if args.gumbel:
            temp = max(args.temp_min, args.temp * float(np.exp(-args.temp_decay * it)))
            m = step(state, batch, gen, temp)
        else:
            m = step(state, batch)
        window += 1
        if it % args.log_interval == 0 or it == args.train_iters:
            ms = clock.ms() / window
            m = {k: float(v) for k, v in m.items()}
            parts = " ".join(f"{k} {v:.5f}" for k, v in sorted(m.items()))
            mem = device_memory_stats(device)
            peak = "" if mem is None else f" | peak {mem['peak_bytes_in_use_gb']:.2f} GiB"
            if rank == 0:
                print(f"iter {it}/{args.train_iters} | {parts} | {ms:.1f} ms/iter | "
                      f"{args.batch_size * 1000.0 / ms:.1f} images/s{peak}", flush=True)
            writer.add_scalars(it, m)
            main.last = dict(m, iteration=it, ms_per_iter=ms,
                             peak_gib=None if mem is None else mem["peak_bytes_in_use_gb"])
            window = 0
            clock.start()
        if args.save and rank == 0 and (it % args.save_interval == 0
                                        or it == args.train_iters):
            save_checkpoint(args.save, it, state)
    if mesh is not None:
        torch.distributed.barrier()  # the checkpoint is written before any rank returns
    writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
