"""Stage-1 VQ-VAE trainer (twin of cogview_tpu/cli/vqtrain.py) on one CUDA
device.

  python -m cogview_tpu_torch.cli.vqtrain --data images/ --train-iters 20000 \\
      --batch-size 32 --save checkpoints/vqvae

Every flag of the JAX CLI, the same cycling batcher and the same gumbel
temperature schedule.  Two codebook modes: straight-through + EMA codebook
(default) and the gumbel relaxation (--gumbel [--gumbel-hard]) with an
exponentially annealed temperature.  The JAX CLI shards the batch over a
'data' mesh axis; here the whole batch runs on one card.  The initial
weights are drawn from ``--seed`` by a CPU ``torch.Generator`` (not the
JAX package's ``PRNGKey`` stream), the gumbel noise by a generator on the
device seeded with ``--seed + 1``.

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


def _batches(source_path: str, img_size: int, batch: int):
    """Cycle the image source forever, yielding [B, S, S, 3] float32."""
    from ..preprocess.raw_datasets import open_image_source

    buf = []
    while True:
        n = 0
        for _name, arr in open_image_source(source_path, img_size=img_size):
            buf.append(arr)
            n += 1
            if len(buf) == batch:
                yield np.stack(buf)
                buf.clear()
        if n == 0:
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

    from ..config import VQVAEConfig
    from ..models import vqvae
    from ..ops.precision import set_fp32_precision
    from ..training.checkpointing import save_checkpoint
    from ..training.vqvae_train import (
        init_vqvae_train_state,
        make_adam,
        make_vqvae_gumbel_train_step,
        make_vqvae_train_step,
    )
    from ..utils.memory import device_memory_stats
    from ..utils.metrics import MetricsWriter

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    set_fp32_precision()

    cfg = VQVAEConfig(channel=args.channel, embed_dim=args.embed_dim, n_embed=args.n_embed)
    params = vqvae.init_params(cfg, torch.Generator().manual_seed(args.seed))
    params = vqvae.with_ema_buffers(vqvae.tree_to(params, device))
    tx = make_adam(params, args.lr)
    state = init_vqvae_train_state(params, tx)
    if args.gumbel:
        step = make_vqvae_gumbel_train_step(tx, kl_weight=args.kl_weight,
                                            hard=args.gumbel_hard, decay=args.ema_decay)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    else:
        step = make_vqvae_train_step(tx, latent_weight=args.latent_weight,
                                     decay=args.ema_decay)

    writer = MetricsWriter(args.summary_dir, args.experiment_name)
    batches = _batches(args.data, args.img_size, args.batch_size)
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
            print(f"iter {it}/{args.train_iters} | {parts} | {ms:.1f} ms/iter | "
                  f"{args.batch_size * 1000.0 / ms:.1f} images/s{peak}", flush=True)
            writer.add_scalars(it, m)
            main.last = dict(m, iteration=it, ms_per_iter=ms,
                             peak_gib=None if mem is None else mem["peak_bytes_in_use_gb"])
            window = 0
            clock.start()
        if args.save and (it % args.save_interval == 0 or it == args.train_iters):
            save_checkpoint(args.save, it, state)
    writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
