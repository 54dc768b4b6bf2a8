"""The train step on the card: milliseconds a step, tokens per second, peak
memory, and the device's kernel time by kind from ``torch.profiler``.

  python -m cogview_tpu_torch.scripts.train_step_profile --preset tutorial --batch 16
  python -m cogview_tpu_torch.scripts.train_step_profile --preset cogview-sr \\
      --batch 2 --grad-only

Random weights from a fixed seed and a batch of random rows of
``max_position_embeddings`` tokens (a text prefix, then image codes), the
step of ``training/train_loop.py`` (bf16, dropout 0.1, remat) after two
warm steps: six steps by the host clock around synchronised steps, then
two more under ``torch.profiler``.  ``--grad-only`` times the loss and
its gradients without the optimizer.  Zero fills (the ``FillFunctor``
kernels) are counted apart from the other elementwise kernels.  Prints one
JSON line with the card's name and power limit; exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cogview_tpu_torch import config as C
from cogview_tpu_torch.models import gpt
from cogview_tpu_torch.ops.precision import set_fp32_precision
from cogview_tpu_torch.scripts._timing import device_time
from cogview_tpu_torch.training import losses, optim
from cogview_tpu_torch.training import train_loop as tl

PRESETS = {"tutorial": C.cogview_tutorial, "cogview-base": C.cogview_base,
           "cogview-sr": C.cogview_sr}
STEPS, SEED = 6, 1234


def random_batch(cfg, batch: int, seed: int):
    """Rows of max_position_embeddings tokens: 16-40 text ids, then image
    codes; every position on the loss."""
    rng = np.random.RandomState(seed)
    P = cfg.max_position_embeddings
    text = rng.randint(0, 8192, (batch, P)).astype(np.int32)
    for r in range(batch):
        n = rng.randint(16, 41)
        text[r, :n] = rng.randint(8192, 8192 + 50000, n)
    return {"text": torch.from_numpy(text).cuda(),
            "loss_mask": torch.ones((batch, P), device="cuda")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("train_step_profile")
    p.add_argument("--preset", default="tutorial", choices=list(PRESETS))
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--grad-only", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    set_fp32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = PRESETS[args.preset]()
    params = gpt.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                             device="cuda")
    batch = random_batch(cfg, args.batch, SEED)
    if args.grad_only:
        optim.tree_map(lambda t: t.requires_grad_(True), params)
        leaves = list(optim.tree_leaves(params))
        seeds = list(range(1, cfg.num_layers + 2))

        def run():
            loss, _ = losses.lm_loss(params, cfg, batch, seeds=seeds)
            torch.autograd.grad(loss, leaves)
    else:
        opt, _ = optim.make_optimizer(params, lr=1e-4, warmup_iter=1, num_iters=100)
        state = tl.init_train_state(params, opt, torch.Generator().manual_seed(SEED))
        step = tl.make_train_step(cfg, opt)

        def run():
            step(state, batch)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    secs, counts, busy, top, flash = device_time(prof, wall)
    ms = 1000.0 * statistics.median(times)
    tokens = args.batch * (cfg.max_position_embeddings - 1)
    out = {"card": smi.splitlines()[0], "preset": args.preset, "layers": cfg.num_layers,
           "batch": args.batch, "grad_only": args.grad_only, "ms_per_step": ms,
           "ms_per_step_all": [1000.0 * t for t in times],
           "tokens_per_s": tokens / ms * 1000.0, "peak_gib": peak,
           "kernel_ms_per_step": {k: 1000.0 * v / 2 for k, v in secs.items()},
           "launches_per_step": {k: v // 2 for k, v in counts.items()},
           "busy": busy, "profiled_wall_ms_per_step": 1000.0 * wall / 2,
           "top": [(1000.0 * s / 2, n // 2, name) for s, n, name in top],
           "flash": {k: (1000.0 * s / 2, n // 2) for k, (s, n) in flash.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
