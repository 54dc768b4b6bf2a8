"""Decode-kernel cost against live windows: the fixed cost per call and the
cost per window of K1 (int8 cache) and K2 (int4 cache) on the card.  The
counterpart of scripts/decode_kernel_microbench.py.

The cache is cogview-base's from ``gpt.init_cache`` (48 layers, 40 heads,
D = 64, T = 1089, 9 windows of 128) at ``--batch`` rows: with the int8
cache at batch 40 that is 11.3 GB of kv, 0.71 GB of scales and 0.31 GB of
ring.  It is allocated and filled from a seed once, outside the timed
region, so unlike the JAX script (which builds its cache inside each timed
dispatch) there is no zero-iteration baseline to subtract.  The kernels do
the same work whatever the bytes; random bytes make the check below see
a kernel that reads the wrong window, row or lane.

Call i of a loop of ``--iters`` reads layer li = i % 48: with
``--ring-write 1`` it first writes the ring slot index % 8 of that layer,
as the decode step does, then calls ``decode_attention_quant``.  The sweep
runs the loop at 1, 3, 5, 7 and 9 live windows (index min(128 w - 64,
T - 1) = 64, 320, 576, 832, 1088; none is a seal step), each timed eagerly
and as one replayed CUDA graph (the index is a Python int, so every point
captures its own graph), by CUDA events over 3 runs after one warm run.  At each
point the last ctx of the eager loop and of the graph is held against the
plain version (``decode_attention_quant_reference``) on the same layer and
inputs, with the kernels' tolerance, and the script exits non-zero beyond
it.  A least-squares line through the five points gives the cost per window
(slope) and per call (intercept), and the slope the marginal GB/s; with
``--ring-write 0`` the intercept is the kernel's alone.  There is no
``--row-block``: that was a Mosaic tile knob.

Usage: python -m cogview_tpu_torch.scripts.decode_kernel_microbench
       [--batch 40] [--iters 50] [--kv int8|int4] [--ring-write 0|1]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import cogview_base
from ..models import gpt
from ..ops.decode_attention import (SEAL_GROUP, WRITE_WINDOW, decode_attention_quant,
                                    decode_attention_quant_reference, is_packed)
from ._timing import pick_device, time_graph, time_runs, us_text

WINDOWS = (1, 3, 5, 7, 9)
REPS = 3
SEED = 0


def seeded_cache(cfg, batch: int, max_len: int, device: torch.device,
                 seed: int = SEED) -> gpt.QuantKVCache:
    """``gpt.init_cache``'s int8 or int4 cache filled from ``seed``: every
    kv byte random (int4: both nibbles in [-8, 7]), scales uniform in
    [0, 0.02) (int8) or [0, 0.3) (int4), so a dequantized value lies within
    about 2.5 of 0, and a standard normal ring."""
    cache = gpt.init_cache(cfg, batch, max_len, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cache.kv.random_(-128, 128, generator=gen)
    cache.scale.uniform_(0.0, 0.02 if cfg.kv_cache_dtype == "int8" else 0.3, generator=gen)
    cache.recent.normal_(generator=gen)
    return cache


def check(ctx: torch.Tensor, q: torch.Tensor, cache: gpt.QuantKVCache, index: int,
          li: int) -> float:
    """``ctx`` of layer ``li`` at ``index`` against the plain version on the
    same inputs -> the largest difference; exits non-zero beyond the
    kernels' tolerance: 1e-4 for a float32 q; for a bfloat16 q, 2e-2 on the
    int8 cache (K1 rounds q and p * vs to bfloat16) and 1e-4 plus one
    bfloat16 ulp of the value on the int4 cache (K2 rounds its ctx once)."""
    want = decode_attention_quant_reference(q, cache.recent[li], cache.kv[li], cache.scale[li],
                                            index).float()
    diff = (ctx.float() - want).abs()
    if q.dtype == torch.float32:
        ok, tol = bool((diff <= 1e-4).all()), "1e-4"
    elif is_packed(cache.kv[li], q.shape[2]):
        ok, tol = bool((diff <= 1e-4 + want.abs() * 2.0 ** -7).all()), "1e-4 + one bf16 ulp"
    else:
        ok, tol = bool((diff <= 2e-2).all()), "2e-2"
    err = diff.max().item()
    if not ok or ctx.shape != q.shape or ctx.dtype != q.dtype:
        raise SystemExit(f"decode kernel at index {index}, layer {li}: ctx differs from the "
                         f"plain version by {err:.3e} (tol {tol})")
    return err


def decode_calls(q: torch.Tensor, cols: torch.Tensor, cache: gpt.QuantKVCache, index: int,
                 iters: int, ring_write: bool) -> torch.Tensor:
    """``iters`` decode-kernel calls at ``index``, call i on layer i % L,
    each after writing ``cols`` into the ring slot index % G when
    ``ring_write`` -> the last ctx."""
    L = cache.kv.shape[0]
    for i in range(iters):
        li = i % L
        if ring_write:
            cache.recent[li, index % SEAL_GROUP].copy_(cols)
        ctx = decode_attention_quant(q, cache.recent[li], cache.kv[li], cache.scale[li], index)
    return ctx


def fit(points: Sequence[tuple]) -> tuple:
    """Least-squares (slope per window, intercept) of (windows, us) pairs."""
    xs = np.array([p[0] for p in points], np.float64)
    ys = np.array([p[1] for p in points], np.float64)
    (slope, intercept), *_ = np.linalg.lstsq(np.stack([xs, np.ones_like(xs)], 1), ys, rcond=None)
    return float(slope), float(intercept)


def sweep(device: torch.device, cache: gpt.QuantKVCache, q: torch.Tensor, cols: torch.Tensor,
          iters: int, ring_write: bool, max_len: int, reps: int = REPS) -> List[Dict]:
    """The loop at each live-window count, checked against the plain
    version -> one dict per point: windows, index, eager and graph
    microseconds per call, the launches the graph's capture recorded and
    those its replays ran, and the largest ctx difference."""
    rows = []
    last = (iters - 1) % cache.kv.shape[0]

    def count():
        return decode_attention_quant.launches + decode_attention_quant.launches_int4

    for w in WINDOWS:
        index = min(w * WRITE_WINDOW - WRITE_WINDOW // 2, max_len - 1)

        def loop(index=index):
            return decode_calls(q, cols, cache, index, iters, ring_write)

        eager_s = time_runs(device, loop, reps)
        err = check(loop(), q, cache, index, last)
        graph = time_graph(device, loop, reps, count)
        if graph is not None:
            err = max(err, check(graph["out"], q, cache, index, last))
        rows.append({"windows": w, "index": index, "eager_us": eager_s / iters * 1e6,
                     "graph_us": None if graph is None else graph["seconds"] / iters * 1e6,
                     "graph_captured": 0 if graph is None else graph["captured"],
                     "graph_replayed": 0 if graph is None else graph["replayed"],
                     "max_abs_err": err})
        print(f"live_windows {w:2d}  index {index:4d}  {us_text(rows[-1]['eager_us'])} us/call "
              f"eager  {us_text(rows[-1]['graph_us'])} us/call in a CUDA graph  max_abs_err "
              f"{err:.2e} against the plain version", flush=True)
    return rows


def summarize(rows: List[Dict], batch: int, heads: int, head_dim: int, kv: str) -> Dict:
    """Slope, intercept and marginal GB/s of the eager and graph columns."""
    win_bytes = batch * heads * WRITE_WINDOW * (2 * head_dim * (1 if kv == "int8" else 0.5)
                                                + 2 * 4)
    out = {"window_mb": win_bytes / 1e6}
    for col in ("eager_us", "graph_us"):
        if rows[0][col] is None:
            out[col[:-3]] = None
            continue
        slope, intercept = fit([(r["windows"], r[col]) for r in rows])
        gbs = win_bytes / (slope * 1e-6) / 1e9 if slope > 0 else float("inf")
        out[col[:-3]] = {"slope_us": slope, "intercept_us": intercept, "marginal_gbs": gbs}
        print(f"per-call {col[:-3]:5s}: slope {slope:.2f} us/window  fixed {intercept:.2f} us  "
              f"-> {gbs:.0f} GB/s marginal ({win_bytes / 1e6:.1f} MB/window)  [one 48-layer "
              f"step: {48 * (intercept + slope * 5.5) / 1e3:.2f} ms at avg 5.5 windows]",
              flush=True)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=40)
    ap.add_argument("--iters", type=int, default=50,
                    help="kernel calls per timed loop (48 = one step)")
    ap.add_argument("--kv", default="int8", choices=["int8", "int4"])
    ap.add_argument("--ring-write", type=int, default=1, choices=[0, 1],
                    help="0 = leave the ring alone (the kernel only)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = pick_device(args.device)

    cfg = cogview_base(kv_cache_dtype=args.kv)
    B, N, D = args.batch, cfg.num_heads, cfg.head_dim
    cache = seeded_cache(cfg, B, cfg.max_position_embeddings, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    q, kc, vc = (torch.randn((B, N, D), generator=gen, device=device).to(torch.bfloat16)
                 for _ in range(3))
    cols = torch.cat([kc, vc], dim=-1).float()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"decode kernel sweep: {args.kv} cache, batch {B}, {args.iters} calls per loop, "
          f"ring write {args.ring_write}, device {name}", flush=True)
    rows = sweep(device, cache, q, cols, args.iters, bool(args.ring_write),
                 cfg.max_position_embeddings)
    res = summarize(rows, B, N, D, args.kv)
    del cache
    return {"device": name, "kv": args.kv, "batch": B, "iters": args.iters,
            "ring_write": args.ring_write, "points": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "graph_captured": sum(r["graph_captured"] for r in rows),
            "graph_replayed": sum(r["graph_replayed"] for r in rows), **res}


if __name__ == "__main__":
    main(sys.argv[1:])
