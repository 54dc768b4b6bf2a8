"""Per-call launch cost of the port's CUDA kernels: the counterpart of
scripts/pallas_launch_probe.py.

Two chains of ``--iters`` calls, each call fed the previous call's output:

  tiny        P1a (``ops.probes.add_one``): x + 1.0 on an [8, 128] float32
              block, starting from zeros, so the chain ends at iters
              everywhere;
  convention  P1b (``ops.probes.decode_convention``): the decode kernel's
              arguments at cogview-base width and batch 40 (an int8 cache
              [L=48, NW=9, B=40, 2, N=40, D=64, W=128], its scales and ring,
              a bf16 q, all random from a seed), call i reading layer i % 48
              through per-layer views, as the decode step does; each call
              copies rows [0, 2) x {K, V} x 40 heads of window 0 (1.31 MB
              and 80 KB of scales) and writes ctx = q + bf16(first scale).

``torch.add(x, 1.0)`` is chained as P1a is: the library call beside it,
and P1a's plain version itself (``x + 1.0``).

Each chain is timed two ways: eagerly, ``iters`` launches issued one by one
from Python, which is how the port's decode step runs; and as one CUDA
graph captured from the same chain and replayed, one dispatch carrying all
the calls (the counterpart of the TPU probe's on-device loop), whose time
per call is the kernel's own with the launch cost a graph leaves.  P1b's
plain version is chained and replayed from a graph beside it.  Times are
CUDA events over ``--reps`` runs after one warm run, in microseconds per
call; the kernels' own device time per launch is read by torch.profiler off
two more graph replays.  Before timing, P1b at layers 0, 1 and L - 1 must
equal its plain version bit for bit and change q; after, the eager and
graph chains must equal the plain versions' chain bit for bit, or the
script exits non-zero.
The kernel does the same work whatever the values; the random cache makes
the checks see a kernel that reads the wrong layer, row or scale.

Replays pass through no wrapper, so the ``.launches`` counters see a
graph's calls once, at its capture (which runs nothing); the returned dict
gives the calls each capture recorded and those its replays ran.

Usage: python -m cogview_tpu_torch.scripts.launch_probe [--iters 480]
       [--reps 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops import probes
from ..ops.decode_attention import SEAL_GROUP
from ._timing import pick_device, time_graph, time_runs, us_text

# L, NW, B, N, D, W of the TPU probe: cogview-base, batch 40, 9 windows
CONVENTION_SHAPE = (48, 9, 40, 40, 64, 128)
SEED = 0


def tiny_chain(x: torch.Tensor, iters: int, fn: Callable = probes.add_one) -> torch.Tensor:
    """``iters`` calls of ``fn``, each on the previous output."""
    for _ in range(iters):
        x = fn(x)
    return x


def convention_chain(q: torch.Tensor, ring: torch.Tensor, kv: torch.Tensor,
                     scales: torch.Tensor, iters: int,
                     fn: Callable = probes.decode_convention) -> torch.Tensor:
    """``iters`` calls of ``fn`` with the decode kernel's arguments, call i
    on layer i % L of the [L, ...] cache, each fed the previous ctx."""
    L = kv.shape[0]
    for i in range(iters):
        li = i % L
        q = fn(q, ring[li], kv[li], scales[li], 0)
    return q


def convention_inputs(device: torch.device, shape: Sequence[int], seed: int):
    """(q [B, N, D] bf16, ring, kv, scales) at ``shape`` = (L, NW, B, N, D, W),
    random from ``seed``: int8 kv over its whole range, scales in
    [-2, 2), q standard normal, the ring (which P1b never reads) zeros."""
    L, NW, B, N, D, W = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    kv = torch.empty((L, NW, B, 2, N, D, W), dtype=torch.int8, device=device)
    kv.random_(-128, 128, generator=gen)
    scales = torch.empty((L, NW, B, 2, N, W), dtype=torch.float32, device=device)
    scales.uniform_(-2.0, 2.0, generator=gen)
    ring = torch.zeros((L, SEAL_GROUP, B, N, 2 * D), dtype=torch.float32, device=device)
    q = torch.empty((B, N, D), dtype=torch.bfloat16, device=device).normal_(generator=gen)
    return q, ring, kv, scales


def check_layers(q, ring, kv, scales, layers: Sequence[int]) -> float:
    """One P1b call at each of ``layers``: bit-equal to the plain version,
    and different from q (the scale was added); exits non-zero otherwise
    -> the largest difference (0)."""
    err = 0.0
    for li in layers:
        got = probes.decode_convention(q, ring[li], kv[li], scales[li], 0)
        want = probes.decode_convention_reference(q, ring[li], kv[li], scales[li], 0)
        err = max(err, (got.float() - want.float()).abs().max().item())
        if not torch.equal(got, want) or torch.equal(got, q):
            raise SystemExit(f"decode-convention: layer {li} differs from the plain version")
    print(f"decode-convention layers {tuple(layers)}: bit-equal to the plain version",
          flush=True)
    return err


def _timed(name: str, device, loop, reps: int, iters: int, want: torch.Tensor,
           count: Callable[[], int] = lambda: 0, plain: Optional[Callable] = None,
           kernel: Optional[str] = None) -> Dict:
    """Time ``loop`` eagerly and as a graph (and ``plain``, the plain
    versions' chain, as a graph), print one line each, and check both of
    ``loop``'s outputs equal ``want`` bit for bit.  ``kernel`` names the
    kernel whose device time per launch torch.profiler reads off two more
    graph replays."""
    eager_s = time_runs(device, loop, reps)
    eager_out = loop()
    graph = time_graph(device, loop, reps, count, profile=kernel)
    res = {"eager_us": eager_s / iters * 1e6,
           "graph_us": None if graph is None else graph["seconds"] / iters * 1e6,
           "device_us": None if graph is None else graph.get("device_us"),
           "graph_captured": 0 if graph is None else graph["captured"],
           "graph_replayed": 0 if graph is None else graph["replayed"]}
    print(f"{name + ' eager':40s} {us_text(res['eager_us'])} us/call", flush=True)
    print(f"{name + ' CUDA graph':40s} {us_text(res['graph_us'])} us/call", flush=True)
    if kernel is not None:
        print(f"{name + ' device (torch.profiler)':40s} {us_text(res['device_us'])} us/launch "
              f"({0 if graph is None else graph['device_launches']} launches seen)",
              flush=True)
    if plain is not None:
        plain_graph = time_graph(device, plain, reps)
        res["plain_graph_us"] = (None if plain_graph is None
                                 else plain_graph["seconds"] / iters * 1e6)
        print(f"{name + ' plain version CUDA graph':40s} {us_text(res['plain_graph_us'])} "
              f"us/call", flush=True)
    if not torch.equal(eager_out, want) or (graph is not None
                                            and not torch.equal(graph["out"], want)):
        raise SystemExit(f"{name}: the chain differs from the plain versions' chain")
    return res


def run(device: torch.device, iters: int, reps: int,
        shape: Sequence[int] = CONVENTION_SHAPE) -> Dict:
    """Both chains and the torch.add yardstick, checked and timed ->
    results by name."""
    out = {"device": str(device) if device.type != "cuda" else torch.cuda.get_device_name(device),
           "iters": iters, "reps": reps}
    x0 = torch.zeros((8, 128), dtype=torch.float32, device=device)
    want = tiny_chain(x0, iters, probes.add_one_reference)
    if want.sum().item() != 1024 * iters:
        raise SystemExit("the tiny chain does not end at iters")
    out["tiny"] = _timed("tiny [8,128] block", device, lambda: tiny_chain(x0, iters), reps,
                         iters, want, lambda: probes.add_one.launches, kernel="add_one_kernel")
    out["torch_add"] = _timed("torch.add [8,128] block", device,
                              lambda: tiny_chain(x0, iters, lambda x: torch.add(x, 1.0)),
                              reps, iters, want, kernel="elementwise")
    inputs = convention_inputs(device, shape, SEED)
    err = check_layers(*inputs, (0, 1, shape[0] - 1))
    want = convention_chain(*inputs, iters, probes.decode_convention_reference)
    out["convention"] = _timed(
        "decode-convention 1 window", device, lambda: convention_chain(*inputs, iters), reps,
        iters, want, lambda: probes.decode_convention.launches,
        plain=lambda: convention_chain(*inputs, iters, probes.decode_convention_reference),
        kernel="decode_convention_kernel")
    out["convention"]["max_abs_err"] = err
    del inputs, want
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=480)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = pick_device(args.device)
    return run(device, args.iters, args.reps)


if __name__ == "__main__":
    main(sys.argv[1:])
