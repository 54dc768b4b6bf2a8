"""Time of the seal's lane scatter on the card: the counterpart of
scripts/seal_scatter_probe.py.

The decode kernels' seal places column g of the quantized ring's
[hb, Dc] values into lane lane0 + g of a [hb, Dc, W] window block.  The
TPU script asked which Mosaic construct could express that scatter, and
compiled and timed five lowerings of the same function:

  accum    a per-g float32 multiply-add chain
  bigsum   one [G, hb, Dc, W] broadcast product summed over G
  batched  dot_general with hb as a batch dimension
  fused2d  K|V-fused [G, hb, 128] reshaped to one 2D dot
  serial   a per-g int8 where-chain

They are lowering alternatives, not functions: all compute the same bytes,
and which of them compiled was a property of Mosaic.  None has a CUDA twin;
the port has one kernel for the function they share
(``ops.probes.seal_scatter``, csrc/probes.cu).  ``batched`` never traced in
JAX at all (its ``broadcast_to`` has the wrong rank), so it has nothing to
port.

The inputs are the TPU script's: qc [8, 40, 64] float32 integers in
[-127, 127) from RandomState(0), lane0 = 16 and the matching one-hot
[8, 128].  The loop runs ``--iters`` calls, ``acc += out[:G].int()`` after
each, timed eagerly and as one replayed CUDA graph (CUDA events, ``--reps``
runs after one warm run).  It prints ``seal PASS`` when both loops' acc
equal iters times the plain version's bytes, and exits non-zero otherwise.
The loop's time per call holds the cast and the add; ``--iters`` calls of
the kernel alone, and of its plain version alone, are then replayed from a
CUDA graph each and timed the same way, the kernel's last output held
byte-equal to the plain version's; torch.profiler reads the kernel's own
device time per launch off two more replays of its graph, printed beside
its bound (:func:`bound_us`: qc, oh and lane0 read once and out written
once at the H100's 3.35 TB/s) and the bound's share of it.

Usage: python -m cogview_tpu_torch.scripts.seal_scatter_probe [--iters 64]
       [--reps 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import numpy as np
import torch

from ..ops import probes
from ._timing import pick_device, time_graph, time_runs, us_text

G, HB, DC, W = 8, 40, 64, 128
LANE0 = 16
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


def bound_us() -> float:
    """Least device microseconds of one call at the probe's shapes: qc, oh
    and lane0 read once, out written once, at the memory rate (the G x G
    products of each row are far below the float32 peak)."""
    nbytes = G * HB * DC * 4 + G * W * 4 + 4 + HB * DC * W
    return nbytes / HBM_BYTES_PER_S * 1e6


def one_hot(lane0: int, device=None) -> torch.Tensor:
    """[G, W] float32 with a 1 at (g, lane0 + g)."""
    lanes = torch.arange(W, device=device)[None, :]
    return (lanes == lane0 + torch.arange(G, device=device)[:, None]).float()


def probe_inputs(device=None):
    """(qc, oh, lane0) of the TPU script."""
    rng = np.random.RandomState(0)
    qc = torch.from_numpy(rng.randint(-127, 127, (G, HB, DC)).astype(np.float32)).to(device)
    lane0 = torch.full((1, 1), LANE0, dtype=torch.int32, device=device)
    return qc, one_hot(LANE0, device), lane0


def seal_loop(qc: torch.Tensor, oh: torch.Tensor, lane0: torch.Tensor, iters: int,
              fn: Callable = probes.seal_scatter) -> torch.Tensor:
    """``iters`` calls of ``fn``, summing the first G heads' bytes ->
    acc [G, Dc, W] int32."""
    acc = torch.zeros((G, qc.shape[2], oh.shape[1]), dtype=torch.int32, device=qc.device)
    for _ in range(iters):
        out = fn(qc, oh, lane0)
        acc += out[:G].int()
    return acc


def scatter_calls(qc: torch.Tensor, oh: torch.Tensor, lane0: torch.Tensor, iters: int,
                  fn: Callable = probes.seal_scatter) -> torch.Tensor:
    """``iters`` calls of ``fn`` alone -> the last output."""
    for _ in range(iters):
        out = fn(qc, oh, lane0)
    return out


def run(device: torch.device, iters: int, reps: int) -> Dict:
    qc, oh, lane0 = probe_inputs(device)
    plain = probes.seal_scatter_reference(qc, oh, lane0)
    want = iters * plain[:G].int()

    def loop():
        return seal_loop(qc, oh, lane0, iters)

    def count():
        return probes.seal_scatter.launches

    eager_s = time_runs(device, loop, reps)
    ok = torch.equal(loop(), want)
    graph = time_graph(device, loop, reps, count)
    ok = ok and (graph is None or torch.equal(graph["out"], want))
    alone = time_graph(device, lambda: scatter_calls(qc, oh, lane0, iters), reps, count,
                       profile="seal_scatter_kernel")
    ok = ok and (alone is None or torch.equal(alone["out"], plain))
    plain_alone = time_graph(
        device, lambda: scatter_calls(qc, oh, lane0, iters, probes.seal_scatter_reference), reps)

    def per_call(g):
        return None if g is None else g["seconds"] / iters * 1e6

    res = {"device": str(device) if device.type != "cuda" else torch.cuda.get_device_name(device),
           "iters": iters, "reps": reps, "pass": ok, "eager_us": eager_s / iters * 1e6,
           "graph_us": per_call(graph), "kernel_graph_us": per_call(alone),
           "plain_graph_us": per_call(plain_alone),
           "device_us": None if alone is None else alone["device_us"],
           "bound_us": bound_us(),
           "graph_captured": sum(g["captured"] for g in (graph, alone) if g is not None),
           "graph_replayed": sum(g["replayed"] for g in (graph, alone) if g is not None)}
    print(f"seal {'PASS' if ok else 'FAIL'}  {us_text(res['eager_us'])} us/call eager, "
          f"{us_text(res['graph_us'])} us/call in a CUDA graph", flush=True)
    share = (None if res["device_us"] is None
             else f"{res['bound_us'] / res['device_us']:.3f}")
    print(f"seal kernel alone {us_text(res['kernel_graph_us'])} us/call in a CUDA graph, "
          f"plain version {us_text(res['plain_graph_us'])} us/call; the kernel's device time "
          f"{us_text(res['device_us'])} us/launch (torch.profiler), bound "
          f"{res['bound_us']:.4f} us, share {share}", flush=True)
    if not ok:
        raise SystemExit("seal: the kernel's bytes differ from the plain version's")
    return res


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    return run(pick_device(args.device), args.iters, args.reps)


if __name__ == "__main__":
    main(sys.argv[1:])
