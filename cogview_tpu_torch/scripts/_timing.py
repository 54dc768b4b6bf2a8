"""Device choice and loop timing shared by the measurement entry points.

A loop is timed two ways on a card: eagerly, each launch issued from Python
as the port's decode step issues it, and as one CUDA graph captured from the
same loop and replayed, one dispatch carrying every launch.  Both are CUDA
events around whole runs after one warm run.  On the CPU only the eager
loop exists, timed by the host clock; such a time describes the plain
versions on the CPU, never the card.

Capturing a graph passes through the kernel wrappers, which count each
call once, but a capture records a node and runs nothing; replays run every
recorded node and pass through no wrapper.  :func:`time_graph` therefore
reports what the capture recorded and counts the launches its replays ran.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, Optional, Tuple

import torch


def pick_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; exits non-zero when ``cuda`` is asked for and
    there is no card (there is no silent CPU path)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs the card's kernels; pass "
                         "--device cpu to run the plain versions on the CPU")
    return torch.device(name)


def time_runs(device: torch.device, run: Callable[[], object], reps: int) -> float:
    """Mean seconds of ``run()`` (an eager loop, or a graph's replay) over
    ``reps`` runs after one warm run."""
    run()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1000.0 / reps


def capture(loop: Callable[[], torch.Tensor]) -> Tuple[torch.cuda.CUDAGraph, torch.Tensor]:
    """``loop()`` captured once in a CUDA graph -> (graph, its output, which
    every replay overwrites).  The loop's inputs must outlive the graph."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = loop()
    return graph, out


def profile_device_us(device: torch.device, run: Callable[[], object], kernel: str,
                      reps: int = 2) -> Tuple[Optional[float], int]:
    """``reps`` runs of ``run`` under torch.profiler -> (mean device
    microseconds of one launch of the kernels whose name holds ``kernel``,
    their launches), or (None, 0) when the profiler recorded none."""
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize(device)
    us, n = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key and t > 0:
            us, n = us + t, n + e.count
    return (us / n if n else None), n


def time_graph(device: torch.device, loop: Callable[[], torch.Tensor], reps: int,
               count: Callable[[], int] = lambda: 0,
               profile: Optional[str] = None) -> Optional[Dict]:
    """``loop`` captured as one CUDA graph and timed over ``reps`` replays
    after one warm replay -> {"seconds": mean seconds of one replay, "out":
    the graph's output after the replays, "captured": the rise of
    ``count()`` (a wrapper's launch counter) during the capture, i.e. the
    kernel calls one replay runs, "replayed": captured times the replays
    actually made}; None off the card.  With ``profile``, two more replays
    run under torch.profiler and add "device_us" and "device_launches"
    (:func:`profile_device_us` for the kernels named ``profile``)."""
    if device.type != "cuda":
        return None
    before = count()
    graph, out = capture(loop)
    captured = count() - before
    replays = 0

    def replay():
        nonlocal replays
        graph.replay()
        replays += 1

    seconds = time_runs(device, replay, reps)
    torch.cuda.synchronize(device)
    res = {"seconds": seconds, "out": out}
    if profile is not None:
        res["device_us"], res["device_launches"] = profile_device_us(device, replay, profile)
    res.update(captured=captured, replayed=replays * captured)
    return res


KINDS = ("flash kernels", "matmuls", "elementwise", "zero fills", "reductions",
         "copies / casts", "other")


def kernel_kind(name: str) -> str:
    """A CUDA kernel's name -> one of KINDS."""
    name = name.lower()
    if "flash" in name:
        return "flash kernels"
    if any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet", "sm90")):
        return "matmuls"
    if "fill" in name:
        return "zero fills"
    if "reduce" in name or "norm" in name or "softmax" in name:
        return "reductions"
    if "copy" in name or "memcpy" in name or "memset" in name or "cast" in name:
        return "copies / casts"
    if "elementwise" in name or "vectorized" in name or "unrolled" in name:
        return "elementwise"
    return "other"


def device_time(prof, wall_s: float):
    """A profile's CUDA kernels -> (seconds by kind, launches by kind, busy
    share of ``wall_s``, the 8 longest as (seconds, launches, name), the
    flash kernels' (seconds, launches) by instantiation)."""
    secs, counts = dict.fromkeys(KINDS, 0.0), dict.fromkeys(KINDS, 0)
    top, flash = [], {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = kernel_kind(e.key)
        secs[kind] += us / 1e6
        counts[kind] += e.count
        top.append((us / 1e6, e.count, e.key[:90]))
        if kind == "flash kernels":
            short = re.search(r"flash_\w+<[^>]*>", e.key)
            flash[short.group(0) if short else e.key[:90]] = (us / 1e6, e.count)
    return secs, counts, sum(secs.values()) / wall_s, sorted(top, reverse=True)[:8], flash


def us_text(us: Optional[float]) -> str:
    return "     n/a" if us is None else f"{us:8.2f}"
