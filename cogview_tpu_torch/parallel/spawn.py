"""Run a function on several local ranks of one process group.

:func:`run_ranks` starts ``world`` processes that join a group on a
``FileStore`` (a file, so no port is fixed and parallel runs cannot
collide), calls ``fn(rank, world, *args)`` in each and joins them within a
time limit: a rank that raises or a group that hangs fails the call, and
no process outlives it.  The dry run, the parallel tests and the card's
smoke check use it; torchrun is the launcher for training.
"""

from __future__ import annotations

import multiprocessing
import os
from multiprocessing import forkserver, resource_tracker
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import comm


def _entry(rank: int, world: int, store_path: str, device: str, fn: Callable, args) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:  # a card a rank while there are enough, else shared
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    comm.init_process_group(rank, world, dev, store=dist.FileStore(store_path, world))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, workdir: str, *args, device: str = "cpu",
              timeout: float = 300.0) -> None:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one group on
    ``device``: "cpu" (gloo), "cuda" (rank r on card r mod the card count;
    NCCL where every rank has its own card, gloo otherwise, see
    ``comm.backend_for``) or "cuda:<i>" (every rank on card i).  ``fn`` must be
    importable by name (a module-level function).  Raises when a rank
    raises or exits non-zero, or after ``timeout`` seconds, when every rank
    is killed."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store-{os.getpid()}-{time.monotonic_ns()}")
    # ranks fork from a server process that has imported torch once (about
    # 3 s a rank otherwise); the server itself never touches CUDA
    multiprocessing.get_context("forkserver").set_forkserver_preload(["torch"])
    ctx = mp.start_processes(_entry, args=(world, store, device, fn, args), nprocs=world,
                             join=False, start_method="forkserver")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        # the fork server and the resource tracker that starting the ranks
        # brought up would each outlive the caller for a moment: stop both
        # and wait for them (the next call starts them again)
        forkserver._forkserver._stop()
        resource_tracker._resource_tracker._stop()
