"""Named timers (twin of cogview_tpu/utils/timers.py).

With ``fence=True`` a timer synchronises the CUDA device at start and stop,
so it measures finished device work and not only its enqueueing.
"""

from __future__ import annotations

import time
from typing import Dict

import torch


def device_fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    def __init__(self, name: str, fence: bool = False):
        self.name = name
        self.fence = fence
        self.elapsed_ = 0.0
        self.started = False
        self._t0 = 0.0

    def start(self) -> None:
        if self.started:
            raise RuntimeError(f"timer {self.name} already started")
        if self.fence:
            device_fence()
        self._t0 = time.time()
        self.started = True

    def stop(self) -> None:
        if not self.started:
            raise RuntimeError(f"timer {self.name} not started")
        if self.fence:
            device_fence()
        self.elapsed_ += time.time() - self._t0
        self.started = False

    def reset(self) -> None:
        self.elapsed_ = 0.0
        self.started = False

    def elapsed(self, reset: bool = True) -> float:
        e = self.elapsed_
        if reset:
            self.reset()
        return e


class Timers:
    def __init__(self, fence: bool = False):
        self.timers: Dict[str, Timer] = {}
        self.fence = fence

    def __call__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name, self.fence)
        return self.timers[name]

    def log(self, names, normalizer: float = 1.0, reset: bool = True) -> str:
        fields = []
        for n in names:
            if n in self.timers:
                ms = self.timers[n].elapsed(reset=reset) * 1000.0 / normalizer
                fields.append(f"{n}: {ms:.2f}")
        return " | ".join(fields)
