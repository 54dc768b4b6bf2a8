"""Device-memory reporting (twin of cogview_tpu/utils/memory.py), on
``torch.cuda.memory_stats``: the bytes the caching allocator hands to
tensors now and at their peak, and the card's memory."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def device_memory_stats(device=None) -> Optional[Dict[str, float]]:
    """GiB in use, at peak and in all on a CUDA device; None elsewhere."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    gb = 1024.0 ** 3
    return {
        "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / gb,
        "peak_bytes_in_use_gb": stats.get("allocated_bytes.all.peak", 0) / gb,
        "bytes_limit_gb": torch.cuda.get_device_properties(device).total_memory / gb,
    }


def report_memory(name: str = "", device=None) -> str:
    stats = device_memory_stats(device)
    if stats is None:
        return f"memory ({name}) | unavailable on this device"
    return (
        f"memory ({name}) | in-use: {stats['bytes_in_use_gb']:.2f} GB | "
        f"peak: {stats['peak_bytes_in_use_gb']:.2f} GB | "
        f"limit: {stats['bytes_limit_gb']:.2f} GB"
    )


def print_args(args) -> None:
    """Startup flag dump (reference utils.py:48-56)."""
    print("arguments:", flush=True)
    for key in sorted(vars(args)):
        dots = "." * max(1, 32 - len(key))
        print(f"  {key} {dots} {getattr(args, key)}", flush=True)
