"""Scalar metrics as JSON lines on disk (twin of cogview_tpu/utils/metrics.py)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir: Optional[str], experiment: str = "run"):
        self.path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{experiment}.metrics.jsonl")
            self._f = open(self.path, "a")

    def add_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
        if self.path is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self.path is not None:
            self._f.close()
