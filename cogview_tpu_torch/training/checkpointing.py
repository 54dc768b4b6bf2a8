"""Checkpoint save/load with the reference's tracker-file protocol (twin of
cogview_tpu/training/checkpointing.py).

    <save>/<iteration>/state.pt             one ``torch.save`` of a dict:
                                            params, optimizer state,
                                            iteration, the training
                                            generator's state,
                                            loader_consumed and, under
                                            float16, the loss scaler
    <save>/latest_checkpointed_iteration.txt

A tracker that reads ``release`` means iteration 0.  Loading uses
``weights_only=True``: a checkpoint holds tensors, numbers and dicts only.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

TRACKER = "latest_checkpointed_iteration.txt"
STATE_FILE = "state.pt"


def save_checkpoint(save_dir: str, iteration: int, state: Dict[str, Any]) -> str:
    """Write ``state`` at ``<save_dir>/<iteration>/`` and point the tracker
    at it -> the directory."""
    path = os.path.join(os.path.abspath(save_dir), str(iteration))
    os.makedirs(path, exist_ok=True)
    torch.save(state, os.path.join(path, STATE_FILE))
    with open(os.path.join(save_dir, TRACKER), "w") as f:
        f.write(str(iteration))
    return path


def get_checkpoint_iteration(load_dir: str) -> Optional[int]:
    tracker = os.path.join(load_dir, TRACKER)
    if not os.path.exists(tracker):
        return None
    with open(tracker) as f:
        txt = f.read().strip()
    return 0 if txt == "release" else int(txt)


def load_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


def load_latest(load_dir: str, map_location=None) -> Optional[Dict[str, Any]]:
    """The checkpoint the tracker names, or None without a tracker."""
    it = get_checkpoint_iteration(load_dir)
    if it is None:
        return None
    return load_checkpoint(os.path.join(load_dir, str(it)), map_location)
