"""Dynamic loss scaling for float16 training (twin of
cogview_tpu/training/loss_scaler.py).

The reference's DynamicLossScaler: the scale doubles after ``scale_window``
consecutive good steps and halves on overflow, with ``hysteresis`` and
``min_scale`` guards.  State in, state out; the state is host scalars.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class LossScaleState(NamedTuple):
    scale: float
    good_steps: int  # consecutive overflow-free steps
    hysteresis_left: int


def init_loss_scale(init_scale: float = 2.0 ** 32, hysteresis: int = 2) -> LossScaleState:
    return LossScaleState(float(init_scale), 0, int(hysteresis))


def update_loss_scale(state: LossScaleState, overflow: bool, scale_factor: float = 2.0,
                      scale_window: int = 1000, min_scale: float = 1.0,
                      hysteresis: int = 2) -> Tuple[LossScaleState, bool]:
    """-> (new state, apply_update).  On overflow, consume hysteresis, then
    halve the scale (floored at min_scale) and reset the good-step counter;
    after scale_window good steps, double the scale."""
    hy = state.hysteresis_left - 1 if overflow else state.hysteresis_left
    scale = state.scale
    if overflow and hy <= 0:
        scale = max(scale / scale_factor, min_scale)
    good = 0 if overflow else state.good_steps + 1
    if not overflow and good >= scale_window:
        scale, good = scale * scale_factor, 0
    if overflow and hy <= 0:
        hy = hysteresis
    if not overflow:
        hy = hysteresis
    return LossScaleState(scale, good, hy), not overflow
