"""Static and dynamic fp16 loss scaling (counterpart of
``deepspeed_tpu/runtime/loss_scaler.py``).

The same scaler with the same state transitions: scale the loss before
backward, detect inf/nan in the grads, skip the step and (after
``hysteresis`` consecutive overflows) divide the scale by
``scale_factor``, multiply it after ``scale_window`` clean steps. The
state is three host numbers: the engine reads the overflow flag of a step
once from the device (one host read per step) and updates the scale on
the host, where the JAX package branches inside its compiled step.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float
    good_steps: int         # consecutive overflow-free steps
    hysteresis: int         # remaining tolerated overflows


class LossScaler:
    """Unified static/dynamic scaler. static = dynamic with growth disabled."""

    def __init__(self,
                 static_scale: float = 0.0,
                 initial_scale_power: int = 16,
                 scale_window: int = 1000,
                 min_scale: float = 1.0,
                 hysteresis: int = 2,
                 scale_factor: float = 2.0,
                 enabled: bool = True):
        self.enabled = enabled
        self.dynamic = enabled and static_scale == 0.0
        self.initial_scale = (static_scale if static_scale > 0.0 else
                              2.0 ** initial_scale_power) if enabled else 1.0
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.init_hysteresis = hysteresis
        self.scale_factor = scale_factor

    def init(self) -> LossScaleState:
        return LossScaleState(scale=float(self.initial_scale), good_steps=0,
                              hysteresis=int(self.init_hysteresis))

    def scale_loss(self, loss, state: LossScaleState):
        return loss * state.scale if self.enabled else loss

    def unscale(self, grads: List[torch.Tensor],
                state: LossScaleState) -> List[torch.Tensor]:
        if not self.enabled:
            return grads
        inv = 1.0 / state.scale
        return [g.to(torch.float32) * inv for g in grads]

    @staticmethod
    def has_overflow(grads: List[torch.Tensor]) -> torch.Tensor:
        """Global inf/nan check over the grads: a 0-d bool tensor on the
        grads' device (no host read here)."""
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        return ~finite

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:
        """Post-step scale adjustment (the JAX package's ``update``)."""
        if not self.dynamic:
            return state
        if overflow:
            hyst = state.hysteresis - 1
            scale = (max(state.scale / self.scale_factor, self.min_scale)
                     if hyst <= 0 else state.scale)
            return LossScaleState(scale=float(scale), good_steps=0,
                                  hysteresis=max(hyst, 1))
        good = state.good_steps + 1
        grow = good >= self.scale_window
        return LossScaleState(
            scale=float(state.scale * self.scale_factor if grow
                        else state.scale),
            good_steps=0 if grow else good,
            hysteresis=int(self.init_hysteresis))
