"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR
(counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

The same pure step -> lr functions, evaluated on the host in Python
floats (the JAX package evaluates them in f32 inside its compiled step);
the engine reads them at its optimizer step count, which a skipped step
does not advance. ``LRScheduler`` keeps the reference's
``step()/get_lr()`` API.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

VALID_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR"]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def warmup_lr(warmup_min_lr: float = 0.0,
              warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = "log") -> Callable:
    """Log or linear warmup from warmup_min_lr to warmup_max_lr, then flat."""
    warmup_num_steps = max(warmup_num_steps, 2)

    def fn(step):
        s = float(step)
        frac = _clip(s / warmup_num_steps, 0.0, 1.0)
        if warmup_type == "log":
            frac = _clip(math.log1p(s) / math.log(1 + warmup_num_steps),
                         0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return fn


def warmup_decay_lr(total_num_steps: int,
                    warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Callable:
    """Warmup, then linear decay to 0 at total_num_steps."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def fn(step):
        s = float(step)
        decay = _clip((total_num_steps - s)
                      / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return warm(s) if s < warmup_num_steps else warmup_max_lr * decay

    return fn


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Callable:
    """Smith's LR range sweep."""

    def fn(step):
        s = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            s = math.floor(s)
        return lr_range_test_min_lr * (1.0 + s * lr_range_test_step_rate)

    return fn


def one_cycle(cycle_min_lr: float = 1e-3,
              cycle_max_lr: float = 1e-2,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: Optional[int] = None,
              decay_step_size: int = 0,
              decay_lr_rate: float = 0.0,
              **_ignored) -> Callable:
    """Triangular cycle, then an optional decay. Momentum cycling is
    accepted and not applied, as in the JAX package."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    total_cycle = cycle_first_step_size + second

    def fn(step):
        s = float(step)
        if s <= total_cycle:
            if s <= cycle_first_step_size:
                up = _clip(s / cycle_first_step_size, 0.0, 1.0)
                return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up
            down = _clip((s - cycle_first_step_size) / second, 0.0, 1.0)
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down
        if decay_step_size > 0:
            decay_steps = max(s - total_cycle, 0.0) / decay_step_size
            return cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        return cycle_min_lr

    return fn


_SCHEDULE_BUILDERS: Dict[str, Callable] = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "lrrangetest": lr_range_test,
    "onecycle": one_cycle,
}


def build_schedule(sched_type: Optional[str], params: Optional[dict] = None,
                   base_lr: Optional[float] = None) -> Optional[Callable]:
    """Build a step -> lr function from a ds_config ``scheduler`` section."""
    if sched_type is None:
        return None
    key = sched_type.lower()
    if key not in _SCHEDULE_BUILDERS:
        raise ValueError(f"Unknown scheduler '{sched_type}'. "
                         f"Known: {VALID_SCHEDULES}")
    return _SCHEDULE_BUILDERS[key](**(params or {}))


class LRScheduler:
    """Stateful wrapper keeping the reference's scheduler API."""

    def __init__(self, fn: Callable, last_step: int = 0):
        self.fn = fn
        self.last_step = last_step

    def step(self, increment: int = 1):
        self.last_step += increment

    def get_lr(self):
        return [float(self.fn(self.last_step))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]
