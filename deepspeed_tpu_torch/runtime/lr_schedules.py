"""Learning-rate schedules, PyTorch port.

A copy of ``deepspeed_tpu/runtime/lr_schedules.py`` in plain Python: the
same schedule types and config keys, each a pure ``step -> lr`` function.
The JAX package evaluates them in fp32 inside the jitted step; here they
run on the host once per optimizer step, in fp32 (numpy scalars) so the
port computes the same learning rate bit for bit.  ``OneCycle`` and
``LRRangeTest`` come along unchanged.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np

Schedule = Callable[[Any], Any]

WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
ONE_CYCLE = "OneCycle"
LR_RANGE_TEST = "LRRangeTest"

VALID_LR_SCHEDULES = [WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR, ONE_CYCLE, LR_RANGE_TEST]

_f32 = np.float32


def _clip(x, lo, hi):
    return _f32(min(max(x, _f32(lo)), _f32(hi)))


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_: Any) -> Schedule:
    """Warm up from min to max, then hold (reference ``WarmupLR``)."""
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        frac = _clip(_f32(step) / _f32(warmup_num_steps), 0.0, 1.0)
        if warmup_type == "log":
            gamma = (_f32(np.log(_f32(1.0) + frac * _f32(math.e - 1.0)))
                     if frac > 0 else _f32(0.0))
        else:
            gamma = frac
        return _f32(warmup_min_lr) + _f32(warmup_max_lr - warmup_min_lr) * gamma

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_: Any) -> Schedule:
    """Warmup then linear decay to 0 (reference ``WarmupDecayLR``)."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    total = max(total_num_steps, warmup_num_steps + 1)

    def schedule(step):
        step = _f32(step)
        if step < warmup_num_steps:
            return base(step)
        decay = _clip((_f32(total) - step) / _f32(max(1.0, total - warmup_num_steps)),
                      0.0, 1.0)
        return _f32(warmup_max_lr) * decay

    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001, **_: Any) -> Schedule:
    def schedule(step):
        step = _f32(step)
        if step < warmup_num_steps:
            warm_frac = _clip(step / _f32(max(1, warmup_num_steps)), 0.0, 1.0)
            return (_f32(warmup_min_ratio) + _f32(1 - warmup_min_ratio) * warm_frac) \
                * _f32(warmup_max_lr)
        progress = _clip((step - _f32(warmup_num_steps))
                         / _f32(max(1, total_num_steps - warmup_num_steps)), 0.0, 1.0)
        cosine = _f32(cos_min_ratio) + _f32(1 - cos_min_ratio) * _f32(0.5) * (
            _f32(1) + _f32(np.cos(_f32(np.pi) * progress)))
        return _f32(warmup_max_lr) * cosine

    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, cycle_momentum: bool = False, **_: Any) -> Schedule:
    """Triangular one-cycle policy (reference ``OneCycle``)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    cycle_len = cycle_first_step_size + second

    def schedule(step):
        step = _f32(step)
        in_cycle = min(step, _f32(cycle_len))
        if in_cycle < cycle_first_step_size:
            up = _clip(in_cycle / _f32(cycle_first_step_size), 0.0, 1.0)
            tri = _f32(cycle_min_lr) + _f32(cycle_max_lr - cycle_min_lr) * up
        else:
            down = _clip((in_cycle - _f32(cycle_first_step_size)) / _f32(second), 0.0, 1.0)
            tri = _f32(cycle_max_lr) - _f32(cycle_max_lr - cycle_min_lr) * down
        if decay_step_size > 0:
            decay_steps = max(step - _f32(cycle_len), _f32(0.0)) / _f32(decay_step_size)
            tri = tri * (_f32(1.0) / (_f32(1.0) + _f32(decay_lr_rate) * decay_steps))
        return tri

    return schedule


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  **_: Any) -> Schedule:
    def schedule(step):
        interval = _f32(step) / _f32(lr_range_test_step_size)
        if lr_range_test_staircase:
            interval = _f32(np.floor(interval))
        return _f32(lr_range_test_min_lr) * (_f32(1.0) + interval
                                             * _f32(lr_range_test_step_rate))

    return schedule


_FACTORIES: Dict[str, Callable[..., Schedule]] = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
    ONE_CYCLE: one_cycle,
    LR_RANGE_TEST: lr_range_test,
}


def get_lr_schedule(name: str, params: Dict[str, Any]) -> Schedule:
    if name not in _FACTORIES:
        raise ValueError(f"Unknown scheduler type {name!r}; valid: {VALID_LR_SCHEDULES}")
    return _FACTORIES[name](**params)


class LRSchedulerShim:
    """Imperative facade over a functional schedule, for reference API parity
    (``lr_scheduler.step()``, ``get_last_lr()``)."""

    def __init__(self, schedule: Schedule, engine=None):
        self.schedule = schedule
        self._step = 0

    def step(self, increment: int = 1) -> None:
        self._step += increment

    def get_last_lr(self):
        return [float(self.schedule(self._step))]

    def state_dict(self):
        return {"step": self._step}

    def load_state_dict(self, sd):
        self._step = sd["step"]
