"""Dynamic and static loss scaling (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The same transition as the JAX package: the loss is scaled before the
backward; a step whose gradients hold an inf or a NaN is skipped and, for a
dynamic scale, counts against ``hysteresis`` (the scale halves, never
below ``min_loss_scale``, once the tolerated overflows are spent); after
``loss_scale_window`` clean steps in a row the scale doubles.  A static
scale (``loss_scale > 0``) only counts skips.

The JAX state lives on the device inside the jitted step.  The port's
engine reads the overflow flag on the host once an optimizer step (its
optimizer count is a host int), so the state is a host record: the scale
an fp32 0-dim CPU tensor, whose halving, doubling and floor round in fp32
exactly as the JAX ``jnp.float32`` arithmetic does, and the trackers and
the skip count Python ints.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class LossScaleState:
    scale: torch.Tensor        # fp32 0-dim (CPU), the current loss scale
    growth_tracker: int        # consecutive overflow-free steps
    hysteresis_tracker: int    # overflows still tolerated before a shrink
    skipped_steps: int         # total skipped steps (reporting)


def _state(scale: float, hysteresis: int) -> LossScaleState:
    return LossScaleState(torch.tensor(scale, dtype=torch.float32), 0,
                          int(hysteresis), 0)


def make_state(config) -> LossScaleState:
    """Initial state from an ``FP16Config``: static at ``loss_scale`` when
    it is nonzero, else dynamic from ``2 ** initial_scale_power``; scale 1
    when fp16 is off."""
    if config is not None and config.enabled:
        init = (config.loss_scale if config.loss_scale > 0
                else float(2 ** config.initial_scale_power))
        return _state(init, config.hysteresis)
    return _state(1.0, 1)


def to_leaves(state: LossScaleState):
    """The state as a checkpoint holds it, ``['scaler'][0..3]``: the scale
    fp32, the two trackers and the skip count int32 (the JAX
    ``LossScaleState``'s fields in order)."""
    return (state.scale.clone(),
            *(torch.tensor(int(x), dtype=torch.int32)
              for x in (state.growth_tracker, state.hysteresis_tracker,
                        state.skipped_steps)))


def from_leaves(leaves) -> LossScaleState:
    """Inverse of :func:`to_leaves`, from the four loaded scalars."""
    scale, growth, hyst, skipped = leaves
    return LossScaleState(torch.as_tensor(scale, dtype=torch.float32).reshape(()).clone(),
                          int(growth), int(hyst), int(skipped))


def update(state: LossScaleState, overflow: bool, *, dynamic: bool,
           loss_scale_window: int, min_loss_scale: float, hysteresis: int,
           consecutive_hysteresis: bool = False) -> LossScaleState:
    """One scaler transition given this step's overflow flag."""
    overflow = bool(overflow)
    skipped = state.skipped_steps + int(overflow)
    if not dynamic:
        return replace(state, skipped_steps=skipped)
    ht = state.hysteresis_tracker - 1 if overflow else state.hysteresis_tracker
    scale = state.scale
    if overflow and ht <= 0:
        scale = torch.maximum(scale / 2.0, torch.tensor(min_loss_scale,
                                                        dtype=torch.float32))
        ht = int(hysteresis)
    growth = 0 if overflow else state.growth_tracker + 1
    if growth >= loss_scale_window:
        scale = scale * 2.0
        growth = 0
    if consecutive_hysteresis and not overflow:
        ht = int(hysteresis)
    return LossScaleState(scale, growth, ht, skipped)


class DynamicLossScaler:
    """Imperative shim for reference API parity (``cur_scale``)."""

    def __init__(self, init_scale=2**16, scale_window=1000, min_scale=1.0,
                 hysteresis=2):
        self.state = _state(float(init_scale), hysteresis)
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.hysteresis = hysteresis

    @property
    def cur_scale(self) -> float:
        return float(self.state.scale)

    def update_scale(self, overflow: bool) -> None:
        self.state = update(self.state, overflow, dynamic=True,
                            loss_scale_window=self.scale_window,
                            min_loss_scale=self.min_scale,
                            hysteresis=self.hysteresis)
