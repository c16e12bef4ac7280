"""Adagrad, PyTorch port of the config path ``"optimizer": {"type":
"Adagrad"}`` (and its alias ``DeepSpeedCPUAdagrad``).

The JAX package's ``build_optimizer`` makes ``optax.adagrad(lr,
eps=params.get("eps", 1e-10))`` for both names, with optax's
``initial_accumulator_value`` of 0.1 and no weight decay; no Pallas kernel.
Here the same formulas in foreach torch ops over fp32 grads:

    s = g * g + s;   u = where(s > 0, rsqrt(s + eps), 0) * g;   p += -lr u

with ``lr`` a constant or the schedule at the 0-based count.  State: the
fp32 sum of squares (starting at 0.1), in a checkpoint optax's chain
``(ScaleByRssState(sum_of_squares), lr)``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Union

import torch

from deepspeed_tpu_torch.ops.optax_states import ScaleByRssState, lr_state
from deepspeed_tpu_torch.ops.plain_optimizer import PlainOptimizer, apply_updates


class Adagrad(PlainOptimizer):
    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable] = 1e-2, eps: float = 1e-10,
                 initial_accumulator_value: float = 0.1):
        super().__init__(params, lr, dict(
            eps=eps, initial_accumulator_value=initial_accumulator_value))

    def _sums(self, params=None):
        init = self.defaults["initial_accumulator_value"]
        return self._states("sum_of_squares", lambda p: torch.full_like(
            p, init, dtype=torch.float32), params)

    def _update(self, group, params, grads, lr):
        sums = self._sums(params)
        torch._foreach_add_(sums, torch._foreach_mul(grads, grads))
        u = []
        for s, g in zip(sums, grads):
            inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                              torch.zeros((), device=s.device))
            u.append(inv * g)
        torch._foreach_mul_(u, -lr)
        apply_updates(params, u)

    def jax_state(self, nest: Callable) -> Any:
        """``optax.adagrad``'s chain state over the live sums."""
        return (ScaleByRssState(nest(self._sums())),
                lr_state(self.schedule, self.count))


__all__ = ["Adagrad"]
