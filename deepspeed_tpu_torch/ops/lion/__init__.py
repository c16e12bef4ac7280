"""Lion, PyTorch port of the config path ``"optimizer": {"type": "Lion"}``.

The JAX package's ``build_optimizer`` makes ``optax.lion(lr, b1, b2,
weight_decay)`` for it (betas default (0.9, 0.99), weight decay from the
config, default 0); no Pallas kernel.  Here the same formulas in foreach
torch ops over fp32 grads:

    c = (1 - b1) g + b1 m;   u = sign(c) + wd p;   p += -lr u
    m = (1 - b2) g + b2 m

with ``lr`` a constant or the schedule at the 0-based count.  State: the
fp32 moment ``mu`` and the count, in a checkpoint optax's chain
``(ScaleByLionState(count, mu), EmptyState, lr)``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Union

import torch

from deepspeed_tpu_torch.ops.optax_states import (EMPTY, ScaleByLionState,
                                                  count_leaf, lr_state)
from deepspeed_tpu_torch.ops.plain_optimizer import (PlainOptimizer, apply_updates,
                                                     zeros_f32)


class Lion(PlainOptimizer):
    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable] = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, lr, dict(betas=tuple(betas),
                                          weight_decay=weight_decay))

    def _update(self, group, params, grads, lr):
        b1, b2 = group["betas"]
        mus = self._states("exp_avg", zeros_f32, params)
        c = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(c, torch._foreach_mul(mus, b1))
        u = torch._foreach_sign(c)
        if group["weight_decay"]:
            torch._foreach_add_(u, torch._foreach_mul(
                [p.float() for p in params], group["weight_decay"]))
        torch._foreach_mul_(u, -lr)
        new_mu = torch._foreach_mul(grads, 1.0 - b2)
        torch._foreach_add_(new_mu, torch._foreach_mul(mus, b2))
        torch._foreach_copy_(mus, new_mu)
        apply_updates(params, u)

    def jax_state(self, nest: Callable) -> Any:
        """``optax.lion``'s chain state over the live moments."""
        return (ScaleByLionState(count_leaf(self.count), nest(self._states("exp_avg", zeros_f32))),
                EMPTY, lr_state(self.schedule, self.count))


__all__ = ["Lion"]
