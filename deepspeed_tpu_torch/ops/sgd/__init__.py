"""SGD, PyTorch port of the config path ``"optimizer": {"type": "SGD"}``.

The JAX package's ``build_optimizer`` makes ``optax.sgd(lr,
momentum=params.get("momentum", 0.0), nesterov=params.get("nesterov",
False))`` for it, with no weight decay; no Pallas kernel.  A momentum of
0.0 is not optax's ``None``, so the trace is always kept.  Here the same
formulas in foreach torch ops over fp32 grads:

    t = g + momentum t;   u = g + momentum t if nesterov else t;   p += -lr u

with ``lr`` a constant or the schedule at the 0-based count.  State: the
fp32 trace, in a checkpoint optax's chain ``(TraceState(trace), lr)``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Union

import torch

from deepspeed_tpu_torch.ops.optax_states import TraceState, lr_state
from deepspeed_tpu_torch.ops.plain_optimizer import (PlainOptimizer, apply_updates,
                                                     zeros_f32)


class SGD(PlainOptimizer):
    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable] = 1e-3, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, lr, dict(momentum=momentum, nesterov=nesterov))

    def _update(self, group, params, grads, lr):
        mom = group["momentum"]
        traces = self._states("trace", zeros_f32, params)
        new = torch._foreach_mul(traces, mom)
        torch._foreach_add_(new, grads)            # g + momentum t
        torch._foreach_copy_(traces, new)
        if group["nesterov"]:
            u = torch._foreach_mul(new, mom)
            torch._foreach_add_(u, grads)
        else:
            u = new
        torch._foreach_mul_(u, -lr)
        apply_updates(params, u)

    def jax_state(self, nest: Callable) -> Any:
        """``optax.sgd``'s chain state over the live traces."""
        return (TraceState(nest(self._states("trace", zeros_f32))),
                lr_state(self.schedule, self.count))


__all__ = ["SGD"]
