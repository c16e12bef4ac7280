"""FusedAdam as a :class:`torch.optim.Optimizer` over fp32 master weights.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py`` (an optax
transformation there).  State: fp32 first and second moments per
parameter and one int step count for the whole optimizer, as the JAX
``FusedAdamState``.  Each :meth:`FusedAdam.step` evaluates a callable
``lr`` at the 0-based count before incrementing it (``optax.
scale_by_schedule`` semantics), then updates every parameter leaf in
place with the 1-based count: one launch of the fused Adam kernel per leaf
on the card, as the JAX package issues one ``pallas_call`` per leaf.
``fused=False`` runs the plain fp32 version of the same update instead —
what the JAX package's ``optax.adamw`` computes for ``Adam``/``AdamW`` and
``"torch_adam": true``.

:meth:`FusedAdam.jax_state` gives the state as the JAX package's
optimizer for the same config holds it in a checkpoint
(``ops/optax_states.py``): ``FusedAdamState`` when fused, else
``optax.adamw``'s chain, or under ``adam_w_mode=False`` the chain the JAX
package's ``build_optimizer`` makes, ``optax.chain(add_decayed_weights or
identity, optax.adam)``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, NamedTuple, Optional, Sequence, Union

import torch

from deepspeed_tpu_torch.ops.kernels.fused_adam import (fused_adam_update,
                                                        fused_adam_update_plain)
from deepspeed_tpu_torch.ops.optax_states import (EMPTY, ScaleByAdamState,
                                                  count_leaf, lr_state)


class FusedAdamState(NamedTuple):
    count: Any
    m: Any
    v: Any


class FusedAdam(torch.optim.Optimizer):
    """Adam / AdamW (``adam_w_mode``) with fp32 moments, updating the
    parameters in place.  ``lr`` is a float or a schedule ``count -> lr``.
    ``bias_correction=False`` is accepted and changes nothing, as in the
    JAX class: the update always corrects."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable] = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 set_grad_none: bool = True, *, fused: bool = True):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad (reference parity)")
        # bias_correction is accepted and ignored: the JAX class always
        # corrects (deepspeed_tpu/ops/adam/fused_adam.py)
        self.schedule = lr if callable(lr) else None
        defaults = dict(lr=0.0 if callable(lr) else float(lr), betas=tuple(betas),
                        eps=eps, weight_decay=weight_decay, adam_w_mode=adam_w_mode)
        super().__init__(params, defaults)
        self.fused = fused
        self.count = 0

    def current_lr(self, group) -> float:
        """The learning rate the next :meth:`step` applies."""
        return float(self.schedule(self.count)) if self.schedule else group["lr"]

    def _state_of(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
        return st

    def jax_state(self, nest: Callable) -> Any:
        """The state in the JAX optimizer's layout, over the live moment
        tensors; ``nest`` maps the per-parameter list onto the params'
        tree."""
        params = [p for g in self.param_groups for p in g["params"]]
        sts = [self._state_of(p) for p in params]
        m = nest([st["exp_avg"] for st in sts])
        v = nest([st["exp_avg_sq"] for st in sts])
        if self.fused:
            return FusedAdamState(count_leaf(self.count), m, v)
        adam = ScaleByAdamState(count_leaf(self.count), m, v)
        lr = lr_state(self.schedule, self.count)
        if self.param_groups[0]["adam_w_mode"]:
            return (adam, EMPTY, lr)     # scale_by_adam, decay, lr
        return (EMPTY, (adam, lr))       # decay or identity, optax.adam

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence[torch.Tensor]] = None):
        """One update of every parameter.  ``grads`` (one tensor per
        parameter, in group order; any float dtype) replaces ``p.grad`` —
        the engine passes its accumulators, whose dtype may differ from the
        parameters'."""
        loss = closure() if closure is not None else None
        params = [p for g in self.param_groups for p in g["params"]]
        if grads is None:
            grads = [p.grad for p in params]
        if len(grads) != len(params):
            raise ValueError(f"FusedAdam.step: {len(grads)} grads for "
                             f"{len(params)} parameters")
        lrs = [self.current_lr(g) for g in self.param_groups]
        self.count += 1
        update = fused_adam_update if self.fused else fused_adam_update_plain
        it = iter(grads)
        for group, lr in zip(self.param_groups, lrs):
            b1, b2 = group["betas"]
            for p in group["params"]:
                g = next(it)
                if g is None:
                    continue
                st = self._state_of(p)
                update(p, g, st["exp_avg"], st["exp_avg_sq"], self.count, lr=lr,
                       beta1=b1, beta2=b2, eps=group["eps"],
                       weight_decay=group["weight_decay"],
                       adam_w_mode=group["adam_w_mode"])
        return loss
