"""The shared frame of the port's plain optimizers (Lion, Adagrad, SGD,
Muon): the optax transformations that the JAX package's
``build_optimizer`` makes for them have no Pallas kernel, so the port
writes each from its formulas as a :class:`torch.optim.Optimizer` over the
engine's masters, in foreach torch ops.

:class:`PlainOptimizer` keeps one step count for the whole optimizer and
takes a float learning rate or a schedule ``count -> lr`` evaluated at the
0-based count before the count moves (optax's ``scale_by_schedule``).
:meth:`PlainOptimizer.step` takes the gradients as a list (the engine's
accumulators, any float dtype) or from ``p.grad``, and hands each param
group's fp32 gradients to the subclass's ``_update``.  ``jax_state(nest)``
gives the state in the JAX optimizer's checkpoint layout
(:mod:`deepspeed_tpu_torch.ops.optax_states`).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Union

import torch


class PlainOptimizer(torch.optim.Optimizer):
    """Base of the plain optimizers; subclasses define ``_update(group,
    params, grads, lr)`` over one group's parameters and fp32 grads."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable], defaults: dict):
        self.schedule = lr if callable(lr) else None
        super().__init__(params, dict(defaults,
                                      lr=0.0 if callable(lr) else float(lr)))
        self.count = 0

    def current_lr(self, group) -> float:
        """The learning rate the next :meth:`step` applies."""
        return float(self.schedule(self.count)) if self.schedule else group["lr"]

    def all_params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def _update(self, group: dict, params: List[torch.Tensor],
                grads: List[torch.Tensor], lr: float) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence[torch.Tensor]] = None):
        """One update of every parameter.  ``grads`` (one tensor per
        parameter, in group order) replaces ``p.grad``."""
        loss = closure() if closure is not None else None
        params = self.all_params()
        if grads is None:
            grads = [p.grad for p in params]
        if len(grads) != len(params):
            raise ValueError(f"{type(self).__name__}.step: {len(grads)} grads "
                             f"for {len(params)} parameters")
        lrs = [self.current_lr(g) for g in self.param_groups]
        self.count += 1
        it = iter(grads)
        for group, lr in zip(self.param_groups, lrs):
            pairs = [(p, g) for p, g in zip(group["params"], it) if g is not None]
            if pairs:
                self._update(group, [p for p, _ in pairs],
                             [g.float() for _, g in pairs], lr)
        return loss

    def _states(self, name: str, init,
                params: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
        """The state tensor ``name`` of each of ``params`` (default: every
        parameter), made by ``init(p)`` at first use."""
        out = []
        for p in self.all_params() if params is None else params:
            st = self.state[p]
            if name not in st:
                st[name] = init(p)
            out.append(st[name])
        return out

    def state_bytes(self) -> int:
        """Bytes of optimizer state held on the device."""
        return sum(t.numel() * t.element_size() for st in self.state.values()
                   for t in st.values() if torch.is_tensor(t))


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def apply_updates(params: List[torch.Tensor], updates: List[torch.Tensor]) -> None:
    """``optax.apply_updates``: ``p + u`` in fp32, rounded to p's dtype, in
    place."""
    for p, u in zip(params, updates):
        if p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_(p.float() + u)
