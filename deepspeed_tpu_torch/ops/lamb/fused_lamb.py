"""FusedLamb as a :class:`torch.optim.Optimizer`.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_lamb.py`` ``fused_lamb``
(an optax transformation there).  State: fp32 first and second moments per
parameter and one int step count for the whole optimizer.  Each
:meth:`FusedLamb.step` increments the count FIRST and evaluates a callable
``lr`` at the new, 1-based count (the JAX transformation's ``count =
state.count + 1; lr = learning_rate(count)``; FusedAdam and Adam8bit use
the 0-based count), then updates every leaf in place: on the card two
wrapper calls per leaf (:func:`~deepspeed_tpu_torch.ops.kernels.fused_lamb.
lamb_phase1`, three launches in all), as the JAX package issues two
``pallas_call`` per leaf.  The weight decay applies to every leaf, with no
mask, as in JAX.

``fused=False`` runs the plain fp32 formula of ``optax.lamb`` instead, what
the JAX package builds for ``Lamb`` and ``"torch_lamb": true``:
``scale_by_adam`` (moments divided by ``1 - b^t``), decayed weights, the
trust ratio, and the learning rate at the 0-based count.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.fused_lamb import fused_lamb_update


class FusedLamb(torch.optim.Optimizer):
    """LAMB with fp32 moments, updating the parameters in place.  ``lr`` is
    a float or a schedule ``count -> lr``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable] = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0, *,
                 fused: bool = True):
        self.schedule = lr if callable(lr) else None
        defaults = dict(lr=0.0 if callable(lr) else float(lr), betas=tuple(betas),
                        eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.fused = fused
        self.count = 0

    def current_lr(self, group) -> float:
        """The learning rate the next :meth:`step` applies: the schedule at
        the 1-based count when fused, at the 0-based one (optax) when not."""
        if not self.schedule:
            return group["lr"]
        return float(self.schedule(self.count + 1 if self.fused else self.count))

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence[torch.Tensor]] = None):
        """One update of every parameter.  ``grads`` (one tensor per
        parameter, in group order; fp32 or bf16) replaces ``p.grad``."""
        loss = closure() if closure is not None else None
        params = [p for g in self.param_groups for p in g["params"]]
        if grads is None:
            grads = [p.grad for p in params]
        if len(grads) != len(params):
            raise ValueError(f"FusedLamb.step: {len(grads)} grads for "
                             f"{len(params)} parameters")
        lrs = [self.current_lr(g) for g in self.param_groups]
        self.count += 1
        update = fused_lamb_update if self.fused else optax_lamb_update
        it = iter(grads)
        for group, lr in zip(self.param_groups, lrs):
            b1, b2 = group["betas"]
            for p in group["params"]:
                g = next(it)
                if g is None:
                    continue
                st = self.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                update(p, g, st["exp_avg"], st["exp_avg_sq"], self.count, lr=lr,
                       beta1=b1, beta2=b2, eps=group["eps"],
                       weight_decay=group["weight_decay"])
        return loss


def optax_lamb_update(param, grad, m, v, step: int, *, lr: float,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-6, weight_decay: float = 0.0) -> None:
    """``optax.lamb``'s update of one leaf in fp32, in place; ``step`` is
    the 1-based count, ``lr`` already the schedule's value."""
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** t)
    g = grad.float()
    p = param.float()
    m.copy_((1 - beta1) * g + beta1 * m)
    v.copy_((1 - beta2) * (g * g) + beta2 * v)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
    w_norm = torch.linalg.vector_norm(p)
    u_norm = torch.linalg.vector_norm(u)
    trust = torch.where((w_norm == 0) | (u_norm == 0), torch.ones_like(w_norm),
                        w_norm / u_norm)
    param.copy_(p + (u * trust) * -lr)
