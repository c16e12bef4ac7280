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

Over ZeRO shards (``sharded``: a parameter's process group, set by the
engine for each parameter that is a slice of its leaf) the two norms are
the leaf's: the slices' squares summed over the group before the trust
ratio.

``fused=False`` runs the plain fp32 formula of ``optax.lamb`` instead, what
the JAX package builds for ``Lamb`` and ``"torch_lamb": true``:
``scale_by_adam`` (moments divided by ``1 - b^t``), decayed weights, the
trust ratio, and the learning rate at the 0-based count.

:meth:`FusedLamb.jax_state` gives the state as the JAX package's
optimizer for the same config holds it in a checkpoint: ``FusedLambState``
(``.count``, ``.mu``, ``.nu``) when fused, else ``optax.lamb``'s chain
(``scale_by_adam``, decay, trust ratio, learning rate).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.fused_lamb import (fused_lamb_update, lamb_phase1,
                                                        lamb_scale)
from deepspeed_tpu_torch.ops.optax_states import (EMPTY, ScaleByAdamState,
                                                  count_leaf, lr_state)


class FusedLambState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


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
        self.sharded: Dict[int, Any] = {}    # id(param) -> its shards' group

    def current_lr(self, group) -> float:
        """The learning rate the next :meth:`step` applies: the schedule at
        the 1-based count when fused, at the 0-based one (optax) when not."""
        if not self.schedule:
            return group["lr"]
        return float(self.schedule(self.count + 1 if self.fused else self.count))

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
        mu = nest([st["exp_avg"] for st in sts])
        nu = nest([st["exp_avg_sq"] for st in sts])
        if self.fused:
            return FusedLambState(count_leaf(self.count), mu, nu)
        return (ScaleByAdamState(count_leaf(self.count), mu, nu), EMPTY, EMPTY,
                lr_state(self.schedule, self.count))

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
        it = iter(grads)
        for group, lr in zip(self.param_groups, lrs):
            b1, b2 = group["betas"]
            for p in group["params"]:
                g = next(it)
                if g is None:
                    continue
                st = self._state_of(p)
                args = (p, g, st["exp_avg"], st["exp_avg_sq"], self.count)
                kw = dict(beta1=b1, beta2=b2, eps=group["eps"],
                          weight_decay=group["weight_decay"])
                shards = self.sharded.get(id(p))
                if not self.fused:
                    optax_lamb_update(*args, lr=lr, norm_group=shards, **kw)
                elif shards is None:
                    fused_lamb_update(*args, lr=lr, **kw)
                else:
                    stats = _leaf_stats(lamb_phase1(*args, lr=lr, **kw), lr, shards)
                    lamb_scale(p, st["exp_avg"], st["exp_avg_sq"], stats,
                               self.count, **kw)
        return loss


def _leaf_norm(norm: torch.Tensor, group: Any) -> torch.Tensor:
    """A slice's norm into its leaf's: the squares summed over ``group``."""
    from deepspeed_tpu_torch.comm import comm

    return torch.sqrt(comm.all_reduce(norm.square(), group))


def _leaf_stats(stats: torch.Tensor, lr: float, group: Any) -> torch.Tensor:
    """Phase 1's (||p||, ||u||, lr * trust) of a slice made the leaf's."""
    from deepspeed_tpu_torch.comm import comm

    w, u = torch.sqrt(comm.all_reduce(stats[:2].square(), group)).unbind()
    trust = torch.where((w > 0) & (u > 0), w / u, torch.ones_like(w))
    return torch.stack([w, u, lr * trust])


def optax_lamb_update(param, grad, m, v, step: int, *, lr: float,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-6, weight_decay: float = 0.0,
                      norm_group: Any = None) -> None:
    """``optax.lamb``'s update of one leaf in fp32, in place; ``step`` is
    the 1-based count, ``lr`` already the schedule's value.  With
    ``norm_group`` the leaf is a slice and its norms are summed over the
    group."""
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
    if norm_group is not None:
        w_norm, u_norm = _leaf_norm(w_norm, norm_group), _leaf_norm(u_norm, norm_group)
    trust = torch.where((w_norm == 0) | (u_norm == 0), torch.ones_like(w_norm),
                        w_norm / u_norm)
    param.copy_(p + (u * trust) * -lr)
