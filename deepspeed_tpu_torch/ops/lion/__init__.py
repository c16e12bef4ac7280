"""Lion, PyTorch port of the config path ``"optimizer": {"type": "Lion"}``,
and the host stepper :class:`DeepSpeedCPULion` of the offload path.

The JAX package's ``build_optimizer`` makes ``optax.lion(lr, b1, b2,
weight_decay)`` for it (betas default (0.9, 0.99), weight decay from the
config, default 0); no Pallas kernel.  Here the same formulas in foreach
torch ops over fp32 grads:

    c = (1 - b1) g + b1 m;   u = sign(c) + wd p;   p += -lr u
    m = (1 - b2) g + b2 m

with ``lr`` a constant or the schedule at the 0-based count.  State: the
fp32 moment ``mu`` and the count, in a checkpoint optax's chain
``(ScaleByLionState(count, mu), EmptyState, lr)``.

:class:`DeepSpeedCPULion` is the JAX package's host stepper
(``deepspeed_tpu/ops/lion/__init__.py``): the C++ ``ds_lion_step`` over
CPU fp32 tensors, which the engine steps under ``zero_optimization.
offload_optimizer``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from deepspeed_tpu_torch.ops.adam.cpu_adam import host_flat, host_pool, run_chunked
from deepspeed_tpu_torch.ops.op_builder import CPUAdamBuilder
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


def lion_step_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    lr: float, betas=(0.9, 0.99),
                    weight_decay: float = 0.0) -> None:
    """The host Lion update in plain fp32 torch, in place (the JAX class's
    ``_numpy_step``)."""
    b1, b2 = betas
    update = torch.sign(b1 * m + (1 - b1) * g)
    if weight_decay:
        update = update + weight_decay * p
    p.sub_(lr * update)
    m.mul_(b2).add_((1 - b2) * g)


class DeepSpeedCPULion:
    """The host Lion stepper of the offload path: ``ds_lion_step`` over
    host fp32 tensors, chunked over the host pool.  Raises if the library
    does not build."""

    def __init__(self, params: Optional[List[torch.Tensor]] = None,
                 lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        self.lr = lr
        self.betas = tuple(betas)
        self.weight_decay = weight_decay
        self.step_count = 0
        self.params = [host_flat(p, torch.float32, "param").view(p.shape)
                       for p in (params or [])]
        self.state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._native = CPUAdamBuilder().load()
        self._pool = host_pool()

    def native_step(self, p: torch.Tensor, g: torch.Tensor,
                    m: torch.Tensor) -> None:
        """``ds_lion_step`` over flat fp32 ``p``, ``g`` and the moment ``m``."""
        p, g, m = (host_flat(t, torch.float32, n)
                   for t, n in ((p, "param"), (g, "grad"), (m, "exp_avg")))
        es = p.element_size()
        b1, b2 = self.betas
        fn = self._native.ds_lion_step
        tail = (ctypes.c_float(self.lr), ctypes.c_float(b1), ctypes.c_float(b2),
                ctypes.c_float(self.weight_decay))

        def run(lo, hi):
            fn(ctypes.c_int64(hi - lo), ctypes.c_void_p(p.data_ptr() + es * lo),
               ctypes.c_void_p(g.data_ptr() + es * lo),
               ctypes.c_void_p(m.data_ptr() + es * lo), *tail)

        run_chunked(self._pool, p.numel(), run)

    def step_flat(self, p, g, aux: List[torch.Tensor], step: int) -> None:
        """One leaf: ``aux`` is ``[exp_avg]``; Lion reads no count."""
        self.native_step(p, g, aux[0])

    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        self.step_count += 1
        for i, p in enumerate(self.params):
            st = self.state.setdefault(i, {"exp_avg": torch.zeros_like(p)})
            g = torch.as_tensor(grads[i]).to(torch.float32).contiguous().view(-1)
            self.native_step(p.view(-1), g, st["exp_avg"].view(-1))


__all__ = ["Lion", "DeepSpeedCPULion", "lion_step_plain"]
