"""Adagrad, PyTorch port of the config path ``"optimizer": {"type":
"Adagrad"}`` (and of the type name ``DeepSpeedCPUAdagrad`` without
offload), and the host stepper :class:`DeepSpeedCPUAdagrad`.

Two different things carry the name, as in the JAX package: the config
TYPE ``DeepSpeedCPUAdagrad`` builds the device optimizer :class:`Adagrad`
below unless ``zero_optimization.offload_optimizer`` is on; the CLASS
:class:`DeepSpeedCPUAdagrad` is the host stepper of the offload path
(``deepspeed_tpu/ops/adagrad/__init__.py``), the C++ ``ds_adagrad_step``
over CPU tensors, with another formula (sums start at 0, weight decay
added to the gradient).

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

import ctypes
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from deepspeed_tpu_torch.ops.adam.cpu_adam import host_flat, host_pool, run_chunked
from deepspeed_tpu_torch.ops.op_builder import CPUAdamBuilder
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


def adagrad_step_plain(p: torch.Tensor, g: torch.Tensor, sq: torch.Tensor,
                       lr: float, eps: float = 1e-10,
                       weight_decay: float = 0.0) -> None:
    """The host Adagrad update in plain fp32 torch, in place (the JAX
    class's ``_numpy_step``)."""
    if weight_decay:
        g = g + weight_decay * p
    sq.add_(g * g)
    p.sub_(lr * g / (sq.sqrt() + eps))


class DeepSpeedCPUAdagrad:
    """The host Adagrad stepper of the offload path (the JAX package's
    ``DeepSpeedCPUAdagrad``): ``ds_adagrad_step`` over host fp32 tensors,
    chunked over the host pool.  Raises if the library does not build."""

    def __init__(self, params: Optional[List[torch.Tensor]] = None,
                 lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.step_count = 0
        self.params = [host_flat(p, torch.float32, "param").view(p.shape)
                       for p in (params or [])]
        self.state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._native = CPUAdamBuilder().load()
        self._pool = host_pool()

    def native_step(self, p: torch.Tensor, g: torch.Tensor,
                    sq: torch.Tensor) -> None:
        """``ds_adagrad_step`` over flat fp32 ``p``, ``g`` and the sum of
        squares ``sq``."""
        p, g, sq = (host_flat(t, torch.float32, n)
                    for t, n in ((p, "param"), (g, "grad"), (sq, "exp_avg_sq")))
        es = p.element_size()
        fn = self._native.ds_adagrad_step
        tail = (ctypes.c_float(self.lr), ctypes.c_float(self.eps),
                ctypes.c_float(self.weight_decay))

        def run(lo, hi):
            fn(ctypes.c_int64(hi - lo), ctypes.c_void_p(p.data_ptr() + es * lo),
               ctypes.c_void_p(g.data_ptr() + es * lo),
               ctypes.c_void_p(sq.data_ptr() + es * lo), *tail)

        run_chunked(self._pool, p.numel(), run)

    def step_flat(self, p, g, aux: List[torch.Tensor], step: int) -> None:
        """One leaf: ``aux`` is ``[exp_avg_sq]``; Adagrad reads no count."""
        self.native_step(p, g, aux[0])

    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        self.step_count += 1
        for i, p in enumerate(self.params):
            st = self.state.setdefault(i, {"exp_avg_sq": torch.zeros_like(p)})
            g = torch.as_tensor(grads[i]).to(torch.float32).contiguous().view(-1)
            self.native_step(p.view(-1), g, st["exp_avg_sq"].view(-1))


__all__ = ["Adagrad", "DeepSpeedCPUAdagrad", "adagrad_step_plain"]
