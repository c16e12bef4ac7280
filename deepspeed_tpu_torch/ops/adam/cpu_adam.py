"""DeepSpeedCPUAdam: the host Adam step over offloaded fp32 states.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py``: the optimizer the
engine steps when ``zero_optimization.offload_optimizer`` is on.  States
are CPU torch tensors; the C++ kernels of ``csrc/cpu_adam.cpp`` (built by
:class:`~deepspeed_tpu_torch.ops.op_builder.CPUAdamBuilder`) do the math
through the tensors' ``data_ptr()``, each step split into contiguous
chunks over a thread pool (ctypes drops the GIL for the call).  The update
is elementwise, so the chunking never changes a bit.  There is no fallback:
if the library does not build, the constructor raises.

:func:`adam_step_plain` is the same update in plain torch (the JAX class's
numpy step); only the tests use it.

This module also holds what the three host steppers share: the thread
pool (:func:`run_chunked`) and the argument checks (:func:`host_flat`).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import torch

from deepspeed_tpu_torch.ops.op_builder import CPUAdamBuilder

_MIN_CHUNK = 1 << 16
_POOL: Optional[ThreadPoolExecutor] = None


def host_pool() -> ThreadPoolExecutor:
    """The process-wide pool of the host steppers: one worker a core, at
    most 16, as the JAX class sizes its pool."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1),
                                   thread_name_prefix="ds_cpu_optim")
    return _POOL


def run_chunked(pool: ThreadPoolExecutor, n: int,
                fn: Callable[[int, int], None]) -> None:
    """``fn(lo, hi)`` over ``[0, n)`` in one contiguous chunk a worker
    (one call on the caller's thread for a small span)."""
    workers = pool._max_workers
    if n <= _MIN_CHUNK or workers == 1:
        fn(0, n)
        return
    chunk = (n + workers - 1) // workers
    futs = [pool.submit(fn, lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
    for f in futs:
        f.result()


def host_flat(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    """``t`` as a flat view for a C kernel that reads it through a raw
    pointer: a contiguous CPU tensor of ``dtype``, or an error."""
    if t.device.type != "cpu" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: the host kernels need a contiguous CPU "
                         f"{dtype} tensor, got {t.dtype} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    return t.view(-1)


def _addr(t: torch.Tensor, lo: int) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() + t.element_size() * lo)


def adam_step_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, step: int, lr: float, betas=(0.9, 0.999),
                    eps: float = 1e-8, weight_decay: float = 0.0,
                    adamw_mode: bool = True) -> None:
    """The host Adam update in plain fp32 torch, in place (the JAX class's
    ``_numpy_step``)."""
    b1, b2 = betas
    if adamw_mode:
        p.mul_(1.0 - lr * weight_decay)
    elif weight_decay:
        g = g + weight_decay * p
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g.square())
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    p.sub_((lr / bc1) * m / (v.sqrt() / bc2 ** 0.5 + eps))


class DeepSpeedCPUAdam:
    """Adam/AdamW over a list of host fp32 tensors (one 'param group')."""

    def __init__(self, params: Optional[List[torch.Tensor]] = None,
                 lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 adamw_mode: bool = True):
        if amsgrad:
            raise NotImplementedError("amsgrad not supported (reference parity)")
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self.state: Dict[int, Dict[str, torch.Tensor]] = {}
        self.params = [host_flat(p, torch.float32, "param").view(p.shape)
                       for p in (params or [])]
        self._native = CPUAdamBuilder().load()
        self._pool = host_pool()

    def _args(self, step: int):
        b1, b2 = self.betas
        return (ctypes.c_int64(step), ctypes.c_float(self.lr), ctypes.c_float(b1),
                ctypes.c_float(b2), ctypes.c_float(self.eps),
                ctypes.c_float(self.weight_decay), ctypes.c_int(int(self.adamw_mode)))

    def native_step(self, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, step: int) -> None:
        """``ds_adam_step`` over flat fp32 ``p``, ``g``, ``m``, ``v``."""
        p, g, m, v = (host_flat(t, torch.float32, n)
                      for t, n in ((p, "param"), (g, "grad"), (m, "exp_avg"),
                                   (v, "exp_avg_sq")))
        tail = self._args(step)
        fn = self._native.ds_adam_step

        def run(lo, hi):
            fn(ctypes.c_int64(hi - lo), _addr(p, lo), _addr(g, lo), _addr(m, lo),
               _addr(v, lo), *tail)

        run_chunked(self._pool, p.numel(), run)

    def native_step_bf16g(self, p: torch.Tensor, g_bf16: torch.Tensor,
                          out_bf16: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, step: int) -> None:
        """``ds_adam_step_bf16g``: bf16 grads in, the fp32 master and
        moments stepped, the new params written in bf16 (round to nearest
        even) into ``out_bf16``."""
        p, m, v = (host_flat(t, torch.float32, n)
                   for t, n in ((p, "param"), (m, "exp_avg"), (v, "exp_avg_sq")))
        g = host_flat(g_bf16, torch.bfloat16, "bf16 grad")
        out = host_flat(out_bf16, torch.bfloat16, "bf16 out")
        tail = self._args(step)
        fn = self._native.ds_adam_step_bf16g

        def run(lo, hi):
            fn(ctypes.c_int64(hi - lo), _addr(p, lo), _addr(g, lo), _addr(out, lo),
               _addr(m, lo), _addr(v, lo), *tail)

        run_chunked(self._pool, p.numel(), run)

    def step_flat(self, p, g, aux: List[torch.Tensor], step: int) -> None:
        """One leaf: ``aux`` is ``[exp_avg, exp_avg_sq]``."""
        self.native_step(p, g, aux[0], aux[1], step)

    def step(self, grads: Optional[List[torch.Tensor]] = None,
             lr: Optional[float] = None) -> List[torch.Tensor]:
        """In-place update of ``self.params`` from matching grads."""
        if lr is not None:
            self.lr = lr
        if grads is None:
            raise ValueError("pass grads=[...] matching params")
        self.step_count += 1
        for i, (p, g) in enumerate(zip(self.params, grads)):
            st = self.state.setdefault(i, {"exp_avg": torch.zeros_like(p),
                                           "exp_avg_sq": torch.zeros_like(p)})
            g = torch.as_tensor(g).to(torch.float32).contiguous().view(-1)
            self.native_step(p.view(-1), g, st["exp_avg"].view(-1),
                             st["exp_avg_sq"].view(-1), self.step_count)
        return self.params
