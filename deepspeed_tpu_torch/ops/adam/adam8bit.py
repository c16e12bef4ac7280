"""Adam8bit: AdamW with 8-bit blockwise-quantized moments.

Counterpart of ``deepspeed_tpu/ops/adam/adam8bit.py`` (an optax-shaped
transformation there).  State per parameter of at least ``min_quant_size``
elements: ``m_q`` int8 ``[nb_pad, block]`` with ``m_scale`` fp32
``[nb_pad, 1]`` (signed absmax per row of ``block``), and ``v_q`` /
``v_scale`` likewise for sqrt(v) (v spans decades; sqrt halves its range).
Smaller parameters keep fp32 ``m_q`` = m and ``v_q`` = sqrt(v) of shape
``[n]``.  One int step count for the whole optimizer.

Each :meth:`Adam8bit.step` evaluates a callable ``lr`` at the 0-based count,
then updates every parameter in place with the 1-based count:

- a quantized leaf goes through one launch of the fused Adam8bit kernel on
  the card (``ops/kernels/fused_adam8bit.py``; its plain version on the
  CPU), in the kernel's bias-correction form ``m * (1 / (1 - b1^t))``;
- a small leaf runs the JAX package's jnp formula in plain torch on both
  devices, in its form ``(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.

A bf16 parameter is rounded stochastically (the JAX default,
``stochastic_rounding="auto"``), an fp32 one never: master-free bf16 training
(``bf16.master_weights: false``) keeps its sub-ulp updates in expectation.
Leaf ``i`` (in the engine's sorted-path order) at 1-based count ``t`` takes
the noise seed ``t * 1000003 + i * 7919`` (int32, wrapping), as the JAX
optimizer seeds its kernel.  ``updates_are_new_params`` is kept for API
parity with the JAX transformation (whose engine branches on it).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.fused_adam8bit import (
    check_block, fused_adam8bit_update, sr_seed, state_rows,
    stochastic_round_bf16)


class Adam8bit(torch.optim.Optimizer):
    """AdamW (decoupled weight decay) over int8 blockwise moments, updating
    the parameters in place.  ``lr`` is a float or a schedule
    ``count -> lr``."""

    updates_are_new_params = True

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable] = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 block_size: int = 512, min_quant_size: int = 4096):
        check_block(block_size)
        self.schedule = lr if callable(lr) else None
        defaults = dict(lr=0.0 if callable(lr) else float(lr), betas=tuple(betas),
                        eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.block = block_size
        self.min_quant_size = min_quant_size
        self.count = 0

    def current_lr(self, group) -> float:
        """The learning rate the next :meth:`step` applies."""
        return float(self.schedule(self.count)) if self.schedule else group["lr"]

    def quantized(self, p: torch.Tensor) -> bool:
        return p.numel() >= self.min_quant_size

    def _init_state(self, p: torch.Tensor) -> dict:
        if not self.quantized(p):
            zeros = lambda: torch.zeros(p.numel(), device=p.device,
                                        dtype=torch.float32)
            return {"m_q": zeros(), "v_q": zeros()}
        rows = state_rows(p.numel(), self.block)
        codes = lambda: torch.zeros(rows, self.block, device=p.device,
                                    dtype=torch.int8)
        ones = lambda: torch.ones(rows, 1, device=p.device, dtype=torch.float32)
        return {"m_q": codes(), "m_scale": ones(), "v_q": codes(),
                "v_scale": ones()}

    def state_bytes(self) -> int:
        """Bytes of optimizer state held on the device (codes, scales and
        the small leaves' fp32 moments)."""
        return sum(t.numel() * t.element_size() for st in self.state.values()
                   for t in st.values())

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence[torch.Tensor]] = None):
        """One update of every parameter.  ``grads`` (one tensor per
        parameter, in group order; fp32 or bf16) replaces ``p.grad``."""
        loss = closure() if closure is not None else None
        params = [p for g in self.param_groups for p in g["params"]]
        if grads is None:
            grads = [p.grad for p in params]
        if len(grads) != len(params):
            raise ValueError(f"Adam8bit.step: {len(grads)} grads for "
                             f"{len(params)} parameters")
        leaves = [(group, lr, p) for group, lr in
                  zip(self.param_groups, [self.current_lr(g) for g in
                                          self.param_groups])
                  for p in group["params"]]
        self.count += 1
        t = self.count
        for leaf, ((group, lr, p), g) in enumerate(zip(leaves, grads)):
            if g is None:
                continue
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            st = self.state[p]
            if not st:
                st.update(self._init_state(p))
            sr = p.dtype == torch.bfloat16
            seed = sr_seed(t, leaf)
            if self.quantized(p):
                fused_adam8bit_update(
                    p, g, st["m_q"], st["m_scale"], st["v_q"], st["v_scale"],
                    t, lr=lr, beta1=b1, beta2=b2, eps=eps, weight_decay=wd,
                    seed=seed, sr=sr)
            else:
                _small_leaf_update(p, g, st, t, lr=lr, b1=b1, b2=b2, eps=eps,
                                   wd=wd, seed=seed, sr=sr)
        return loss


def _small_leaf_update(p, g, st, count: int, *, lr, b1, b2, eps, wd, seed,
                       sr) -> None:
    """The JAX package's jnp formula for a leaf under ``min_quant_size``
    (``adam8bit.py:165-179``), in place; fp32 m and sqrt(v)."""
    t = np.float32(count)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)
    g32 = g.float().reshape(-1)
    m = b1 * st["m_q"] + (1.0 - b1) * g32
    v = b2 * (st["v_q"] * st["v_q"]) + (1.0 - b2) * g32 * g32
    direction = (m / c1) / (torch.sqrt(v / c2) + eps)
    p32 = p.float()
    new32 = p32 - lr * (direction.view(p.shape) + wd * p32)
    st["m_q"].copy_(m)
    st["v_q"].copy_(torch.sqrt(v))
    p.copy_(stochastic_round_bf16(new32, seed) if sr else new32)
