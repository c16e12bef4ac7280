"""Muon, PyTorch port of ``deepspeed_tpu/ops/adam/muon.py`` (the config
path ``"optimizer": {"type": "Muon"}``).

Momentum with an orthogonalized update: per leaf, in fp32,

    buf = momentum buf + g;   eff = g + momentum buf (Nesterov) or buf
    o = NS5(eff) * sqrt(max(1, m / n))   for a 2-D [m, n] or 3-D [L, m, n]
        leaf whose path the exclusion does not match; else o = eff
    p += -lr (o + wd p)

with ``lr`` a constant or the schedule at the 0-based count.  NS5 is five
quintic Newton-Schulz steps (``x / (||x||_F + 1e-7)``, then ``a = x xᵀ``,
``x = A x + (B a + C a a) x``) on the matrix, transposed first when m > n;
a stacked ``[L, m, n]`` leaf is taken per layer as one batched product.
Leaves of any other rank (MoE's ``[L, E, D, F]``, the norm vectors) keep
the momentum update, and so do leaves whose path matches
``embed|head|tok|wte|wpe`` (case-insensitive), the path being
``jax.tree_util.keystr`` of the leaf in the params tree (``"['layers']
['attn']['wq']"``): the engine passes the names; without names nothing is
excluded.  A norm scale stacked ``[L, D]`` is 2-D, so it is
orthogonalized, as in the JAX package.

The JAX package computes the Newton-Schulz products outside any Pallas
kernel, so here they stay ``torch.matmul``, with TF32 off (fp32 products,
as XLA's on the CPU).  State: the fp32 momentum and the count,
``MuonState(count, momentum)`` in a checkpoint.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Iterable, Optional, Sequence, Union

import torch

from deepspeed_tpu_torch.ops.kernels.common import full_fp32
from deepspeed_tpu_torch.ops.optax_states import MuonState, count_leaf
from deepspeed_tpu_torch.ops.plain_optimizer import (PlainOptimizer, apply_updates,
                                                     zeros_f32)

# quintic Newton-Schulz coefficients (the public Muon constants)
_NS_A, _NS_B, _NS_C = 3.4445, -4.7750, 2.0315
DEFAULT_EXCLUDE = re.compile(r"embed|head|tok|wte|wpe", re.IGNORECASE)


def newton_schulz(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Orthogonalize [m, n] or, per leading index, [L, m, n] in fp32."""
    transpose = g.shape[-2] > g.shape[-1]
    x = g.transpose(-2, -1) if transpose else g
    norm = torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    x = x / (norm + eps)
    with full_fp32():
        for _ in range(steps):
            a = x @ x.transpose(-2, -1)
            b = _NS_B * a + _NS_C * (a @ a)
            x = _NS_A * x + b @ x
    return x.transpose(-2, -1) if transpose else x


class Muon(PlainOptimizer):
    """``names``: each parameter's ``keystr`` path, read by ``exclude``
    (default: the JAX package's regex)."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable] = 2e-2, weight_decay: float = 0.0,
                 momentum: float = 0.95, nesterov: bool = True, ns_steps: int = 5,
                 names: Optional[Sequence[str]] = None,
                 exclude: Optional[Callable[[str], bool]] = None):
        super().__init__(params, lr, dict(weight_decay=weight_decay,
                                          momentum=momentum, nesterov=nesterov,
                                          ns_steps=ns_steps))
        exclude = exclude or (lambda path: bool(DEFAULT_EXCLUDE.search(path)))
        params = self.all_params()
        names = list(names) if names is not None else [None] * len(params)
        if len(names) != len(params):
            raise ValueError(f"Muon: {len(names)} names for {len(params)} "
                             f"parameters")
        self.excluded = {id(p): n is not None and exclude(n)
                         for p, n in zip(params, names)}

    def _update(self, group, params, grads, lr):
        mom, wd = group["momentum"], group["weight_decay"]
        bufs = self._states("momentum", zeros_f32, params)
        new = torch._foreach_mul(bufs, mom)
        torch._foreach_add_(new, grads)              # momentum buf + g
        torch._foreach_copy_(bufs, new)
        if group["nesterov"]:
            eff = torch._foreach_mul(new, mom)
            torch._foreach_add_(eff, grads)          # g + momentum buf
        else:
            eff = new
        upd = []
        for p, e in zip(params, eff):
            if e.dim() in (2, 3) and not self.excluded[id(p)]:
                o = newton_schulz(e, group["ns_steps"])
                o = o * math.sqrt(max(1.0, e.shape[-2] / e.shape[-1]))
            else:
                o = e
            if wd:
                o = o + wd * p.float()
            upd.append(-lr * o)
        apply_updates(params, upd)

    def jax_state(self, nest: Callable) -> Any:
        """``MuonState`` over the live momentum buffers."""
        return MuonState(count_leaf(self.count),
                         nest(self._states("momentum", zeros_f32)))


__all__ = ["Muon", "MuonState", "newton_schulz"]
