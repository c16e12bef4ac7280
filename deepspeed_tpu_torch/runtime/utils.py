"""Gradient-norm helpers (counterpart of ``deepspeed_tpu/runtime/utils.py``).

``global_norm`` and ``clip_grad_norm`` over a list of tensors, with the
JAX package's numerics: an fp32 L2 norm over every leaf, and a clip scale
``min(1, max_norm / (norm + 1e-6))`` applied in fp32; ``has_overflow``,
the fp16 loss scaler's test.  Results stay device tensors: nothing here
synchronises with the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors, in fp32 (0-dim tensor)."""
    if not tensors:
        return torch.zeros(())
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square() for t in tensors]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_grad_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                    norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``grads`` IN PLACE to global norm ``max_norm`` (the JAX
    ``clip_grad_norm`` returns new arrays; the engine owns its
    accumulators, so the port scales them where they are).  Returns the
    pre-clip norm."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return norm


def has_overflow(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """True (a bool 0-dim tensor) if any element of any tensor is inf or
    NaN.  Each leaf's largest magnitude, a max-reduction that keeps a NaN,
    read once: finite values can never make it non-finite, where the fp32
    sum of squares in :func:`global_norm` reaches inf from finite values of
    1.8e19 and more, which the reference does not count as an overflow."""
    if not tensors:
        return torch.zeros((), dtype=torch.bool)
    peaks = [torch.linalg.vector_norm(t, float("inf")) for t in tensors]
    return ~torch.isfinite(torch.stack(peaks)).all()
