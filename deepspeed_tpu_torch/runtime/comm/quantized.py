"""The block codec and the int8 gather and reduce-scatter of the runtime
(counterpart of ``deepspeed_tpu/runtime/comm/quantized.py``, its codec
half).

Thin over the comm layer: :func:`block_quantize` and
:func:`block_dequantize` are :mod:`deepspeed_tpu_torch.comm.quant`'s
device codec with the JAX functions' signatures, and
:func:`quantized_all_gather` / :func:`quantized_reduce_scatter` are
:mod:`deepspeed_tpu_torch.comm.collectives_q`'s.  The 1-bit
``compressed_allreduce`` waits with the 1-bit optimizers (ROADMAP.md queue
1, item 2e: the 1-bit family).
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepspeed_tpu_torch.comm import collectives_q as cq
from deepspeed_tpu_torch.comm.quant import dequantize_blockwise, quantize_blockwise

DEFAULT_BLOCK = 256


def block_quantize(x: torch.Tensor, block: int = DEFAULT_BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-block absmax int8 codes of flat ``x``: (q int8 [nb, block],
    scale fp32 [nb, 1], pad)."""
    q, scale = quantize_blockwise(x, block)
    return q, scale, q.numel() - x.numel()


def block_dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int, shape,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`block_quantize` (``scale`` [nb] or [nb, 1])."""
    return dequantize_blockwise(q, scale.reshape(-1, 1), tuple(shape), dtype)


def quantized_all_gather(x: torch.Tensor, axis, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 through int8 codes."""
    return cq.q_all_gather(x, axis, block=block)


def quantized_reduce_scatter(x: torch.Tensor, axis, block: int = DEFAULT_BLOCK
                             ) -> torch.Tensor:
    """This rank's shard (dim 0 split) of the ranks' summed ``x``, each
    destination's chunk quantized once and summed in fp32."""
    return cq.q_reduce_scatter(x, axis, block=block)
