"""Blockwise int8 codec (counterpart of ``deepspeed_tpu/comm/quant.py``),
in two twins:

- the host numpy twins, copied unchanged in their math:
  ``offload_optimizer.int8_masters`` keeps the host masters and moments as
  (q int8 [nb, block], scale fp32 [nb, 1]): one absmax scale a block,
  codes ``rint(x / scale)``.  A second moment is coded in sqrt space
  (``sqrt_space``): the sqrt halves the dynamic range a 127-level code
  must span.  The JAX host twins are numpy too, so ``scale`` is
  ``absmax / 127.0``;
- the device twins, :func:`quantize_blockwise` and
  :func:`dequantize_blockwise`, the codec of the quantized collectives
  (:mod:`.collectives_q`): the kernels of
  :mod:`deepspeed_tpu_torch.ops.kernels.comm_quant` (plain torch on a CPU
  tensor).  Every JAX caller of its device twin runs under jit, where XLA
  compiles ``absmax / 127.0`` into ``absmax * fl(1/127)``, so these take
  the product: the two scales differ in about one block of 25.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DEFAULT_BLOCK = 256


def quantize_blockwise_np(arr: np.ndarray, block: int = DEFAULT_BLOCK,
                          sqrt_space: bool = False
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat fp array -> (q int8 [nb, block], scale fp32 [nb, 1])."""
    flat = np.asarray(arr, np.float32).reshape(-1)
    if sqrt_space:
        flat = np.sqrt(flat)
    n = flat.size
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(nb, block)
    absmax = np.abs(blocks).max(axis=1, keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    q = np.rint(blocks * inv).astype(np.int8)
    return q, scale


def dequantize_blockwise_np(q: np.ndarray, scale: np.ndarray, n: int,
                            sqrt_space: bool = False,
                            out: np.ndarray = None) -> np.ndarray:
    """(q, scale) -> flat fp32 [n] (into ``out`` when given)."""
    flat = (q.astype(np.float32) * scale).reshape(-1)[:n]
    if sqrt_space:
        flat = flat * flat
    if out is not None:
        out[:] = flat
        return out
    return flat


def quantize_blockwise(x: torch.Tensor, block: int = DEFAULT_BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device twin: flat ``x`` -> (q int8 [nb, block], scale fp32 [nb, 1]),
    the tail block zero-padded."""
    from deepspeed_tpu_torch.ops.kernels.comm_quant import quantize_blockwise as kq

    q, scale = kq(x.contiguous(), block)
    return q[0], scale[0]


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(q [nb, block], scale [nb, 1]) -> the first ``prod(shape)`` values as
    ``shape`` in ``dtype``."""
    from deepspeed_tpu_torch.ops.kernels.comm_quant import dequantize_blockwise as kdq

    n = int(np.prod(shape)) if len(shape) else 1
    return kdq(q.reshape(1, *q.shape[-2:]), scale, n, dtype=dtype).reshape(shape)
