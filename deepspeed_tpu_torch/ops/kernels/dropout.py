"""Dropout drawn from JAX's threefry stream: a CUDA C++ kernel and its plain
version.

No Pallas kernel is replaced: the JAX package's ``_dropout``
(``deepspeed_tpu/models/transformer.py``) is plain jnp, ``where(bernoulli(
key, 1 - rate, x.shape), x / (1 - rate), 0)``.  Both versions here give its
bits: the mask from :mod:`deepspeed_tpu_torch.utils.prng` (the same key
gives the same mask as ``jax.random.bernoulli``), and the kept value as
XLA's compiled division by the constant computes it on the CPU, a product
with the reciprocal (:func:`dropout_scale`).  The kernel is
``deepspeed_tpu_torch/csrc/dropout.cu``: one pass, each element's hash in
registers.  Nothing is stored: the backward (:func:`dropout_bwd`, the same
function of ``dy`` under the same key, as ``jax.grad`` of ``_dropout``
gives) and every remat recompute draw the mask again.

A CUDA tensor launches the kernel (the forward adds one to
``dropout.launches``, the backward to ``dropout_bwd.launches``); a CPU
tensor runs :func:`dropout_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels.build import bind, check_launch, load_library
from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES, raw_stream,
                                                    use_kernel)
from deepspeed_tpu_torch.utils import prng

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
         ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int]


def dropout_scale(dtype: torch.dtype, rate: float) -> float:
    """What a kept element is multiplied by.  jnp's ``x / (1.0 - rate)``
    rounds the scalar to x's dtype, and XLA turns the division by that
    constant into a product with its reciprocal: in fp32 for fp32 and
    bf16 (bf16 arithmetic runs in fp32 on the CPU), in fp16 for fp16."""
    d = torch.tensor(1.0 - rate, dtype=dtype)
    if dtype == torch.float16:
        return float(torch.tensor(1.0, dtype=torch.float16) / d)
    return float(torch.tensor(1.0) / d.float())


def dropout_plain(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """``_dropout(x, key, rate)`` in plain PyTorch on x's device."""
    keep = prng.bernoulli(key, 1.0 - rate, x.shape, x.device)
    y = (x.float() * dropout_scale(x.dtype, rate)).to(x.dtype)
    return torch.where(keep, y, torch.zeros((), dtype=x.dtype, device=x.device))


def _launch(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"dropout: dtype {x.dtype} not supported (kernels "
                        f"take {sorted(str(d) for d in KERNEL_DTYPES)})")
    # the mask is a function of the logical row-major flat index
    x = x.contiguous()
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
        err = bind("dropout", "ds_dropout", _ARGS)(
            x.data_ptr(), y.data_ptr(), n, int(key[0]) & prng.MASK,
            int(key[1]) & prng.MASK, prng.keep_threshold(1.0 - rate),
            dropout_scale(x.dtype, rate), KERNEL_DTYPES[x.dtype],
            raw_stream(dev), dev)
        if err:
            check_launch(load_library("dropout"), "dropout", err)
    return y


def dropout_cuda(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """The forward kernel on a CUDA tensor."""
    y = _launch(x, key, rate)
    if x.numel():
        dropout.launches += 1
    return y


def dropout_bwd_cuda(dy: torch.Tensor, key, rate: float) -> torch.Tensor:
    """The backward kernel on a CUDA tensor: the forward's function of
    ``dy``."""
    dx = _launch(dy, key, rate)
    if dy.numel():
        dropout_bwd.launches += 1
    return dx


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, rate):
        ctx.key, ctx.rate = key, rate
        return dropout_cuda(x, key, rate) if use_kernel(x) else dropout_plain(x, key, rate)

    @staticmethod
    def backward(ctx, dy):
        return dropout_bwd(dy, ctx.key, ctx.rate), None, None


def dropout(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """JAX ``_dropout(x, key, rate)``: keep each element with probability
    ``1 - rate`` (the mask of ``jax.random.bernoulli(key, 1 - rate,
    x.shape)``) and scale it as JAX does; differentiable.  ``key`` is a
    threefry key pair (:mod:`deepspeed_tpu_torch.utils.prng`)."""
    return _Dropout.apply(x, key, float(rate))


def dropout_bwd(dy: torch.Tensor, key, rate: float) -> torch.Tensor:
    """The gradient of :func:`dropout` with respect to x: ``where(keep, dy *
    scale, 0)``, the transpose ``jax.grad`` gives."""
    if use_kernel(dy):
        return dropout_bwd_cuda(dy, key, rate)
    return dropout_plain(dy, key, rate)


dropout.launches = 0       # forward launches of csrc/dropout.cu
dropout_bwd.launches = 0   # backward launches (the same kernel)
