"""Blockwise int8 codec of the quantized collectives: CUDA C++ kernels (a
quantizer, a dequantizer with an error-feedback form) and their plain
versions.

No Pallas kernel is replaced: the JAX package's codec
(``deepspeed_tpu/comm/quant.py`` ``quantize_blockwise`` /
``dequantize_blockwise``) and the dequantize-and-sum stages of
``comm/collectives_q.py`` are jnp that XLA fuses into each collective's
program.  Here they are ``deepspeed_tpu_torch/csrc/comm_quant.cu``:

- :func:`quantize_blockwise`: ``x`` as ``rows`` rows, each zero-padded to
  whole blocks on its own -> ``q`` int8 ``[rows, nb, block]`` and ``scale``
  fp32 ``[rows, nb, 1]``; ``scale = absmax * fl(1/127)`` (the product XLA
  compiles the JAX codec's ``absmax / 127.0`` to under jit), codes
  ``rint(x * (1 / scale))`` (0 where the scale is 0);
- :func:`dequantize_blockwise`: ``q`` ``[P, nb, block]`` and ``scale``
  ``[P, nb(, 1)]`` -> each source's first ``keep`` values ``q * scale``
  concatenated in source order (the gather side, cast to ``dtype``), or
  with ``sum`` their fp32 sum over the sources in source order (the reduce
  side), ``acc = fma(q, scale, acc)`` from 0: the reduce XLA's CPU backend
  fuses the JAX collectives' product and sum into (each step rounded once);
- :func:`dequantize_error`: ``q_all_reduce``'s error-feedback residual,
  ``base - q * scale`` rounded once (``fma(-q, scale, base)``), on the
  card the dequantizer's error kernel (counted as a launch of
  ``dequantize_blockwise``).

Each is bit-equal to its plain version.  A CUDA tensor launches the kernel
(``quantize_blockwise.launches`` counts the quantizer's launches,
``dequantize_blockwise.launches`` the dequantizer's in either form); a CPU
tensor runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deepspeed_tpu_torch.ops.kernels.build import bind, check_launch, load_library
from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES, raw_stream,
                                                    use_kernel)

# fl(1/127): XLA's compiled form of the JAX codec's division by 127
INV127 = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(127.0))

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_Q_ARGS = [_VP, _VP, _VP, _LL, _LL, _I, _I, _VP, _I]
_E_ARGS = [_VP, _VP, _VP, _VP, _I, _LL, _VP, _I]
_DQ_ARGS = [_VP, _VP, _VP, _I, _LL, _I, _LL, _I, _I, _VP, _I]


def _check_block(block: int) -> int:
    block = int(block)
    if block <= 0:
        raise ValueError(f"comm quantization block must be positive, got {block}")
    return block


def quantize_blockwise_plain(x: torch.Tensor, block: int, rows: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX codec in plain PyTorch on x's device (each row its own
    zero-padded blocks)."""
    block = _check_block(block)
    flat = x.reshape(rows, -1).float()
    n = flat.shape[1]
    nb = -(-n // block)
    if nb * block != n:
        flat = torch.nn.functional.pad(flat, (0, nb * block - n))
    blocks = flat.view(rows, nb, block)
    absmax = blocks.abs().amax(-1, keepdim=True)
    scale = absmax * torch.tensor(INV127, dtype=torch.float32, device=x.device)
    pos = scale > 0
    inv = torch.where(pos, torch.reciprocal(torch.where(pos, scale, torch.ones_like(scale))),
                      torch.zeros_like(scale))
    q = torch.round(blocks * inv).to(torch.int8)
    return q, scale


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of fp32 tensors rounded once to fp32 (``fmaf``): the
    sum in fp64, whose error TwoSum gives exactly, moved off an fp32
    midpoint toward the exact value where fp64 rounded onto one (so the
    second rounding cannot go the wrong way).  ``a * b`` must be exact in
    fp64, as an int8 code times an fp32 scale is."""
    p = a.double() * b.double()
    c = c.double()
    r = p + c
    bp = r - c
    err = (p - bp) + (c - (r - bp))
    bits = r.view(torch.int64)
    on_mid = ((bits & ((1 << 29) - 1)) == (1 << 28)) & (err != 0)
    r = torch.where(on_mid, torch.nextafter(r, r + err), r)
    return r.float()


def dequantize_error_plain(base: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
                           ) -> torch.Tensor:
    """``base - q * scale`` over the concatenated sources' whole blocks,
    rounded once (``fma(-q, scale, base)``: what XLA's CPU backend fuses the
    JAX ``q_all_reduce``'s residual terms into)."""
    P, nb, block = q.shape
    sf = scale.reshape(P, nb, 1).expand(P, nb, block).reshape(-1)
    n = base.numel()
    return fma32(-q.float().reshape(-1)[:n], sf[:n], base)


def dequantize_blockwise_plain(q: torch.Tensor, scale: torch.Tensor, keep: int,
                               sum: bool = False, dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """``q [P, nb, block] * scale``: each source's first ``keep`` values
    concatenated, or summed over the sources in source order, each step
    ``acc = fma(q, scale, acc)``: the reduce XLA's CPU backend fuses the
    JAX collectives' product and sum into."""
    P, nb, block = q.shape
    sc = scale.reshape(P, nb, 1)
    if not sum:
        parts = (q.float() * sc).reshape(P, -1)[:, :keep]
        return parts.reshape(-1).to(dtype)
    qf = q.float().reshape(P, -1)[:, :keep]
    sf = sc.expand(P, nb, block).reshape(P, -1)[:, :keep]
    acc = torch.zeros(keep, dtype=torch.float32, device=q.device)
    for p in range(P):
        acc = fma32(qf[p], sf[p], acc)
    return acc.to(dtype)


def _device(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def quantize_blockwise_cuda(x: torch.Tensor, block: int, rows: int = 1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantizer kernel on a CUDA tensor (raises on what it does not
    take and on a launch error)."""
    block = _check_block(block)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"quantize_blockwise: dtype {x.dtype} not supported "
                        f"(kernels take {sorted(str(d) for d in KERNEL_DTYPES)})")
    if not x.is_contiguous():
        raise ValueError("quantize_blockwise: expected a contiguous tensor")
    n = x.numel() // rows if rows else 0
    if rows <= 0 or n * rows != x.numel():
        raise ValueError(f"quantize_blockwise: {x.numel()} elements do not "
                         f"split into {rows} rows")
    nb = -(-n // block)
    q = torch.empty(rows, nb, block, dtype=torch.int8, device=x.device)
    scale = torch.empty(rows, nb, 1, dtype=torch.float32, device=x.device)
    if n:
        dev = _device(x)
        err = bind("comm_quant", "ds_quantize_blockwise", _Q_ARGS)(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, n, block,
            KERNEL_DTYPES[x.dtype], raw_stream(dev), dev)
        if err:
            check_launch(load_library("comm_quant"), "quantize_blockwise", err)
        quantize_blockwise.launches += 1
    return q, scale


def dequantize_blockwise_cuda(q: torch.Tensor, scale: torch.Tensor, keep: int,
                              sum: bool = False, dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """The dequantizer kernel on CUDA tensors."""
    if q.dtype != torch.int8 or q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"dequantize_blockwise: q must be a contiguous int8 "
                         f"[P, nb, block], got {q.dtype} {tuple(q.shape)}")
    P, nb, block = q.shape
    if (scale.dtype != torch.float32 or scale.numel() != P * nb
            or not scale.is_contiguous() or scale.device != q.device):
        raise ValueError(f"dequantize_blockwise: scale must be a contiguous "
                         f"fp32 [P, nb] on {q.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"dequantize_blockwise: output dtype {dtype} not supported")
    keep = int(keep)
    if not 0 <= keep <= nb * block:
        raise ValueError(f"dequantize_blockwise: keep {keep} outside a source's "
                         f"{nb * block} values")
    out = torch.empty(keep if sum else P * keep, dtype=dtype, device=q.device)
    if out.numel():
        dev = _device(q)
        err = bind("comm_quant", "ds_dequantize_blockwise", _DQ_ARGS)(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), P, nb, block, keep,
            int(bool(sum)), KERNEL_DTYPES[dtype], raw_stream(dev), dev)
        if err:
            check_launch(load_library("comm_quant"), "dequantize_blockwise", err)
        dequantize_blockwise.launches += 1
    return out


def dequantize_error_cuda(base: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
                          ) -> torch.Tensor:
    """The dequantizer's error kernel on CUDA tensors: ``base`` fp32 [n],
    ``q`` int8 [P, nb, block] with n <= P * nb * block, ``scale`` [P, nb(, 1)]."""
    if q.dtype != torch.int8 or q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"dequantize_error: q must be a contiguous int8 [P, nb, block], "
                         f"got {q.dtype} {tuple(q.shape)}")
    P, nb, block = q.shape
    if (scale.dtype != torch.float32 or scale.numel() != P * nb
            or not scale.is_contiguous() or scale.device != q.device):
        raise ValueError(f"dequantize_error: scale must be a contiguous fp32 [P, nb] "
                         f"on {q.device}, got {scale.dtype} {tuple(scale.shape)}")
    if (base.dtype != torch.float32 or not base.is_contiguous()
            or base.device != q.device or base.numel() > q.numel()):
        raise ValueError(f"dequantize_error: base must be a contiguous fp32 of at "
                         f"most {q.numel()} values on {q.device}, got {base.dtype} "
                         f"{tuple(base.shape)} on {base.device}")
    out = torch.empty(base.numel(), dtype=torch.float32, device=q.device)
    if out.numel():
        dev = _device(q)
        err = bind("comm_quant", "ds_dequantize_error", _E_ARGS)(
            q.data_ptr(), scale.data_ptr(), base.data_ptr(), out.data_ptr(), block,
            out.numel(), raw_stream(dev), dev)
        if err:
            check_launch(load_library("comm_quant"), "dequantize_error", err)
        dequantize_blockwise.launches += 1
    return out


def dequantize_error(base: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
                     ) -> torch.Tensor:
    """``base - q * scale`` (fp32, ``base``'s length; ``q`` and ``scale``
    the sources' whole blocks, read flat), each element rounded once: the
    kernel for CUDA tensors, the plain version for CPU ones."""
    if use_kernel(q):
        return dequantize_error_cuda(base.reshape(-1).contiguous(), q,
                                     scale.contiguous())
    return dequantize_error_plain(base, q, scale)


def quantize_blockwise(x: torch.Tensor, block: int, rows: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (fp32, bf16 or fp16; its elements as ``rows`` equal rows) ->
    ``(q int8 [rows, nb, block], scale fp32 [rows, nb, 1])``: the kernel for
    a CUDA tensor, the plain version for a CPU one."""
    if use_kernel(x):
        return quantize_blockwise_cuda(x, block, rows)
    return quantize_blockwise_plain(x, block, rows)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, keep: int,
                         sum: bool = False, dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """``q [P, nb, block]``, ``scale [P, nb(, 1)]`` -> ``[P * keep]`` (each
    source's first ``keep`` values, in ``dtype``) or, with ``sum``, ``[keep]``
    (their sum over the sources in fp32, then cast to ``dtype``): the kernel
    for CUDA tensors, the plain version for CPU ones."""
    if use_kernel(q):
        return dequantize_blockwise_cuda(q, scale.contiguous(), keep, sum, dtype)
    return dequantize_blockwise_plain(q, scale, keep, sum, dtype)


quantize_blockwise.launches = 0     # launches of quantize_blockwise_kernel
# launches of dequantize_blockwise_kernel and dequantize_error_kernel
dequantize_blockwise.launches = 0
