"""Symmetric per-block quantization: a CUDA C++ kernel and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/quantizer.py``.  :func:`quantize`
is the kernel (``deepspeed_tpu_torch/csrc/quantizer.cu``: one pass of
absmax and codes per block, reading x in its own dtype and masking the
ragged last block itself, with no padded fp32 copy); :func:`dequantize`,
:func:`pack_int4` and :func:`unpack_int4` are plain torch on both devices,
as the JAX package computes them in XLA outside Pallas.

The block is clamped to ``[128, 65536]`` on both devices: the Pallas
contract.  The JAX package's jnp path (``impl="xla"``) keeps a block under
128 as it is; the port does not (ROADMAP.md queue 3).  CUDA C++ rather
than Triton: the kernel reads x in fp32, bf16 or fp16 with 16-byte loads
and its block length is a runtime value up to 65536, which a Triton block
(a compile-time power of two held in registers) would have to loop over
anyway; the C interface also builds in seconds beside the other kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.kernels.build import check_launch, load_library
from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES,
                                                    check_kernel_input,
                                                    use_kernel)

MIN_BLOCK, MAX_BLOCK = 128, 1 << 16


def _qmax(bits: int) -> float:
    if bits not in (8, 4):
        raise ValueError(f"quantize: bits must be 8 or 4, got {bits}")
    return 127.0 if bits == 8 else 7.0


def _block(block: int) -> int:
    return max(MIN_BLOCK, min(int(block), MAX_BLOCK))


def quantize_plain(x: torch.Tensor, bits: int = 8, block: int = 2048
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The jnp formula: absmax per block of the zero-padded flat fp32 x."""
    qmax = _qmax(bits)
    block = _block(block)
    n = x.numel()
    pad = (-n) % block
    flat = x.reshape(-1).float()
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.view(-1, block)
    absmax = blocks.abs().amax(-1, keepdim=True)
    # qmax as a device tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its fp32 reciprocal, which is not the IEEE quotient
    qmax_t = torch.tensor(qmax, device=absmax.device)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / qmax_t)
    q = torch.clamp(torch.round(blocks / scale), -qmax, qmax).to(torch.int8)
    return q, scale[:, 0], pad


def _library():
    built = load_library("quantizer")
    fn = built.lib.ds_quantize
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return built


def quantize_cuda(x: torch.Tensor, bits: int = 8, block: int = 2048
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Launch the kernel on the current stream; raises on what it does not
    take and on a launch error."""
    qmax = _qmax(bits)
    block = _block(block)
    check_kernel_input("quantize x", x, x.device)
    n = x.numel()
    nb = -(-n // block)
    q = torch.empty(nb, block, device=x.device, dtype=torch.int8)
    scale = torch.empty(nb, device=x.device, dtype=torch.float32)
    if n:
        built = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = built.lib.ds_quantize(x.data_ptr(), q.data_ptr(),
                                         scale.data_ptr(), n, block,
                                         KERNEL_DTYPES[x.dtype], qmax, stream)
        check_launch(built, "quantize", code)
        quantize.launches += 1
    return q, scale, nb * block - n


def quantize(x: torch.Tensor, bits: int = 8, block: int = 2048
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Symmetric per-block quantization: ``(q int8 [nb, block], scale fp32
    [nb], pad)``, codes in [-127, 127] (8 bits) or [-7, 7] (4 bits, one a
    byte; :func:`pack_int4` packs them).  The CUDA kernel for a CUDA tensor,
    the plain version for a CPU one."""
    fn = quantize_cuda if use_kernel(x) else quantize_plain
    return fn(x, bits, block)


quantize.launches = 0   # kernel launches (CUDA tensors only)


def dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize` (a scaled cast)."""
    out = (q.float() * scale[:, None]).reshape(-1)
    if pad:
        out = out[: out.numel() - pad]
    return out.reshape(shape).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7] -> uint8, two nibbles a byte (low first)."""
    flat = q.reshape(-1)
    if flat.numel() % 2:
        flat = F.pad(flat, (0, 1))
    pairs = (flat.to(torch.int32) + 8).view(-1, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: the first ``n`` int8 codes."""
    p = packed.to(torch.int32)
    lo = (p & 0xF) - 8
    hi = ((p >> 4) & 0xF) - 8
    return torch.stack([lo, hi], dim=-1).reshape(-1)[:n].to(torch.int8)
