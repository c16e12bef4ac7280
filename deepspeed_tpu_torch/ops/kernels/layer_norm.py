"""RMSNorm forward: a CUDA C++ kernel for Hopper and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/layer_norm.py`` ``rms_norm``.
The kernel is ``deepspeed_tpu_torch/csrc/layer_norm.cu`` (one block per
row, 16-byte vector loads, fp32 warp-shuffle reduction), built by nvcc at
first use and called through ctypes.  :func:`rms_norm_plain` keeps the JAX
``impl="xla"`` semantics — fp32 upcast, ``x * rsqrt(mean(x^2) + eps) * g``,
cast back to x's dtype — and is what a CPU tensor runs.

LayerNorm and the backward passes are not in this slice (ROADMAP.md
queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels.build import check_launch, load_library
from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES,
                                                    check_kernel_input,
                                                    use_kernel)


def rms_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """The jnp reference, op for op: fp32 statistics, output in x's dtype."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def _library():
    built = load_library("layer_norm")
    fn = built.lib.ds_rms_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def rms_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on what it does
    not take (device, dtype, shape, contiguity) and on a launch error."""
    n = x.shape[-1]
    check_kernel_input("rms_norm x", x, x.device)
    check_kernel_input("rms_norm gamma", gamma, x.device, dtype=x.dtype)
    if gamma.shape != (n,):
        raise ValueError(f"rms_norm: gamma shape {tuple(gamma.shape)} != "
                         f"({n},)")
    built = _library()
    y = torch.empty_like(x)
    rows = x.numel() // n if n else 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = built.lib.ds_rms_norm_fwd(x.data_ptr(), gamma.data_ptr(),
                                         y.data_ptr(), rows, n, float(eps),
                                         KERNEL_DTYPES[x.dtype], stream)
    check_launch(built, "rms_norm", code)
    rms_norm.launches += 1
    return y


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if use_kernel(x):
        return rms_norm_cuda(x, gamma, eps)
    return rms_norm_plain(x, gamma, eps)


rms_norm.launches = 0   # kernel launches (CUDA tensors only)
