"""Fused LAMB update: CUDA C++ kernels and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_lamb.py``
``fused_lamb_update``, whose two ``pallas_call`` sites become two wrappers
over ``deepspeed_tpu_torch/csrc/fused_lamb.cu``:

- :func:`lamb_phase1` (``_lamb_phase1_kernel``, :110, and the XLA combine
  after it): the Adam moments in place and ``stats`` = (||p||, ||u||,
  lr * trust), a 3-element fp32 device tensor: the norms are per-block
  partials summed by a second launch in a fixed order, and the trust ratio
  ``where(w > 0 & u > 0, w / u, 1)`` is computed on the device (no host
  sync inside the step);
- :func:`lamb_scale` (``_scale_kernel``, :128): ``p -= stats[2] * u``, with
  u recomputed from p and the new moments (the same rounded operations, so
  the same bits as phase 1's u) rather than stored: the same bytes, and no
  leaf-sized u buffer.

Unlike the JAX function, which returns new arrays, both update ``param``,
``m`` and ``v`` IN PLACE.  :func:`fused_lamb_update` runs both; its plain
version is the JAX ``impl="xla"`` formula op for op, and is what a CPU
tensor runs.
"""

from __future__ import annotations

import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels.build import check_launch, load_library
from deepspeed_tpu_torch.ops.kernels.common import check_kernel_input, use_kernel
from deepspeed_tpu_torch.ops.kernels.fused_adam import bias_corrections

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _u(p32, m, v, c1, c2, eps, weight_decay):
    u = (m * c1) / (torch.sqrt(v * c2) + eps)
    if weight_decay != 0.0:
        u = u + weight_decay * p32
    return u


def lamb_phase1_plain(param, grad, m, v, step: int, *, lr: float,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-6, weight_decay: float = 0.0
                      ) -> torch.Tensor:
    """Moments in place; returns stats = (||p||, ||u||, lr * trust)."""
    c1, c2 = bias_corrections(step, beta1, beta2)
    p = param.float()
    g = grad.float()
    m.copy_(beta1 * m + (1 - beta1) * g)
    v.copy_(beta2 * v + (1 - beta2) * g * g)
    u = _u(p, m, v, c1, c2, eps, weight_decay)
    w_norm = torch.linalg.vector_norm(p)
    u_norm = torch.linalg.vector_norm(u)
    trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                        torch.ones_like(w_norm))
    return torch.stack([w_norm, u_norm, lr * trust])


def lamb_scale_plain(param, m, v, stats, step: int, *, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-6,
                     weight_decay: float = 0.0) -> None:
    """p -= stats[2] * u, in place."""
    c1, c2 = bias_corrections(step, beta1, beta2)
    p = param.float()
    param.copy_(p - stats[2] * _u(p, m, v, c1, c2, eps, weight_decay))


def _library():
    built = load_library("fused_lamb")
    lib = built.lib
    if lib.ds_lamb_phase1.argtypes is None:
        vp, cf = ctypes.c_void_p, ctypes.c_float
        lib.ds_lamb_phase1.argtypes = ([vp] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                                   ctypes.c_int] + [cf] * 9 + [vp])
        lib.ds_lamb_phase1.restype = ctypes.c_int
        lib.ds_lamb_scale.argtypes = ([vp] * 4 + [ctypes.c_longlong, ctypes.c_int]
                                      + [cf] * 4 + [vp])
        lib.ds_lamb_scale.restype = ctypes.c_int
        lib.ds_lamb_partials.argtypes = [ctypes.c_longlong]
        lib.ds_lamb_partials.restype = ctypes.c_int
    return built


def _check(name, param, m, v, grad=None):
    check_kernel_input(f"{name} param", param, param.device)
    check_kernel_input(f"{name} m", m, param.device, dtype=torch.float32)
    check_kernel_input(f"{name} v", v, param.device, dtype=torch.float32)
    tensors = [param, m, v]
    if grad is not None:
        check_kernel_input(f"{name} grad", grad, param.device)
        tensors.append(grad)
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in tensors):
        raise TypeError(f"{name} kernel takes fp32 or bf16 params and grads")
    if any(t.shape != param.shape for t in tensors):
        raise ValueError(f"{name}: param, grad, m and v must share a shape")
    if param.numel() == 0:
        raise ValueError(f"{name}: an empty leaf")


def lamb_phase1_cuda(param, grad, m, v, step: int, *, lr: float,
                     beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-6, weight_decay: float = 0.0
                     ) -> torch.Tensor:
    """Launch phase 1 and the reduce on the current stream."""
    _check("lamb_phase1", param, m, v, grad)
    c1, c2 = bias_corrections(step, beta1, beta2)
    built = _library()
    n = param.numel()
    partials = torch.empty(2 * built.lib.ds_lamb_partials(n),
                           device=param.device, dtype=torch.float32)
    stats = torch.empty(3, device=param.device, dtype=torch.float32)
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream(param.device).cuda_stream
        code = built.lib.ds_lamb_phase1(
            param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
            partials.data_ptr(), stats.data_ptr(), n, _DTYPES[param.dtype],
            _DTYPES[grad.dtype], float(lr), c1, c2, float(beta1), float(beta2),
            1.0 - beta1, 1.0 - beta2, float(eps), float(weight_decay), stream)
    check_launch(built, "lamb_phase1", code)
    lamb_phase1.launches += 1
    return stats


def lamb_scale_cuda(param, m, v, stats, step: int, *, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-6,
                    weight_decay: float = 0.0) -> None:
    """Launch phase 2 on the current stream (in place)."""
    _check("lamb_scale", param, m, v)
    check_kernel_input("lamb_scale stats", stats, param.device,
                       dtype=torch.float32)
    if stats.shape != (3,):
        raise ValueError("lamb_scale: stats must be the [3] tensor of lamb_phase1")
    c1, c2 = bias_corrections(step, beta1, beta2)
    built = _library()
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream(param.device).cuda_stream
        code = built.lib.ds_lamb_scale(
            param.data_ptr(), m.data_ptr(), v.data_ptr(), stats.data_ptr(),
            param.numel(), _DTYPES[param.dtype], c1, c2, float(eps),
            float(weight_decay), stream)
    check_launch(built, "lamb_scale", code)
    lamb_scale.launches += 1


def lamb_phase1(param, grad, m, v, step: int, *, lr: float, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-6,
                weight_decay: float = 0.0) -> torch.Tensor:
    """LAMB phase 1 of one leaf (moments in place; returns the [3] stats).
    The CUDA kernels for a CUDA tensor, the plain version for a CPU one."""
    fn = lamb_phase1_cuda if use_kernel(param) else lamb_phase1_plain
    return fn(param, grad, m, v, step, lr=lr, beta1=beta1, beta2=beta2,
              eps=eps, weight_decay=weight_decay)


def lamb_scale(param, m, v, stats, step: int, *, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-6,
               weight_decay: float = 0.0) -> None:
    """LAMB phase 2 of one leaf (p in place)."""
    fn = lamb_scale_cuda if use_kernel(param) else lamb_scale_plain
    fn(param, m, v, stats, step, beta1=beta1, beta2=beta2, eps=eps,
       weight_decay=weight_decay)


lamb_phase1.launches = 0   # phase-1 calls on CUDA tensors (two launches each)
lamb_scale.launches = 0    # phase-2 launches (CUDA tensors only)


def fused_lamb_update(param, grad, m, v, step: int, *, lr: float,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-6, weight_decay: float = 0.0
                      ) -> torch.Tensor:
    """One LAMB step of one leaf, in place; ``step`` is the 1-based count.
    Returns the [3] stats (||p||, ||u||, lr * trust) as a device tensor."""
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    stats = lamb_phase1(param, grad, m, v, step, lr=lr, **kw)
    lamb_scale(param, m, v, stats, step, **kw)
    return stats
