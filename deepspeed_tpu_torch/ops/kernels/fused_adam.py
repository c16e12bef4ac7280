"""Fused Adam / AdamW update: a CUDA C++ kernel and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_adam.py``
``fused_adam_update``.  The kernel is
``deepspeed_tpu_torch/csrc/fused_adam.cu`` (one elementwise pass per
parameter leaf, fp32 math, ``lr`` and the bias corrections passed per call;
params and grads fp32, bf16 or fp16).  The fp16-param instance has a
wrapper and a launch count of its own, :func:`fused_adam_update_f16_cuda`:
no training path of the engine runs it (fp16 training keeps fp32 masters),
and the op library's :func:`fused_adam_update` reaches it for an fp16 leaf,
as the JAX function takes any float param dtype.
Unlike the JAX function, which returns new arrays, both versions here
update ``param``, ``m`` and ``v`` IN PLACE: the optimizer owns those
buffers, and a second copy of 1.34e9 fp32 parameters and moments would cost
16 GB at llama-1b4.  :func:`fused_adam_update_plain` is the JAX
``impl="xla"`` formula, op for op, and is what a CPU tensor runs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.build import check_launch, load_library
from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES,
                                                    check_kernel_input,
                                                    use_kernel)


def bias_corrections(step: int, beta1: float, beta2: float):
    """(c1, c2) = (1/(1 - beta1^t), 1/(1 - beta2^t)) in fp32, as the JAX
    function computes them from its 1-based int step."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (float(one / (one - np.float32(beta1) ** t)),
            float(one / (one - np.float32(beta2) ** t)))


def fused_adam_update_plain(param, grad, m, v, step: int, *, lr: float,
                            beta1: float = 0.9, beta2: float = 0.999,
                            eps: float = 1e-8, weight_decay: float = 0.0,
                            adam_w_mode: bool = True) -> None:
    """The jnp formula in fp32, written back into param (rounded to its
    dtype), m and v."""
    c1, c2 = bias_corrections(step, beta1, beta2)
    p = param.float()
    g = grad.float()
    if not adam_w_mode and weight_decay != 0.0:
        g = g + weight_decay * p
    m_new = beta1 * m + (1 - beta1) * g
    v_new = beta2 * v + (1 - beta2) * g * g
    update = (m_new * c1) / (torch.sqrt(v_new * c2) + eps)
    if adam_w_mode and weight_decay != 0.0:
        update = update + weight_decay * p
    param.copy_(p - lr * update)
    m.copy_(m_new)
    v.copy_(v_new)


def _library():
    built = load_library("fused_adam")
    fn = built.lib.ds_fused_adam
    if fn.argtypes is None:
        vp, cf = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = ([vp] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int] + [cf] * 9
                       + [ctypes.c_int, vp])
        fn.restype = ctypes.c_int
    return built


def _launch(param, grad, m, v, step, lr, beta1, beta2, eps, weight_decay,
            adam_w_mode) -> None:
    check_kernel_input("fused_adam param", param, param.device)
    check_kernel_input("fused_adam grad", grad, param.device)
    check_kernel_input("fused_adam m", m, param.device, dtype=torch.float32)
    check_kernel_input("fused_adam v", v, param.device, dtype=torch.float32)
    if not (param.shape == grad.shape == m.shape == v.shape):
        raise ValueError("fused_adam: param, grad, m and v must share a shape")
    c1, c2 = bias_corrections(step, beta1, beta2)
    built = _library()
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream(param.device).cuda_stream
        code = built.lib.ds_fused_adam(
            param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
            param.numel(), KERNEL_DTYPES[param.dtype], KERNEL_DTYPES[grad.dtype],
            float(lr), c1, c2, float(beta1), float(beta2), 1.0 - beta1,
            1.0 - beta2, float(eps), float(weight_decay), int(adam_w_mode),
            stream)
    check_launch(built, "fused_adam", code)


def fused_adam_update_cuda(param, grad, m, v, step: int, *, lr: float,
                           beta1: float = 0.9, beta2: float = 0.999,
                           eps: float = 1e-8, weight_decay: float = 0.0,
                           adam_w_mode: bool = True) -> None:
    """Launch the kernel on the current stream (in place) for an fp32 or
    bf16 param (any kernel dtype of grad); raises on what it does not take
    and on a launch error."""
    if param.dtype == torch.float16:
        raise TypeError("fused_adam_update_cuda takes fp32 or bf16 params; "
                        "fp16 ones go to fused_adam_update_f16_cuda")
    _launch(param, grad, m, v, step, lr, beta1, beta2, eps, weight_decay,
            adam_w_mode)
    fused_adam_update.launches += 1


def fused_adam_update_f16_cuda(param, grad, m, v, step: int, *, lr: float,
                               beta1: float = 0.9, beta2: float = 0.999,
                               eps: float = 1e-8, weight_decay: float = 0.0,
                               adam_w_mode: bool = True) -> None:
    """The kernel's fp16-param instance (any kernel dtype of grad): as
    :func:`fused_adam_update_cuda`, counted on its own."""
    if param.dtype != torch.float16:
        raise TypeError(f"fused_adam_update_f16_cuda takes fp16 params, got "
                        f"{param.dtype}")
    _launch(param, grad, m, v, step, lr, beta1, beta2, eps, weight_decay,
            adam_w_mode)
    fused_adam_update_f16_cuda.launches += 1


def fused_adam_update(param, grad, m, v, step: int, *, lr: float,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-8, weight_decay: float = 0.0,
                      adam_w_mode: bool = True) -> None:
    """One Adam step of one leaf, in place; ``step`` is the 1-based count.
    The CUDA kernel for a CUDA tensor (its fp16 instance for an fp16
    param), the plain version for a CPU one."""
    if not use_kernel(param):
        fn = fused_adam_update_plain
    elif param.dtype == torch.float16:
        fn = fused_adam_update_f16_cuda
    else:
        fn = fused_adam_update_cuda
    fn(param, grad, m, v, step, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
       weight_decay=weight_decay, adam_w_mode=adam_w_mode)


fused_adam_update.launches = 0   # kernel launches, fp32 and bf16 params
fused_adam_update_f16_cuda.launches = 0   # kernel launches, fp16 params
