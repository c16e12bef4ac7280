"""Shared helpers for the port's hand-written kernels.

Counterpart of ``deepspeed_tpu/ops/pallas/common.py``.  The JAX package
picks the Pallas kernel or its jnp reference from the jax backend (with an
environment override); the port decides by the device the tensor lies on,
and by nothing else:

- a CUDA tensor goes to the kernel, which launches or raises — no wrapper
  falls back to the plain version when a kernel fails;
- a CPU tensor goes to the plain PyTorch version (the CPU tests, and the
  reference the kernels are held against on the card);
- any other device is refused.

:func:`raw_stream` is the launch helper's half in Python (the C entry
takes the device index and makes it current only where it is not): the
wrappers moved to it read the current stream's handle without building a
``torch.cuda.Stream`` and enter no ``torch.cuda.device`` context.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

# dtypes the kernels take, with the code the CUDA C interface uses for each
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SLOPES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check_kernel_input(name: str, t: torch.Tensor, device: torch.device,
                       dtype: torch.dtype = None) -> None:
    """Raise unless ``t`` is a contiguous tensor of a kernel dtype on
    ``device`` (and of ``dtype`` when given)."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (kernels "
                        f"take {sorted(str(d) for d in KERNEL_DTYPES)})")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls without TF32 on the card (a no-op on the CPU): the
    products the JAX package computes in fp32 outside its kernels (the MoE
    router, Muon's Newton-Schulz steps)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def raw_stream(index: int) -> int:
    """The raw ``cudaStream_t`` of the current stream of CUDA device
    ``index``, read afresh on every call (so it follows
    ``torch.cuda.stream(...)``) without building a ``torch.cuda.Stream``:
    the call Triton and Inductor make."""
    return torch._C._cuda_getCurrentRawStream(index)


def alibi_slopes_on(H: int, dev: torch.device) -> torch.Tensor:
    """ALiBi's fp32 [H] slope table on ``dev``, the one the decode and
    flash attention kernels read: built once per ``(H, device)``."""
    key = (H, dev)
    t = _SLOPES.get(key)
    if t is None:
        from deepspeed_tpu_torch.models.layers import alibi_slopes

        t = _SLOPES[key] = alibi_slopes(H, device=dev).contiguous()
    return t
