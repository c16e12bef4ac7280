"""Scaled masked softmax and bias + activation: Triton kernels and their
plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/softmax.py``, the fused ops of
the GPT-2 era (scale + mask + softmax over attention scores, bias + GeLU
after a projection).  No module of either package calls them; they belong
to the public op library.

:func:`scaled_masked_softmax` replaces both ``pallas_call`` sites of the
Pallas ``scaled_masked_softmax`` (``_softmax_kernel`` and
``_masked_softmax_kernel``) with one Triton kernel whose ``HAS_MASK`` is a
compile-time switch; :func:`bias_act` replaces the Pallas ``bias_act``
(``_bias_act_kernel``).  What bounds both on the H100: memory bytes — every
element is read once and written once with a handful of fp32 operations
between (an exp and a divide for softmax).  Design: each is one fused
pass with no matrix product and no state across programs, so a Triton
program takes a tile of whole rows (softmax: the row's maximum and sum are
block reductions inside one program, n <= 16384) or a flat run of elements
(bias_act) with masked block loads.  The keep-mask is read where the caller
left it: a mask that broadcasts against x (say ``[S, S]`` against
``[B, H, S, S]``) is indexed by its own strides, zero on the broadcast
dims, and never expanded in memory.  ``triton`` is imported when a kernel
is first launched, never at module import.

A masked entry takes the finite value -1e30 (not -inf), as in the
reference, so a fully masked row comes out uniform.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels.common import check_kernel_input, use_kernel

NEG_INF = -1e30
SOFTMAX_MAX_N = 16384       # one program holds a whole row in registers
# bias_act's activations; any other name is the identity, as in the reference
_ACTS = {"gelu": 0, "relu": 1, "silu": 2}
_IDENTITY = 3
_GELU_C = math.sqrt(2.0 / math.pi)

tl = None            # triton.language, bound when the kernels are first built
_KERNELS = None


def scaled_masked_softmax_plain(x: torch.Tensor,
                                mask: Optional[torch.Tensor] = None,
                                scale: float = 1.0) -> torch.Tensor:
    """The jnp reference, op for op: fp32 inside, masked entries at -1e30,
    exp(x - max) over its sum, output in x's dtype."""
    xf = x.float() * scale
    if mask is not None:
        xf = torch.where(mask != 0, xf, NEG_INF)
    e = torch.exp(xf - torch.amax(xf, dim=-1, keepdim=True))
    return (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)


def bias_act_plain(x: torch.Tensor, bias: torch.Tensor,
                   act: str = "gelu") -> torch.Tensor:
    """The jnp reference, op for op: act(x + b) in fp32, output in x's
    dtype; ``gelu`` is the tanh form."""
    xf = x.float() + bias.float()
    if act == "gelu":
        y = 0.5 * xf * (1.0 + torch.tanh(_GELU_C * (xf + 0.044715 * xf ** 3)))
    elif act == "relu":
        y = torch.clamp_min(xf, 0.0)
    elif act == "silu":
        y = xf * torch.sigmoid(xf)
    else:
        y = xf
    return y.to(x.dtype)


def _build_kernels():
    global tl, _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _softmax_kernel(x_ptr, m_ptr, y_ptr, n_rows, n, d1, d2, ms0, ms1, ms2,
                        ms3, scale, HAS_MASK: tl.constexpr,
                        BLOCK_R: tl.constexpr, BLOCK_N: tl.constexpr):
        # rows of the flattened [d0 * d1 * d2, n] view; the mask is indexed
        # as [d0, d1, d2, n] by its own strides (0 on a broadcast dim)
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_N)
        inb = (rows < n_rows)[:, None] & (cols < n)[None, :]
        off = rows.to(tl.int64)[:, None] * n + cols[None, :]
        x = tl.load(x_ptr + off, mask=inb, other=0.0).to(tl.float32) * scale
        if HAS_MASK:
            r = rows.to(tl.int64)
            moff = ((r // (d1 * d2)) * ms0 + ((r // d2) % d1) * ms1
                    + (r % d2) * ms2)[:, None] + cols.to(tl.int64)[None, :] * ms3
            keep = tl.load(m_ptr + moff, mask=inb, other=0)
            x = tl.where(keep != 0, x, -1e30)
        # columns past the row's end take no part: exp(-inf - max) = 0
        x = tl.where(inb, x, float("-inf"))
        e = tl.exp(x - tl.max(x, axis=1)[:, None])
        y = e / tl.sum(e, axis=1)[:, None]
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=inb)

    @triton.jit
    def _bias_act_kernel(x_ptr, b_ptr, y_ptr, total, n, ACT: tl.constexpr,
                         BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        inb = offs < total
        x = tl.load(x_ptr + offs, mask=inb, other=0.0).to(tl.float32)
        x = x + tl.load(b_ptr + offs % n, mask=inb, other=0.0).to(tl.float32)
        if ACT == 0:
            # tanh-form GeLU; 0.5 * (1 + tanh(u)) = sigmoid(2u)
            u = 0.7978845608028654 * (x + 0.044715 * x * x * x)
            y = x / (1.0 + tl.exp(-2.0 * u))
        elif ACT == 1:
            y = tl.maximum(x, 0.0)
        elif ACT == 2:
            y = x / (1.0 + tl.exp(-x))
        else:
            y = x
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=inb)

    _KERNELS = (triton, _softmax_kernel, _bias_act_kernel)
    return _KERNELS


def _mask_strides(mask: torch.Tensor, x: torch.Tensor):
    """The keep-mask as the kernel reads it: (tensor, d1, d2, four strides)
    over x seen as [d0, d1, d2, n].  A mask that broadcasts against x with
    at most three leading dims is read in place through its strides; a
    deeper one is broadcast and copied, as the JAX wrapper does."""
    if mask.device != x.device:
        raise ValueError(f"softmax mask: expected a tensor on {x.device}, got "
                         f"{mask.device}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)      # the same bytes, a loadable type
    mask = torch.broadcast_to(mask, x.shape)   # raises unless broadcastable
    if x.dim() > 4:
        mask = mask.reshape(-1, x.shape[-1])   # materialises the broadcast
    lead = (1,) * (4 - mask.dim())
    shape, strides = lead + tuple(mask.shape), (0,) * len(lead) + mask.stride()
    return mask, shape[1], shape[2], strides


def scaled_masked_softmax_triton(x: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 scale: float = 1.0) -> torch.Tensor:
    """Launch the Triton kernel on the current stream; raises on what it
    does not take (device, dtype, contiguity, row length) and on a launch
    error."""
    check_kernel_input("softmax x", x, x.device)
    if x.dim() < 1:
        raise ValueError("softmax: x must have at least one dim")
    n = x.shape[-1]
    if n > SOFTMAX_MAX_N:
        raise ValueError(f"softmax kernel holds a row in one program: n <= "
                         f"{SOFTMAX_MAX_N}, got {n}")
    y = torch.empty_like(x)
    n_rows = x.numel() // n if n else 0
    if not n_rows:
        return y
    triton, kernel, _ = _build_kernels()
    if mask is None:
        m, d1, d2, ms = x, 1, 1, (0, 0, 0, 0)
    else:
        m, d1, d2, ms = _mask_strides(mask, x)
    block_n = triton.next_power_of_2(n)
    block_r = max(1, min(16, 4096 // block_n))
    grid = (triton.cdiv(n_rows, block_r),)
    # Triton's launcher raises when the launch is refused, so a launch that
    # returns here was accepted
    with torch.cuda.device(x.device):
        kernel[grid](x, m, y, n_rows, n, d1, d2, *ms, float(scale),
                     HAS_MASK=mask is not None, BLOCK_R=block_r,
                     BLOCK_N=block_n, num_warps=8 if block_n >= 4096 else 4)
    scaled_masked_softmax.launches += 1
    return y


def scaled_masked_softmax(x: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: float = 1.0) -> torch.Tensor:
    """Softmax of ``x * scale`` over the last dim with an optional keep-mask
    (non-zero = attend, 0 = masked out) that broadcasts against ``x``: the
    Triton kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if use_kernel(x):
        return scaled_masked_softmax_triton(x, mask, scale)
    return scaled_masked_softmax_plain(x, mask, scale)


scaled_masked_softmax.launches = 0   # kernel launches (CUDA tensors only)


def bias_act_triton(x: torch.Tensor, bias: torch.Tensor,
                    act: str = "gelu") -> torch.Tensor:
    """Launch the Triton kernel on the current stream; raises on what it
    does not take (device, dtype, shape, contiguity) and on a launch error."""
    check_kernel_input("bias_act x", x, x.device)
    check_kernel_input("bias_act bias", bias, x.device)
    n = x.shape[-1] if x.dim() else 0
    if bias.shape != (n,):
        raise ValueError(f"bias_act: bias shape {tuple(bias.shape)} != ({n},)")
    y = torch.empty_like(x)
    total = x.numel()
    if not total:
        return y
    triton, _, kernel = _build_kernels()
    block = 4096
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(total, block),)](
            x, bias, y, total, n, ACT=_ACTS.get(act, _IDENTITY), BLOCK=block,
            num_warps=8)
    bias_act.launches += 1
    return y


def bias_act(x: torch.Tensor, bias: torch.Tensor,
             act: str = "gelu") -> torch.Tensor:
    """``act(x + bias)`` with ``act`` one of gelu (tanh form), relu, silu,
    and any other name the identity: the Triton kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if use_kernel(x):
        return bias_act_triton(x, bias, act)
    return bias_act_plain(x, bias, act)


bias_act.launches = 0   # kernel launches (CUDA tensors only)
