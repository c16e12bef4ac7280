"""Rotary position embedding (RoPE): a Triton kernel and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/rope.py``.  Half-rotation
convention (GPT-NeoX / Llama): the head dim splits into halves [x1, x2] ->
[x1*cos - x2*sin, x2*cos + x1*sin], computed in fp32 and written in x's
dtype.  ``x`` is [..., S, D]; ``cos``/``sin`` are [S, D/2] from
:func:`rope_angles`.

The Triton kernel replaces the Pallas ``_rope_fwd`` (kernel body
``_rope_kernel``).  What bounds it on the H100: memory bytes — each element
is read once and written once with four fp32 operations between, and a
serving call moves well under 1 MB, so a launch costs more than its bytes.
Design: a pure elementwise pass with no reduction and no reuse, so one
program rotates a tile of BLOCK_R rows x D/2 column pairs with masked
block loads; the cos/sin row of each x row is re-read from L2 rather than
staged.  ``triton`` is imported when the kernel is first launched, never
at module import.

The backward is ``_rope_bwd_vjp``: the rotation is orthogonal, so its VJP
is the same kernel launched with ``-sin``; cos and sin get no gradient.
:func:`apply_rotary_pos_emb` is a :class:`torch.autograd.Function` when
autograd records, and a plain call otherwise (serving).
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops.kernels.common import check_kernel_input, use_kernel

tl = None            # triton.language, bound when the kernel is first built
_KERNEL = None


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """[S] int positions -> ([S, D/2] cos, [S, D/2] sin), fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope_plain(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """The jnp reference (``_rope_ref``), op for op."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    shape = (1,) * (x.dim() - 2) + tuple(cos.shape)
    c = cos.reshape(shape).float()
    s = sin.reshape(shape).float()
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


def _build_kernel():
    global tl, _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _rope_fwd_kernel(x_ptr, cos_ptr, sin_ptr, y_ptr, n_rows, S, HALF,
                         BLOCK_R: tl.constexpr, BLOCK_H: tl.constexpr):
        # rows of the flattened [lead * S, D] view; row r sits at position
        # r % S and reads that row of cos/sin
        pid = tl.program_id(0)
        rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_H)
        rmask = rows < n_rows
        mask = rmask[:, None] & (cols[None, :] < HALF)
        pos = rows % S
        x_row = rows.to(tl.int64)[:, None] * (2 * HALF)
        cs_off = pos.to(tl.int64)[:, None] * HALF + cols[None, :]
        x1 = tl.load(x_ptr + x_row + cols[None, :], mask=mask).to(tl.float32)
        x2 = tl.load(x_ptr + x_row + HALF + cols[None, :],
                     mask=mask).to(tl.float32)
        c = tl.load(cos_ptr + cs_off, mask=mask).to(tl.float32)
        s = tl.load(sin_ptr + cs_off, mask=mask).to(tl.float32)
        out_ty = y_ptr.dtype.element_ty
        tl.store(y_ptr + x_row + cols[None, :], (x1 * c - x2 * s).to(out_ty),
                 mask=mask)
        tl.store(y_ptr + x_row + HALF + cols[None, :],
                 (x2 * c + x1 * s).to(out_ty), mask=mask)

    _KERNEL = (triton, _rope_fwd_kernel)
    return _KERNEL


def rope_triton(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Launch the Triton kernel on the current stream; raises on what it does
    not take (device, dtype, shape, contiguity) and on a launch error."""
    check_kernel_input("rope x", x, x.device)
    check_kernel_input("rope cos", cos, x.device)
    check_kernel_input("rope sin", sin, x.device, dtype=cos.dtype)
    if x.dim() < 2:
        raise ValueError(f"rope: x must be [..., S, D], got {tuple(x.shape)}")
    S, D = x.shape[-2], x.shape[-1]
    if D % 2 or cos.shape != (S, D // 2) or sin.shape != cos.shape:
        raise ValueError(f"rope: x {tuple(x.shape)} needs even D and cos/sin "
                         f"[{S}, {D // 2}], got {tuple(cos.shape)} / "
                         f"{tuple(sin.shape)}")
    triton, kernel = _build_kernel()
    y = torch.empty_like(x)
    n_rows = x.numel() // D if D else 0
    if n_rows:
        block_h = triton.next_power_of_2(D // 2)
        block_r = max(1, min(64, 4096 // block_h))
        grid = (triton.cdiv(n_rows, block_r),)
        # Triton's launcher checks the CUresult of cuLaunchKernel and raises
        # RuntimeError when the launch is refused, so a launch that returns
        # here was accepted
        with torch.cuda.device(x.device):
            kernel[grid](x, cos, sin, y, n_rows, S, D // 2,
                         BLOCK_R=block_r, BLOCK_H=block_h, num_warps=4)
        apply_rotary_pos_emb.launches += 1
    return y


def _rope(x, cos, sin):
    if use_kernel(x):
        return rope_triton(x, cos, sin)
    return rope_plain(x, cos, sin)


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rope(x, cos, sin)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        return _rope(dy.contiguous(), cos, -sin), None, None


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE: the Triton kernel for a CUDA tensor, the plain version for
    a CPU tensor; differentiable in ``x`` (the backward rotates by the
    negated angle through the same kernel).  ``x``: [..., S, D];
    ``cos``/``sin``: [S, D/2]."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rope.apply(x, cos, sin)
    return _rope(x, cos, sin)


apply_rotary_pos_emb.launches = 0   # kernel launches, forward and backward
                                    # (CUDA tensors only)
