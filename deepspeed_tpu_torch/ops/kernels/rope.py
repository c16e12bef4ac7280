"""Rotary position embedding (RoPE): a CUDA C++ kernel for Hopper and its
plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/rope.py`` (``_rope_fwd``, kernel
body ``_rope_kernel``, and ``_rope_bwd_vjp``) and of the rotations that the
JAX decode paths write in plain jnp.  Half-rotation convention (GPT-NeoX /
Llama): the first rd head dims split into halves [x1, x2] -> [x1*cos -
x2*sin, x2*cos + x1*sin], computed in fp32 and written in x's dtype; the
dims past rd pass through (gpt-neox ``rotary_pct``).  rd is
``2 * cos.shape[-1]``.

The kernel is ``deepspeed_tpu_torch/csrc/rope.cu``, built by nvcc at first
use and called through ctypes on the lean host path of :mod:`.common`.
One launch rotates q and k read where they lie (base pointer and batch,
position and head strides; the last dim contiguous) and writes them
contiguous.  The forms, each beside the plain version that its path ran
before, op for op:

- :func:`apply_rotary_pos_emb` (the TPU site's function): x [..., S, D],
  cos/sin [S, D/2] -> y shaped as x; :func:`partial_rope` the same with
  cos/sin [S, rd/2], rd <= D (plain: :func:`rope_plain`,
  :func:`partial_rope_plain`);
- :func:`rope_qk`: the projections' views q [B, S, H, D] and k [B, S, Hkv,
  D] -> contiguous [B, H, S, D] and [B, Hkv, S, D], with one table [S, rd/2]
  (training and prefill; plain: :func:`partial_rope_plain` of the
  transposed ``.contiguous()`` tensors) or per-row tables [B, S, rd/2] (the
  unfused per-row decode; plain: :func:`rope_rows_plain`); its backward is
  one launch for dq and dk, written in the projections' layout;
- :func:`rope_qkv_rows`: the fused decode's [B, (H + 2 Hkv) D] QKV rows ->
  q [B, H, D] and k [B, Hkv, D], contiguous, with tables [1 or B, rd/2]
  (plain: :func:`rope_qkv_rows_plain`).

The kernel rounds each product, difference and sum on its own, as the
plain version's separate operations round them, so on the card the two
agree bit for bit.  The backward rotates by the negated angle (a sign flag
of the launch, no ``-sin`` tensor); cos and sin get no gradient.  Every
launch adds one to ``apply_rotary_pos_emb.launches``.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from deepspeed_tpu_torch.ops.kernels.build import (bind, check_launch,
                                                   load_library)
from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES,
                                                    raw_stream, use_kernel)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """[S] int positions -> ([S, D/2] cos, [S, D/2] sin), fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

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


def partial_rope_plain(x: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``2 * cos.shape[-1]`` dims of x [..., S, D] and pass
    the rest through: ``rope_plain`` of the slice, then a ``cat``."""
    rot = 2 * cos.shape[-1]
    if rot == x.shape[-1]:
        return rope_plain(x, cos, sin)
    rotated = rope_plain(x[..., :rot].contiguous(), cos, sin)
    return torch.cat([rotated, x[..., rot:]], dim=-1)


def rope_rows_plain(t: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Per-row partial RoPE, the unfused decode's (JAX ``_rope_rows``), op
    for op: t [B, Hx, s, D]; cos/sin [B, s, rd/2] at each row's own
    positions."""
    rot = 2 * cos.shape[-1]
    half = cos.shape[-1]
    c = cos[:, None].float()
    sn = sin[:, None].float()
    x1 = t[..., :half].float()
    x2 = t[..., half:rot].float()
    r = torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1).to(t.dtype)
    return torch.cat([r, t[..., rot:]], dim=-1) if rot < t.shape[-1] else r


def rope_qk_plain(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor):
    """:func:`rope_qk`'s plain version: q [B, S, H, D], k [B, S, Hkv, D] ->
    [B, H, S, D], [B, Hkv, S, D], as the paths rotated them before: the
    transposed views made contiguous and rotated (one [S, rd/2] table), or
    rotated row by row (per-row [B, S, rd/2] tables)."""
    if cos.dim() == 3:
        return (rope_rows_plain(q.transpose(1, 2), cos, sin),
                rope_rows_plain(k.transpose(1, 2), cos, sin))
    return (partial_rope_plain(q.transpose(1, 2).contiguous(), cos, sin),
            partial_rope_plain(k.transpose(1, 2).contiguous(), cos, sin))


def rope_qkv_rows_plain(qkv: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor, H: int, Hkv: int, D: int):
    """:func:`rope_qkv_rows`' plain version, the fused decode's rotation
    (JAX ``fused_decode.rope_rows``) op for op: the q and k heads of the
    [B, N] QKV rows side by side, cos/sin [1 or B, rd/2] (fp32 on the path)
    -> (q [B, H, D] contiguous, k [B, Hkv, D])."""
    B = qkv.shape[0]
    half = cos.shape[-1]
    rd = 2 * half
    t = qkv[:, :(H + Hkv) * D].reshape(B, H + Hkv, D)
    c, s = cos[:, None].float(), sin[:, None].float()
    x1 = t[..., :half].float()
    x2 = t[..., half:rd].float()
    rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    if rd < D:
        qk = torch.cat([rot.to(t.dtype), t[..., rd:]], dim=-1)
    else:
        qk = rot.to(t.dtype)
    return qk[:, :H].contiguous(), qk[:, H:]


# ---------------------------------------------------------------------------
# the kernel's host path
# ---------------------------------------------------------------------------

# a launch's arguments, packed as ``csrc/rope.cu``'s RopeCall: x0, x1, y0,
# y1, cos, sin (pointers); x0's and x1's strides (batch, position, head);
# the table's strides (batch, position); B, S, h0, h1, D, half, layout, neg,
# dtype, table_dtype.  One buffer costs ~1 us of host a call where 26
# ctypes arguments cost ~8.
_PACK = struct.Struct("24q").pack
_ARGS = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int]


def _refuse(name: str, xs, cos: torch.Tensor, sin: torch.Tensor,
            shapes: str) -> None:
    """Raise what the kernel refuses in its inputs: the checks of every
    form, run only once the lean test has failed.  ``shapes`` names what
    the form asks of the shapes, raised when all else holds."""
    x = xs[0]
    if not x.is_cuda:
        raise ValueError(f"{name} kernel: expected a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (the kernel "
                        f"takes {sorted(str(d) for d in KERNEL_DTYPES)})")
    for t in xs + (cos, sin):
        if t.device != x.device:
            raise ValueError(f"{name}: expected tensors on {x.device}, got "
                             f"{t.device}")
    for t in xs[1:]:
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: expected dtype {x.dtype}, got {t.dtype}")
    if cos.dtype not in (torch.float32, x.dtype) or sin.dtype != cos.dtype:
        raise TypeError(f"{name}: cos and sin must both be float32 or x's "
                        f"dtype {x.dtype}, got {cos.dtype} / {sin.dtype}")
    for t in xs + (cos, sin):
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous "
                             f"(stride 1), got strides {tuple(t.stride())}")
    if cos.shape != sin.shape or cos.stride() != sin.stride():
        raise ValueError(f"{name}: cos {tuple(cos.shape)} / {tuple(cos.stride())}"
                         f" and sin {tuple(sin.shape)} / {tuple(sin.stride())} "
                         f"must match in shape and strides")
    raise ValueError(f"{name}: {shapes}")


def _launch(args: tuple, dev: int) -> None:
    """One launch of ``csrc/rope.cu``'s ``ds_rope`` on the current stream,
    ``args`` as RopeCall holds them; raises on a CUDA error."""
    err = bind("rope", "ds_rope", _ARGS)(_PACK(*args), raw_stream(dev), dev)
    if err:
        check_launch(load_library("rope"), "rope", err)
    apply_rotary_pos_emb.launches += 1


def _table_bad(cos: torch.Tensor, sin: torch.Tensor, dtype: torch.dtype,
               dev: int, cst) -> bool:
    """The lean test of a table pair (``cst``: cos's strides): a dtype of
    fp32 or x's, on x's device, the last dim contiguous, sin laid out as
    cos."""
    tdt = cos.dtype
    return ((tdt is not torch.float32 and tdt is not dtype)
            or sin.dtype is not tdt or cos.get_device() != dev
            or sin.get_device() != dev or cst[-1] != 1
            or sin.stride() != cst or sin.shape != cos.shape)


def partial_rope_cuda(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      neg: bool = False) -> torch.Tensor:
    """Launch the kernel on x [..., S, D] (any strides, the last dim
    contiguous) with cos/sin [S, rd/2], rd <= D; y is contiguous, shaped as
    x.  ``neg`` rotates by -angle.  Raises on what the kernel does not take
    and on a launch error."""
    dev = x.get_device()
    code = KERNEL_DTYPES.get(x.dtype)
    shape, xst, csh, cst = x.shape, x.stride(), cos.shape, cos.stride()
    nd = len(shape)
    if (code is None or dev < 0 or nd < 2 or xst[-1] != 1 or len(csh) != 2
            or csh[0] != shape[-2] or 2 * csh[1] > shape[-1] or csh[1] < 1
            or _table_bad(cos, sin, x.dtype, dev, cst)):
        _refuse("rope", (x,), cos, sin,
                f"x {tuple(shape)} must be [..., S, D] and cos/sin [S, rd/2] "
                f"with 2 <= rd <= D, got {tuple(csh)}")
    S, D = shape[-2], shape[-1]
    if nd > 4:
        x = x.reshape(-1, S, D)
        xst, nd = x.stride(), 3
    if nd == 4:
        B, H, st = shape[0], shape[1], (xst[0], xst[2], xst[1])
    elif nd == 3:
        B, H, st = x.shape[0], 1, (xst[0], xst[1], 0)
    else:
        B, H, st = 1, 1, (0, xst[0], 0)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    if y.numel():
        _launch((x.data_ptr(), 0, y.data_ptr(), 0, cos.data_ptr(), sin.data_ptr(),
                 *st, 0, 0, 0, 0, cst[0], B, S, H, 0, D, csh[1], 0, int(neg),
                 code, KERNEL_DTYPES[cos.dtype]), dev)
    return y


def rope_qk_cuda(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, backward: bool = False):
    """One launch for q [B, S, H, D] and k [B, S, Hkv, D] (any strides, the
    last dim contiguous) -> contiguous [B, H, S, D] and [B, Hkv, S, D];
    cos/sin [S, rd/2] or per-row [B, S, rd/2].  ``backward``: the
    gradients dq [B, H, S, D] and dk [B, Hkv, S, D] rotated by -angle into
    contiguous [B, S, H, D] and [B, S, Hkv, D], the projections' layout.
    Raises on what the kernel does not take and on a launch error."""
    dev = q.get_device()
    code = KERNEL_DTYPES.get(q.dtype)
    qsh, ksh, qst, kst = q.shape, k.shape, q.stride(), k.stride()
    csh, cst = cos.shape, cos.stride()
    s_dim, h_dim = (2, 1) if backward else (1, 2)
    cd = len(csh)
    if (code is None or dev < 0 or len(qsh) != 4 or len(ksh) != 4
            or k.dtype is not q.dtype or k.get_device() != dev or qst[3] != 1
            or kst[3] != 1 or qsh[h_dim] < 1 or ksh[0] != qsh[0]
            or ksh[s_dim] != qsh[s_dim] or ksh[3] != qsh[3] or cd not in (2, 3)
            or csh[-2] != qsh[s_dim] or (cd == 3 and csh[0] != qsh[0])
            or 2 * csh[-1] > qsh[3] or csh[-1] < 1
            or _table_bad(cos, sin, q.dtype, dev, cst)):
        lay = "[B, heads, S, D]" if backward else "[B, S, heads, D]"
        _refuse("rope_qk", (q, k), cos, sin,
                f"q {tuple(qsh)} and k {tuple(ksh)} must be {lay} and cos/sin "
                f"[S, rd/2] or [B, S, rd/2] with 2 <= rd <= D, got {tuple(csh)}")
    B, S, H, D = qsh[0], qsh[s_dim], qsh[h_dim], qsh[3]
    Hk = ksh[h_dim]
    # the outputs swap the inputs' position and head dims
    shape = (B, S, H, D) if backward else (B, H, S, D)
    yq = torch.empty(shape, dtype=q.dtype, device=q.device)
    yk = torch.empty(shape[:s_dim] + (Hk,) + shape[s_dim + 1:], dtype=q.dtype,
                     device=q.device)
    if yq.numel():
        _launch((q.data_ptr(), k.data_ptr(), yq.data_ptr(), yk.data_ptr(),
                 cos.data_ptr(), sin.data_ptr(), qst[0], qst[s_dim], qst[h_dim],
                 kst[0], kst[s_dim], kst[h_dim], cst[0] if cd == 3 else 0,
                 cst[-2], B, S, H, Hk, D, csh[-1], int(backward),
                 int(backward), code, KERNEL_DTYPES[cos.dtype]), dev)
    return yq, yk


def rope_qkv_rows_cuda(qkv: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor, H: int, Hkv: int, D: int):
    """One launch for the q and k heads of the fused QKV rows qkv [B, N]
    (N >= (H + Hkv) D, the last dim contiguous) -> q [B, H, D] and k [B,
    Hkv, D], contiguous; cos/sin [1 or B, rd/2].  Raises on what the kernel
    does not take and on a launch error."""
    dev = qkv.get_device()
    code = KERNEL_DTYPES.get(qkv.dtype)
    xsh, xst, csh, cst = qkv.shape, qkv.stride(), cos.shape, cos.stride()
    if (code is None or dev < 0 or len(xsh) != 2 or xst[1] != 1
            or xsh[1] < (H + Hkv) * D or H < 1 or Hkv < 1 or len(csh) != 2
            or (csh[0] != 1 and csh[0] != xsh[0]) or 2 * csh[1] > D
            or csh[1] < 1 or _table_bad(cos, sin, qkv.dtype, dev, cst)):
        _refuse("rope_qkv_rows", (qkv,), cos, sin,
                f"qkv {tuple(xsh)} must be [B, N >= (H + Hkv) D] = [B, >= "
                f"{(H + Hkv) * D}] and cos/sin [1 or B, rd/2] with 2 <= rd <= "
                f"D = {D}, got {tuple(csh)}")
    B = xsh[0]
    q = torch.empty(B, H, D, dtype=qkv.dtype, device=qkv.device)
    k = torch.empty(B, Hkv, D, dtype=qkv.dtype, device=qkv.device)
    if B:
        p = qkv.data_ptr()
        _launch((p, p + H * D * qkv.element_size(), q.data_ptr(), k.data_ptr(),
                 cos.data_ptr(), sin.data_ptr(), xst[0], 0, D, xst[0], 0, D,
                 cst[0] if csh[0] > 1 else 0, 0, B, 1, H, Hkv, D, csh[1], 0, 0,
                 code, KERNEL_DTYPES[cos.dtype]), dev)
    return q, k


# ---------------------------------------------------------------------------
# the forms
# ---------------------------------------------------------------------------

class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        if use_kernel(x):
            return partial_rope_cuda(x, cos, sin)
        return partial_rope_plain(x, cos, sin)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        if use_kernel(dy):
            return partial_rope_cuda(dy, cos, sin, neg=True), None, None
        return partial_rope_plain(dy, cos, -sin), None, None


def partial_rope(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first rd = ``2 * cos.shape[-1]`` dims of x [..., S, D]
    (cos/sin [S, rd/2]) and pass the rest through: the CUDA kernel for a
    CUDA tensor, :func:`partial_rope_plain` for a CPU tensor;
    differentiable in ``x`` (the backward rotates by the negated angle
    through the same kernel)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rope.apply(x, cos, sin)
    if x.is_cuda or use_kernel(x):
        return partial_rope_cuda(x, cos, sin)
    return partial_rope_plain(x, cos, sin)


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor; differentiable in ``x``.  ``x``: [..., S, D] with an even
    D, all of it rotated; ``cos``/``sin``: [S, D/2]."""
    if 2 * cos.shape[-1] != x.shape[-1]:
        raise ValueError(f"apply_rotary_pos_emb: rotates all of an even D: x "
                         f"{tuple(x.shape)} needs cos/sin [S, {x.shape[-1] / 2}],"
                         f" got {tuple(cos.shape)} (partial_rope rotates fewer)")
    return partial_rope(x, cos, sin)


apply_rotary_pos_emb.launches = 0   # launches of csrc/rope.cu, every form,
                                    # forward and backward (CUDA tensors only)


class _RopeQK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        if use_kernel(q):
            return rope_qk_cuda(q, k, cos, sin)
        return rope_qk_plain(q, k, cos, sin)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        if use_kernel(dq):
            return (*rope_qk_cuda(dq, dk, cos, sin, backward=True), None,
                    None)
        if cos.dim() == 3:
            gq, gk = (rope_rows_plain(g, cos, -sin) for g in (dq, dk))
        else:
            gq, gk = (partial_rope_plain(g, cos, -sin) for g in (dq, dk))
        return gq.transpose(1, 2), gk.transpose(1, 2), None, None


def rope_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor):
    """RoPE on the projections' views: q [B, S, H, D] and k [B, S, Hkv, D]
    -> (q, k) rotated, contiguous [B, H, S, D] and [B, Hkv, S, D] (the
    attention kernels' layout).  cos/sin: [S, rd/2] (every row at the same
    positions) or [B, S, rd/2] (each row's own); the dims past rd pass
    through.  One kernel launch for both on a CUDA tensor, the plain
    version on a CPU tensor; differentiable in q and k (the backward, one
    launch, writes dq and dk in the projections' layout)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _RopeQK.apply(q, k, cos, sin)
    if q.is_cuda or use_kernel(q):
        return rope_qk_cuda(q, k, cos, sin)
    return rope_qk_plain(q, k, cos, sin)


def rope_qkv_rows(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  H: int, Hkv: int, D: int):
    """The fused decode's RoPE: the q and k heads of the [B, (H + 2 Hkv) D]
    QKV rows -> (q [B, H, D] contiguous, k [B, Hkv, D]); cos/sin [1 or B,
    rd/2].  One kernel launch on a CUDA tensor, the plain version on a CPU
    tensor; no gradient (serving)."""
    if qkv.is_cuda or use_kernel(qkv):
        return rope_qkv_rows_cuda(qkv, cos, sin, H, Hkv, D)
    return rope_qkv_rows_plain(qkv, cos, sin, H, Hkv, D)
