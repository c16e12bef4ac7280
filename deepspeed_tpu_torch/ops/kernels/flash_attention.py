"""Causal flash attention, forward and backward: CUDA C++ kernels and the
plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``.  q, k, v
are [B, H, S, Dh].  A CUDA tensor runs the kernels of
``deepspeed_tpu_torch/csrc/flash_attention.cu`` through a
:class:`torch.autograd.Function`, whose forward saves the fp32 logsumexp
[B, H, S] for the backward.  For bf16 every kernel runs its products on
Hopper's ``wgmma`` over swizzled shared-memory tiles, 128 rows a block, the
other side streamed through a four-stage ring: the forward, then for the
backward a pre-pass that writes ``delta = rowsum(do * o)``, the dQ kernel
and the dK/dV kernel (no atomics, so two calls give the same bits).  fp16
runs the same kernels instantiated for float16 (``*_f16_kernel``: what
``fp16.enabled`` training runs), through wrappers with launch counts of
their own (:func:`flash_fwd_f16_cuda`, :func:`flash_attention_bwd_f16` and
their ALiBi twins, all made by ``_instances``).  For fp32 a scalar
forward, dQ kernel (which writes delta itself) and dK/dV kernel.  A CPU
tensor runs :func:`mha_reference`, the jnp reference op for op, and
autograd takes its backward — what the JAX ``impl="xla"`` path does.

The kernels take ``S == Sk`` only (all the training path produces; see the
``S != Sk`` hazard in ROADMAP.md queue 3), head dims 32, 64 and 128 (every
preset's: llama-tiny and mixtral-tiny 32, GPT-2 64, Llama 128), bf16 and
fp16 (the tensor-core path) or fp32 (a scalar path for the fp32 reference
runs).  A ragged S is masked inside the kernels.

``alibi=True`` (BLOOM) adds the per-head bias ``slope_h * (col - row)`` to
the scaled logits before the causal mask, as the Pallas kernels do: on a
CUDA tensor the kernels' ALiBi instances (:func:`flash_fwd_alibi_cuda`,
:func:`flash_attention_bwd_alibi`, each with its own launch count), reading
the slope table of ``alibi_slopes(H)`` kept on the card; on a CPU tensor
:func:`mha_reference` with the JAX ``_alibi_ref_bias``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels.build import check_launch, load_library
from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES,
                                                    alibi_slopes_on,
                                                    check_kernel_input,
                                                    use_kernel)

NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The jnp reference op for op: fp32 logits times scale, plus ``bias``
    (broadcast to [B, H, S, Sk]) where given, the causal mask offset by
    ``Sk - S`` (query i sees keys <= i + Sk - S) with NEG_INF, softmax, fp32
    probs . fp32 v, cast to q's dtype."""
    S, D = q.shape[-2], q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        Sk = k.shape[-2]
        mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                      device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _library():
    built = load_library("flash_attention")
    lib = built.lib
    if lib.ds_flash_fwd.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # ..., BH, S, D, scale, causal, slopes (None: no ALiBi), H, dtype, stream
        tail = [ci, ci, ci, cf, ci, vp, ci, ci, vp]
        lib.ds_flash_fwd.argtypes = [vp] * 5 + tail
        lib.ds_flash_fwd.restype = ci
        lib.ds_flash_bwd.argtypes = [vp] * 10 + tail
        lib.ds_flash_bwd.restype = ci
    return built


def _check(q, k, v, f16: bool):
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_input(f"flash_attention {name}", t, q.device,
                           dtype=q.dtype)
    if (q.dtype == torch.float16) != f16:
        raise TypeError(f"flash_attention: the {'fp16' if f16 else 'fp32 and bf16'}"
                        f" wrappers got {q.dtype} (fp16 goes to the *_f16 ones)")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention kernel takes q, k, v of one shape "
                         f"[B, H, S, Dh] (S == Sk), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{_HEAD_DIMS}, got {q.shape[-1]} (other head dims: "
                         f"ROADMAP.md queue 2)")


def _fwd(q, k, v, causal, scale, slopes, f16=False):
    _check(q, k, v, f16)
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, device=q.device, dtype=torch.float32)
    built = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = built.lib.ds_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B * H, S, D, float(scale), int(causal),
            None if slopes is None else slopes.data_ptr(), H,
            KERNEL_DTYPES[q.dtype], stream)
    check_launch(built, "flash_attention fwd", code)
    return o, lse


def flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    """Forward kernel, fp32 or bf16: (o [B, H, S, Dh] in q's dtype, lse
    [B, H, S] fp32)."""
    out = _fwd(q, k, v, causal, scale, None)
    flash_attention.launches += 1
    return out


def _bwd(q, k, v, o, lse, do, causal, scale, slopes, f16=False):
    _check(q, k, v, f16)
    for name, t in (("o", o), ("do", do)):
        check_kernel_input(f"flash_attention {name}", t, q.device,
                           dtype=q.dtype)
    check_kernel_input("flash_attention lse", lse, q.device,
                       dtype=torch.float32)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("flash_attention bwd: o, do must match q and lse "
                         "must be [B, H, S]")
    B, H, S, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, S, device=q.device, dtype=torch.float32)
    built = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = built.lib.ds_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B * H, S, D, float(scale),
            int(causal), None if slopes is None else slopes.data_ptr(), H,
            KERNEL_DTYPES[q.dtype], stream)
    check_launch(built, "flash_attention bwd", code)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """Backward kernels, fp32 or bf16 (bf16: the delta pre-pass, dQ, then
    dK/dV; fp32: dQ with delta, then dK/dV), counted as one call: (dq, dk,
    dv) in q's dtype."""
    out = _bwd(q, k, v, o, lse, do, causal, scale, None)
    flash_attention_bwd.launches += 1
    return out


flash_attention_bwd.launches = 0   # backward calls (2 or 3 kernel launches each)


def _instances(f16: bool, alibi: bool):
    """The forward and backward wrappers of the kernels' fp16 and ALiBi
    instances (ALiBi: the bias ``slope_h * (col - row)`` added to the
    scaled logits; the delta pre-pass is shared), as :func:`flash_fwd_cuda`
    and :func:`flash_attention_bwd`, each with a launch count of its own."""
    tag = "_f16" * f16 + "_alibi" * alibi

    def slopes(q):
        return alibi_slopes_on(q.shape[1], q.device) if alibi else None

    def fwd(q, k, v, causal: bool, scale: float):
        out = _fwd(q, k, v, causal, scale, slopes(q), f16)
        fwd.launches += 1
        return out

    def bwd(q, k, v, o, lse, do, causal: bool, scale: float):
        out = _bwd(q, k, v, o, lse, do, causal, scale, slopes(q), f16)
        bwd.launches += 1
        return out

    fwd.__name__ = fwd.__qualname__ = f"flash_fwd{tag}_cuda"
    bwd.__name__ = bwd.__qualname__ = f"flash_attention_bwd{tag}"
    fwd.launches = bwd.launches = 0
    return fwd, bwd


# (fp16, alibi) -> the forward and backward wrappers of those instances
_WRAPPERS = {(False, False): (flash_fwd_cuda, flash_attention_bwd),
             **{key: _instances(*key)
                for key in ((False, True), (True, False), (True, True))}}
flash_fwd_alibi_cuda, flash_attention_bwd_alibi = _WRAPPERS[False, True]
flash_fwd_f16_cuda, flash_attention_bwd_f16 = _WRAPPERS[True, False]
flash_fwd_f16_alibi_cuda, flash_attention_bwd_f16_alibi = _WRAPPERS[True, True]


def wrappers(dtype: torch.dtype, alibi: bool):
    """The (forward, backward) kernel wrappers for q's dtype and ALiBi."""
    return _WRAPPERS[(dtype == torch.float16, bool(alibi))]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, alibi):
        o, lse = wrappers(q.dtype, alibi)[0](q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.alibi = causal, scale, alibi
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = wrappers(q.dtype, ctx.alibi)[1]
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                         ctx.scale)
        return dq, dk, dv, None, None, None


def _alibi_ref_bias(q, k, alibi):
    """The JAX ``_alibi_ref_bias``: [1, H, S, Sk] fp32 on q's device, query
    i at position i + (Sk - S) (mha_reference's offset mask convention)."""
    if not alibi:
        return None
    from deepspeed_tpu_torch.models.layers import alibi_bias

    H, S, Sk = q.shape[1], q.shape[2], k.shape[2]
    return alibi_bias(H, torch.arange(S, device=q.device) + (Sk - S),
                      torch.arange(Sk, device=q.device))[None]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    alibi: bool = False) -> torch.Tensor:
    """Memory-efficient attention, [B, H, S, Dh] -> [B, H, S, Dh]: the CUDA
    kernels (differentiable) for a CUDA tensor, :func:`mha_reference` for a
    CPU tensor; ``alibi`` adds the per-head linear position bias."""
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if use_kernel(q):
        return _FlashAttention.apply(q, k, v, causal, scale, alibi)
    return mha_reference(q, k, v, causal=causal, sm_scale=scale,
                         bias=_alibi_ref_bias(q, k, alibi))


flash_attention.launches = 0   # fp32 and bf16 forward launches (CUDA tensors only)
