"""Fused 8-bit-state AdamW update: a CUDA C++ kernel and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_adam8bit.py``
``fused_adam8bit_update``.  The kernel is
``deepspeed_tpu_torch/csrc/fused_adam8bit.cu``: one pass per row of
``block`` elements (dequant m and sqrt-space v, the Adam moments, the
AdamW direction, the new p, the per-row absmax requant of m and sqrt(v),
and for bf16 params the stochastic rounding), fp32 math, int8 / bf16 I/O.

Both versions differ from the JAX function in two ways:

- they update ``p``, ``m_q``, ``m_scale``, ``v_q`` and ``v_scale`` IN
  PLACE (at llama-1b4 a second copy of the largest leaf's state and
  parameters costs gigabytes);
- ``p`` and ``g`` are the leaf's own buffers with their true ``n``
  elements, not ``[nb, block]`` padded copies: positions past ``n`` are
  the zeros that ``adam8bit.py``'s ``pad2d`` would add, and ``p`` is never
  written there.  The state keeps the JAX layout: int8 ``[nb_pad, block]``
  and fp32 ``[nb_pad, 1]``, ``nb_pad`` = ceil(n / block) rounded up to
  ``ROW_MULT`` rows, so it compares with JAX element for element.

Stochastic rounding takes its 16 random bits from :func:`sr_noise`, a
counter-based hash of (seed, flat element index) that the kernel computes
identically, and applies the TPU kernel's bit rule (add them to the fp32
pattern, clear the low 16 bits).  It cannot give the TPU's bits; against
the JAX package it is held by its distribution.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.kernels.build import check_launch, load_library
from deepspeed_tpu_torch.ops.kernels.common import check_kernel_input, use_kernel
from deepspeed_tpu_torch.ops.kernels.fused_adam import bias_corrections
from deepspeed_tpu_torch.ops.kernels.quantizer import quantize_plain

ROW_MULT = 32                      # rows of the state, a multiple of this
BLOCKS = tuple(1 << k for k in range(7, 13))     # 128 .. 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


def check_block(block: int) -> int:
    if block not in BLOCKS:
        raise ValueError(f"fused_adam8bit: block must be a power of two in "
                         f"[128, 4096], got {block}")
    return block


def state_rows(n: int, block: int) -> int:
    """Rows of a leaf's int8 state: ceil(n / block) rounded up to ROW_MULT."""
    nb = -(-n // block)
    return -(-nb // ROW_MULT) * ROW_MULT


def sr_seed(count: int, leaf_index: int) -> int:
    """The seed of a leaf's noise at a 1-based step count, as the JAX
    optimizer forms it in int32 (``count * 1000003 + i * 7919``, wrapping),
    returned as its 32-bit pattern."""
    return (count * 1000003 + leaf_index * 7919) & _M32


def mix32_int(x: int) -> int:
    """The kernel's 32-bit integer hash (a Python int in [0, 2^32))."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # (x * c) mod 2^32 for int64 x in [0, 2^32), without an int64 overflow
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sr_noise(seed: int, n: int, device) -> torch.Tensor:
    """The 16 random bits (int64 in [0, 65536)) that stochastic rounding
    adds to element ``i`` of a leaf: ``mix32(i ^ mix32(seed)) & 0xFFFF``."""
    idx = torch.arange(n, device=device, dtype=torch.int64)
    return _mix32(idx ^ mix32_int(seed)) & 0xFFFF


def stochastic_round_bf16(x32: torch.Tensor, seed: int) -> torch.Tensor:
    """Unbiased fp32 -> bf16 rounding with the noise of ``seed``: add 16
    random bits to the fp32 pattern, clear the low 16 (the carry into the
    exponent gives the next binade), keep the top 16."""
    flat = x32.reshape(-1).float()
    bits = flat.view(torch.int32).to(torch.int64) & _M32
    r = (bits + sr_noise(seed, flat.numel(), flat.device)) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return r.view(torch.float32).to(torch.bfloat16).view(x32.shape)


def _check_state(p, g, mq, ms, vq, vs):
    n = p.numel()
    if g.numel() != n:
        raise ValueError(f"fused_adam8bit: p has {n} elements, g {g.numel()}")
    if mq.dim() != 2 or mq.dtype != torch.int8:
        raise ValueError("fused_adam8bit: m_q must be int8 [rows, block]")
    rows, block = mq.shape
    check_block(block)
    if rows != state_rows(n, block):
        raise ValueError(f"fused_adam8bit: {rows} state rows for {n} elements "
                         f"at block {block}, expected {state_rows(n, block)}")
    if vq.shape != mq.shape or vq.dtype != torch.int8:
        raise ValueError("fused_adam8bit: v_q must match m_q")
    for name, s in (("m_scale", ms), ("v_scale", vs)):
        if s.shape != (rows, 1) or s.dtype != torch.float32:
            raise ValueError(f"fused_adam8bit: {name} must be float32 "
                             f"[{rows}, 1], got {s.dtype} {tuple(s.shape)}")
    return n, rows, block


def fused_adam8bit_update_plain(p, g, mq, ms, vq, vs, step: int, *, lr: float,
                                beta1: float = 0.9, beta2: float = 0.999,
                                eps: float = 1e-8, weight_decay: float = 0.0,
                                seed: int = 0, sr: bool = False) -> None:
    """The jnp formula over the zero-padded [rows, block] view, written back
    into p (its first n elements) and the state; ``step`` is 1-based."""
    n, rows, block = _check_state(p, g, mq, ms, vq, vs)
    c1, c2 = bias_corrections(step, beta1, beta2)
    pad = rows * block - n
    pf = F.pad(p.reshape(-1).float(), (0, pad)).view(rows, block)
    gf = F.pad(g.reshape(-1).float(), (0, pad)).view(rows, block)
    m = mq.float() * ms
    rv = vq.float() * vs
    v = rv * rv
    m = beta1 * m + (1 - beta1) * gf
    v = beta2 * v + (1 - beta2) * gf * gf
    update = (m * c1) / (torch.sqrt(v * c2) + eps) + weight_decay * pf
    new = (pf - lr * update).reshape(-1)[:n]
    for x, q_out, s_out in ((m, mq, ms), (torch.sqrt(v), vq, vs)):
        q, s, _ = quantize_plain(x, 8, block)
        q_out.copy_(q)
        s_out.copy_(s[:, None])
    if sr and p.dtype == torch.bfloat16:
        p.copy_(stochastic_round_bf16(new, seed).view(p.shape))
    else:
        p.copy_(new.view(p.shape))


def _library():
    built = load_library("fused_adam8bit")
    fn = built.lib.ds_fused_adam8bit
    if fn.argtypes is None:
        vp, cf = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = ([vp] * 6 + [ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [cf] * 9
                       + [ctypes.c_uint, ctypes.c_int, vp])
        fn.restype = ctypes.c_int
        built.lib.ds_mix32.argtypes = [ctypes.c_uint]
        built.lib.ds_mix32.restype = ctypes.c_uint
    return built


def fused_adam8bit_update_cuda(p, g, mq, ms, vq, vs, step: int, *, lr: float,
                               beta1: float = 0.9, beta2: float = 0.999,
                               eps: float = 1e-8, weight_decay: float = 0.0,
                               seed: int = 0, sr: bool = False) -> None:
    """Launch the kernel on the current stream (in place); raises on what it
    does not take and on a launch error."""
    check_kernel_input("fused_adam8bit p", p, p.device)
    check_kernel_input("fused_adam8bit g", g, p.device)
    if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
        raise TypeError(f"fused_adam8bit kernel takes fp32 or bf16 params and "
                        f"grads, got {p.dtype} / {g.dtype}")
    n, rows, block = _check_state(p, g, mq, ms, vq, vs)
    for name, t in (("m_q", mq), ("m_scale", ms), ("v_q", vq), ("v_scale", vs)):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"fused_adam8bit {name}: expected a contiguous "
                             f"tensor on {p.device}")
    if n >= 1 << 32:
        raise ValueError(f"fused_adam8bit: a leaf of {n} elements is past the "
                         f"noise's 32-bit element index")
    c1, c2 = bias_corrections(step, beta1, beta2)
    built = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        code = built.lib.ds_fused_adam8bit(
            p.data_ptr(), g.data_ptr(), mq.data_ptr(), ms.data_ptr(),
            vq.data_ptr(), vs.data_ptr(), n, rows, block, _DTYPES[p.dtype],
            _DTYPES[g.dtype], float(lr), c1, c2, float(beta1), float(beta2),
            1.0 - beta1, 1.0 - beta2, float(eps), float(weight_decay),
            seed & _M32, int(bool(sr)), stream)
    check_launch(built, "fused_adam8bit", code)
    fused_adam8bit_update.launches += 1


def fused_adam8bit_update(p, g, mq, ms, vq, vs, step: int, *, lr: float,
                          beta1: float = 0.9, beta2: float = 0.999,
                          eps: float = 1e-8, weight_decay: float = 0.0,
                          seed: int = 0, sr: bool = False) -> None:
    """One AdamW step of one leaf over int8 state, in place; ``step`` is the
    1-based count, ``seed`` the leaf's noise (:func:`sr_seed`), ``sr``
    rounds a bf16 ``p`` stochastically (an fp32 ``p`` is never).  The CUDA
    kernel for a CUDA tensor, the plain version for a CPU one."""
    fn = (fused_adam8bit_update_cuda if use_kernel(p)
          else fused_adam8bit_update_plain)
    fn(p, g, mq, ms, vq, vs, step, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
       weight_decay=weight_decay, seed=seed, sr=sr)


fused_adam8bit_update.launches = 0   # kernel launches (CUDA tensors only)
