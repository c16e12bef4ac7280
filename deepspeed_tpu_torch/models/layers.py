"""Model building blocks wired to the port's kernels.

Counterpart of ``deepspeed_tpu/models/layers.py``: the norm and RoPE
helpers dispatch to ``deepspeed_tpu_torch/ops/kernels`` (a kernel for a
CUDA tensor, the plain version for a CPU tensor); everything else is plain
PyTorch, as the JAX package left it to XLA.  :func:`attention_core` is the
training attention: the flash kernels for a CUDA tensor, the jnp reference
(``mha_reference``) for a CPU tensor.  Meshes, sharding constraints and
sequence parallelism are not in the port yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.kernels import rms_norm, rope_angles
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.kernels.layer_norm import layer_norm
from deepspeed_tpu_torch.ops.kernels.rope import partial_rope


def norm(x: torch.Tensor, params, kind: str, eps: float) -> torch.Tensor:
    """RMSNorm or LayerNorm through the port's kernels, differentiable
    (each backward is the norm's backward kernel)."""
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"], eps=eps)
    return layer_norm(x, params["scale"], params["bias"], eps=eps)


def activation_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_exact": lambda x: F.gelu(x, approximate="none"),
            "relu": F.relu}[name]


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand [B, Hkv, S, D] -> [B, Hkv*n_rep, S, D]; head h reads kv
    head h // n_rep."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=1)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.): geometric 2^(-8i/H) for
    power-of-two H, with the standard interpolation for other head counts."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    n = 2 ** math.floor(math.log2(num_heads))
    slopes = pow2_slopes(n)
    if n < num_heads:
        extra = pow2_slopes(2 * n)
        slopes += extra[0::2][: num_heads - n]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def alibi_bias(num_heads: int, q_pos: torch.Tensor,
               k_pos: torch.Tensor) -> torch.Tensor:
    """[H, |q|, |k|] additive attention bias: slope_h * (k - q)
    (non-positive under the causal mask), fp32 on the positions' device."""
    slopes = alibi_slopes(num_heads, device=q_pos.device)
    rel = k_pos[None, :].float() - q_pos[:, None].float()
    return slopes[:, None, None] * rel[None]


def apply_partial_rope(x: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``2*cos.shape[-1]`` head dims, pass the rest through
    (gpt-neox ``rotary_pct``): one launch of the RoPE kernel, which copies
    the rest through itself."""
    return partial_rope(x, cos, sin)


def rope_dim(cfg) -> int:
    """Rotated head dims (even; head_dim * rotary_pct, neox convention)."""
    d = int(cfg.head_dim * cfg.rotary_pct)
    return max(2, d - (d % 2))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, alibi: bool = False) -> torch.Tensor:
    """Multi-head attention on [B, H, S, Dh]: the JAX ``attention_core``
    with no mesh.  A CUDA tensor runs the flash attention kernels
    (differentiable; their ALiBi instances under ``alibi``), a CPU tensor
    ``mha_reference`` with autograd's backward."""
    return flash_attention(q, k, v, causal=causal, alibi=alibi)


def rope_cache(seq_len: int, head_dim: int, theta: float, device=None):
    """(cos, sin) [seq_len, head_dim/2] fp32 for positions 0..seq_len-1."""
    return rope_angles(torch.arange(seq_len, device=device), head_dim, theta=theta)
