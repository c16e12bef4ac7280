"""Kernel-injected decode path: four fused kernel calls per layer at s=1.

Counterpart of ``deepspeed_tpu/models/fused_decode.py``, the serving
engine's default decode.  :func:`inject_decode_params` lays the weights out
for the fused kernels (Q, K and V concatenated into one [D, N] matrix per
layer) and :func:`decode_step` runs one token per slot through
``ops/kernels/decode.py``: norm+QKV, paged flash-decode attention,
out-projection+residual+norm, MLP+residual — four calls per layer instead
of the unfused path's chain of small ops.  Prefill keeps
:func:`~deepspeed_tpu_torch.models.decoding.forward_with_cache` on the plain
tree; both read and write the same paged KV pool.

This slice carries the paged, per-row-position branch of ``decode_step``
(what the continuous-batching engine runs).  A scalar position or a
contiguous cache (``generate()``, the fixed-slot layout) raises, as do int8
weights (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from deepspeed_tpu_torch.models.layers import norm, rope_dim
from deepspeed_tpu_torch.ops.kernels import rope_angles
from deepspeed_tpu_torch.ops.kernels.decode import (flash_decode, fused_mlp,
                                                    fused_norm_qkv,
                                                    fused_proj_norm)


def supports_fused_decode(cfg, *, quantized_kv: bool = False,
                          tp: int = 1) -> bool:
    """The JAX gate: dense rope/learned/alibi models at tp=1 with a bf16 (not
    int8) KV cache take the fused path; MoE MLPs, int8 KV caches and tp>1
    stay on the unfused loop."""
    return (not cfg.is_moe and not quantized_kv
            and tp == 1 and cfg.position in ("rope", "learned", "alibi"))


def inject_decode_params(params: Any, cfg) -> Dict[str, Any]:
    """Build the kernel-injected weight view from a model param tree.

    Layers are unstacked into a tuple of per-layer dicts, as in the JAX
    package.  Where the JAX code copies every per-layer leaf into a buffer
    of its own (a slice of a stacked array inside its compiled program would
    be re-materialised per token), here every leaf except the QKV weight is
    ``stacked[l]``: a contiguous view of the engine's own tensors, which
    costs nothing.  The one new buffer is ``wqkv`` (and ``bqkv``), the
    concatenation of wq | wk | wv: 1.61 GB at llama3-8b in bf16.  Int8
    weights are refused before this point (the engine's dtype check)."""
    ly = params["layers"]
    attn, mlp = ly["attn"], ly["mlp"]
    stacked: Dict[str, Any] = {
        "wqkv": torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=-1),
        "wo": attn["wo"],
        "n1_scale": ly["attn_norm"]["scale"],
        "n2_scale": ly["mlp_norm"]["scale"],
        "w_up": mlp["w_up"],
        "w_down": mlp["w_down"],
    }
    if cfg.norm == "layernorm":
        stacked["n1_bias"] = ly["attn_norm"]["bias"]
        stacked["n2_bias"] = ly["mlp_norm"]["bias"]
    if cfg.use_bias or cfg.qkv_bias:
        stacked["bqkv"] = torch.cat([attn["bq"], attn["bk"], attn["bv"]],
                                    dim=-1)
    if cfg.use_bias:
        stacked["bo"] = attn["bo"]
    if cfg.has_mlp_bias:
        stacked["b_up"] = mlp["b_up"]
        stacked["b_down"] = mlp["b_down"]
        if cfg.glu:
            stacked["b_gate"] = mlp["b_gate"]
    if cfg.glu:
        stacked["w_gate"] = mlp["w_gate"]
    layers = tuple({k: v[l] for k, v in stacked.items()}
                   for l in range(cfg.num_layers))
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": layers}
    if not cfg.tie_embeddings:
        out["lm_head"] = params["lm_head"]
    if cfg.lm_head_bias:
        out["lm_head_bias"] = params["lm_head_bias"]
    return out


@torch.no_grad()
def decode_step(cfg, dparams, tokens, cache, pos, *, page_table=None):
    """One generation step: ``tokens`` [B, 1] at per-row positions ``pos``
    [B] (int64) over the paged pool ``cache`` ([L, P, Hkv, page, Dh] K and V
    behind ``page_table`` [B, maxp] int64) -> (logits [B, V] fp32, cache).

    The new K/V rows are written into ``cache`` in place (where the JAX
    function returns an updated cache) through the page table: row b lands
    at row pos[b] % page of physical page page_table[b, pos[b] // page];
    parked rows' tables point at the junk page 0, where no live slot reads.
    RoPE stays plain torch, as the JAX package leaves it plain jnp, with
    fp32 angles at each row's own position."""
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    if not per_row or page_table is None:
        raise NotImplementedError(
            "decode_step: only the paged per-row-position branch is ported "
            "(ROADMAP.md queue 1 item 6: a scalar position or a contiguous "
            "cache is generate() / the fixed-slot layout)")
    B = tokens.shape[0]
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    M, Mkv = H * Dh, Hkv * Dh
    kind, eps = cfg.norm, cfg.norm_eps
    x = dparams["embed"]["tok"][tokens[:, 0]]
    if cfg.position == "learned":
        # parked rows may sit past the table; their output is discarded
        table = dparams["embed"]["pos"]
        x = x + table[pos.clamp(max=table.shape[0] - 1)]
    if cfg.embed_norm:  # bloom word_embeddings_layernorm
        x = norm(x, dparams["embed"]["norm"], "layernorm", cfg.norm_eps)
    kc_all, vc_all = cache["k"], cache["v"]
    dtype = kc_all.dtype
    x = x.to(dtype)

    if cfg.position == "rope":
        rd = rope_dim(cfg)
        half = rd // 2
        cos, sin = rope_angles(pos, rd, theta=cfg.rope_theta)   # [B, rd/2]
        cos, sin = cos[:, None], sin[:, None]                   # fp32

    def rope_rows(t):
        """[B, Hx, Dh] -> rotate the first rd dims of each head."""
        if cfg.position != "rope":
            return t
        x1 = t[..., :half].float()
        x2 = t[..., half:rd].float()
        rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        if rd < t.shape[-1]:
            return torch.cat([rot.to(t.dtype), t[..., rd:]], dim=-1)
        return rot.to(t.dtype)

    scale = 1.0 / (Dh ** 0.5)
    page = kc_all.shape[3]
    # the append's page and row, once per step (the same for every layer)
    rows = torch.arange(B, device=pos.device)
    pp = page_table[rows, pos // page]
    po = pos % page
    alibi = cfg.position == "alibi"
    for l, lp in enumerate(dparams["layers"]):
        qkv = fused_norm_qkv(x, lp["n1_scale"], lp.get("n1_bias"),
                             lp["wqkv"], lp.get("bqkv"), kind=kind, eps=eps)
        # q and k heads side by side: one rotation for both
        qk = rope_rows(qkv[:, :M + Mkv].reshape(B, H + Hkv, Dh))
        q, k = qk[:, :H], qk[:, H:]
        v = qkv[:, M + Mkv:].reshape(B, Hkv, Dh)
        kc_all[l, pp, :, po, :] = k.to(dtype)
        vc_all[l, pp, :, po, :] = v.to(dtype)
        ctx = flash_decode(q.contiguous(), kc_all, vc_all, pos,
                           sm_scale=scale, layer=l, alibi=alibi,
                           page_table=page_table)
        r, h = fused_proj_norm(ctx.reshape(B, M), x, lp["wo"], lp.get("bo"),
                               lp["n2_scale"], lp.get("n2_bias"), kind=kind,
                               eps=eps, parallel=cfg.parallel_residual)
        x = fused_mlp(h, r, lp["w_up"], lp["w_down"], lp.get("w_gate"),
                      lp.get("b_up"), lp.get("b_gate"), lp.get("b_down"),
                      act=cfg.activation)
    x = norm(x, dparams["final_norm"], kind, eps)
    if cfg.tie_embeddings:
        head = dparams["embed"]["tok"].T.to(x.dtype)
    else:
        head = dparams["lm_head"].to(x.dtype)
    logits = (x @ head).float()
    if cfg.lm_head_bias:
        logits = logits + dparams["lm_head_bias"].float()
    return logits, cache
