"""Kernel-injected decode path: four fused kernel calls per layer at s=1.

Counterpart of ``deepspeed_tpu/models/fused_decode.py``, the serving
engine's default decode.  :func:`inject_decode_params` lays the weights out
for the fused kernels (Q, K and V concatenated into one [D, N] matrix per
layer) and :func:`decode_step` runs one token per slot through
``ops/kernels/decode.py``: norm+QKV, flash-decode attention,
out-projection+residual+norm, MLP+residual — four calls per layer instead
of the unfused path's chain of small ops.  Prefill keeps
:func:`~deepspeed_tpu_torch.models.decoding.forward_with_cache` on the plain
tree; both read and write the same KV cache.

``decode_step`` has the JAX function's three branches: the paged pool at
per-row positions (the continuous-batching engine), a contiguous cache at
one scalar position (``InferenceEngine.generate()``), and a contiguous
cache at per-row positions (the fixed-slot layout).  int8 weights
(:class:`~deepspeed_tpu_torch.models.quant.QTensor` leaves) run the int8
bodies of the three GEMV kernels on their codes and scales.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from deepspeed_tpu_torch.models.layers import norm, rope_dim
from deepspeed_tpu_torch.models.quant import QTensor, is_qtensor
from deepspeed_tpu_torch.ops.kernels import rope_angles
from deepspeed_tpu_torch.ops.kernels.decode import (flash_decode, fused_mlp,
                                                    fused_norm_qkv,
                                                    fused_proj_norm)
from deepspeed_tpu_torch.ops.kernels.rope import rope_qkv_rows


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
    concatenation of wq | wk | wv: 1.61 GB at llama3-8b in bf16.  With int8
    weights the codes and the scales are concatenated alike (0.81 GB), and
    each layer's QTensor is a view of the stacked codes and scales."""
    ly = params["layers"]
    attn, mlp = ly["attn"], ly["mlp"]
    qkv = [attn["wq"], attn["wk"], attn["wv"]]
    if is_qtensor(attn["wq"]):   # int8: concatenate payloads AND scales
        wqkv = QTensor(torch.cat([w.q for w in qkv], dim=-1),
                       torch.cat([w.scale for w in qkv], dim=-1))
    else:
        wqkv = torch.cat(qkv, dim=-1)
    stacked: Dict[str, Any] = {
        "wqkv": wqkv,
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
    # a QTensor's [l] is QTensor(q[l], scale[l]): views, like a dense leaf's
    layers = tuple({k: v[l] for k, v in stacked.items()}
                   for l in range(cfg.num_layers))
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": layers}
    if not cfg.tie_embeddings:
        out["lm_head"] = params["lm_head"]
    if cfg.lm_head_bias:
        out["lm_head_bias"] = params["lm_head_bias"]
    return out


def _wq_pair(w):
    """(payload, per-output-column scale or None) of a dense or int8 weight."""
    if is_qtensor(w):
        return w.q, w.scale
    return w, None


@torch.no_grad()
def decode_step(cfg, dparams, tokens, cache, pos, *, page_table=None):
    """One generation step: ``tokens`` [B, 1] at position ``pos`` ->
    (logits [B, V] fp32, cache).

    ``pos`` is an int (every row at one depth: ``generate()``) or an int64
    [B] tensor of per-row positions.  ``cache`` holds K and V as contiguous
    [L, B, Hkv, Smax, Dh] tensors or, with ``page_table`` [B, maxp] int64
    (per-row positions required), as the paged pool [L, P, Hkv, page, Dh].

    The new K/V rows are written into ``cache`` in place (where the JAX
    function returns an updated cache): at row ``pos`` of every row's cache
    (scalar), at row pos[b] of row b (per-row), or through the page table
    at row pos[b] % page of physical page page_table[b, pos[b] // page]
    (paged; parked rows' tables point at the junk page 0, where no live slot
    reads).  RoPE is one launch of the RoPE kernel a layer, reading q and k
    out of the QKV rows (where the JAX package leaves it to XLA to fuse its
    jnp), with fp32 angles at each row's own position."""
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    if page_table is not None and not per_row:
        raise ValueError("paged KV decode requires per-row positions")
    if "k_scale" in cache:
        raise NotImplementedError(
            "decode_step does not take the int8 KV cache: the JAX fused path "
            "does not either, and supports_fused_decode routes it to the "
            "unfused loop, forward_with_cache (ROADMAP.md queue 1: the int8 "
            "KV cache decodes on the unfused loop)")
    if not per_row:
        pos = int(pos)
    B = tokens.shape[0]
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    M, Mkv = H * Dh, Hkv * Dh
    kind, eps = cfg.norm, cfg.norm_eps
    x = dparams["embed"]["tok"][tokens[:, 0]]
    dev = x.device
    if cfg.position == "learned":
        # parked rows may sit past the table; their output is discarded
        table = dparams["embed"]["pos"]
        last = table.shape[0] - 1
        x = x + (table[pos.clamp(max=last)] if per_row
                 else table[min(pos, last)])
    if cfg.embed_norm:  # bloom word_embeddings_layernorm
        x = norm(x, dparams["embed"]["norm"], "layernorm", cfg.norm_eps)
    kc_all, vc_all = cache["k"], cache["v"]
    dtype = kc_all.dtype
    x = x.to(dtype)

    rope = cfg.position == "rope"
    if rope:
        # per-row [B, rd/2], or a scalar position's [1, rd/2] (its index
        # made on the device: no host-to-device copy, no sync); fp32
        ang_pos = pos if per_row else torch.arange(pos, pos + 1, device=dev)
        cos, sin = rope_angles(ang_pos, rope_dim(cfg), theta=cfg.rope_theta)

    scale = 1.0 / (Dh ** 0.5)
    # where each row's new K/V lands, once per step (the same every layer)
    if page_table is not None:
        page = kc_all.shape[3]
        rows = torch.arange(B, device=dev)
        at = (page_table[rows, pos // page], slice(None), pos % page)
    elif per_row:
        at = (torch.arange(B, device=dev), slice(None), pos)
    else:
        at = (slice(None), slice(None), pos)
    alibi = cfg.position == "alibi"
    for l, lp in enumerate(dparams["layers"]):
        wqkv, s_qkv = _wq_pair(lp["wqkv"])
        qkv = fused_norm_qkv(x, lp["n1_scale"], lp.get("n1_bias"), wqkv,
                             lp.get("bqkv"), kind=kind, eps=eps,
                             wscale=s_qkv)
        # q and k read out of the QKV rows: one rotation for both, q
        # written contiguous for flash_decode
        if rope:
            q, k = rope_qkv_rows(qkv, cos, sin, H, Hkv, Dh)
        else:
            q = qkv[:, :M].reshape(B, H, Dh)
            k = qkv[:, M:M + Mkv].reshape(B, Hkv, Dh)
        v = qkv[:, M + Mkv:].reshape(B, Hkv, Dh)
        kc_all[l][at] = k.to(dtype)
        vc_all[l][at] = v.to(dtype)
        ctx = flash_decode(q.contiguous(), kc_all, vc_all, pos,
                           sm_scale=scale, layer=l, alibi=alibi,
                           page_table=page_table)
        wo, s_wo = _wq_pair(lp["wo"])
        r, h = fused_proj_norm(ctx.reshape(B, M), x, wo, lp.get("bo"),
                               lp["n2_scale"], lp.get("n2_bias"), kind=kind,
                               eps=eps, parallel=cfg.parallel_residual,
                               wscale=s_wo)
        wu, su = _wq_pair(lp["w_up"])
        wd, sd = _wq_pair(lp["w_down"])
        wg, sg = _wq_pair(lp["w_gate"]) if "w_gate" in lp else (None, None)
        x = fused_mlp(h, r, wu, wd, wg, lp.get("b_up"), lp.get("b_gate"),
                      lp.get("b_down"), act=cfg.activation,
                      wscales=None if su is None else (su, sg, sd))
    x = norm(x, dparams["final_norm"], kind, eps)
    if cfg.tie_embeddings:
        head = dparams["embed"]["tok"].T.to(x.dtype)
    elif is_qtensor(dparams["lm_head"]):
        head = dparams["lm_head"].astype(x.dtype)
    else:
        head = dparams["lm_head"].to(x.dtype)
    logits = (x @ head).float()
    if cfg.lm_head_bias:
        logits = logits + dparams["lm_head_bias"].float()
    return logits, cache
