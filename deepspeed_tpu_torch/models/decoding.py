"""KV-cache prefill/decode paths for the built-in models, PyTorch port.

Counterpart of ``deepspeed_tpu/models/decoding.py``.  The cache is a dict
of ``[L, B, Hkv, Smax, Dh]`` tensors (or, paged, ``[L, P, Hkv, page, Dh]``
pools behind a ``[B, maxp]`` page table) that :func:`forward_with_cache`
updates IN PLACE — where the JAX functions return a new cache, the port
writes into the one it was given and returns it, which saves a copy of the
whole cache per call.

Prefill attends densely under a position mask; decode (s == 1 over a cache
longer than one block, a block multiple) runs the length-aware
flash-decode: online softmax over cache blocks, visiting only the blocks up
to the deepest query — a Python loop here where the JAX package has a
``lax.while_loop``.  The branch choice is the JAX package's, so the two
packages take the same numerical path for the same call.

Matmul weights may be int8 :class:`~deepspeed_tpu_torch.models.quant.
QTensor` leaves: each product dequantizes its weight to the activation
dtype (``QTensor.__rmatmul__``), as the JAX ``QTensor`` does.

The int8 KV cache (``init_kv_cache(quantized=True)``, and the paged pool's
``init_paged_kv_cache(quantized=True)``) stores K and V as int8 codes with
an fp32 scale per (position, head) over the head dim, ``k_scale`` /
``v_scale`` of shape ``[..., 1]``, and an ``x_dtype`` zero-dim tensor
naming the activations' dtype.  Each write quantizes its rows
(:func:`_quantize_kv_rows`); each read dequantizes as ``code * scale`` in
fp32 inside the attention, as the JAX readers do.  An MoE model's MLP is
:func:`~deepspeed_tpu_torch.moe.sharded_moe.moe_mlp` on the layer's
weights, over every row of the call (parked slots and pad rows included,
as the JAX programs feed them: capacity couples rows).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.layers import (_repeat_kv, activation_fn,
                                               alibi_slopes, norm, rope_dim)
from deepspeed_tpu_torch.models.quant import _INV_QMAX
from deepspeed_tpu_torch.moe.sharded_moe import moe_mlp
from deepspeed_tpu_torch.ops.kernels import rope_angles
from deepspeed_tpu_torch.ops.kernels.rope import rope_qk

logger = logging.getLogger(__name__)

NEG_INF = -1e30
DECODE_BLOCK = 256  # flash-decode cache block


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                  device: DeviceLike = None,
                  quantized: bool = False) -> Dict[str, Any]:
    """Contiguous per-row cache.  Caches longer than one decode block are
    rounded UP to a block multiple so the flash-decode path applies (read
    the length back from ``cache['k'].shape[-2]``).  ``quantized`` makes
    the int8 cache: int8 ``k``/``v``, fp32 ``k_scale``/``v_scale``
    ``[L, batch, Hkv, max_len, 1]`` and the ``x_dtype`` anchor."""
    L, Hkv, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if max_len > DECODE_BLOCK and max_len % DECODE_BLOCK:
        rounded = -(-max_len // DECODE_BLOCK) * DECODE_BLOCK
        logger.info("init_kv_cache: max_len %d rounded up to %d (a %d-multiple)"
                    " for the flash-decode path", max_len, rounded, DECODE_BLOCK)
        max_len = rounded
    dev = resolve_device(device)
    shape = (L, batch, Hkv, max_len, Dh)
    if quantized:
        return quantized_planes(shape, dtype, dev)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def quantized_planes(shape, dtype, device) -> Dict[str, Any]:
    """The int8 cache's planes for K/V of ``shape`` (contiguous or paged)."""
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
            "x_dtype": torch.zeros((), dtype=dtype, device=device)}


def cache_planes(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The cache's per-token planes (K, V and, int8, their scales): every
    entry but the zero-dim ``x_dtype`` anchor."""
    return {k: v for k, v in cache.items() if v.dim() > 0}


def activation_dtype(cache: Dict[str, Any]) -> torch.dtype:
    """The dtype decode activations run in: the cache's, or the int8
    cache's ``x_dtype`` anchor."""
    return cache["x_dtype"].dtype if "x_dtype" in cache else cache["k"].dtype


def _quantize_kv_rows(x: torch.Tensor):
    """[B, Hkv, s, Dh] -> (int8 codes, fp32 [B, Hkv, s, 1] scales): absmax
    over the head dim, scale 1 for an all-zero row, codes rounded half to
    even and clipped to ±127.  The scale is the product with the fp32
    reciprocal of 127, as XLA computes the JAX function's ``absmax / 127.0``
    under jit (a Python float multiplies an fp32 tensor in fp32)."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax * _INV_QMAX)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _as_row_pos(q_pos: torch.Tensor) -> torch.Tensor:
    """Query positions as [Bq, s]: a [s] vector is shared across the batch."""
    return q_pos[None] if q_pos.dim() == 1 else q_pos


def _dequant(block, block_scale):
    """A cache block in fp32: ``code * scale`` for an int8 cache."""
    out = block.float()
    return out if block_scale is None else out * block_scale


def _cached_attention_dense(q, kcache, vcache, q_pos, scale, slopes=None,
                            k_scale=None, v_scale=None):
    """Masked attention over the whole cache (prefill path, s > 1).
    ``q_pos`` is [s] (batch-shared) or [B, s]; ``slopes`` [H] adds ALiBi;
    ``k_scale``/``v_scale`` dequantize an int8 cache."""
    B, H, s, Dh = q.shape
    Hkv = kcache.shape[1]
    q_pos = _as_row_pos(q_pos)
    k = _repeat_kv(_dequant(kcache, k_scale), H // Hkv)
    v = _repeat_kv(_dequant(vcache, v_scale), H // Hkv)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    key_pos = torch.arange(k.shape[-2], device=q.device)
    if slopes is not None:
        rel = (key_pos[None, None, :] - q_pos[:, :, None]).float()
        logits = logits + slopes[None, :, None, None] * rel[:, None]
    mask = key_pos[None, None, :] <= q_pos[:, :, None]
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.to(q.dtype)


def _cached_attention_flash_decode(q, kcache, vcache, q_pos, scale,
                                   slopes=None, block: int = DECODE_BLOCK,
                                   n_blocks: Optional[int] = None,
                                   k_scale=None, v_scale=None):
    """Length-aware decode attention: online softmax over cache blocks
    [0, n_blocks), n_blocks = max(q_pos) // block + 1.  Shallower rows'
    extra blocks are fully masked and add exactly 0 (exp(NEG_INF - m) is 0
    and their correction factor exactly 1), so a caller may pass a larger
    ``n_blocks`` — an upper bound it knows on the host — and get the same
    bits without a device sync.  ``k_scale``/``v_scale`` dequantize an int8
    cache block by block."""
    B, H, s, Dh = q.shape
    Hkv, Smax = kcache.shape[1], kcache.shape[2]
    rep = H // Hkv
    q_pos = _as_row_pos(q_pos)
    qf = q.float()
    if n_blocks is None:
        n_blocks = int(q_pos.max()) // block + 1
    n_blocks = min(n_blocks, Smax // block)
    m = torch.full((B, H, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, s, Dh), dtype=torch.float32, device=q.device)
    for i in range(n_blocks):
        start = i * block
        sl = slice(start, start + block)
        kb = _repeat_kv(_dequant(kcache[:, :, sl], None if k_scale is None
                                 else k_scale[:, :, sl]), rep)
        vb = _repeat_kv(_dequant(vcache[:, :, sl], None if v_scale is None
                                 else v_scale[:, :, sl]), rep)
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        key_pos = start + torch.arange(block, device=q.device)
        if slopes is not None:
            rel = (key_pos[None, None, :] - q_pos[:, :, None]).float()
            logits = logits + slopes[None, :, None, None] * rel[:, None]
        mask = key_pos[None, None, :] <= q_pos[:, :, None]
        logits = torch.where(mask[:, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                         p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def _cached_attention(q, kcache, vcache, q_pos, scale, slopes=None,
                      n_blocks: Optional[int] = None, k_scale=None,
                      v_scale=None):
    """q: [B, H, s, Dh]; caches: [B, Hkv, Smax, Dh].  Decode (s == 1,
    cache longer than one block and a block multiple) takes the length-aware
    flash-decode; everything else the dense masked path — the JAX package's
    branch choice, so both take the same numerical path."""
    s = q.shape[2]
    Smax = kcache.shape[2]
    if s == 1 and Smax > DECODE_BLOCK:
        if Smax % DECODE_BLOCK == 0:
            return _cached_attention_flash_decode(q, kcache, vcache, q_pos,
                                                  scale, slopes,
                                                  n_blocks=n_blocks,
                                                  k_scale=k_scale,
                                                  v_scale=v_scale)
        logger.warning("decode: cache length %d is not a multiple of %d; the "
                       "length-aware flash-decode is disabled", Smax,
                       DECODE_BLOCK)
    return _cached_attention_dense(q, kcache, vcache, q_pos, scale, slopes,
                                   k_scale, v_scale)


def paged_logical_view(buf, page_table):
    """Gather a slot-contiguous logical cache view out of the paged pool:
    ``buf`` [P, Hkv, page, D], ``page_table`` [B, maxp] -> [B, Hkv,
    maxp*page, D].  Unallocated entries gather the junk page 0, whose rows
    sit past every live position and are masked like any other padding."""
    g = buf[page_table]                                 # [B, maxp, Hkv, page, D]
    B, mp, Hkv, pg, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, mp * pg, D)


def _scatter_paged_rows(buf, rows, pos, page_table):
    """In place: ``rows`` [B, Hkv, 1, D] written at logical positions ``pos``
    [B] through the page table into ``buf`` [P, Hkv, page, D].  Parked rows
    (table pointing at junk page 0) may write the same junk row; which of
    them lands is unspecified on CUDA, and no live row reads it."""
    B = rows.shape[0]
    page = buf.shape[2]
    pp = page_table[torch.arange(B, device=buf.device), pos // page]
    buf[pp, :, pos % page, :] = rows[:, :, 0, :].to(buf.dtype)


def _scatter_rows(buf, rows, start_pos):
    """In place: ``rows`` [B, Hx, s, D] into ``buf`` [B, Hx, Smax, D] at
    per-row start positions ``start_pos`` [B]."""
    B, _, s, _ = rows.shape
    bidx = torch.arange(B, device=buf.device)[:, None]
    pidx = start_pos[:, None] + torch.arange(s, device=buf.device)[None, :]
    buf[bidx, :, pidx, :] = rows.transpose(1, 2).to(buf.dtype)


def _dense_mlp(mp, h, cfg, act):
    up = h @ mp["w_up"]
    if cfg.has_mlp_bias:
        up = up + mp["b_up"]
    if cfg.glu:
        gate = h @ mp["w_gate"]
        if cfg.has_mlp_bias:
            gate = gate + mp["b_gate"]
        gated = act(gate) * up
    else:
        gated = act(up)
    out = gated @ mp["w_down"]
    if cfg.has_mlp_bias:
        out = out + mp["b_down"]
    return out


@torch.no_grad()
def forward_with_cache(model, params, tokens, cache, start_pos,
                       page_table=None, *, max_pos: Optional[int] = None,
                       logits_at: Optional[int] = None):
    """Run the model over ``tokens`` [B, s] starting at ``start_pos``,
    writing the new K/V into ``cache`` in place.

    ``start_pos`` is an int (the whole batch at one depth: prefill, chunked
    prefill) or an int [B] tensor of per-row positions (continuous-batching
    decode).  ``page_table`` [B, maxp] switches to the PAGED layout (decode
    only: per-row positions and s == 1; serving prefill gathers a slot's
    pages around this function instead).  ``max_pos`` is an optional host-
    side upper bound on every query position: it sizes the flash-decode
    loop without reading the positions back from the device.
    ``logits_at`` (a prefill's last true position in its padded bucket)
    runs the final norm and the head on that one query position only.

    Returns (logits [B, s, V] fp32 — [B, 1, V] with ``logits_at`` —,
    cache).
    """
    cfg = model.config
    B, s = tokens.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = tokens.device
    per_row = isinstance(start_pos, torch.Tensor) and start_pos.dim() == 1
    if not per_row:
        start_pos = int(start_pos)
    paged = page_table is not None
    if paged and (not per_row or s != 1):
        raise ValueError("paged KV decode requires per-row positions and "
                         "s == 1 (prefill runs on a gathered slot view)")
    quant_kv = "k_scale" in cache
    x = params["embed"]["tok"][tokens]
    if per_row:
        q_pos = start_pos[:, None] + torch.arange(s, device=dev)    # [B, s]
    else:
        q_pos = start_pos + torch.arange(s, device=dev)             # [s]
    if cfg.position == "learned":
        # a padded prefill chunk may reach past the table: those rows are
        # junk that no query attends (the JAX gather fills them; an index
        # past the table faults on a CUDA tensor), so the index is clamped
        table = params["embed"]["pos"]
        pos_emb = table[q_pos.clamp(max=table.shape[0] - 1)]
        x = x + (pos_emb if per_row else pos_emb[None])
    if cfg.embed_norm:
        x = norm(x, params["embed"]["norm"], "layernorm", cfg.norm_eps)
    x = x.to(activation_dtype(cache))
    slopes = alibi_slopes(H, device=dev) if cfg.position == "alibi" else None

    s_max = cache["k"].shape[-2] * (page_table.shape[1] if paged else 1)
    if not per_row and start_pos + s > s_max:
        raise ValueError(f"tokens [{start_pos}, {start_pos + s}) overrun the "
                         f"cache window {s_max}")
    if cfg.position == "rope":
        # angles for the whole cache window once; gather the query slice
        cos_all, sin_all = rope_angles(torch.arange(s_max, device=dev),
                                       rope_dim(cfg), theta=cfg.rope_theta)
        if per_row:
            cos = cos_all[q_pos].to(x.dtype)                        # [B, s, half]
            sin = sin_all[q_pos].to(x.dtype)
        else:
            cos = cos_all[start_pos:start_pos + s].to(x.dtype)      # [s, half]
            sin = sin_all[start_pos:start_pos + s].to(x.dtype)
    scale = 1.0 / (Dh ** 0.5)
    n_blocks = None if max_pos is None else int(max_pos) // DECODE_BLOCK + 1
    act = activation_fn(cfg.activation)
    lyr = params["layers"]

    for li in range(cfg.num_layers):
        a = {k: w[li] for k, w in lyr["attn"].items()}
        mp = {k: w[li] for k, w in lyr["mlp"].items()}
        kc, vc = cache["k"][li], cache["v"][li]
        ksc = cache["k_scale"][li] if quant_kv else None
        vsc = cache["v_scale"][li] if quant_kv else None
        x0 = x
        h = norm(x, {k: w[li] for k, w in lyr["attn_norm"].items()}, cfg.norm,
                 cfg.norm_eps)
        q = h @ a["wq"]
        k = h @ a["wk"]
        v = h @ a["wv"]
        if cfg.use_bias or cfg.qkv_bias:
            q = q + a["bq"]
            k = k + a["bk"]
            v = v + a["bv"]
        q = q.reshape(B, s, H, Dh)
        k = k.reshape(B, s, Hkv, Dh)
        v = v.reshape(B, s, Hkv, Dh).transpose(1, 2)
        if cfg.position == "rope":
            # one launch for q and k, per-row tables [B, s, half] or one
            # table [s, half]; contiguous [B, Hx, s, Dh] out
            q, k = rope_qk(q, k, cos, sin)
        else:
            q = q.transpose(1, 2)
            k = k.transpose(1, 2)
        if quant_kv:
            kq, ks = _quantize_kv_rows(k)
            vq, vs = _quantize_kv_rows(v)
            writes = ((kc, kq), (vc, vq), (ksc, ks), (vsc, vs))
        else:
            writes = ((kc, k), (vc, v))
        for buf, rows in writes:
            if paged:
                _scatter_paged_rows(buf, rows, start_pos, page_table)
            elif per_row:
                _scatter_rows(buf, rows, start_pos)
            else:
                buf[:, :, start_pos:start_pos + s] = rows.to(buf.dtype)
        if paged:
            def view(buf):
                return (None if buf is None
                        else paged_logical_view(buf, page_table))
            o = _cached_attention(q, view(kc), view(vc), q_pos, scale, slopes,
                                  n_blocks=n_blocks, k_scale=view(ksc),
                                  v_scale=view(vsc))
        else:
            o = _cached_attention(q, kc, vc, q_pos, scale, slopes,
                                  n_blocks=n_blocks, k_scale=ksc,
                                  v_scale=vsc)
        o = o.transpose(1, 2).reshape(B, s, H * Dh) @ a["wo"]
        if cfg.use_bias:
            o = o + a["bo"]
        if cfg.parallel_residual:
            mlp_src = x0
        else:
            x = x + o
            mlp_src = x
        h = norm(mlp_src, {k: w[li] for k, w in lyr["mlp_norm"].items()},
                 cfg.norm, cfg.norm_eps)
        if cfg.is_moe:
            # the JAX step casts the layer's MoE weights to the activations'
            # dtype first (the router's too, before its fp32 logits)
            mlp_out, _ = moe_mlp({k: w.to(h.dtype) for k, w in mp.items()},
                                 h, cfg)
        else:
            mlp_out = _dense_mlp(mp, h, cfg, act)
        x = (x0 + o + mlp_out) if cfg.parallel_residual else (x + mlp_out)
    if logits_at is not None:
        x = x[:, logits_at:logits_at + 1].contiguous()
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    if cfg.lm_head_bias:
        logits = logits + params["lm_head_bias"].float()
    return logits, cache


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 do_sample: bool = True) -> torch.Tensor:
    """logits: [B, V] -> token ids [B] (greedy — the first maximum — when
    ``do_sample`` is False).  Sampling draws from ``generator``; it does not
    reproduce the JAX package's random stream."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(float(temperature), 1e-6)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]

