"""Decoder-only transformer (Llama, GPT-2, BLOOM and GPT-NeoX families),
PyTorch port.

Counterpart of ``deepspeed_tpu/models/transformer.py``.  :class:`CausalLM`
keeps the JAX parameter tree: the same names and the same stacked
``[L, ...]`` layer layout as ``CausalLM.init`` there, registered as nested
sub-modules so ``state_dict()`` keys are the JAX tree paths joined with
``.`` (``layers.attn.wq`` is ``params["layers"]["attn"]["wq"]``).  Weight
conversion is therefore a name-for-name map (:mod:`.convert`).

Init draws from the same distributions as the JAX init — uniform
±``fan_in**-0.5`` for the projections, normal(0.02) for the token
embedding — from a :class:`torch.Generator` on the target device, so a
full-width model is built on the card directly.  The numbers differ from
the JAX init (different generators); tests carry JAX weights across with
:func:`~deepspeed_tpu_torch.models.convert.jax_params_to_torch`.

Training runs :meth:`CausalLM.apply` — the JAX ``CausalLM.apply`` for the
dense families: Llama (RoPE, RMSNorm), GPT-2 (learned positions,
LayerNorm), BLOOM (ALiBi positions, the embedding LayerNorm) and the
parallel-residual GPT-NeoX and GPT-J: embedding, the layer loop over ``[L]``
slices (the JAX
``scan_layers`` branch written as a Python loop), the final norm and the
next-token cross-entropy (:func:`cross_entropy`, or
:func:`blockwise_cross_entropy` once ``B*S*V > 2^28``).  It is functional
over the nested JAX-layout param dict, so the engine can hand it a
grad-carrying compute copy of the weights.  The parameters registered on
the module keep ``requires_grad=False`` for serving, which runs the model
through :func:`~deepspeed_tpu_torch.models.decoding.forward_with_cache`.
An MoE model (the Mixtral family: top-k routed experts in place of the
MLP, :mod:`deepspeed_tpu_torch.moe`) trains as the JAX one does: each
layer's MoE MLP gives a load-balancing aux loss, summed over the layers in
order, and the loss with labels is ``loss + moe_aux_loss_coef * aux``; its
backward is autograd through the router, the dispatch and the expert
matmuls.  Dropout (``ModelConfig.dropout > 0``) follows the JAX key chain:
``apply(..., rngs={"dropout": key})`` splits the key into one a layer, each
layer's into an attention and an MLP key (an MoE layer splits its MLP key
again for Random Token Selection), and :func:`~deepspeed_tpu_torch.ops.
kernels.dropout.dropout` draws JAX's own masks from them, so the masks are
``jax.random.bernoulli``'s bit for bit.  The keys are plain arguments of
every remat body, so a recompute draws the same masks with no RNG state to
track; without a key (serving, ``generate()``) nothing is dropped, as in
JAX.  The ``offload_dots`` remat policy (``cpu_checkpointing``) keeps each
layer's matmul outputs in pinned host memory between the forward and the
backward on the card (:class:`_Dots` with ``offload``); on the CPU it
saves them in place, as the JAX package does there.  Under
``offload_param`` the engine trains through :meth:`CausalLM.
stream_segments` (the embedding, one layer, the head's loss, the RoPE
tables) a layer at a time instead of :meth:`CausalLM.apply`.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.accelerator.real_accelerator import (DeviceLike,
                                                              resolve_device)
from deepspeed_tpu_torch.models.config import ModelConfig, get_model_config
from deepspeed_tpu_torch.models.layers import (_repeat_kv, activation_fn,
                                               attention_core, norm, rope_cache,
                                               rope_dim)
from deepspeed_tpu_torch.ops.kernels.dropout import dropout
from deepspeed_tpu_torch.ops.kernels.rope import rope_qk
from deepspeed_tpu_torch.utils import prng

logger = logging.getLogger(__name__)


class _Replay(torch.autograd.Function):
    """``a @ w`` whose output ``out`` was kept from the forward: returns it
    and back-propagates as the matmul does (the backward of ``aten.mm`` on
    the row-major operands, with ``a`` folded to ``[rows, K]``)."""

    @staticmethod
    def forward(ctx, a, w, out):
        ctx.save_for_backward(a, w)
        return out

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = (a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return da, dw, None


class _Dots(torch.autograd.Function):
    """A block whose matmul outputs are kept from the forward and replayed
    in the backward (JAX's ``dots_with_no_batch_dims_saveable`` remat
    policies): the forward runs ``fn(ins, dot)`` keeping each ``dot``
    output; the backward runs ``fn`` again under autograd with each matmul
    replayed from what was kept (:class:`_Replay`), so only the rest
    (norms, RoPE, attention, activations, dropout) is recomputed.  ``fn``
    returns a tensor or a tuple of tensors.  With ``offload`` the kept
    outputs wait in pinned host memory between the forward and the
    backward (the ``offload_dots`` policy): each is copied out on a side
    stream as soon as it is made, and the layer's outputs are copied back
    together when its backward starts, both ordered by events."""

    @staticmethod
    def forward(ctx, fn, offload, *ins):
        kept = []

        def dot(a, w):
            kept.append(a @ w)
            return kept[-1]
        out = fn(ins, dot)
        ctx.fn, ctx.n, ctx.multi = fn, len(ins), isinstance(out, tuple)
        ctx.host = [_to_host(t) for t in kept] if offload else None
        ctx.save_for_backward(*ins, *([] if offload else kept))
        return out

    @staticmethod
    def backward(ctx, *douts):
        saved = ctx.saved_tensors
        ins_saved = saved[:ctx.n]
        if ctx.host is None:
            kept = iter(saved[ctx.n:])
        else:
            dev = next(t.device for t in ins_saved if t is not None)
            kept = iter(_from_host(ctx.host, dev))
            ctx.host = None
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(ins_saved, ctx.needs_input_grad[2:])]
            out = ctx.fn(ins, lambda a, w: _Replay.apply(a, w, next(kept)))
            outs = out if ctx.multi else (out,)
            pairs = [(o, g) for o, g in zip(outs, douts)
                     if g is not None and o.requires_grad]
            wanted = [t for t in ins if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                             [g for _, g in pairs],
                                             allow_unused=True))
        return (None, None) + tuple(
            next(grads) if t is not None and t.requires_grad else None
            for t in ins)


_SIDE_STREAMS: Dict[torch.device, Any] = {}


def _side_stream(dev: torch.device):
    s = _SIDE_STREAMS.get(dev)
    if s is None:
        s = _SIDE_STREAMS[dev] = torch.cuda.Stream(device=dev)
    return s


def _to_host(t: torch.Tensor):
    """Start copying ``t`` into pinned host memory on the side stream,
    after the work that made it: ``(host, event)``.  ``t``'s memory is not
    reused before the copy ends (``record_stream``)."""
    side = _side_stream(t.device)
    side.wait_stream(torch.cuda.current_stream(t.device))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    t.record_stream(side)
    return host, done


def _from_host(host, dev: torch.device):
    """Copy a layer's kept outputs back to ``dev`` on the side stream; the
    current stream waits for them before the replay reads them."""
    side = _side_stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    outs = [torch.empty(h.shape, dtype=h.dtype, device=dev) for h, _ in host]
    with torch.cuda.stream(side):
        for (h, ev), out in zip(host, outs):
            side.wait_event(ev)
            out.copy_(h, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    cur.wait_event(done)
    for out in outs:
        out.record_stream(side)
    return outs


def _nest(keys, leaves):
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for (group, name), t in zip(keys, leaves):
        out.setdefault(group, {})[name] = t
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's shapes, leaf for leaf as the JAX init builds it,
    with each leaf's init as ``(shape, kind, scale)``: kind is ``uniform``
    (±scale), ``normal`` (std scale), ``ones`` or ``zeros``."""
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s_in, s_ff = D ** -0.5, F ** -0.5

    def norm_p(*lead):
        p = {"scale": (lead + (D,), "ones", 0.0)}
        if cfg.norm == "layernorm":
            p["bias"] = (lead + (D,), "zeros", 0.0)
        return p

    attn = {"wq": ((L, D, H * Dh), "uniform", s_in),
            "wk": ((L, D, Hkv * Dh), "uniform", s_in),
            "wv": ((L, D, Hkv * Dh), "uniform", s_in),
            "wo": ((L, H * Dh, D), "uniform", (H * Dh) ** -0.5)}
    if cfg.use_bias or cfg.qkv_bias:
        attn.update(bq=((L, H * Dh), "zeros", 0.0),
                    bk=((L, Hkv * Dh), "zeros", 0.0),
                    bv=((L, Hkv * Dh), "zeros", 0.0))
    if cfg.use_bias:
        attn["bo"] = ((L, D), "zeros", 0.0)
    if cfg.is_moe:
        E = cfg.num_experts
        mlp = {"gate_w": ((L, D, E), "uniform", s_in),
               "w_up": ((L, E, D, F), "uniform", s_in),
               "w_down": ((L, E, F, D), "uniform", s_ff)}
        if cfg.glu:
            mlp["w_gate"] = ((L, E, D, F), "uniform", s_in)
    else:
        mlp = {"w_up": ((L, D, F), "uniform", s_in),
               "w_down": ((L, F, D), "uniform", s_ff)}
        if cfg.glu:
            mlp["w_gate"] = ((L, D, F), "uniform", s_in)
    if cfg.has_mlp_bias and not cfg.is_moe:
        mlp.update(b_up=((L, F), "zeros", 0.0), b_down=((L, D), "zeros", 0.0))
        if cfg.glu:
            mlp["b_gate"] = ((L, F), "zeros", 0.0)
    tree = {"embed": {"tok": ((V, D), "normal", 0.02)},
            "layers": {"attn_norm": norm_p(L), "mlp_norm": norm_p(L),
                       "attn": attn, "mlp": mlp},
            "final_norm": norm_p()}
    if cfg.position == "learned":
        tree["embed"]["pos"] = ((cfg.max_seq_len, D), "normal", 0.02)
    if cfg.embed_norm:
        tree["embed"]["norm"] = {"scale": ((D,), "ones", 0.0),
                                 "bias": ((D,), "zeros", 0.0)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((D, V), "normal", s_in)
    if cfg.lm_head_bias:
        tree["lm_head_bias"] = ((V,), "zeros", 0.0)
    return tree


class _ParamTree(nn.Module):
    """One level of the parameter tree: leaves are parameters, sub-dicts
    are sub-modules, both under their JAX names."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, _ParamTree(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf,
                                                           requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out = {name: p for name, p in self._parameters.items()}
        out.update({name: m.tree() for name, m in self._modules.items()})
        return out


def _init_tree(spec, device, dtype, gen):
    if isinstance(spec, dict):
        return {k: _init_tree(v, device, dtype, gen) for k, v in spec.items()}
    shape, kind, scale = spec
    t = torch.empty(shape, device=device, dtype=dtype)
    if kind == "uniform":
        return t.uniform_(-scale, scale, generator=gen)
    if kind == "normal":
        return t.normal_(0.0, scale, generator=gen)
    return t.fill_(1.0 if kind == "ones" else 0.0)


class CausalLM(_ParamTree):
    """Causal language model holding the JAX-layout parameter tree."""

    def __init__(self, config: ModelConfig, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None):
        """Random weights from ``seed`` on ``device`` in ``dtype``, or
        ``params``, a nested tensor tree in the JAX layout (as
        :func:`~deepspeed_tpu_torch.models.convert.jax_params_to_torch`
        gives it), held as it is."""
        if params is None:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            params = _init_tree(param_shapes(config), dev, dtype, gen)
        super().__init__(params)
        self.config = config

    def params(self) -> Dict[str, Any]:
        """The nested parameter dict (JAX tree layout) the decode functions
        read; the tensors are the module's own parameters, not copies."""
        return self.tree()

    def logical_pspecs(self) -> Dict[str, Any]:
        """The tensor- and expert-parallel claims on each leaf's dims (the
        JAX ``CausalLM.logical_pspecs``, the AutoTP column / row map), as
        tuples of axis names: ZeRO shards a param and its grads past them,
        as the JAX engine does, also while ``tp`` and ``ep`` are 1."""
        cfg = self.config
        col = (None, None, "tp")        # [L, D, H*Dh] / [L, D, F]
        row = (None, "tp", None)        # [L, F, D] / [L, H*Dh, D]
        norm_spec = {"scale": (None, None)}
        if cfg.norm == "layernorm":
            norm_spec["bias"] = (None, None)
        attn = {"wq": col, "wk": col, "wv": col, "wo": row}
        if cfg.use_bias or cfg.qkv_bias:
            attn.update(bq=(None, "tp"), bk=(None, "tp"), bv=(None, "tp"))
        if cfg.use_bias:
            attn.update(bo=(None, None))
        if cfg.is_moe:
            mlp = {"gate_w": (None, None, None),
                   "w_up": (None, "ep", None, "tp"),
                   "w_down": (None, "ep", "tp", None)}
            if cfg.glu:
                mlp["w_gate"] = (None, "ep", None, "tp")
        else:
            mlp = {"w_up": col, "w_down": row}
            if cfg.glu:
                mlp["w_gate"] = col
            if cfg.has_mlp_bias:
                mlp.update(b_up=(None, "tp"), b_down=(None, None))
                if cfg.glu:
                    mlp["b_gate"] = (None, "tp")
        fnorm = {"scale": (None,)}
        if cfg.norm == "layernorm":
            fnorm["bias"] = (None,)
        specs = {"embed": {"tok": ("tp", None)},
                 "layers": {"attn_norm": norm_spec, "mlp_norm": dict(norm_spec),
                            "attn": attn, "mlp": mlp},
                 "final_norm": fnorm}
        if cfg.position == "learned":
            specs["embed"]["pos"] = (None, None)
        if cfg.embed_norm:
            specs["embed"]["norm"] = {"scale": (None,), "bias": (None,)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = (None, "tp")
        if cfg.lm_head_bias:
            specs["lm_head_bias"] = ("tp",)
        return specs

    # ------------------------------------------------------------------
    # training forward (JAX ``CausalLM.apply``)
    # ------------------------------------------------------------------
    def check_trainable(self, streamed: bool = False) -> None:
        """Raise for what the training forward does not carry yet:
        ``param_offload`` (set by the engine under ``offload_param``) on a
        model trained through :meth:`apply`, the JAX package's whole-program
        path with its layer weights moved in from host memory inside the
        program.  ``streamed``: the engine drives :meth:`stream_segments`
        instead, which carries it."""
        if self.config.param_offload and not streamed:
            raise NotImplementedError(
                "training with param_offload through apply is not ported yet "
                "(ROADMAP.md queue 1: item 2e, the whole-program offload_param "
                "path); offload_param trains through stream_segments")

    def _drop(self, x, key):
        """JAX ``_dropout`` at the model's rate; nothing without a key."""
        return x if key is None else dropout(x, key, self.config.dropout)

    def _attn_out(self, lp, x, cos, sin, key=None, dot=torch.matmul):
        """Attention sub-block output (residual not added), dropped with
        ``key``; its projections through ``dot``."""
        cfg = self.config
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        h = norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
        a = lp["attn"]
        q, k, v = dot(h, a["wq"]), dot(h, a["wk"]), dot(h, a["wv"])
        if cfg.use_bias or cfg.qkv_bias:
            q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
        # [B, H, S, Dh] is the kernels' layout; they take contiguous tensors.
        # RoPE reads q and k in the projections' layout and writes that one
        q = q.reshape(B, S, H, Dh)
        k = k.reshape(B, S, Hkv, Dh)
        if cfg.position == "rope":
            q, k = rope_qk(q, k, cos, sin)
        else:
            q = q.transpose(1, 2).contiguous()
            k = k.transpose(1, 2).contiguous()
        v = v.reshape(B, S, Hkv, Dh).transpose(1, 2).contiguous()
        k = _repeat_kv(k, H // Hkv)
        v = _repeat_kv(v, H // Hkv)
        o = attention_core(q, k, v, causal=True, alibi=cfg.position == "alibi")
        o = dot(o.transpose(1, 2).reshape(B, S, H * Dh), a["wo"])
        if cfg.use_bias:
            o = o + a["bo"]
        return self._drop(o.to(x.dtype), key)

    def _mlp_block(self, lp, x, key=None, dot=torch.matmul):
        """``(x + dropout(mlp(norm(x))), aux)``: an MoE MLP's load-balancing
        aux loss (fp32 scalar), None for a dense MLP.  An MoE MLP splits
        ``key`` into the RTS permutation's key and the dropout key, as the
        JAX ``_mlp_block``."""
        cfg = self.config
        if cfg.is_moe:
            from deepspeed_tpu_torch.moe.sharded_moe import moe_mlp

            h = norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
            k_rts = None
            if key is not None:
                k_rts, key = prng.split(key)
            out, aux = moe_mlp(lp["mlp"], h, cfg, key=k_rts)
            return x + self._drop(out.to(x.dtype), key), aux
        return self._dense_mlp(lp, x, dot, key), None

    def _dense_mlp(self, lp, x, dot=torch.matmul, key=None):
        """``x + dropout(mlp(norm(x)))`` of a dense MLP, its matmuls
        through ``dot``."""
        cfg = self.config
        h = norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
        m = lp["mlp"]
        act = activation_fn(cfg.activation)
        up = dot(h, m["w_up"])
        if cfg.has_mlp_bias:
            up = up + m["b_up"]
        if cfg.glu:
            gate = dot(h, m["w_gate"])
            if cfg.has_mlp_bias:
                gate = gate + m["b_gate"]
            gated = act(gate) * up
        else:
            gated = act(up)
        out = dot(gated, m["w_down"])
        if cfg.has_mlp_bias:
            out = out + m["b_down"]
        return x + self._drop(out.to(x.dtype), key)

    def _layer(self, lp, x, cos, sin, key=None, mlp=None, dot=torch.matmul):
        """One layer: ``(output, aux)``; ``key`` splits into the attention's
        and the MLP's dropout keys (JAX ``_layer``); ``mlp(lp, y, key)`` is
        ``(y + mlp(norm(y)), aux)`` (default :meth:`_mlp_block`).
        Sequential: the MLP reads ``x + attn``; parallel residual (gpt-neox,
        gpt-j): both sub-blocks read the layer input and the attention
        output is added to ``x + mlp``."""
        k_attn, k_mlp = prng.split(key) if key is not None else (None, None)
        mlp = mlp or functools.partial(self._mlp_block, dot=dot)
        attn = self._attn_out(lp, x, cos, sin, k_attn, dot)
        if self.config.parallel_residual:
            y, aux = mlp(lp, x, k_mlp)
            return y + attn, aux
        return mlp(lp, x + attn, k_mlp)

    def _mlp_dots(self, lp, x, key=None):
        names = tuple((g, n) for g in ("mlp_norm", "mlp") for n in lp[g])

        def fn(ins, dot):
            return self._dense_mlp(_nest(names, ins[1:]), ins[0], dot, key)
        return _Dots.apply(fn, False, x, *(lp[g][n] for g, n in names)), None

    def _layer_dots(self, lp, x, cos, sin, key=None, offload=False):
        """The whole layer keeping its matmul outputs: on the device, or
        (``offload``) in pinned host memory."""
        names = tuple((g, n) for g in lp for n in lp[g])

        def fn(ins, dot):
            y, aux = self._layer(_nest(names, ins[3:]), ins[0], ins[1], ins[2],
                                 key, dot=dot)
            return y if aux is None else (y, aux)
        out = _Dots.apply(fn, offload, x, cos, sin,
                          *(lp[g][n] for g, n in names))
        return out if isinstance(out, tuple) else (out, None)

    def _layer_fn(self, device: torch.device):
        """The per-layer body under the model's remat policy.  ``mlp_only``
        and ``mlp_dots`` remat the MLP sub-block only (the attention
        residuals persist and the flash kernel never re-runs): ``mlp_only``
        under ``torch.utils.checkpoint`` (non-reentrant), which recomputes
        what the backward needs (the norm, the up and gate matmuls, the
        activation); ``mlp_dots`` through :class:`_Dots`, which keeps the
        matmul outputs and recomputes the norm and the activation.  ``full``
        and ``dots`` checkpoint the whole layer.  ``offload_dots`` keeps the
        whole layer's matmul outputs in pinned host memory on the card; on
        the CPU it keeps them in place, with the JAX package's warning (its
        CPU backend cannot place them on the host either).  Recomputation
        repeats the same operations on the same inputs, dropout included
        (its keys are arguments of every body), so the numbers are identical
        to no remat; only memory and time differ.  (The JAX ``dots`` policy
        also saves the matmul outputs; here it recomputes them.)  An MoE MLP
        under ``mlp_dots`` is recomputed whole, as under ``mlp_only``: JAX's
        policy (``dots_with_no_batch_dims_saveable``) saves its router
        product (and the einsum dispatch's two products) but not the expert
        contractions, whose batch dim is E, so the port recomputes beyond
        JAX only those small products; the numbers are the same.  Each body
        takes ``(lp, x, cos, sin, key)`` and returns ``(output, aux)``, the
        aux a differentiable fp32 scalar or None."""
        cfg = self.config
        if not cfg.remat:
            return self._layer
        if cfg.remat_policy == "offload_dots":
            on_card = device.type == "cuda"
            if not on_card and not getattr(self, "_warned_offload", False):
                self._warned_offload = True
                logger.warning("cpu_checkpointing: offloaded residuals "
                               "unsupported on the CPU backend; saving dots "
                               "without the host memory-space move")
            return functools.partial(self._layer_dots, offload=on_card)
        if cfg.remat_policy == "mlp_only" or (cfg.remat_policy == "mlp_dots"
                                              and cfg.is_moe):
            return functools.partial(self._layer, mlp=functools.partial(
                checkpoint, self._mlp_block, use_reentrant=False))
        if cfg.remat_policy == "mlp_dots":
            return functools.partial(self._layer, mlp=self._mlp_dots)
        return functools.partial(checkpoint, self._layer, use_reentrant=False)

    def apply(self, params: Dict[str, Any], tokens: torch.Tensor,
              labels: Optional[torch.Tensor] = None,
              loss_mask: Optional[torch.Tensor] = None,
              rngs: Any = None, ce_weight: Any = None) -> torch.Tensor:
        """Logits [B, S, V] (no labels) or the mean next-token loss.
        ``params`` is the nested JAX-layout dict; a layer leaf may be the
        stacked ``[L, ...]`` tensor or a sequence of L per-layer tensors
        (the engine's compute copy).  ``rngs`` is a threefry key (or
        ``{"dropout": key}``) for dropout, as the JAX ``apply``: with
        ``dropout > 0`` it splits into one key a layer.  An MoE model's loss
        adds ``moe_aux_loss_coef`` times the sum of its layers' aux losses,
        in layer order, as the JAX ``apply``.  ``ce_weight`` (a scalar)
        multiplies the cross-entropy alone: the data-parallel engine's
        weight, which leaves the aux loss a per-rank mean."""
        cfg = self.config
        x = params["embed"]["tok"][tokens]
        S = tokens.shape[1]
        if cfg.position == "learned":
            x = x + params["embed"]["pos"][:S][None]
        if cfg.embed_norm:  # bloom word_embeddings_layernorm
            x = norm(x, params["embed"]["norm"], "layernorm", cfg.norm_eps)
        cos = sin = None
        if cfg.position == "rope":
            cos, sin = rope_cache(S, rope_dim(cfg), cfg.rope_theta,
                                  device=x.device)
            cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        drop_rng = rngs.get("dropout") if isinstance(rngs, dict) else rngs
        keys = (prng.split(drop_rng, cfg.num_layers)
                if cfg.dropout > 0 and drop_rng is not None
                else [None] * cfg.num_layers)
        body = self._layer_fn(x.device)
        layers = params["layers"]
        aux_loss = None
        for i in range(cfg.num_layers):
            lp = {name: {k: v[i] for k, v in sub.items()}
                  for name, sub in layers.items()}
            x, aux = body(lp, x, cos, sin, keys[i])
            if aux is not None:
                aux_loss = aux if aux_loss is None else aux_loss + aux
        head = (params["embed"]["tok"].t() if cfg.tie_embeddings
                else params["lm_head"])
        if labels is None:
            x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
            logits = x @ head.to(x.dtype)
            if cfg.lm_head_bias:
                logits = logits + params["lm_head_bias"].to(logits.dtype)
            return logits
        loss = self._loss_tail(params["final_norm"], head, x, labels, loss_mask,
                               head_bias=params.get("lm_head_bias"))
        if ce_weight is not None:
            loss = loss * ce_weight
        return loss + cfg.moe_aux_loss_coef * aux_loss if cfg.is_moe else loss

    def _loss_tail(self, fnorm, head, x, labels, loss_mask, head_bias=None):
        """Final norm + next-token cross-entropy: logits[t] predicts
        labels[t+1].  ``head`` is [D, V].  The one implementation behind
        :meth:`apply` and the streamed head segment."""
        cfg = self.config
        h = norm(x, fnorm, cfg.norm, cfg.norm_eps)
        head = head.to(h.dtype)
        shifted_labels = labels[:, 1:]
        shifted_mask = loss_mask[:, 1:] if loss_mask is not None else None
        B, S, _ = h.shape
        chunk = cfg.ce_chunk
        if chunk is None:  # auto: chunk when the fp32 logits would be > 2^28
            chunk = 2048 if B * S * cfg.vocab_size > (1 << 28) else 0
        if chunk:
            return blockwise_cross_entropy(h[:, :-1], head, shifted_labels,
                                           chunk=chunk, z_loss=cfg.z_loss,
                                           mask=shifted_mask, head_bias=head_bias)
        logits = h[:, :-1] @ head
        if head_bias is not None:
            logits = logits + head_bias.to(logits.dtype)
        return cross_entropy(logits, shifted_labels, z_loss=cfg.z_loss,
                             mask=shifted_mask)


    # ------------------------------------------------------------------
    # streamed per-layer segments (ZeRO-Infinity, ``offload_param``)
    # ------------------------------------------------------------------
    def stream_segments(self) -> Dict[str, Any]:
        """The pure per-segment functions the engine's streamed forward and
        backward drive (:mod:`~deepspeed_tpu_torch.runtime.zero.stream_grad`;
        the JAX ``CausalLM.stream_segments``), so that one layer at a time
        is on the card and no model-sized buffer, params or grads, ever is:

        - ``embed_fwd(embed, tokens)``: the token rows, the learned
          positions and the embedding norm (BLOOM);
        - ``layer_fwd(lp, x, key, cos, sin)``: one layer, ``(y, aux)``
          (aux None for a dense MLP), dropped with ``key`` when it is given;
        - ``head_loss(head_tree, x, labels, loss_mask)``: the final norm and
          the cross-entropy; ``head_tree["head"]`` is the ``[V, D]`` token
          table when the embeddings are tied, else ``[D, V]``;
        - ``rope(S, dtype, device)``: cos and sin (None without RoPE);
        - ``layer_body(device)``: the training forward's per-layer body under
          the model's remat policy (:meth:`_layer_fn`; the ``overlap_comm``
          schedule runs it, so its numbers are the plain path's);
        - ``num_layers``, ``dropout``, ``moe_coef`` (0 for a dense model)
          and ``tied``."""
        cfg = self.config

        def embed_fwd(embed, tokens):
            x = embed["tok"][tokens]
            if cfg.position == "learned":
                x = x + embed["pos"][:tokens.shape[1]][None]
            if cfg.embed_norm:
                x = norm(x, embed["norm"], "layernorm", cfg.norm_eps)
            return x

        def layer_fwd(lp, x, key, cos, sin):
            return self._layer(lp, x, cos, sin, key)

        def head_loss(head_tree, x, labels, loss_mask):
            head = head_tree["head"]
            if cfg.tie_embeddings:          # the [V, D] token table
                head = head.t()
            return self._loss_tail(head_tree["final_norm"], head, x, labels,
                                   loss_mask, head_bias=head_tree.get("head_bias"))

        def rope(S, dtype, device):
            if cfg.position != "rope":
                return None, None
            cos, sin = rope_cache(S, rope_dim(cfg), cfg.rope_theta, device=device)
            return cos.to(dtype), sin.to(dtype)

        return {"num_layers": cfg.num_layers, "dropout": cfg.dropout,
                "moe_coef": cfg.moe_aux_loss_coef if cfg.is_moe else 0.0,
                "tied": cfg.tie_embeddings, "embed_fwd": embed_fwd,
                "layer_fwd": layer_fwd, "layer_body": self._layer_fn,
                "head_loss": head_loss, "rope": rope}


def causal_lm(preset: str, *, device: DeviceLike = None,
              dtype: torch.dtype = torch.float32, seed: int = 0,
              **overrides) -> CausalLM:
    """Build a preset (``get_model_config`` overrides apply) with random
    weights from ``seed`` on ``device`` (default: the CUDA card)."""
    return CausalLM(get_model_config(preset, **overrides), device=device,
                    dtype=dtype, seed=seed)


def _nll(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """Per-token nll of fp32 logits (ignore_index handled by the caller)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None]).squeeze(-1)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return nll


def _valid(labels, mask):
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    return valid


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0, mask=None) -> torch.Tensor:
    """Token-level CE in fp32; labels < 0 are ignored (HF -100)."""
    nll = _nll(logits.float(), labels, z_loss)
    valid = _valid(labels, mask)
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum() / valid.sum().clamp(min=1)


def blockwise_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                            labels: torch.Tensor, chunk: int,
                            z_loss: float = 0.0, mask=None,
                            head_bias=None) -> torch.Tensor:
    """LM loss without the full [B, S, V] logits: token chunks of
    ``chunk`` rows, each a [chunk, V] logits block reduced to an nll sum in
    fp32 under ``torch.utils.checkpoint``, so the backward recomputes the
    block instead of saving it (the JAX ``jax.checkpoint`` scan body)."""
    B, S, D = x.shape
    N = B * S
    xf, lf = x.reshape(N, D), labels.reshape(N)
    mf = None if mask is None else mask.reshape(N)
    pad = (-N) % chunk
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, D)])
        lf = torch.cat([lf, lf.new_full((pad,), -100)])
        if mf is not None:
            mf = torch.cat([mf, mf.new_zeros(pad)])

    def block(xc, lc, mc):
        logits = (xc @ head).float()
        if head_bias is not None:
            logits = logits + head_bias.float()
        nll = _nll(logits, lc, z_loss)
        valid = _valid(lc, mc)
        return torch.where(valid, nll, torch.zeros((), device=nll.device)).sum()

    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, xf.shape[0], chunk):
        lc = lf[i:i + chunk]
        mc = None if mf is None else mf[i:i + chunk]
        tot = tot + checkpoint(block, xf[i:i + chunk], lc, mc, use_reentrant=False)
        cnt = cnt + _valid(lc, mc).sum()
    return tot / cnt.clamp(min=1)
