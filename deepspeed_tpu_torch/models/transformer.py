"""Decoder-only transformer (Llama family), PyTorch port.

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

The training forward (``apply``), the loss and the MoE layers are not in
this slice (ROADMAP.md queue 1); serving runs the model through
:func:`~deepspeed_tpu_torch.models.decoding.forward_with_cache`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import (DeviceLike,
                                                              resolve_device)
from deepspeed_tpu_torch.models.config import ModelConfig, get_model_config


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's shapes, leaf for leaf as the JAX init builds it,
    with each leaf's init as ``(shape, kind, scale)``: kind is ``uniform``
    (±scale), ``normal`` (std scale), ``ones`` or ``zeros``."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE models are not ported yet (ROADMAP.md queue 1: serving "
            "features deferred from the first slice)")
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
    mlp = {"w_up": ((L, D, F), "uniform", s_in),
           "w_down": ((L, F, D), "uniform", s_ff)}
    if cfg.glu:
        mlp["w_gate"] = ((L, D, F), "uniform", s_in)
    if cfg.has_mlp_bias:
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
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        super().__init__(_init_tree(param_shapes(config), dev, dtype, gen))
        self.config = config

    def params(self) -> Dict[str, Any]:
        """The nested parameter dict (JAX tree layout) the decode functions
        read; the tensors are the module's own parameters, not copies."""
        return self.tree()


def causal_lm(preset: str, *, device: DeviceLike = None,
              dtype: torch.dtype = torch.float32, seed: int = 0,
              **overrides) -> CausalLM:
    """Build a preset (``get_model_config`` overrides apply) with random
    weights from ``seed`` on ``device`` (default: the CUDA card)."""
    return CausalLM(get_model_config(preset, **overrides), device=device,
                    dtype=dtype, seed=seed)
