"""HF checkpoint import: published GPT-2 / Llama / Mixtral / OPT / Qwen2 /
GPT-NeoX(Pythia) / BLOOM / GPT-J weights -> the port's parameter tree.

Counterpart of ``deepspeed_tpu/module_inject/containers.py``, copied and
trimmed (numpy only, no jax): read safetensors / torch .bin shards, rename
and transpose into the CausalLM tree (stacked [L, ...] layer weights,
input-major linear layout), and derive the :class:`ModelConfig` from
config.json.  The tree is the JAX package's, array for array, so
:func:`causal_lm_from_hf` loads it through
:func:`~deepspeed_tpu_torch.models.convert.jax_params_to_torch`.

Conventions handled:
- HF ``nn.Linear`` stores [out, in] -> transposed to our [in, out].
- GPT-2 ``Conv1D`` stores [in, out] -> copied as-is; fused c_attn split into
  wq/wk/wv; biases mapped (our models carry biases when ``use_bias``).
- Llama/Mixtral rotary uses the half-split pairing — identical to our RoPE
  kernel, so q/k import without permutation.
- GPT-J rotary is INTERLEAVED; its q/k output columns are permuted at import
  so the half-split kernel computes identical rotations (the q.k dot is
  invariant to a permutation applied to both sides).  Its single shared
  ln_1 is copied into both norm slots of the parallel-residual block.
- BLOOM: fused per-head-interleaved QKV (like NeoX), ALiBi positions, and
  the word_embeddings_layernorm (``embed_norm``).
- Mixtral experts w1/w3/w2 -> w_gate/w_up/w_down stacked on a leading [E],
  the router as ``gate_w`` (the MoE MLP of :mod:`deepspeed_tpu_torch.moe`).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike
from deepspeed_tpu_torch.models.config import ModelConfig
from deepspeed_tpu_torch.models.convert import jax_params_to_torch
from deepspeed_tpu_torch.models.layers import rope_dim
from deepspeed_tpu_torch.models.transformer import CausalLM

logger = logging.getLogger(__name__)


def load_hf_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a HF checkpoint dir (safetensors preferred, torch .bin fallback)
    into {name: np.ndarray}."""
    sd: Dict[str, np.ndarray] = {}
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        from safetensors.numpy import load_file

        for f in st_files:
            sd.update(load_file(os.path.join(path, f)))
        return sd
    bin_files = sorted(f for f in os.listdir(path)
                       if f.endswith(".bin") and "pytorch_model" in f)
    if bin_files:
        for f in bin_files:
            part = torch.load(os.path.join(path, f), map_location="cpu",
                              weights_only=True)
            sd.update({k: v.float().numpy() if v.dtype == torch.bfloat16
                       else v.numpy() for k, v in part.items()})
        return sd
    raise FileNotFoundError(f"no safetensors/.bin weights in {path}")


def _strip_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    for prefix in ("transformer.", "model.", "gpt_neox."):
        if any(k.startswith(prefix) for k in sd):
            out = {}
            for k, v in sd.items():
                out[k[len(prefix):] if k.startswith(prefix) else k] = v
            return out
    return sd


def detect_arch(sd: Dict[str, np.ndarray]) -> str:
    keys = set(sd)
    if any("block_sparse_moe" in k for k in keys):
        return "mixtral"
    if any("word_embeddings_layernorm" in k for k in keys):
        return "bloom"
    if any("wte.weight" in k for k in keys):
        # gpt-j has separate q/k/v projections; gpt2 a fused Conv1D c_attn
        if any(".attn.q_proj." in k for k in keys):
            return "gptj"
        return "gpt2"
    if any("decoder.embed_positions" in k for k in keys):
        return "opt"
    if any("embed_in.weight" in k for k in keys):
        return "gpt_neox"
    if any("embed_tokens.weight" in k for k in keys):
        # qwen2 is llama-shaped with q/k/v biases
        if any(k.endswith("q_proj.bias") for k in keys):
            return "qwen2"
        return "llama"
    raise ValueError(f"unrecognized HF architecture (keys: {sorted(keys)[:8]}...)")


def config_from_hf(path: str):
    """The port's ModelConfig from a HF config.json."""
    with open(os.path.join(path, "config.json")) as fh:
        hf = json.load(fh)
    mt = hf.get("model_type", "")
    if mt == "gpt2":
        return ModelConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["n_embd"],
            intermediate_size=4 * hf["n_embd"], num_layers=hf["n_layer"],
            num_heads=hf["n_head"], max_seq_len=hf.get("n_positions", 1024),
            norm="layernorm", norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            activation="gelu", glu=False, position="learned",
            tie_embeddings=True, use_bias=True)
    if mt in ("llama", "mistral", "qwen2"):
        return ModelConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads"),
            max_seq_len=hf.get("max_position_embeddings", 4096),
            norm="rmsnorm", norm_eps=hf.get("rms_norm_eps", 1e-5),
            activation="silu", glu=True, position="rope",
            rope_theta=hf.get("rope_theta", 10000.0),
            qkv_bias=(mt == "qwen2"),
            tie_embeddings=hf.get("tie_word_embeddings", False))
    if mt == "gpt_neox":
        if not hf.get("attention_bias", True):
            raise ValueError(
                "gpt_neox with attention_bias=false is not supported: the "
                "model's use_bias covers attention AND mlp biases together "
                "(NeoX keeps mlp biases regardless)")
        # HF "gelu" is the exact erf form; the tanh approximations map to
        # this model zoo's default "gelu"
        act_map = {"gelu": "gelu_exact", "gelu_new": "gelu",
                   "gelu_fast": "gelu", "gelu_pytorch_tanh": "gelu"}
        act = hf.get("hidden_act", "gelu")
        if act not in act_map:
            raise ValueError(f"gpt_neox hidden_act {act!r} is not supported "
                             f"(supported: {sorted(act_map)})")
        return ModelConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="layernorm", norm_eps=hf.get("layer_norm_eps", 1e-5),
            activation=act_map[act], glu=False, position="rope",
            # transformers deprecated rotary_emb_base for rope_theta
            rope_theta=hf.get("rotary_emb_base",
                              hf.get("rope_theta", 10000.0)),
            rotary_pct=hf.get("rotary_pct", 1.0),
            parallel_residual=hf.get("use_parallel_residual", True),
            use_bias=True,
            tie_embeddings=hf.get("tie_word_embeddings", False))
    if mt == "bloom":
        D = hf["hidden_size" if "hidden_size" in hf else "n_embed"]
        return ModelConfig(
            vocab_size=hf["vocab_size"], hidden_size=D,
            intermediate_size=4 * D,
            num_layers=hf["n_layer"], num_heads=hf["n_head"],
            max_seq_len=hf.get("seq_length", 2048),
            norm="layernorm", norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            # HF BloomGelu is the tanh approximation
            activation="gelu", glu=False, position="alibi",
            use_bias=True, embed_norm=True,
            tie_embeddings=hf.get("tie_word_embeddings", True))
    if mt == "gptj":
        D = hf["n_embd"]
        Dh = D // hf["n_head"]
        return ModelConfig(
            vocab_size=hf["vocab_size"], hidden_size=D,
            intermediate_size=hf.get("n_inner") or 4 * D,
            num_layers=hf["n_layer"], num_heads=hf["n_head"],
            max_seq_len=hf.get("n_positions", 2048),
            norm="layernorm", norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            activation="gelu", glu=False, position="rope",
            rotary_pct=(hf.get("rotary_dim") or Dh) / Dh,
            # gpt-j runs attention and MLP in parallel off ONE layernorm;
            # the import copies ln_1 into both norm slots (identical math)
            parallel_residual=True,
            use_bias=False, mlp_bias=True, lm_head_bias=True,
            tie_embeddings=hf.get("tie_word_embeddings", False))
    if mt == "opt":
        D = hf["hidden_size"]
        if hf.get("word_embed_proj_dim", D) != D:
            raise ValueError("OPT word_embed_proj_dim != hidden_size "
                             "(project_in/out) is not supported")
        if not hf.get("do_layer_norm_before", True):
            raise ValueError("OPT with do_layer_norm_before=false (350m "
                             "post-LN variant) is not supported")
        return ModelConfig(
            vocab_size=hf["vocab_size"], hidden_size=D,
            intermediate_size=hf["ffn_dim"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="layernorm", activation="relu", glu=False,
            position="learned", use_bias=True,
            tie_embeddings=hf.get("tie_word_embeddings", True))
    if mt == "mixtral":
        return ModelConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads"),
            max_seq_len=hf.get("max_position_embeddings", 4096),
            norm="rmsnorm", norm_eps=hf.get("rms_norm_eps", 1e-5),
            activation="silu", glu=True, position="rope",
            rope_theta=hf.get("rope_theta", 1e6),
            num_experts=hf["num_local_experts"],
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
            tie_embeddings=hf.get("tie_word_embeddings", False))
    raise ValueError(f"unsupported HF model_type {mt!r}")


def _stack(sd, fmt: str, L: int, transform=None) -> np.ndarray:
    parts = [sd[fmt.format(i)] for i in range(L)]
    if transform is not None:
        parts = [transform(p) for p in parts]
    return np.stack(parts)


def hf_to_params(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """Map a HF state dict onto the CausalLM param tree."""
    sd = _strip_prefix(sd)
    arch = detect_arch(sd)
    L, D = cfg.num_layers, cfg.hidden_size
    T = lambda w: np.ascontiguousarray(w.T)

    if arch == "gpt2":
        qkv = [sd[f"h.{i}.attn.c_attn.weight"] for i in range(L)]      # [D, 3D]
        qkv_b = [sd[f"h.{i}.attn.c_attn.bias"] for i in range(L)]      # [3D]
        attn = {
            "wq": np.stack([w[:, :D] for w in qkv]),
            "wk": np.stack([w[:, D:2 * D] for w in qkv]),
            "wv": np.stack([w[:, 2 * D:] for w in qkv]),
            "wo": _stack(sd, "h.{}.attn.c_proj.weight", L),
            "bq": np.stack([b[:D] for b in qkv_b]),
            "bk": np.stack([b[D:2 * D] for b in qkv_b]),
            "bv": np.stack([b[2 * D:] for b in qkv_b]),
            "bo": _stack(sd, "h.{}.attn.c_proj.bias", L),
        }
        mlp = {
            "w_up": _stack(sd, "h.{}.mlp.c_fc.weight", L),
            "b_up": _stack(sd, "h.{}.mlp.c_fc.bias", L),
            "w_down": _stack(sd, "h.{}.mlp.c_proj.weight", L),
            "b_down": _stack(sd, "h.{}.mlp.c_proj.bias", L),
        }
        params = {
            "embed": {"tok": sd["wte.weight"], "pos": sd["wpe.weight"]},
            "layers": {
                "attn_norm": {"scale": _stack(sd, "h.{}.ln_1.weight", L),
                              "bias": _stack(sd, "h.{}.ln_1.bias", L)},
                "mlp_norm": {"scale": _stack(sd, "h.{}.ln_2.weight", L),
                             "bias": _stack(sd, "h.{}.ln_2.bias", L)},
                "attn": attn, "mlp": mlp,
            },
            "final_norm": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
        }
        return params

    if arch == "bloom":
        H, Dh = cfg.num_heads, cfg.head_dim

        def qkv_w(which):
            # fused [3D, D], per-head [q,k,v] interleave (same as neox)
            def split(i):
                w = sd[f"h.{i}.self_attention.query_key_value.weight"]
                part = w.reshape(H, 3, Dh, -1)[:, which]        # [H, Dh, D]
                return np.ascontiguousarray(part.reshape(H * Dh, -1).T)
            return np.stack([split(i) for i in range(L)])

        def qkv_b(which):
            def split(i):
                b = sd[f"h.{i}.self_attention.query_key_value.bias"]
                return b.reshape(H, 3, Dh)[:, which].reshape(H * Dh)
            return np.stack([split(i) for i in range(L)])

        attn = {
            "wq": qkv_w(0), "wk": qkv_w(1), "wv": qkv_w(2),
            "wo": _stack(sd, "h.{}.self_attention.dense.weight", L, T),
            "bq": qkv_b(0), "bk": qkv_b(1), "bv": qkv_b(2),
            "bo": _stack(sd, "h.{}.self_attention.dense.bias", L),
        }
        mlp = {
            "w_up": _stack(sd, "h.{}.mlp.dense_h_to_4h.weight", L, T),
            "b_up": _stack(sd, "h.{}.mlp.dense_h_to_4h.bias", L),
            "w_down": _stack(sd, "h.{}.mlp.dense_4h_to_h.weight", L, T),
            "b_down": _stack(sd, "h.{}.mlp.dense_4h_to_h.bias", L),
        }
        return {
            "embed": {"tok": sd["word_embeddings.weight"],
                      "norm": {"scale": sd["word_embeddings_layernorm.weight"],
                               "bias": sd["word_embeddings_layernorm.bias"]}},
            "layers": {
                "attn_norm": {
                    "scale": _stack(sd, "h.{}.input_layernorm.weight", L),
                    "bias": _stack(sd, "h.{}.input_layernorm.bias", L)},
                "mlp_norm": {
                    "scale": _stack(sd, "h.{}.post_attention_layernorm.weight", L),
                    "bias": _stack(sd, "h.{}.post_attention_layernorm.bias", L)},
                "attn": attn, "mlp": mlp,
            },
            "final_norm": {"scale": sd["ln_f.weight"],
                           "bias": sd["ln_f.bias"]},
        }

    if arch == "gptj":
        H, Dh = cfg.num_heads, cfg.head_dim
        rd = rope_dim(cfg)
        # HF GPT-J rotates interleaved pairs (2i, 2i+1); our kernel rotates
        # half-split pairs (i, i+rd/2).  Permuting the q/k OUTPUT columns
        # within each head maps one convention onto the other exactly (the
        # q.k dot is invariant to a permutation applied to both sides).
        perm = np.arange(Dh)
        perm[:rd // 2] = np.arange(0, rd, 2)
        perm[rd // 2:rd] = np.arange(1, rd, 2)

        def rot_cols(w):
            # w: HF [out=H*Dh, in=D] -> ours [D, H*Dh] with permuted heads
            wt = w.T.reshape(-1, H, Dh)
            return np.ascontiguousarray(wt[:, :, perm].reshape(-1, H * Dh))

        attn = {
            "wq": _stack(sd, "h.{}.attn.q_proj.weight", L, rot_cols),
            "wk": _stack(sd, "h.{}.attn.k_proj.weight", L, rot_cols),
            "wv": _stack(sd, "h.{}.attn.v_proj.weight", L, T),
            "wo": _stack(sd, "h.{}.attn.out_proj.weight", L, T),
        }
        mlp = {
            "w_up": _stack(sd, "h.{}.mlp.fc_in.weight", L, T),
            "b_up": _stack(sd, "h.{}.mlp.fc_in.bias", L),
            "w_down": _stack(sd, "h.{}.mlp.fc_out.weight", L, T),
            "b_down": _stack(sd, "h.{}.mlp.fc_out.bias", L),
        }
        ln1_s = _stack(sd, "h.{}.ln_1.weight", L)
        ln1_b = _stack(sd, "h.{}.ln_1.bias", L)
        params = {
            "embed": {"tok": sd["wte.weight"]},
            "layers": {
                # one shared LayerNorm in the HF block: both slots get it
                "attn_norm": {"scale": ln1_s, "bias": ln1_b},
                "mlp_norm": {"scale": ln1_s.copy(), "bias": ln1_b.copy()},
                "attn": attn, "mlp": mlp,
            },
            "final_norm": {"scale": sd["ln_f.weight"],
                           "bias": sd["ln_f.bias"]},
            "lm_head": T(sd["lm_head.weight"]),
            "lm_head_bias": sd["lm_head.bias"],
        }
        return params

    if arch == "gpt_neox":
        H, Dh = cfg.num_heads, cfg.head_dim

        def qkv_w(which):
            # fused [3D, D], per-head [q,k,v] interleave -> our [D, H*Dh]
            def split(i):
                w = sd[f"layers.{i}.attention.query_key_value.weight"]
                part = w.reshape(H, 3, Dh, -1)[:, which]        # [H, Dh, D]
                return np.ascontiguousarray(part.reshape(H * Dh, -1).T)
            return np.stack([split(i) for i in range(L)])

        def qkv_b(which):
            def split(i):
                b = sd[f"layers.{i}.attention.query_key_value.bias"]
                return b.reshape(H, 3, Dh)[:, which].reshape(H * Dh)
            return np.stack([split(i) for i in range(L)])

        attn = {
            "wq": qkv_w(0), "wk": qkv_w(1), "wv": qkv_w(2),
            "wo": _stack(sd, "layers.{}.attention.dense.weight", L, T),
            "bq": qkv_b(0), "bk": qkv_b(1), "bv": qkv_b(2),
            "bo": _stack(sd, "layers.{}.attention.dense.bias", L),
        }
        mlp = {
            "w_up": _stack(sd, "layers.{}.mlp.dense_h_to_4h.weight", L, T),
            "b_up": _stack(sd, "layers.{}.mlp.dense_h_to_4h.bias", L),
            "w_down": _stack(sd, "layers.{}.mlp.dense_4h_to_h.weight", L, T),
            "b_down": _stack(sd, "layers.{}.mlp.dense_4h_to_h.bias", L),
        }
        params = {
            "embed": {"tok": sd["embed_in.weight"]},
            "layers": {
                "attn_norm": {
                    "scale": _stack(sd, "layers.{}.input_layernorm.weight", L),
                    "bias": _stack(sd, "layers.{}.input_layernorm.bias", L)},
                "mlp_norm": {
                    "scale": _stack(sd, "layers.{}.post_attention_layernorm.weight", L),
                    "bias": _stack(sd, "layers.{}.post_attention_layernorm.bias", L)},
                "attn": attn, "mlp": mlp,
            },
            "final_norm": {"scale": sd["final_layer_norm.weight"],
                           "bias": sd["final_layer_norm.bias"]},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = T(sd["embed_out.weight"])
        return params

    if arch == "opt":
        attn = {
            "wq": _stack(sd, "decoder.layers.{}.self_attn.q_proj.weight", L, T),
            "wk": _stack(sd, "decoder.layers.{}.self_attn.k_proj.weight", L, T),
            "wv": _stack(sd, "decoder.layers.{}.self_attn.v_proj.weight", L, T),
            "wo": _stack(sd, "decoder.layers.{}.self_attn.out_proj.weight", L, T),
            "bq": _stack(sd, "decoder.layers.{}.self_attn.q_proj.bias", L),
            "bk": _stack(sd, "decoder.layers.{}.self_attn.k_proj.bias", L),
            "bv": _stack(sd, "decoder.layers.{}.self_attn.v_proj.bias", L),
            "bo": _stack(sd, "decoder.layers.{}.self_attn.out_proj.bias", L),
        }
        mlp = {
            "w_up": _stack(sd, "decoder.layers.{}.fc1.weight", L, T),
            "b_up": _stack(sd, "decoder.layers.{}.fc1.bias", L),
            "w_down": _stack(sd, "decoder.layers.{}.fc2.weight", L, T),
            "b_down": _stack(sd, "decoder.layers.{}.fc2.bias", L),
        }
        params = {
            "embed": {
                "tok": sd["decoder.embed_tokens.weight"],
                # OPT's learned positions carry a +2 fairseq padding offset;
                # with a full attention mask position ids are arange+2, so
                # rows [2:] are the effective table
                "pos": sd["decoder.embed_positions.weight"][2:],
            },
            "layers": {
                "attn_norm": {
                    "scale": _stack(sd, "decoder.layers.{}.self_attn_layer_norm.weight", L),
                    "bias": _stack(sd, "decoder.layers.{}.self_attn_layer_norm.bias", L)},
                "mlp_norm": {
                    "scale": _stack(sd, "decoder.layers.{}.final_layer_norm.weight", L),
                    "bias": _stack(sd, "decoder.layers.{}.final_layer_norm.bias", L)},
                "attn": attn, "mlp": mlp,
            },
            "final_norm": {"scale": sd["decoder.final_layer_norm.weight"],
                           "bias": sd["decoder.final_layer_norm.bias"]},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = T(sd["lm_head.weight"])
        return params

    if arch in ("llama", "qwen2"):
        attn = {
            "wq": _stack(sd, "layers.{}.self_attn.q_proj.weight", L, T),
            "wk": _stack(sd, "layers.{}.self_attn.k_proj.weight", L, T),
            "wv": _stack(sd, "layers.{}.self_attn.v_proj.weight", L, T),
            "wo": _stack(sd, "layers.{}.self_attn.o_proj.weight", L, T),
        }
        if arch == "qwen2":
            attn.update(
                bq=_stack(sd, "layers.{}.self_attn.q_proj.bias", L),
                bk=_stack(sd, "layers.{}.self_attn.k_proj.bias", L),
                bv=_stack(sd, "layers.{}.self_attn.v_proj.bias", L))
        mlp = {
            "w_gate": _stack(sd, "layers.{}.mlp.gate_proj.weight", L, T),
            "w_up": _stack(sd, "layers.{}.mlp.up_proj.weight", L, T),
            "w_down": _stack(sd, "layers.{}.mlp.down_proj.weight", L, T),
        }
    else:  # mixtral
        E = cfg.num_experts
        attn = {
            "wq": _stack(sd, "layers.{}.self_attn.q_proj.weight", L, T),
            "wk": _stack(sd, "layers.{}.self_attn.k_proj.weight", L, T),
            "wv": _stack(sd, "layers.{}.self_attn.v_proj.weight", L, T),
            "wo": _stack(sd, "layers.{}.self_attn.o_proj.weight", L, T),
        }
        def experts(wname):
            return np.stack([
                np.stack([T(sd[f"layers.{i}.block_sparse_moe.experts.{e}.{wname}.weight"])
                          for e in range(E)]) for i in range(L)])
        mlp = {
            "gate_w": _stack(sd, "layers.{}.block_sparse_moe.gate.weight", L, T),
            "w_gate": experts("w1"),   # HF w1 = gate_proj
            "w_down": experts("w2"),   # HF w2 = down_proj
            "w_up": experts("w3"),     # HF w3 = up_proj
        }
    params = {
        "embed": {"tok": sd["embed_tokens.weight"]},
        "layers": {
            "attn_norm": {"scale": _stack(sd, "layers.{}.input_layernorm.weight", L)},
            "mlp_norm": {"scale": _stack(
                sd, "layers.{}.post_attention_layernorm.weight", L)},
            "attn": attn, "mlp": mlp,
        },
        "final_norm": {"scale": sd["norm.weight"]},
    }
    if not cfg.tie_embeddings:
        head = sd.get("lm_head.weight")
        params["lm_head"] = (T(head) if head is not None
                             else T(sd["embed_tokens.weight"]))
    return params


def causal_lm_from_hf(path: str, *, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> CausalLM:
    """One-call import: HF checkpoint dir -> the port's CausalLM holding its
    weights in ``dtype`` on ``device`` (default: the CUDA card)."""
    cfg = config_from_hf(path)
    sd = load_hf_state_dict(path)
    params = hf_to_params(sd, cfg)
    n = sum(int(a.size) for a in _leaves(params))
    logger.info("imported HF checkpoint %s: %s, %.2fM params", path,
                detect_arch(_strip_prefix(sd)), n / 1e6)
    return CausalLM(cfg, params=jax_params_to_torch(params, cfg, device=device,
                                                    dtype=dtype))


def is_hf_checkpoint(path: str) -> bool:
    """True only for genuine HF layouts (config.json + safetensors or
    pytorch_model*.bin) — the framework's own shard_p*.bin files must not
    match, or its checkpoints would become unloadable next to a config.json."""
    if not (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "config.json"))):
        return False
    return any(f.endswith(".safetensors")
               or (f.endswith(".bin") and "pytorch_model" in f)
               for f in os.listdir(path))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
