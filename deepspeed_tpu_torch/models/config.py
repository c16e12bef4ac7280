"""Model configurations for the built-in model families.

A field-for-field copy of ``deepspeed_tpu/models/config.py`` (the port
imports nothing of the JAX package): the same :class:`ModelConfig` fields,
defaults and presets, so a configuration means the same model in both
packages.  Fields that only the JAX training stack reads (pipeline, remat,
MoE transport) are kept so the two dataclasses stay comparable field by
field; the port's serving slice ignores them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None     # GQA; None -> == num_heads
    head_dim: Optional[int] = None         # None -> hidden_size // num_heads
    max_seq_len: int = 4096
    norm: str = "rmsnorm"                  # "rmsnorm" (llama) | "layernorm" (gpt2)
    norm_eps: float = 1e-5
    activation: str = "silu"               # "silu" (swiglu) | "gelu"
    glu: bool = True                       # gated MLP (llama) vs plain (gpt2)
    position: str = "rope"                 # "rope" | "learned" | "alibi"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    use_bias: bool = False                 # attn/mlp projection biases (gpt2)
    qkv_bias: bool = False                 # biases on q/k/v only (qwen2)
    mlp_bias: bool = False                 # biases on the MLP only (gpt-j)
    lm_head_bias: bool = False             # bias on the LM head (gpt-j)
    embed_norm: bool = False               # layernorm after token embed (bloom)
    # gpt-neox/pythia: x + attn(ln1(x)) + mlp(ln2(x))
    parallel_residual: bool = False
    rotary_pct: float = 1.0                # fraction of head dims rotated (neox)
    dropout: float = 0.0
    # MoE (mixtral family); num_experts == 0 -> dense MLP
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_drop_tokens: bool = True
    moe_use_rts: bool = False
    moe_dispatch: str = "scatter"
    moe_q_dispatch: bool = False
    seq_ring_q: bool = False
    comm_quant_block: int = 256
    pp_boundary_q: bool = False
    pp_comm_record: bool = True
    # training-time knobs
    sp_mode: str = "auto"
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"
    remat: Optional[bool] = None
    remat_policy: str = "full"
    param_offload: bool = False
    scan_layers: bool = True
    z_loss: float = 0.0
    ce_chunk: Optional[int] = None

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple "
                             f"of num_kv_heads {self.num_kv_heads}")
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pp_schedule must be 'gpipe' or '1f1b', got "
                             f"{self.pp_schedule!r}")
        if self.position not in ("rope", "learned", "alibi"):
            raise ValueError(f"position must be 'rope', 'learned' or "
                             f"'alibi', got {self.position!r}")

    @property
    def has_mlp_bias(self) -> bool:
        return self.use_bias or self.mlp_bias

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


_PRESETS = {
    "gpt2-small": dict(vocab_size=50257, hidden_size=768, intermediate_size=3072,
                       num_layers=12, num_heads=12, max_seq_len=1024,
                       norm="layernorm", activation="gelu", glu=False,
                       position="learned", tie_embeddings=True),
    "gpt2-medium": dict(vocab_size=50257, hidden_size=1024, intermediate_size=4096,
                        num_layers=24, num_heads=16, max_seq_len=1024,
                        norm="layernorm", activation="gelu", glu=False,
                        position="learned", tie_embeddings=True),
    "gpt2-xl": dict(vocab_size=50257, hidden_size=1600, intermediate_size=6400,
                    num_layers=48, num_heads=25, max_seq_len=1024,
                    norm="layernorm", activation="gelu", glu=False,
                    position="learned", tie_embeddings=True, remat=True),
    "llama-tiny": dict(vocab_size=32000, hidden_size=256, intermediate_size=688,
                       num_layers=4, num_heads=8, num_kv_heads=4, max_seq_len=2048),
    "llama-1b4": dict(vocab_size=50304, hidden_size=2048, intermediate_size=5632,
                      num_layers=24, num_heads=16, num_kv_heads=16,
                      max_seq_len=2048, tie_embeddings=True, remat=True,
                      remat_policy="mlp_dots"),
    "llama2-7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                      num_layers=32, num_heads=32, max_seq_len=4096, remat=True),
    "llama2-13b": dict(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                       num_layers=40, num_heads=40, max_seq_len=4096, remat=True),
    "llama3-8b": dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                      num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
                      rope_theta=500000.0, remat=True),
    "llama3-70b": dict(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
                       num_layers=80, num_heads=64, num_kv_heads=8, max_seq_len=8192,
                       rope_theta=500000.0, remat=True),
    "mixtral-tiny": dict(vocab_size=32000, hidden_size=256, intermediate_size=512,
                         num_layers=4, num_heads=8, num_kv_heads=4, max_seq_len=2048,
                         num_experts=8, num_experts_per_tok=2),
    "mixtral-8x7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                         num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
                         rope_theta=1000000.0, num_experts=8, num_experts_per_tok=2,
                         remat=True),
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown model preset {name!r}; available: {sorted(_PRESETS)}")
    kw = dict(_PRESETS[name])
    kw.update(overrides)
    return ModelConfig(**kw)
