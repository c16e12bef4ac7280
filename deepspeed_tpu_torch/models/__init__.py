"""Built-in model families, PyTorch port (Llama, GPT-2, Mixtral, and
through the HF import BLOOM, GPT-NeoX, GPT-J, OPT and Qwen2)."""

from deepspeed_tpu_torch.models.config import ModelConfig, get_model_config
from deepspeed_tpu_torch.models.convert import jax_params_to_torch
from deepspeed_tpu_torch.models.transformer import CausalLM, causal_lm

__all__ = ["ModelConfig", "get_model_config", "CausalLM", "causal_lm",
           "jax_params_to_torch"]
