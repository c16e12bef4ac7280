"""Built-in model families, PyTorch port (the Llama family in this slice)."""

from deepspeed_tpu_torch.models.config import ModelConfig, get_model_config
from deepspeed_tpu_torch.models.convert import jax_params_to_torch
from deepspeed_tpu_torch.models.transformer import CausalLM, causal_lm

__all__ = ["ModelConfig", "get_model_config", "CausalLM", "causal_lm",
           "jax_params_to_torch"]
