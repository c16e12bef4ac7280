"""Module injection, PyTorch port: the HF checkpoint import.

Counterpart of ``deepspeed_tpu/module_inject/``.  :func:`config_from_hf`
and :func:`hf_to_params` map a HuggingFace checkpoint onto the port's
:class:`~deepspeed_tpu_torch.models.config.ModelConfig` and parameter tree,
and :func:`causal_lm_from_hf` builds the model from it.  ``tp_model_init``
and ``replace_module`` (training-time tensor parallelism over a mesh) wait
for ZeRO and the parallel meshes (ROADMAP.md queue 1, item 2e).
"""

from deepspeed_tpu_torch.module_inject.containers import (  # noqa: F401
    causal_lm_from_hf, config_from_hf, detect_arch, hf_to_params,
    is_hf_checkpoint, load_hf_state_dict)

__all__ = ["causal_lm_from_hf", "config_from_hf", "detect_arch",
           "hf_to_params", "is_hf_checkpoint", "load_hf_state_dict"]
