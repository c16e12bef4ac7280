"""Activation checkpointing, PyTorch port (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/``)."""

from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (  # noqa: F401
    CudaRNGStatesTracker, checkpoint, checkpoint_wrapper, configure,
    get_cuda_rng_tracker, is_configured, model_parallel_cuda_manual_seed)
