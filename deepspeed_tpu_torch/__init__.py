"""deepspeed_tpu_torch: the PyTorch / CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, which stays the reference.  It
imports torch and never jax, and nothing of ``deepspeed_tpu``.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``; with
no card and no device given they raise.

It serves the Llama family through the paged continuous-batching engine.
Decode runs the kernel-injected (fused) path by default: four CUDA C++
kernels per layer (fused norm+QKV, paged flash-decode attention,
out-projection+residual+norm, fused MLP); ``use_fused_decode: False``
keeps the unfused path.  Prefill runs RMSNorm (CUDA C++) and RoPE
(Triton).  It trains the Llama family on one card through
:func:`initialize` (the standard path: bf16 compute, fp32 masters,
gradient accumulation, clipping, FusedAdam), with RMSNorm and RoPE forward
and backward, flash attention forward and backward and the fused Adam
update as hand-written kernels.  ROADMAP.md lists what comes next.
"""

from __future__ import annotations

from typing import Any

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike
from deepspeed_tpu_torch.models import causal_lm

__all__ = ["initialize", "init_serving", "causal_lm"]


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               config=None, config_params=None, *, device: DeviceLike = None,
               seed: Any = None):
    """Create a training engine (counterpart of ``deepspeed_tpu.initialize``).

    Returns ``(engine, optimizer, None, lr_scheduler)``.  ``model`` is a
    :class:`~deepspeed_tpu_torch.models.transformer.CausalLM` whose
    parameters become the fp32 masters; ``model_parameters`` (a nested
    dict of tensors or numpy arrays in the JAX layout) replaces their
    values.  ``device=None`` is the CUDA card.  ``seed`` seeds torch's
    generators (default: the config's ``seed``).  A client ``optimizer``
    is not ported (ROADMAP.md queue 1)."""
    import torch

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if optimizer is not None:
        raise NotImplementedError("a client optimizer is not ported yet "
                                  "(ROADMAP.md queue 1: other optimizers and "
                                  "schedules); configure the optimizer section")
    cfg = config if config is not None else config_params
    if cfg is None and args is not None and hasattr(args, "deepspeed_config"):
        cfg = args.deepspeed_config
    cfg = cfg if isinstance(cfg, DeepSpeedConfig) else DeepSpeedConfig(cfg)
    torch.manual_seed(int(cfg.seed if seed is None else seed))
    engine = DeepSpeedEngine(model, cfg, model_parameters=model_parameters,
                             device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler


def init_serving(model=None, config=None, *, params: Any = None,
                 device: DeviceLike = None, num_slots: int = 0,
                 prefill_chunk: int = 0, decode_block_tokens: int = 0,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, **config_kwargs):
    """Create a continuous-batching :class:`~deepspeed_tpu_torch.serving.
    engine.ServingEngine` over a paged KV cache (counterpart of
    ``deepspeed_tpu.init_serving``).  ``config`` is a dict or a
    :class:`~deepspeed_tpu_torch.inference.config.DeepSpeedInferenceConfig`;
    extra keyword arguments are config keys laid over it.  ``params`` is
    the nested parameter dict (default: the model's own weights);
    ``device=None`` is the CUDA card."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.serving.engine import ServingEngine

    if isinstance(config, DeepSpeedInferenceConfig):
        config = config.model_dump()
    config = DeepSpeedInferenceConfig(**{**(config or {}), **config_kwargs})
    return ServingEngine(model, config, params=params, device=device,
                         num_slots=num_slots, prefill_chunk=prefill_chunk,
                         decode_block_tokens=decode_block_tokens,
                         do_sample=do_sample, temperature=temperature,
                         top_k=top_k, top_p=top_p)
