"""deepspeed_tpu_torch: the PyTorch / CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, which stays the reference.  It
imports torch and never jax, and nothing of ``deepspeed_tpu``.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``; with
no card and no device given they raise.

It serves the Llama, GPT-2 and Mixtral families through the
continuous-batching engine (:func:`init_serving`: a paged KV pool, or the
fixed-slot layout) and generates through :func:`init_inference`
(``InferenceEngine.generate()`` over a contiguous KV cache), in bf16, fp32
or with int8 weights, the KV cache in the activations' dtype or int8
(``quantize_kv_cache``); a Mixtral model's MLP is the top-k MoE of
:mod:`deepspeed_tpu_torch.moe`.
Decode runs the kernel-injected (fused) path by default: four CUDA C++
kernels per layer (fused norm+QKV, flash-decode attention over the paged
pool or the contiguous cache, out-projection+residual+norm, fused MLP; int8
weights dequantized inside the three GEMV kernels); ``use_fused_decode: False``
keeps the unfused path, which the int8 KV cache and MoE models always
take.  Prefill runs RMSNorm and RoPE (CUDA C++).  It trains on one card through :func:`initialize` (the Llama
and GPT-2 presets, and BLOOM, GPT-NeoX or GPT-J imported from a
HuggingFace checkpoint by :mod:`deepspeed_tpu_torch.module_inject`; the
standard path: bf16 compute, or fp16 compute with a static or dynamic
loss scale that skips a step whose gradients overflow, over fp32 masters,
gradient accumulation, clipping, FusedAdam, Adam8bit, FusedLamb, Lion,
Adagrad, SGD, Muon or a client optimizer; or master-free bf16 with
Adam8bit's stochastic rounding; dropout drawn from JAX's own threefry
stream; every remat policy, ``cpu_checkpointing`` keeping the saved matmul
outputs in pinned host memory; ``zero_optimization.offload_optimizer``
keeping the fp32 masters and moments in host memory or on NVMe, stepped by
the host C++ Adam, Adagrad or Lion; ``zero_optimization.offload_param``
keeping the params and the grads in host memory too, one layer at a time
streamed to the card), with RMSNorm and
RoPE forward and backward, flash attention forward and backward (with
ALiBi for BLOOM) and the
fused Adam, Adam8bit and LAMB updates and dropout as hand-written
kernels; the op
library adds softmax, bias_act and the block quantizer.  Training
checkpoints (``engine.save_checkpoint`` / ``load_checkpoint``, with the
dataloader's position) are the JAX package's sharded layout, so either
package resumes the other's tags; ``zero_to_fp32``
(:mod:`deepspeed_tpu_torch.utils.zero_to_fp32`), the universal layout
(:mod:`deepspeed_tpu_torch.checkpoint`) and ``init_inference(...,
checkpoint=dir)`` read them.  It trains data-parallel over
``torch.distributed`` (NCCL on the cards, gloo on the CPU) with ZeRO stages
0-3 (``zero_optimization.stage``: the optimizer state, then the gradients,
then the fp32 masters sharded over the mesh's ``fsdp`` axis, as the JAX
engine's partitions; ``mesh: {"dp": ..., "fsdp": ...}``): run a script
under ``torchrun --nproc_per_node=N``, or in any process with a process
group; :mod:`deepspeed_tpu_torch.comm` holds the collectives and the mesh,
``deepspeed_tpu_torch.zero`` ``Init`` and ``GatheredParameters``.
ROADMAP.md lists what comes next.
"""

from __future__ import annotations

from typing import Any

from deepspeed_tpu_torch import comm  # noqa: F401
from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike
from deepspeed_tpu_torch.models import causal_lm
from deepspeed_tpu_torch.runtime import zero  # noqa: F401

__all__ = ["initialize", "init_inference", "init_serving", "causal_lm", "comm",
           "zero"]


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, collate_fn=None, config=None,
               config_params=None, *, device: DeviceLike = None,
               seed: Any = None, loss_fn=None):
    """Create a training engine (counterpart of ``deepspeed_tpu.initialize``).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``;
    the dataloader (a :class:`~deepspeed_tpu_torch.runtime.dataloader.
    DeepSpeedDataLoader` over ``training_data`` with ``collate_fn``, CPU
    tensors at the micro batch) is None without ``training_data``.  ``model`` is a
    :class:`~deepspeed_tpu_torch.models.transformer.CausalLM` whose
    parameters become the masters (fp32, or bf16 under
    ``bf16.master_weights: false``; under ``offload_optimizer`` the fp32
    masters go to the host and the card keeps the compute dtype);
    ``model_parameters`` (a nested
    dict of tensors or numpy arrays in the JAX layout) replaces their
    values.  ``device=None`` is the CUDA card.  ``seed`` seeds torch's
    generators (default: the config's ``seed``); dropout draws from the
    threefry key of the config's ``seed``, as the JAX engine's.  A client
    ``optimizer`` (a ``torch.optim.Optimizer`` over the model's parameters,
    or a callable that builds one from the engine's masters) takes
    precedence over the config's optimizer section, as in the JAX
    engine.  Under ``zero_optimization.offload_param`` the params stay in
    host memory and train a layer at a time on the card (ZeRO-Infinity).
    A client ``loss_fn(params, batch, rng)`` (the JAX engine's contract:
    the params in the compute dtype) replaces the model's ``apply``; under
    ``offload_param`` it is refused.

    Under ``torchrun`` (``WORLD_SIZE`` set) it joins the process group
    (:func:`deepspeed_tpu_torch.comm.init_distributed`: NCCL on
    ``cuda:LOCAL_RANK``, gloo for ``device="cpu"``), or takes the group that
    exists; the batch triad is then resolved over the data-parallel world,
    each rank trains on its rows of the global batch and holds its ZeRO
    partition (``zero_optimization.stage``)."""
    import os

    import torch

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    cfg = config if config is not None else config_params
    if cfg is None and args is not None and hasattr(args, "deepspeed_config"):
        cfg = args.deepspeed_config
    if not comm.is_initialized() and "WORLD_SIZE" in os.environ:
        comm.init_distributed(device=device)
    world = comm.get_world_size()
    if isinstance(cfg, DeepSpeedConfig) and cfg.world_size != world:
        cfg = cfg._param_dict
    cfg = (cfg if isinstance(cfg, DeepSpeedConfig)
           else DeepSpeedConfig(cfg, world_size=world))
    torch.manual_seed(int(cfg.seed if seed is None else seed))
    engine = DeepSpeedEngine(model, cfg, model_parameters=model_parameters,
                             device=device, training_data=training_data,
                             collate_fn=collate_fn, optimizer=optimizer,
                             loss_fn=loss_fn)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def _merge_inference_config(config, kwargs):
    """Overlay config-key kwargs on ``config`` (a dict, a config instance or
    None) without dropping the instance's settings."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig

    if isinstance(config, DeepSpeedInferenceConfig):
        config = config.model_dump()
    return DeepSpeedInferenceConfig(**{**(config or {}), **kwargs})


def init_inference(model=None, config=None, *, params: Any = None,
                   device: DeviceLike = None, **config_kwargs):
    """Create an :class:`~deepspeed_tpu_torch.inference.engine.
    InferenceEngine` (counterpart of ``deepspeed_tpu.init_inference``):
    ``engine.generate(input_ids, max_new_tokens=...)`` and ``engine(tokens)``
    for plain logits.  ``config`` is a dict or a
    :class:`~deepspeed_tpu_torch.inference.config.DeepSpeedInferenceConfig`;
    extra keyword arguments are config keys laid over it.  ``params`` is the
    nested parameter dict (default: the model's own weights); ``device=None``
    is the CUDA card."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model, _merge_inference_config(config,
                                                          config_kwargs),
                           params=params, device=device)


def init_serving(model=None, config=None, *, params: Any = None,
                 device: DeviceLike = None, num_slots: int = 0,
                 prefill_chunk: int = 0, decode_block_tokens: int = 0,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, **config_kwargs):
    """Create a continuous-batching :class:`~deepspeed_tpu_torch.serving.
    engine.ServingEngine` over a paged (or, with ``paged_kv_cache: false``,
    a fixed-slot) KV cache (counterpart of
    ``deepspeed_tpu.init_serving``).  ``config`` is a dict or a
    :class:`~deepspeed_tpu_torch.inference.config.DeepSpeedInferenceConfig`;
    extra keyword arguments are config keys laid over it.  ``params`` is
    the nested parameter dict (default: the model's own weights);
    ``device=None`` is the CUDA card."""
    from deepspeed_tpu_torch.serving.engine import ServingEngine

    config = _merge_inference_config(config, config_kwargs)
    return ServingEngine(model, config, params=params, device=device,
                         num_slots=num_slots, prefill_chunk=prefill_chunk,
                         decode_block_tokens=decode_block_tokens,
                         do_sample=do_sample, temperature=temperature,
                         top_k=top_k, top_p=top_p)
