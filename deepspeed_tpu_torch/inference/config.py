"""Inference config, PyTorch port.

A copy of ``deepspeed_tpu/inference/config.py``: the same field names and
defaults, so one config dict means the same thing to both engines.  Fields
whose feature is not ported yet are accepted here and refused by the engine
that would act on them (ROADMAP.md), never silently ignored: a
``checkpoint`` in the legacy msgpack layout, ``kv_host_tier_pages > 0`` and
``tensor_parallel.tp_size > 1``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class InferenceTPConfig(DeepSpeedConfigModel):
    tp_size: int = 1
    enabled: bool = True


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    dtype: str = "bfloat16"
    quantize_kv_cache: bool = False
    tensor_parallel: Optional[InferenceTPConfig] = None
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_batch_size: int = 0
    replace_with_kernel_inject: bool = False
    # None = auto (fused decode when supported); False opts out
    use_fused_decode: Optional[bool] = None
    decode_unroll: int = 4
    checkpoint: Optional[Any] = None
    enable_cuda_graph: bool = False
    seed: int = 0
    # continuous-batching serving knobs (serving/engine.py)
    num_slots: int = 8
    prefill_chunk: int = 64
    decode_block_tokens: int = 0
    max_prefill_chunks: int = 2
    # paged KV cache (serving/paged_kv.py)
    paged_kv_cache: bool = True
    kv_page_tokens: int = 0
    kv_pool_tokens: int = 0
    # copy-on-write prefix caching (serving/prefix_cache.py)
    prefix_caching: bool = True
    kv_host_tier_pages: int = 0
    # overload protection (serving/scheduler.py)
    max_queue_depth: int = 0
    shed_retry_after_s: float = 1.0
    request_deadline_s: float = 0.0
    # goodput ledger + SLO rules: accepted, not acted on in this slice
    goodput: Optional[Dict[str, Any]] = None
    slo: Optional[Dict[str, float]] = None

    def __init__(self, **kwargs):
        # legacy alias: mp_size -> tensor_parallel.tp_size
        mp = kwargs.pop("mp_size", None)
        tp = kwargs.pop("tensor_parallel", None)
        if isinstance(tp, dict):
            tp = InferenceTPConfig(**tp)
        if tp is None:
            tp = InferenceTPConfig(tp_size=mp or 1)
        super().__init__(tensor_parallel=tp, **kwargs)
