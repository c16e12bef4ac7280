"""Inference engine, PyTorch port: the part the serving engine stands on.

Counterpart of ``deepspeed_tpu/inference/engine.py``.  This slice carries
:func:`pow2_bucket` and the weight handling of :class:`InferenceEngine`:
resolve the device, pick the serving dtype, cast the parameter tree to it,
and build the kernel-injected view of the weights that the fused decode
path reads (``_dparams``), on by default as in the JAX engine.
``generate()``, tensor-parallel meshes and int8 weights are not ported yet
(ROADMAP.md queue 1), and a config asking for them is refused here instead
of being served another way than the JAX engine would.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16}


def pow2_bucket(n: int, lo: int = 1, cap: Optional[int] = None) -> int:
    """Next power-of-two >= n, floored at ``lo`` and capped at ``cap``."""
    b = lo
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class InferenceEngine:
    """Holds the serving copy of the weights on ``device`` in the serving
    dtype.  ``params`` is the nested parameter dict (JAX tree layout); when
    omitted, the model module's own parameters are used."""

    def __init__(self, model, config: DeepSpeedInferenceConfig,
                 params: Any = None, *, device: DeviceLike = None):
        self.module = model
        self._config = config
        self.device = resolve_device(device)
        tp = config.tensor_parallel.tp_size if config.tensor_parallel else 1
        if tp > 1:
            raise NotImplementedError(
                "tensor-parallel inference is not ported yet (ROADMAP.md "
                "queue 1)")
        if config.dtype in ("int8", "qint8"):
            raise NotImplementedError(
                "int8 weights are not ported yet (ROADMAP.md queue 1: serving "
                "features deferred from the first slice)")
        if config.quantize_kv_cache:
            raise NotImplementedError(
                "the int8 KV cache is not ported yet (ROADMAP.md queue 1: "
                "serving features deferred from the first slice)")
        if getattr(model, "config", None) is None:
            raise TypeError("model must carry a ModelConfig as .config "
                            "(use deepspeed_tpu_torch.models.causal_lm)")
        self.dtype = _DTYPES.get(config.dtype, torch.float32)
        self._params = None
        self._dparams = None
        if params is None and hasattr(model, "params"):
            params = model.params()
        if params is not None:
            self.set_params(params)
        elif config.checkpoint:
            raise NotImplementedError("checkpoint loading is not ported yet")

    def set_params(self, params: Any) -> None:
        """Move the parameter tree to the engine's device and cast floating
        leaves to the serving dtype (a leaf already there is used as is),
        then rebuild the kernel-injected view."""
        def cast(t):
            t = torch.as_tensor(t)
            if t.is_floating_point():
                return t.to(device=self.device, dtype=self.dtype)
            return t.to(device=self.device)

        with torch.no_grad():
            self._params = _tree_map(cast, params)
            self._build_injected_view()
        n = sum(t.numel() for t in _leaves(self._params))
        logger.info("inference engine ready: %.2fM params, dtype %s, on %s%s",
                    n / 1e6, self.dtype, self.device,
                    ", kernel-injected decode" if self._dparams is not None
                    else "")

    def _build_injected_view(self) -> None:
        """Kernel injection (reference ``replace_with_kernel_inject``): lay
        the weights out for the fused decode kernels.  The JAX policy: on
        when supported; ``use_fused_decode=False`` opts out, even over
        ``replace_with_kernel_inject``."""
        from deepspeed_tpu_torch.models.fused_decode import (
            inject_decode_params, supports_fused_decode)

        self._dparams = None
        if self._config.use_fused_decode is False:
            return
        cfg = self.module.config
        tp = (self._config.tensor_parallel.tp_size
              if self._config.tensor_parallel else 1)
        if not supports_fused_decode(
                cfg, quantized_kv=self._config.quantize_kv_cache, tp=tp):
            if (self._config.replace_with_kernel_inject
                    or self._config.use_fused_decode):
                logger.info("kernel injection requested but unsupported for "
                            "this model/config (MoE, int8 KV cache, or "
                            "tp>1): using the unfused decode path")
            return
        self._dparams = inject_decode_params(self._params, cfg)

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
