"""ds_config parsing for the training engine, PyTorch port.

A trimmed copy of ``deepspeed_tpu/runtime/config.py`` ``DeepSpeedConfig``
over the port's :mod:`.config_utils`.  It covers what the standard
training path reads: the batch triad and its checks, ``bf16`` (with
``master_weights: false``, master-free bf16 training), ``optimizer``, ``scheduler``, ``gradient_clipping``,
``data_types.grad_accum_dtype``, ``activation_checkpointing``, ``seed``
and ``steps_per_print``.  The sections the port does not carry yet raise
``NotImplementedError`` naming ROADMAP.md when they ask for something:
ZeRO stages 1-3 and offload, fp16 loss scaling, quantized communication,
pipeline, tensor, sequence and expert parallelism.  Observability sections
(profilers, monitors, flight recorder, goodput, watchdog, anomaly
detection) are accepted only while disabled.  ``world_size`` is 1: the
port trains on one card until ZeRO over ``torch.distributed`` lands.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Any, Dict, Optional, Union

import torch
from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import AUTO, DeepSpeedConfigModel


class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    master_weights: bool = True


class OptimizerConfig(DeepSpeedConfigModel):
    type: str = "Adam"
    params: Dict[str, Any] = Field(default_factory=dict)


class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)


class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None  # None -> fp32


class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    # enabled=None leaves the model's own remat default; True/False forces
    # per-layer checkpointing on or off (the JAX package's extension)
    enabled: Optional[bool] = None
    policy: str = "full"
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


_DTYPES = {"fp32": torch.float32, "float32": torch.float32, "float": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp16": torch.float16, "float16": torch.float16}

# sections that observe or steer a run: accepted only while disabled
_OBSERVABILITY = ("flops_profiler", "profile_trace", "tensorboard", "wandb",
                  "csv_monitor", "comms_logger", "flight_recorder", "goodput",
                  "watchdog", "continuous_profiler", "anomaly_detection",
                  "elasticity", "data_efficiency", "compression_training",
                  "autotuning", "amp")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1: "
                               f"{item})")


def _load_config_dict(config: Union[str, Dict, None]) -> Dict:
    if config is None:
        return {}
    if isinstance(config, dict):
        return dict(config)
    if isinstance(config, (str, os.PathLike)):
        path = str(config)
        if os.path.exists(path):
            with open(path, "r") as fh:
                return json.load(fh)
        try:
            return json.loads(base64.urlsafe_b64decode(path).decode("utf-8"))
        except Exception:
            pass
        try:
            return json.loads(path)
        except Exception as exc:
            raise ValueError(f"Expected a path to a ds_config JSON file, a JSON "
                             f"string, or a dict; got {path!r}") from exc
    raise TypeError(f"Unsupported config type: {type(config)}")


def _scalar(d: Dict, key: str, default: Any) -> Any:
    v = d.get(key, default)
    return default if v == AUTO else v


def resolve_batch_triad(train_batch_size: Optional[int],
                        micro_batch_per_gpu: Optional[int],
                        grad_accum_steps: Optional[int], world_size: int):
    """Fill in any missing member of ``train_batch_size =
    train_micro_batch_size_per_gpu * gradient_accumulation_steps *
    world_size`` (the JAX package's rules, check for check)."""
    tbs, mbs, gas = train_batch_size, micro_batch_per_gpu, grad_accum_steps
    if tbs is not None and mbs is not None and gas is not None:
        if tbs != mbs * gas * world_size:
            raise ValueError(
                f"Inconsistent batch config: train_batch_size={tbs} != "
                f"micro_batch({mbs}) * grad_accum({gas}) * world_size({world_size})")
        return tbs, mbs, gas
    if tbs is None and mbs is not None and gas is not None:
        return mbs * gas * world_size, mbs, gas
    if mbs is None and tbs is not None and gas is not None:
        if tbs % (gas * world_size) != 0:
            raise ValueError(f"train_batch_size {tbs} not divisible by "
                             f"grad_accum*world {gas * world_size}")
        return tbs, tbs // (gas * world_size), gas
    if gas is None and tbs is not None and mbs is not None:
        if tbs % (mbs * world_size) != 0:
            raise ValueError(f"train_batch_size {tbs} not divisible by "
                             f"micro_batch*world {mbs * world_size}")
        return tbs, mbs, tbs // (mbs * world_size)
    if tbs is not None:
        if tbs % world_size != 0:
            raise ValueError(f"train_batch_size {tbs} not divisible by "
                             f"world_size {world_size}")
        return tbs, tbs // world_size, 1
    if mbs is not None:
        return mbs * world_size, mbs, 1
    if gas is not None:
        return gas * world_size, 1, gas
    return world_size, 1, 1


class DeepSpeedConfig:
    """Parsed, validated view of a ds_config (the training path's sections)."""

    def __init__(self, config: Union[str, Dict, None], world_size: int = 1):
        self._param_dict = d = _load_config_dict(config)
        self._refuse_unported(d)
        self.world_size = int(world_size)

        tbs, mbs, gas = (None if d.get(k) == AUTO else d.get(k)
                         for k in ("train_batch_size",
                                   "train_micro_batch_size_per_gpu",
                                   "gradient_accumulation_steps"))
        (self.train_batch_size, self.train_micro_batch_size_per_gpu,
         self.gradient_accumulation_steps) = resolve_batch_triad(tbs, mbs, gas,
                                                                 self.world_size)

        self.steps_per_print = _scalar(d, "steps_per_print", 10)
        self.gradient_clipping = _scalar(d, "gradient_clipping", 0.0)
        self.seed = _scalar(d, "seed", 42)

        self.bf16 = BF16Config(**d.get("bf16", d.get("bfloat16", {})))
        self.data_types = DataTypesConfig(**d.get("data_types", {}))
        self.optimizer = OptimizerConfig(**d["optimizer"]) if "optimizer" in d else None
        self.scheduler = SchedulerConfig(**d["scheduler"]) if "scheduler" in d else None
        self.activation_checkpointing = ActivationCheckpointingConfig(
            **d.get("activation_checkpointing", {}))
        self._validate()

    @staticmethod
    def _refuse_unported(d: Dict) -> None:
        zero = d.get("zero_optimization") or {}
        if int(zero.get("stage", 0) or 0) >= 1:
            raise _not_ported(f"zero_optimization.stage {zero['stage']}",
                              "ZeRO 1-3 over torch.distributed")
        for key in ("offload_optimizer", "offload_param"):
            dev = (zero.get(key) or {}).get("device", "none")
            if dev not in (None, "none"):
                raise _not_ported(f"zero_optimization.{key}", "ZeRO 1-3 over "
                                  "torch.distributed, then offload")
        if (d.get("fp16") or {}).get("enabled"):
            raise _not_ported("fp16.enabled (loss scaling)", "fp16 loss scaling")
        cq = d.get("comm_quantization") or {}
        if any(v is True for v in cq.values()):
            raise _not_ported("comm_quantization", "ZeRO 1-3 over torch.distributed")
        if d.get("pipeline"):
            raise _not_ported("pipeline parallelism", "ZeRO 1-3 over "
                              "torch.distributed, then the parallel meshes")
        mesh = d.get("mesh") or ((d.get("tpu") or {}).get("mesh") or {})
        big = {k: v for k, v in mesh.items() if isinstance(v, int) and v > 1}
        if big:
            raise _not_ported(f"mesh axes {big}", "ZeRO 1-3 over torch.distributed, "
                              "then the parallel meshes")
        tp = d.get("tensor_parallel") or {}
        if int(tp.get("tp_size", tp.get("autotp_size", 1)) or 1) > 1:
            raise _not_ported("tensor_parallel", "ZeRO 1-3 over torch.distributed, "
                              "then the parallel meshes")
        for key in _OBSERVABILITY:
            sec = d.get(key)
            if isinstance(sec, dict) and sec.get("enabled"):
                raise _not_ported(f"{key}.enabled", "the observability hooks")
        ac = d.get("activation_checkpointing") or {}
        if ac.get("cpu_checkpointing"):
            raise _not_ported("activation_checkpointing.cpu_checkpointing "
                              "(remat_policy 'offload_dots')", "ZeRO 1-3 over "
                              "torch.distributed, then offload")

    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16.enabled else torch.float32

    def master_dtype(self) -> torch.dtype:
        """fp32 masters, or bf16 ones under ``bf16.master_weights: false``."""
        master_free = self.bf16.enabled and not self.bf16.master_weights
        return torch.bfloat16 if master_free else torch.float32

    def grad_accum_dtype(self) -> torch.dtype:
        name = self.data_types.grad_accum_dtype
        return torch.float32 if name is None else _DTYPES[name.lower()]

    def _validate(self) -> None:
        ga = self.data_types.grad_accum_dtype
        if ga is not None and ga.lower() not in _DTYPES:
            raise ValueError(f"data_types.grad_accum_dtype: unknown dtype {ga!r}")
