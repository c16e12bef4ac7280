"""Optimizer construction from the ds_config ``optimizer`` section.

Counterpart of ``deepspeed_tpu/runtime/optimizer.py``.  Ported in this
slice: the Adam family.  ``FusedAdam`` runs the fused Adam kernel;
``"torch_adam": true``, ``Adam``, ``AdamW`` and ``DeepSpeedCPUAdam`` run
the plain fp32 version of the same update (the JAX package sends them to
``optax.adamw``, which has no Pallas kernel).  ``adam_w_mode`` (alias
``adamw_mode``, default True) picks decoupled weight decay.  Every other
type raises ``NotImplementedError`` naming ROADMAP.md.  With no optimizer
section the engine trains with AdamW at lr 1e-3, as the JAX package does.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, Optional, Union

import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam

logger = logging.getLogger(__name__)

Schedule = Union[float, Callable[[Any], Any]]

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "deepspeedcpuadam"


def build_optimizer(type_name: str, params: Dict[str, Any],
                    model_parameters: Iterable[torch.Tensor],
                    lr: Optional[Schedule] = None) -> FusedAdam:
    """Build the optimizer for a ds_config optimizer type over
    ``model_parameters`` (the fp32 masters)."""
    name = type_name.lower().replace("_", "").replace("-", "")
    p = dict(params)
    learning_rate: Schedule = lr if lr is not None else p.get("lr", 1e-3)
    betas = p.get("betas", (0.9, 0.999))
    common = dict(lr=learning_rate, betas=betas, eps=p.get("eps", 1e-8),
                  weight_decay=p.get("weight_decay", 0.0))
    adam_w_mode = p.get("adam_w_mode", p.get("adamw_mode", True))
    if name == FUSED_ADAM:
        return FusedAdam(model_parameters, adam_w_mode=adam_w_mode,
                         fused=not p.get("torch_adam", False), **common)
    if name in (ADAM_OPTIMIZER, CPU_ADAM):
        return FusedAdam(model_parameters, adam_w_mode=adam_w_mode, fused=False,
                         **common)
    if name == ADAMW_OPTIMIZER:
        return FusedAdam(model_parameters, adam_w_mode=True, fused=False, **common)
    raise NotImplementedError(
        f"optimizer type {type_name!r} is not ported yet (ROADMAP.md queue 1: "
        f"other optimizers and schedules); the port has FusedAdam, Adam and "
        f"AdamW")


def build_from_config(ds_config, model_parameters: Iterable[torch.Tensor],
                      lr_schedule: Optional[Schedule] = None) -> FusedAdam:
    """The optimizer the engine uses: the config's section, else AdamW at
    lr 1e-3 (with a log, as the JAX package)."""
    if ds_config.optimizer is None:
        logger.info("no optimizer section in config; defaulting to AdamW(lr=1e-3)")
        return build_optimizer("AdamW", {"lr": 1e-3}, model_parameters, lr=lr_schedule)
    return build_optimizer(ds_config.optimizer.type, ds_config.optimizer.params,
                           model_parameters, lr=lr_schedule)
