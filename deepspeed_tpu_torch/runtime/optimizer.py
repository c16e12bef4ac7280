"""Optimizer construction from the ds_config ``optimizer`` section.

Counterpart of ``deepspeed_tpu/runtime/optimizer.py``.  Ported:

- the Adam family: ``FusedAdam`` runs the fused Adam kernel;
  ``"torch_adam": true``, ``Adam``, ``AdamW`` and ``DeepSpeedCPUAdam`` run
  the plain fp32 version of the same update (the JAX package sends them to
  ``optax.adamw``, which has no Pallas kernel).  ``adam_w_mode`` (alias
  ``adamw_mode``, default True) picks decoupled weight decay;
- ``Adam8bit`` / ``AdamW8bit``: int8 blockwise moments (params
  ``block_size``, default 512, and ``min_quant_size``, default 4096) over
  the fused Adam8bit kernel, with stochastic rounding of bf16 params;
- ``FusedLamb`` (eps default 1e-6) over the fused LAMB kernels;
  ``"torch_lamb": true`` and ``Lamb`` run the plain fp32 ``optax.lamb``
  formula (eps default 1e-8, as the JAX package's ``_adam_args``).

- ``Lion`` (betas default (0.9, 0.99)), ``Adagrad`` / ``DeepSpeedCPUAdagrad``
  (eps default 1e-10, no weight decay), ``SGD`` (momentum default 0.0,
  nesterov, no weight decay) and ``Muon`` (momentum 0.95, nesterov,
  ``ns_steps`` 5): the plain foreach versions of what the JAX package
  builds (``optax.lion``, ``optax.adagrad``, ``optax.sgd`` and its own
  ``muon``).  Muon reads each parameter's ``keystr`` path (``names``) for
  its exclusion of embeddings and heads.

The 1-bit family raises ``NotImplementedError`` naming ROADMAP.md.  With no
optimizer section the engine trains with AdamW at lr 1e-3, as the JAX
package does.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Union

import torch

from deepspeed_tpu_torch.ops.adagrad import Adagrad
from deepspeed_tpu_torch.ops.adam.adam8bit import Adam8bit
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.adam.muon import Muon
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.lion import Lion
from deepspeed_tpu_torch.ops.sgd import SGD

logger = logging.getLogger(__name__)

Schedule = Union[float, Callable[[Any], Any]]

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "deepspeedcpuadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB = "fusedlamb"
ADAM_8BIT = "adam8bit"
ADAMW_8BIT = "adamw8bit"
LION_OPTIMIZER = "lion"
ADAGRAD_OPTIMIZER = "adagrad"
CPU_ADAGRAD = "deepspeedcpuadagrad"
SGD_OPTIMIZER = "sgd"
MUON = "muon"


def build_optimizer(type_name: str, params: Dict[str, Any],
                    model_parameters: Iterable[torch.Tensor],
                    lr: Optional[Schedule] = None,
                    names: Optional[Sequence[str]] = None) -> torch.optim.Optimizer:
    """Build the optimizer for a ds_config optimizer type over
    ``model_parameters`` (the engine's masters); ``names`` are their
    ``keystr`` paths in the params tree (read by Muon)."""
    name = type_name.lower().replace("_", "").replace("-", "")
    p = dict(params)
    learning_rate: Schedule = lr if lr is not None else p.get("lr", 1e-3)
    betas = p.get("betas", (0.9, 0.999))
    common = dict(lr=learning_rate, betas=betas, eps=p.get("eps", 1e-8),
                  weight_decay=p.get("weight_decay", 0.0))
    adam_w_mode = p.get("adam_w_mode", p.get("adamw_mode", True))
    if name in (ADAM_8BIT, ADAMW_8BIT):
        return Adam8bit(model_parameters, block_size=p.get("block_size", 512),
                        min_quant_size=p.get("min_quant_size", 4096), **common)
    if name == FUSED_LAMB and not p.get("torch_lamb", False):
        return FusedLamb(model_parameters, fused=True,
                         **dict(common, eps=p.get("eps", 1e-6)))
    if name in (FUSED_LAMB, LAMB_OPTIMIZER):
        return FusedLamb(model_parameters, fused=False, **common)
    if name == FUSED_ADAM:
        return FusedAdam(model_parameters, adam_w_mode=adam_w_mode,
                         fused=not p.get("torch_adam", False), **common)
    if name in (ADAM_OPTIMIZER, CPU_ADAM):
        return FusedAdam(model_parameters, adam_w_mode=adam_w_mode, fused=False,
                         **common)
    if name == ADAMW_OPTIMIZER:
        return FusedAdam(model_parameters, adam_w_mode=True, fused=False, **common)
    if name == LION_OPTIMIZER:
        return Lion(model_parameters, lr=learning_rate,
                    betas=p.get("betas", (0.9, 0.99)),
                    weight_decay=common["weight_decay"])
    if name in (ADAGRAD_OPTIMIZER, CPU_ADAGRAD):
        return Adagrad(model_parameters, lr=learning_rate, eps=p.get("eps", 1e-10))
    if name == SGD_OPTIMIZER:
        return SGD(model_parameters, lr=learning_rate,
                   momentum=p.get("momentum", 0.0),
                   nesterov=p.get("nesterov", False))
    if name == MUON:
        return Muon(model_parameters, lr=learning_rate,
                    weight_decay=common["weight_decay"],
                    momentum=p.get("momentum", 0.95),
                    nesterov=p.get("nesterov", True),
                    ns_steps=p.get("ns_steps", 5), names=names)
    raise NotImplementedError(
        f"optimizer type {type_name!r} is not ported yet (ROADMAP.md queue 1 "
        f"item 2e: the 1-bit family); the port has FusedAdam, Adam, "
        f"AdamW, Adam8bit, AdamW8bit, FusedLamb, Lamb, Lion, Adagrad, SGD "
        f"and Muon")


def build_from_config(ds_config, model_parameters: Iterable[torch.Tensor],
                      lr_schedule: Optional[Schedule] = None,
                      names: Optional[Sequence[str]] = None
                      ) -> torch.optim.Optimizer:
    """The optimizer the engine uses: the config's section, else AdamW at
    lr 1e-3 (with a log, as the JAX package)."""
    if ds_config.optimizer is None:
        logger.info("no optimizer section in config; defaulting to AdamW(lr=1e-3)")
        return build_optimizer("AdamW", {"lr": 1e-3}, model_parameters, lr=lr_schedule)
    return build_optimizer(ds_config.optimizer.type, ds_config.optimizer.params,
                           model_parameters, lr=lr_schedule, names=names)
