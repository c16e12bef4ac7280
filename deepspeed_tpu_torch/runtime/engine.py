"""Training engine, PyTorch port: the standard (non-ZeRO, one-card) path.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` ``DeepSpeedEngine``.  It
ports the semantics of the compiled step functions there
(``_compile_steps_inner``):

- ``accum``: the loss of one micro-batch on the compute copy of the
  weights (bf16 when ``bf16.enabled``), divided by
  ``gradient_accumulation_steps``; its gradients are cast to the
  accumulator dtype (``data_types.grad_accum_dtype``, default fp32) and
  added to the accumulator;
- ``apply``: clip to ``gradient_clipping`` (or just take the global norm),
  one optimizer update of the masters, zero the accumulator,
  ``global_steps += 1``;
- ``fused`` (:meth:`train_step`): gas micro-batches, then apply; returns
  the mean loss.

The masters are the model's own parameters (moved to the engine's device):
fp32, or bf16 under ``bf16.master_weights: false`` (master-free: the
persistent state is bf16, and an optimizer that rounds stochastically,
Adam8bit, keeps the sub-ulp updates; any other logs the JAX package's
warning).  The compute copy is a set of leaf tensors that carry
gradients: per-layer slices of one buffer per stacked ``[L, ...]`` leaf, so
autograd writes each layer's gradient into a tensor of that layer's size.
When the master dtype is the compute dtype (fp32 training, or master-free
bf16) it aliases the masters; otherwise it is a copy refreshed from them
after every update.

Not ported yet (ROADMAP.md queue 1): checkpoints, fp16 loss scaling, ZeRO,
offload, telemetry, goodput, watchdog, anomaly handling, overlap and the
1-bit optimizers.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.runtime import optimizer as opt_builder
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import LRSchedulerShim, get_lr_schedule
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, global_norm

logger = logging.getLogger(__name__)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        out.extend(_flatten(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def _set(tree: Dict[str, Any], path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


class DeepSpeedEngine:
    """One-card training engine over a :class:`~deepspeed_tpu_torch.models.
    transformer.CausalLM` (or any module with ``params()`` and a functional
    ``apply(params, *batch)`` returning the loss)."""

    def __init__(self, model, config=None, model_parameters=None,
                 device: DeviceLike = None):
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config))
        self.device = resolve_device(device)
        self.module = model
        self._apply_activation_checkpointing_config(model)
        if hasattr(model, "check_trainable"):
            model.check_trainable()
        self.compute_dtype = self.config.dtype()
        self.grad_accum_dtype = self.config.grad_accum_dtype()
        self.master_dtype = self.config.master_dtype()

        # masters: the model's own parameters, on the engine's device
        self._paths: List[str] = []
        self.master: List[torch.Tensor] = []
        given = dict(_flatten(model_parameters)) if model_parameters is not None else {}
        for path, p in _flatten(model.params()):
            if given:
                if path not in given:
                    raise ValueError(f"model_parameters has no leaf {path}")
                src = given.pop(path)
                src = src if torch.is_tensor(src) else torch.from_numpy(np.array(src))
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"model_parameters {path}: shape "
                                     f"{tuple(src.shape)} != {tuple(p.shape)}")
                p.data = src.to(self.device, self.master_dtype).clone()
            elif p.device != self.device or p.dtype != self.master_dtype:
                p.data = p.data.to(self.device, self.master_dtype)
            self._paths.append(path)
            self.master.append(p.data)
        if given:
            raise ValueError(f"model_parameters has extra leaves {sorted(given)}")
        self.grad_acc = [torch.zeros_like(p, dtype=self.grad_accum_dtype)
                         for p in self.master]
        self._stacked = [p.dim() > 0 and path.startswith("layers.")
                         for path, p in zip(self._paths, self.master)]
        self._compute: Optional[List[Any]] = None
        self._compute_bufs: Optional[List[torch.Tensor]] = None

        self._lr_schedule = None
        if self.config.scheduler is not None:
            self._lr_schedule = get_lr_schedule(self.config.scheduler.type,
                                                self.config.scheduler.params)
        self.optimizer = opt_builder.build_from_config(self.config, self.master,
                                                       self._lr_schedule)
        if (self.master_dtype != torch.float32
                and not getattr(self.optimizer, "updates_are_new_params", False)):
            logger.warning(
                "bf16.master_weights=false with optimizer %s: plain "
                "round-to-nearest bf16 updates lose sub-ulp steps; use "
                "Adam8bit (stochastic rounding) for master-free training",
                self.config.optimizer.type if self.config.optimizer else "AdamW")
        self.lr_scheduler = (LRSchedulerShim(self._lr_schedule)
                             if self._lr_schedule is not None else None)
        self.global_steps = 0
        self._micro_count = 0
        self._training = True
        self._last_loss: Optional[torch.Tensor] = None
        self._last_grad_norm: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def _apply_activation_checkpointing_config(self, model) -> None:
        """The ds_config ``activation_checkpointing`` section sets the
        model's remat switch and policy (the JAX engine's rule: the policy
        is taken over only when the section is in play)."""
        ac = self.config.activation_checkpointing
        mcfg = getattr(model, "config", None)
        if mcfg is None or not hasattr(mcfg, "remat"):
            return
        active = ac.enabled is not None or ac.partition_activations
        if ac.enabled is not None:
            mcfg.remat = ac.enabled
        elif active:
            mcfg.remat = True
        if active:
            mcfg.remat_policy = ac.policy

    def _compute_params(self) -> Dict[str, Any]:
        """The grad-carrying compute copy as the model's nested dict; a
        stacked layer leaf is a list of per-layer leaf tensors."""
        if self._compute is None:
            alias = self.compute_dtype == self.master_dtype
            self._compute_bufs = [p if alias else p.to(self.compute_dtype)
                                  for p in self.master]
            self._compute = [
                ([b[i].detach().requires_grad_() for i in range(b.shape[0])]
                 if stacked else b.detach().requires_grad_())
                for b, stacked in zip(self._compute_bufs, self._stacked)]
        tree: Dict[str, Any] = {}
        for path, leaf in zip(self._paths, self._compute):
            _set(tree, path, leaf)
        return tree

    @torch.no_grad()
    def _refresh_compute(self) -> None:
        if (self._compute_bufs is not None
                and self.compute_dtype != self.master_dtype):
            for buf, p in zip(self._compute_bufs, self.master):
                buf.copy_(p)

    def _loss(self, params, batch) -> torch.Tensor:
        if isinstance(batch, (tuple, list)):
            return self.module.apply(params, *batch)
        if isinstance(batch, dict):
            return self.module.apply(params, **batch)
        return self.module.apply(params, batch)

    def _to_device(self, batch):
        def conv(x):
            t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            if not t.is_floating_point():
                t = t.long()          # token ids and labels index and gather
            return t.to(self.device)
        if isinstance(batch, (tuple, list)):
            return type(batch)(conv(x) for x in batch)
        if isinstance(batch, dict):
            return {k: conv(v) for k, v in batch.items()}
        return conv(batch)

    # ------------------------------------------------------------------
    # the step functions
    # ------------------------------------------------------------------
    def _accum(self, batch) -> torch.Tensor:
        gas = self.config.gradient_accumulation_steps
        params = self._compute_params()
        loss = self._loss(params, batch)
        (loss.float() / gas).backward()
        with torch.no_grad():
            for acc, leaf in zip(self.grad_acc, self._compute):
                if isinstance(leaf, list):
                    for i, t in enumerate(leaf):
                        if t.grad is not None:
                            acc[i].add_(t.grad)
                            t.grad = None
                elif leaf.grad is not None:
                    acc.add_(leaf.grad)
                    leaf.grad = None
        return loss.detach()

    def _apply(self) -> torch.Tensor:
        clip = self.config.gradient_clipping
        if clip > 0:
            gnorm = clip_grad_norm_(self.grad_acc, clip)
        else:
            gnorm = global_norm(self.grad_acc)
        self.optimizer.step(grads=self.grad_acc)
        for acc in self.grad_acc:
            acc.zero_()
        self._refresh_compute()
        self.global_steps += 1
        return gnorm

    # ------------------------------------------------------------------
    # reference-parity imperative API
    # ------------------------------------------------------------------
    def train(self, mode: bool = True):
        self._training = mode
        return self

    def eval(self):
        return self.train(False)

    def __call__(self, batch):
        return self.forward(batch)

    def forward(self, batch) -> torch.Tensor:
        """One micro-batch: in training mode the loss with its gradients
        accumulated (forward and backward together, as the JAX engine);
        in eval mode the loss alone."""
        batch = self._to_device(batch)
        if not self._training:
            return self.evaluate(batch)
        loss = self._accum(batch)
        self._micro_count += 1
        self._last_loss = loss
        return loss

    @torch.no_grad()
    def evaluate(self, batch) -> torch.Tensor:
        return self._loss(self._compute_params(), self._to_device(batch)).detach()

    def backward(self, loss, retain_graph: bool = False):
        """Reference-parity no-op: :meth:`forward` already accumulated the
        gradients."""
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        gas = self.config.gradient_accumulation_steps
        return self._micro_count % gas == 0 and self._micro_count > 0

    def step(self) -> None:
        if not self.is_gradient_accumulation_boundary():
            return
        self._last_grad_norm = self._apply()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self._micro_count = 0

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step from a stacked batch: each leaf is
        ``[gas, micro, ...]`` or ``[gas * micro, ...]`` (split here).
        Returns the mean micro-batch loss (a device tensor)."""
        gas = self.config.gradient_accumulation_steps
        tbs = self.config.train_batch_size

        def stack(x):
            x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            if not x.dim():
                return x
            # stacked [gas, micro, ...] vs flat [batch, ...], also when
            # gas == batch (micro 1): the stacked form's second dim is micro
            already = (x.shape[0] == gas
                       and (x.shape[0] != tbs
                            or (x.dim() > 1 and x.shape[1] == tbs // gas)))
            if already:
                return x
            if x.shape[0] % gas:
                raise ValueError(f"batch leading dim {x.shape[0]} not divisible "
                                 f"by gradient_accumulation_steps={gas}")
            return x.reshape((gas, x.shape[0] // gas) + tuple(x.shape[1:]))

        if isinstance(batch, (tuple, list)):
            stacked = type(batch)(stack(x) for x in batch)
            micro = [type(batch)(x[i] for x in stacked) for i in range(gas)]
        elif isinstance(batch, dict):
            stacked = {k: stack(v) for k, v in batch.items()}
            micro = [{k: v[i] for k, v in stacked.items()} for i in range(gas)]
        else:
            stacked = stack(batch)
            micro = [stacked[i] for i in range(gas)]
        losses = [self._accum(self._to_device(b)) for b in micro]
        self._last_grad_norm = self._apply()
        loss = torch.stack([x.float() for x in losses]).mean()
        self._last_loss = loss
        self._micro_count = 0
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        return loss

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def get_global_grad_norm(self) -> Optional[float]:
        return (float(self._last_grad_norm) if self._last_grad_norm is not None
                else None)

    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        if self.config.optimizer is not None:
            return [self.config.optimizer.params.get("lr", 0.0)]
        return [0.0]

    def params(self) -> Dict[str, Any]:
        """The masters (fp32, or bf16 when master-free) as the model's
        nested dict (the tensors themselves)."""
        return self.module.params()
