"""The standalone MoE layer and the expert-parameter mask, PyTorch port.

Counterpart of ``deepspeed_tpu/moe/layer.py``: :class:`MoE` with
``init``/``apply`` over a plain parameter dict (the reference's ``MoE``
constructor surface; ``ep_size`` is informational, as there), and
:func:`split_params_into_moe_groups`, a boolean mask tree marking the
expert weights.  Init draws from the JAX init's distributions through a
``torch.Generator``; the numbers differ from the JAX init, so tests carry
weights across.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.layers import activation_fn
from deepspeed_tpu_torch.moe.sharded_moe import moe_mlp

logger = logging.getLogger(__name__)


class MoE:
    """Standalone top-k MoE feed-forward block."""

    def __init__(self, hidden_size: int, num_experts: int = 1, k: int = 1,
                 intermediate_size: Optional[int] = None, ep_size: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, activation: str = "silu", glu: bool = True,
                 use_residual: bool = False, drop_tokens: bool = True,
                 use_rts: bool = False):
        if ep_size > 1:
            logger.warning("MoE ep_size=%d ignored: the port runs every expert "
                           "on one device", ep_size)
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.cfg = SimpleNamespace(
            num_experts=num_experts, num_experts_per_tok=k,
            moe_capacity_factor=capacity_factor,
            moe_eval_capacity_factor=eval_capacity_factor,
            moe_min_capacity=min_capacity, activation=activation, glu=glu,
            moe_drop_tokens=drop_tokens, moe_use_rts=use_rts)
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.use_residual = use_residual

    def init(self, seed: int = 0, *, device: DeviceLike = None) -> Any:
        """fp32 parameters, uniform ±fan_in**-0.5, the residual coefficient
        zero."""
        D, F, E = self.hidden_size, self.intermediate_size, self.num_experts
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        s_in, s_ff = D ** -0.5, F ** -0.5

        def u(shape, s):
            return torch.empty(shape, device=dev).uniform_(-s, s, generator=gen)

        params = {"gate_w": u((D, E), s_in), "w_up": u((E, D, F), s_in),
                  "w_down": u((E, F, D), s_ff)}
        if self.cfg.glu:
            params["w_gate"] = u((E, D, F), s_in)
        if self.use_residual:
            params["res_up"] = u((D, F), s_in)
            params["res_down"] = u((F, D), s_ff)
            params["res_coef"] = torch.zeros((D, 2), device=dev)
        return params

    def apply(self, params, x: torch.Tensor, training: bool = True,
              generator: Optional[torch.Generator] = None):
        """x: [B, S, D] -> (y, aux_loss).  ``training`` picks
        capacity_factor or eval_capacity_factor; ``generator`` feeds random
        token selection when ``use_rts``."""
        cfg = self.cfg
        factor = (cfg.moe_capacity_factor if training
                  else cfg.moe_eval_capacity_factor)
        eff = SimpleNamespace(**{**vars(cfg), "moe_capacity_factor": factor})
        y, aux = moe_mlp(params, x, eff, generator=generator)
        if self.use_residual:
            act = activation_fn(cfg.activation)
            res = act(x @ params["res_up"]) @ params["res_down"]
            coef = torch.softmax(x @ params["res_coef"], dim=-1)
            y = y * coef[..., 0:1] + res * coef[..., 1:2]
        return y, aux


def split_params_into_moe_groups(params) -> Any:
    """Boolean mask tree: True where a leaf is an expert weight.  An MoE
    block is any dict holding a ``gate_w`` router beside ``w_up`` /
    ``w_down`` (the dense MLPs use the same leaf names without a router);
    the router itself is not an expert weight."""
    expert_keys = {"w_up", "w_down", "w_gate"}

    def walk(node, in_moe):
        if isinstance(node, dict):
            is_moe_block = "gate_w" in node and bool(expert_keys & set(node))
            return {k: walk(v, in_moe or (is_moe_block and k in expert_keys))
                    for k, v in node.items()}
        return in_moe

    return walk(params, False)


def is_moe_param(params, path_or_mask=None) -> Any:
    """The mask tree itself (see :func:`split_params_into_moe_groups`)."""
    return split_params_into_moe_groups(params)
