"""Mixture-of-Experts, PyTorch port (counterpart of ``deepspeed_tpu/moe``)."""

from deepspeed_tpu_torch.moe.layer import (MoE, is_moe_param,
                                           split_params_into_moe_groups)
from deepspeed_tpu_torch.moe.sharded_moe import (compute_capacity, moe_mlp,
                                                 topk_assignments, topk_gating)

__all__ = ["MoE", "split_params_into_moe_groups", "is_moe_param",
           "compute_capacity", "moe_mlp", "topk_assignments", "topk_gating"]
