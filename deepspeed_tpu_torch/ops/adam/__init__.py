"""Optimizers of the port (counterpart of ``deepspeed_tpu/ops/adam``)."""

from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam

__all__ = ["FusedAdam"]
