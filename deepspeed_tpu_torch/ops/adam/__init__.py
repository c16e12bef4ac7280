"""Optimizers of the port (counterpart of ``deepspeed_tpu/ops/adam``)."""

from deepspeed_tpu_torch.ops.adam.adam8bit import Adam8bit
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.adam.muon import Muon

__all__ = ["Adam8bit", "DeepSpeedCPUAdam", "FusedAdam", "Muon"]
