"""Hand-written Hopper kernels of the port, each beside its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas``.  This slice carries the two
kernels the serving path runs: RMSNorm forward (CUDA C++) and RoPE forward
(Triton).
"""

from deepspeed_tpu_torch.ops.kernels.layer_norm import rms_norm
from deepspeed_tpu_torch.ops.kernels.rope import apply_rotary_pos_emb, rope_angles

__all__ = ["rms_norm", "apply_rotary_pos_emb", "rope_angles"]
