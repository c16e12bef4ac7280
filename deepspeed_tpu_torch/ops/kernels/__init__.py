"""Hand-written Hopper kernels of the port, each beside its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas``.  The serving path runs six:
RMSNorm forward (CUDA C++) and RoPE forward (Triton) in prefill, and the
four fused decode kernels of :mod:`.decode` (CUDA C++) in every decode
step.  The training path runs RMSNorm forward and backward, RoPE forward
and backward (the same Triton kernel), flash attention forward and
backward (:mod:`.flash_attention`, CUDA C++; imported from its module,
whose name the function would shadow here) and the fused Adam update
(:mod:`.fused_adam`, CUDA C++).
"""

from deepspeed_tpu_torch.ops.kernels.decode import (flash_decode, fused_mlp,
                                                    fused_norm_qkv,
                                                    fused_proj_norm)
from deepspeed_tpu_torch.ops.kernels.fused_adam import fused_adam_update
from deepspeed_tpu_torch.ops.kernels.layer_norm import rms_norm, rms_norm_bwd
from deepspeed_tpu_torch.ops.kernels.rope import apply_rotary_pos_emb, rope_angles

__all__ = ["rms_norm", "rms_norm_bwd", "apply_rotary_pos_emb", "rope_angles",
           "fused_adam_update", "fused_norm_qkv", "flash_decode",
           "fused_proj_norm", "fused_mlp"]
