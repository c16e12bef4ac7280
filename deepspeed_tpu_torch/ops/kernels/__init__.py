"""Hand-written Hopper kernels of the port, each beside its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas``.  The serving path runs six:
the norm forward (RMSNorm or LayerNorm) and RoPE (q and k in one launch,
:mod:`.rope`) in prefill, and RoPE and the four fused decode kernels of
:mod:`.decode` in every decode step, all CUDA C++.  The training path runs
the norm forward and backward, RoPE forward and backward (the same kernel),
flash attention forward and backward (:mod:`.flash_attention`), dropout
(:mod:`.dropout`, JAX's threefry masks, no TPU kernel behind it) and the
optimizer's update, all CUDA C++: fused Adam (:mod:`.fused_adam`), fused
Adam8bit over int8 moments with stochastic rounding
(:mod:`.fused_adam8bit`) or the two LAMB phases (:mod:`.fused_lamb`).
:mod:`.softmax` and :mod:`.quantizer` hold ops of the public library that
no model path calls: scaled masked softmax and bias + activation (Triton),
and the block quantizer (CUDA C++; dequantize and the int4 packing are
plain torch).  ``layer_norm`` and ``flash_attention`` are imported from
their modules: here each function's name would shadow its module's.
"""

from deepspeed_tpu_torch.ops.kernels.decode import (flash_decode, fused_mlp,
                                                    fused_norm_qkv,
                                                    fused_proj_norm)
from deepspeed_tpu_torch.ops.kernels.fused_adam import fused_adam_update
from deepspeed_tpu_torch.ops.kernels.fused_adam8bit import fused_adam8bit_update
from deepspeed_tpu_torch.ops.kernels.fused_lamb import (fused_lamb_update,
                                                        lamb_phase1, lamb_scale)
from deepspeed_tpu_torch.ops.kernels.layer_norm import (layer_norm_bwd,
                                                        rms_norm, rms_norm_bwd)
from deepspeed_tpu_torch.ops.kernels.quantizer import (dequantize, pack_int4,
                                                       quantize, unpack_int4)
from deepspeed_tpu_torch.ops.kernels.rope import apply_rotary_pos_emb, rope_angles
from deepspeed_tpu_torch.ops.kernels.softmax import (bias_act,
                                                     scaled_masked_softmax)

__all__ = ["layer_norm_bwd", "rms_norm", "rms_norm_bwd",
           "scaled_masked_softmax", "bias_act", "apply_rotary_pos_emb",
           "rope_angles", "fused_adam_update", "fused_adam8bit_update",
           "fused_lamb_update", "lamb_phase1", "lamb_scale", "quantize",
           "dequantize", "pack_int4", "unpack_int4", "fused_norm_qkv",
           "flash_decode", "fused_proj_norm", "fused_mlp"]
