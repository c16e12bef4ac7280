"""LAMB optimizer of the port (counterpart of ``fused_lamb`` in
``deepspeed_tpu/ops/pallas/fused_lamb.py``)."""

from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb

__all__ = ["FusedLamb"]
