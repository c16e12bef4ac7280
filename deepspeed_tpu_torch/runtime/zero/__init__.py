"""ZeRO of the port (counterpart of ``deepspeed_tpu/runtime/zero``): the
stages' partitions (:mod:`.partition`), ``Init`` and
``GatheredParameters`` (:mod:`.partition_parameters`), the offload of the
optimizer state (:mod:`.offload`) and its relay (:mod:`.relay`), and
ZeRO-Infinity's parameter streaming (:mod:`.streaming`,
:mod:`.stream_grad`)."""

from deepspeed_tpu_torch.runtime.zero.partition_parameters import (  # noqa: F401
    GatheredParameters, Init)
