"""Host C++ op builders of the port (counterpart of
``deepspeed_tpu/ops/op_builder``): the g++ builds of ``csrc/cpu_adam.cpp``
and ``csrc/ds_aio.cpp``.  The CUDA kernels build through
:mod:`deepspeed_tpu_torch.ops.kernels.build`."""

from deepspeed_tpu_torch.ops.op_builder.native import (AsyncIOBuilder, CPUAdamBuilder,
                                                       NativeOpBuilder)

__all__ = ["NativeOpBuilder", "CPUAdamBuilder", "AsyncIOBuilder"]
