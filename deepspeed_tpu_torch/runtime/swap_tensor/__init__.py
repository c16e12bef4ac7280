"""NVMe swapping of the optimizer state (counterpart of
``deepspeed_tpu/runtime/swap_tensor``)."""

from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import (OptimizerStateSwapper,
                                                                       rank_swap_dir)

__all__ = ["OptimizerStateSwapper", "rank_swap_dir"]
