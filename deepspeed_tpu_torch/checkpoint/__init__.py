"""Universal checkpointing, PyTorch port (counterpart of
``deepspeed_tpu/checkpoint/``)."""

from deepspeed_tpu_torch.checkpoint.universal import (DeepSpeedCheckpoint,
                                                      ds_to_universal,
                                                      load_universal_optim,
                                                      load_universal_params)

__all__ = ["DeepSpeedCheckpoint", "ds_to_universal", "load_universal_params",
           "load_universal_optim"]
