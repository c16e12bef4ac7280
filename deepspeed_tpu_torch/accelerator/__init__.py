from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device

__all__ = ["resolve_device"]
