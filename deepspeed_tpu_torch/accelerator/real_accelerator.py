"""Device resolution for the PyTorch port.

Counterpart of ``deepspeed_tpu/accelerator/real_accelerator.py``: where the
JAX package picks TPU or CPU from the jax backend, the port runs on one CUDA
card by default.  The CPU is used only when the caller asks for it by name
(the tests do); with no card and no explicit device the entry points raise
instead of quietly running somewhere slower.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is present);
    ``"cpu"`` -> the CPU; ``"cuda"``/``"cuda:N"`` -> that card.  Any other
    device type is refused: the port has kernels for CUDA and plain
    versions for the CPU, and nothing else."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' explicitly to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}: the port runs on 'cuda' "
                     f"(default) or 'cpu'")

