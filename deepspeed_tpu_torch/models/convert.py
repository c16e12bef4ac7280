"""Carry weights across from the JAX package.

The JAX ``CausalLM.init`` tree and the port's :class:`~deepspeed_tpu_torch.
models.transformer.CausalLM` share names and layouts, so conversion is a
name-for-name copy.  The caller hands over the tree with every leaf a numpy
array (``jax.tree.map(np.asarray, params)`` on the JAX side); nothing here
imports jax.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.config import ModelConfig
from deepspeed_tpu_torch.models.transformer import param_shapes


def jax_params_to_torch(params_np: Dict[str, Any], cfg: ModelConfig, *,
                        device: DeviceLike = None,
                        dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Numpy JAX param tree -> the port's nested tensor dict on ``device``
    in ``dtype``.  Raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)

    def conv(tree, spec, path):
        if isinstance(spec, dict):
            if not isinstance(tree, dict) or set(tree) != set(spec):
                got = sorted(tree) if isinstance(tree, dict) else type(tree)
                raise ValueError(f"{path or '<root>'}: keys {got} != "
                                 f"{sorted(spec)}")
            return {k: conv(tree[k], spec[k], f"{path}.{k}".lstrip("."))
                    for k in spec}
        arr = np.asarray(tree)
        if arr.shape != tuple(spec[0]):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(spec[0])}")
        return torch.from_numpy(np.array(arr)).to(device=dev, dtype=dtype)

    return conv(params_np, param_shapes(cfg), "")


def torch_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's nested tensor dict -> the same tree of fp32 numpy arrays
    (the JAX tree's layout), e.g. to compare trained weights."""
    if isinstance(params, dict):
        return {k: torch_params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
