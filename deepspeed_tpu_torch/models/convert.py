"""Carry weights across from the JAX package.

The JAX ``CausalLM.init`` tree and the port's :class:`~deepspeed_tpu_torch.
models.transformer.CausalLM` share names and layouts, so conversion is a
name-for-name copy.  The caller hands over the tree with every leaf a numpy
array (``jax.tree.map(np.asarray, params)`` on the JAX side); nothing here
imports jax.  An int8 tree of the JAX package (its ``QTensor`` leaves) comes
across as ``{"q": int8 array, "scale": fp32 array}`` pairs and becomes the
port's :class:`~deepspeed_tpu_torch.models.quant.QTensor` with the same
codes and scales.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.config import ModelConfig
from deepspeed_tpu_torch.models.quant import QTensor
from deepspeed_tpu_torch.models.transformer import param_shapes


def jax_params_to_torch(params_np: Dict[str, Any], cfg: ModelConfig, *,
                        device: DeviceLike = None,
                        dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Numpy JAX param tree -> the port's nested tensor dict on ``device``
    in ``dtype``.  Raises on a missing, extra or misshapen leaf.  A leaf
    given as a ``{"q", "scale"}`` pair becomes a :class:`QTensor` whose int8
    codes and fp32 scales are the given ones, not cast to ``dtype``."""
    dev = resolve_device(device)

    def conv(tree, spec, path):
        if not isinstance(spec, dict) and isinstance(tree, dict) \
                and set(tree) == {"q", "scale"}:
            q, sc = np.asarray(tree["q"]), np.asarray(tree["scale"])
            want = tuple(spec[0])
            if q.shape != want or q.dtype != np.int8 or \
                    sc.shape != want[:-2] + (1, want[-1]):
                raise ValueError(f"{path}: int8 leaf q {q.dtype}{q.shape}, "
                                 f"scale {sc.shape} does not fit {want}")
            return QTensor(torch.from_numpy(np.array(q)).to(dev),
                           torch.from_numpy(np.array(sc, np.float32)).to(dev))
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
        if arr.dtype.name == "bfloat16":     # numpy has no bf16: widen (exact)
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.array(arr)).to(device=dev, dtype=dtype)

    return conv(params_np, param_shapes(cfg), "")


def torch_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's nested tensor dict -> the same tree of fp32 numpy arrays
    (the JAX tree's layout), e.g. to compare trained weights."""
    if isinstance(params, dict):
        return {k: torch_params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
