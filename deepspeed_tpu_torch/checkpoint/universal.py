"""Universal checkpoint: the topology-independent per-parameter layout
(counterpart of ``deepspeed_tpu/checkpoint/universal.py``).

``ds_to_universal`` writes the JAX package's layout, so either package
reads the other's output::

    output_dir/
      meta.json                       (source meta + param/optim index)
      params/<path with '/'->'.'>.npy
      optim/<path with '/'->'.'>.npy  (moments, counts, scaler, ...)

``split_layers=True`` writes a stacked ``[L, ...]`` layer leaf as one file
a layer (``<name>.layer<k>.npy``).  A bf16 leaf is stored as the JAX
package's ``np.save`` stores one: its raw 2-byte words (a void ``V2``
array), ``"bfloat16"`` in ``meta.json``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import (
    BF16, ShardedCheckpointEngine, is_sharded_checkpoint, nest_keystrs,
    tree_flatten_with_path, tree_map_with_path)
from deepspeed_tpu_torch.utils.tensor_fragment import _path_str


class DeepSpeedCheckpoint:
    """Inspection API over a native checkpoint dir (reference class name):
    the layout records its degrees in ``client_state.json``."""

    def __init__(self, ckpt_dir: str, tag: Optional[str] = None):
        self.dir = ckpt_dir
        if tag is None:
            with open(os.path.join(ckpt_dir, "latest")) as fh:
                tag = fh.read().strip()
        self.tag = str(tag)
        self.path = os.path.join(ckpt_dir, self.tag)
        meta_path = os.path.join(self.path, "client_state.json")
        self.meta: Dict[str, Any] = {}
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                self.meta = json.load(fh)

    @property
    def zero_stage(self) -> int:
        return int(self.meta.get("zero_stage", 0))

    @property
    def world_size(self) -> int:
        return int(self.meta.get("world_size", 1))

    def load_params(self) -> Any:
        return self._load_payload("model_states")

    def load_optim(self) -> Optional[Any]:
        """Optimizer-state dict (``opt_state`` + step bookkeeping) or None for
        a params-only checkpoint."""
        return self._load_payload("optim_states", optional=True)

    def _load_payload(self, name: str, optional: bool = False):
        sharded = os.path.join(self.path, name)
        if is_sharded_checkpoint(sharded):
            return nest_keystrs(ShardedCheckpointEngine().load(sharded))
        if os.path.exists(sharded + ".msgpack"):
            raise NotImplementedError(
                f"{sharded}.msgpack: the legacy msgpack layout is not ported "
                "(ROADMAP.md queue 1: the legacy msgpack layout)")
        if optional:
            return None
        raise FileNotFoundError(f"no {name} payload in {self.path}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as ``np.save`` takes it: bf16 as its raw 2-byte words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return BF16 if t.dtype == torch.bfloat16 else str(t.numpy().dtype)


def ds_to_universal(input_dir: str, output_dir: str, tag: Optional[str] = None,
                    split_layers: bool = False) -> str:
    """Convert a native checkpoint to the universal per-parameter layout
    (see the module docstring); returns ``output_dir``."""
    ckpt = DeepSpeedCheckpoint(input_dir, tag)
    params = ckpt.load_params()

    def export_tree(tree, subdir: str) -> Dict[str, Any]:
        out = os.path.join(output_dir, subdir)
        os.makedirs(out, exist_ok=True)
        index: Dict[str, Any] = {}
        for pth, leaf in tree_flatten_with_path(tree):
            name = _path_str(pth)
            fname = name.replace("/", ".")
            entry = {"shape": list(leaf.shape), "dtype": _dtype_name(leaf)}
            if split_layers and name.startswith("layers/") and leaf.dim() > 0:
                for i in range(leaf.shape[0]):
                    np.save(os.path.join(out, f"{fname}.layer{i}.npy"),
                            _to_numpy(leaf[i]))
                entry["layers"] = int(leaf.shape[0])
            else:
                np.save(os.path.join(out, fname + ".npy"), _to_numpy(leaf))
            index[name] = entry
        return index

    index = export_tree(params, "params")
    optim = ckpt.load_optim()
    optim_index = export_tree(optim, "optim") if optim is not None else None
    with open(os.path.join(output_dir, "meta.json"), "w") as fh:
        json.dump({"source": ckpt.meta, "tag": ckpt.tag, "format": "universal/1",
                   "params": index, "optim": optim_index}, fh, indent=1)
    return output_dir


def load_universal_params(universal_dir: str, target: Any) -> Any:
    """Rebuild a param tree (``target``'s structure, shapes and dtypes; CPU
    tensors) from a universal dir."""
    return _load_universal_tree(universal_dir, target, "params")


def load_universal_optim(universal_dir: str, target: Any) -> Any:
    """Rebuild the optimizer-state tree exported by :func:`ds_to_universal`
    (raises KeyError if the universal dir is params-only)."""
    return _load_universal_tree(universal_dir, target, "optim")


def _load_universal_tree(universal_dir: str, target: Any, section: str) -> Any:
    with open(os.path.join(universal_dir, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get(section) is None:
        raise KeyError(f"universal checkpoint has no {section!r} section")
    pdir = os.path.join(universal_dir, section)

    def read(fname: str, dtype: str) -> torch.Tensor:
        arr = np.load(os.path.join(pdir, fname))
        if dtype == BF16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)

    def load_leaf(pth, leaf):
        name = _path_str(pth)
        info = meta[section].get(name)
        if info is None:
            raise KeyError(f"universal checkpoint {section} section missing {name!r}")
        stem = name.replace("/", ".")
        if "layers" in info:
            t = torch.stack([read(f"{stem}.layer{i}.npy", info["dtype"])
                             for i in range(info["layers"])])
        else:
            t = read(stem + ".npy", info["dtype"])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: universal shape {tuple(t.shape)} != "
                             f"target {tuple(leaf.shape)}")
        return t.to(torch.as_tensor(leaf).dtype)

    return tree_map_with_path(load_leaf, target)
