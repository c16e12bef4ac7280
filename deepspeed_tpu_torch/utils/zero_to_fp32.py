"""Consolidate a checkpoint into a single fp32 state dict (counterpart of
``deepspeed_tpu/utils/zero_to_fp32.py``).

The layout stores logically-full arrays (sharding is a placement, not a
file layout), so consolidation is load + cast + flatten; the entry points
and the CLI are the JAX package's, and either package's tags read alike.

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <save_dir> <out.npz> [-t TAG]
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import (
    ShardedCheckpointEngine, is_sharded_checkpoint, nest_keystrs,
    tree_flatten_with_path)
from deepspeed_tpu_torch.utils.tensor_fragment import _path_str


def _load_checkpoint_params(checkpoint_dir: str, tag: Optional[str] = None) -> Any:
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if not os.path.exists(latest):
            raise FileNotFoundError(f"no 'latest' file in {checkpoint_dir}; pass tag=")
        with open(latest) as fh:
            tag = fh.read().strip()
    sharded = os.path.join(checkpoint_dir, str(tag), "model_states")
    if is_sharded_checkpoint(sharded):
        return nest_keystrs(ShardedCheckpointEngine().load(sharded))
    raise NotImplementedError(
        f"{os.path.join(checkpoint_dir, str(tag))} is not in the sharded "
        "layout: the legacy msgpack layout is not ported (ROADMAP.md queue "
        "1: the legacy msgpack layout)")


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, torch.Tensor]:
    """Flat ``{"layers/attn/wq": fp32 tensor, ...}`` state dict (CPU);
    a non-floating leaf keeps its dtype."""
    params = _load_checkpoint_params(checkpoint_dir, tag)
    return {_path_str(pth): leaf.float() if leaf.is_floating_point() else leaf
            for pth, leaf in tree_flatten_with_path(params)}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> str:
    """Write the consolidated fp32 state dict as an .npz (the JAX package's
    format; the reference writes a torch .bin)."""
    flat = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    out = output_file if output_file.endswith(".npz") else output_file + ".npz"
    np.savez(out, **{k: v.numpy() for k, v in flat.items()})
    print(f"saved consolidated fp32 state dict ({len(flat)} tensors) to {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("-t", "--tag", default=None)
    args = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file,
                                               args.tag)


if __name__ == "__main__":
    main()
