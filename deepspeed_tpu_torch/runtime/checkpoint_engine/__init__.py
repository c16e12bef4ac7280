"""Checkpoint backends, PyTorch port (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/``).

``ShardedCheckpointEngine`` writes and reads the JAX package's sharded
layout (per-process shard files + JSON index); ``atomic`` is its staging,
manifest, ``latest`` pointer and verification, copied unchanged in
format.  The JAX package's ``MsgpackCheckpointEngine`` needs flax and is
not ported (ROADMAP.md queue 1: the legacy msgpack layout).
"""

from deepspeed_tpu_torch.runtime.checkpoint_engine import atomic
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import CheckpointEngine
from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import (ShardedCheckpointEngine,
                                                                   is_sharded_checkpoint,
                                                                   nest_keystrs)

__all__ = ["CheckpointEngine", "ShardedCheckpointEngine", "is_sharded_checkpoint",
           "nest_keystrs", "atomic"]
