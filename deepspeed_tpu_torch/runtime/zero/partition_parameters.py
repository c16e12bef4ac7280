"""``zero.Init`` and ``GatheredParameters`` (counterpart of
``deepspeed_tpu/runtime/zero/partition_parameters.py``).

``Init`` is the reference's context that builds modules already
partitioned.  The port's engine shards the masters when it is built, so
here, as in the JAX package, it only records its settings.

``GatheredParameters`` gathers, lets the caller modify and partitions
again.  Over an engine (``engine=``) it yields the full params as the
model's nested dict (:meth:`DeepSpeedEngine.params`: a stage-3 shard
gathered into a new tensor); on exit every rank takes ``modifier_rank``'s
values (a broadcast; ``modifier_rank=None`` when every rank made the same
change), writes its slice of each back into the masters, the optimizer's
slices and the compute copy.  Over ``params=`` (a nested dict of full
tensors) it yields them and, on exit, broadcasts ``modifier_rank``'s values
into them in place.  Every rank enters the context together.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import tree_flatten_with_path


class Init:
    """``with deepspeed_tpu_torch.zero.Init():``: a recorded no-op (the
    engine partitions when it is built)."""

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear=True,
                 remote_device=None, pin_memory=False, config_dict_or_path=None,
                 config=None, enabled=True, dtype=None, mpu=None):
        self.enabled = enabled
        self.remote_device = remote_device
        self.dtype = dtype

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class GatheredParameters:
    """Gather -> modify -> partition again (the reference's context)."""

    def __init__(self, params: Any = None, modifier_rank: Optional[int] = 0,
                 fwd_module=None, enabled: bool = True, engine: Any = None):
        if params is None and engine is None:
            raise ValueError("GatheredParameters needs params or engine=")
        self.enabled = enabled
        self.engine = engine
        self.modifier_rank = modifier_rank
        self._src = params
        self.params: Any = None
        self.result: Any = None

    def __enter__(self):
        if not self.enabled:
            self.params = self._src if self._src is not None else self.engine.params()
            return self.params
        if self._src is not None:
            self.params = self._src
        else:
            # full tensors of their own, so that a change is made to a copy
            full = self.engine.params()
            self.params = _map_tensors(lambda t: t.detach().clone(), full)
        return self.params

    @torch.no_grad()
    def __exit__(self, exc_type, exc, tb):
        if not self.enabled or exc_type is not None:
            return False
        leaves = [t for _, t in tree_flatten_with_path(self.params)]
        if self.modifier_rank is not None:
            for t in leaves:
                comm.broadcast(t, src=self.modifier_rank)
        if self.engine is not None:
            self.engine.set_full_params(leaves)
        self.result = self.params
        return False


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree)
