"""ZeRO partitioning (counterpart of ``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package makes each stage a placement over the ``fsdp`` mesh axis:

- stage 0: params, grads and optimizer state replicated, grads all-reduced;
- stage 1: the optimizer state sharded;
- stage 2: and the grad accumulator, which takes reduce-scattered grads;
- stage 3: and the params (the fp32 masters), leaves under
  ``stage3_param_persistence_threshold`` elements kept whole.

:func:`choose_pspec` picks the dim a leaf shards on, rule for rule: the
largest dim the axis size divides, a tie to the later dim (``max`` over
``(size, index)``), dims already claimed skipped, nothing for a leaf of
fewer than ``max(min_size, n)`` elements.  Specs are the JAX package's
``PartitionSpec`` as plain tuples: an axis name or None a dim (``()`` for a
leaf left whole by a stage that shards nothing).  The model's logical specs
(:meth:`CausalLM.logical_pspecs`: the dims tensor and expert parallelism
claim) steer the params' and the accumulator's dim, not the optimizer
state's, as in the JAX engine; where the two differ the engine moves a
slice from one to the other with an all-to-all (:func:`reshard`).

:func:`zero_plan` is what the port's engine keeps of it, a
:class:`LeafPlan` a leaf.  At a world of one the JAX rule shards nothing;
the plan takes the same dim as at any world (every dim divides by 1), so a
one-card run takes the sharded path, its collectives over a group of one,
with the same bytes as the whole leaf.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm.mesh import axis_size
from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import (keystr,
                                                                   tree_flatten_with_path)

Spec = Tuple[Optional[str], ...]


def _numel(shape) -> int:
    return int(math.prod(shape or (1,)))


def _pick(shape: Tuple[int, ...], n: int, min_size: int,
          base: List[Optional[str]]) -> Optional[int]:
    """The dim the rule picks, or None (no ``n <= 1`` exit)."""
    if _numel(shape) < max(min_size, n):
        return None
    candidates = [(size, i) for i, size in enumerate(shape)
                  if base[i] is None and size % n == 0]
    return max(candidates)[1] if candidates else None


def choose_pspec(shape: Tuple[int, ...], mesh, axis: str = "fsdp",
                 min_size: int = 0, existing: Optional[Spec] = None) -> Spec:
    """The spec sharding one dim of ``shape`` over ``axis`` (the JAX
    function's rules)."""
    n = axis_size(mesh, axis)
    base = list(existing) if existing is not None else [None] * len(shape)
    while len(base) < len(shape):
        base.append(None)
    if n <= 1:
        return tuple(base)
    dim = _pick(tuple(shape), n, min_size, base)
    if dim is not None:
        base[dim] = axis
    return tuple(base)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (a tuple a leaf;
    ``specs`` None gives None for every leaf)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, None if specs is None else specs[k])
                for k, v in tree.items()}
    return fn(tree, specs)


def params_pspecs(params: Any, mesh, shard: bool, axis: str = "fsdp",
                  persistence_threshold: int = 0, logical_specs: Any = None) -> Any:
    """The spec tree of a params tree: each leaf's ``logical_specs`` entry
    (the model's tensor- and expert-parallel claims; ``()`` without), and
    if ``shard`` (stage 3) :func:`choose_pspec` over it with the
    threshold."""
    def spec_for(leaf, logical):
        if not shard:
            return tuple(logical) if logical is not None else ()
        return choose_pspec(tuple(leaf.shape), mesh, axis=axis,
                            min_size=persistence_threshold, existing=logical)
    return _map2(spec_for, params, logical_specs)


def opt_state_pspecs(opt_state_shapes: Any, mesh, shard: bool, axis: str = "fsdp",
                     persistence_threshold: int = 0) -> Any:
    """The spec tree of an optimizer state: moments as their params,
    scalars (step counts) whole."""
    def spec_for(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shard or len(shape) == 0:
            return ()
        return choose_pspec(shape, mesh, axis=axis, min_size=persistence_threshold)
    return _map(spec_for, opt_state_shapes)


def describe_partitioning(params: Any, pspecs: Any) -> str:
    """A report of which leaves shard on which dim."""
    flat_p = tree_flatten_with_path(params)
    flat_s = [s for _, s in _spec_leaves(pspecs)]
    lines = []
    sharded = replicated = 0
    for (path, leaf), spec in zip(flat_p, flat_s):
        if any(s is not None for s in spec):
            sharded += 1
            lines.append(f"  {keystr(path)}: {tuple(leaf.shape)} -> P{spec}")
        else:
            replicated += 1
    lines.insert(0, f"partitioning: {sharded} sharded, {replicated} replicated params")
    return "\n".join(lines)


def _spec_leaves(tree, path=()):
    """``(path, spec)`` in tree order, a spec tuple being a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k], path + (k,))]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# the engine's plan
# ---------------------------------------------------------------------------

class LeafPlan(NamedTuple):
    """One leaf's placement over ``n`` ranks: its full ``shape``;
    ``pdim``, the dim its param (the master) and its grad accumulator shard
    on (chosen past the model's tensor-parallel claims, as the JAX engine
    chooses them), and ``odim``, its optimizer state's (chosen over the
    bare shape, as ``opt_state_pspecs`` chooses), None for never; and
    whether the param, the optimizer state and the accumulator are
    sharded."""
    shape: Tuple[int, ...]
    pdim: Optional[int]
    odim: Optional[int]
    n: int
    param: bool
    opt: bool
    acc: bool

    def shard_shape(self, dim: int) -> Tuple[int, ...]:
        shape = list(self.shape)
        shape[dim] //= self.n
        return tuple(shape)

    def region(self, dim: int, r: int) -> List[List[int]]:
        """Rank ``r``'s slice along ``dim`` as ``[[start, stop], ...]``."""
        out = [[0, d] for d in self.shape]
        size = self.shape[dim] // self.n
        out[dim] = [r * size, (r + 1) * size]
        return out


# the claim :func:`zero_plan` puts on a stacked leaf's layer dim under
# ``overlap_comm`` (the JAX ``layerwise_pspecs`` sentinel)
LAYER_DIM = "__overlap_layer_dim__"


def zero_plan(shapes: Sequence[Tuple[int, ...]], stage: int, n: int,
              persistence_threshold: int = 100_000,
              logical: Optional[Sequence[Optional[Spec]]] = None,
              layer_leaves: Optional[Sequence[bool]] = None) -> List[LeafPlan]:
    """The JAX engine's three partitions (``runtime/engine.py``
    ``_init_state``): params sharded at stage 3 with the threshold as
    ``min_size``, the accumulator from stage 2 with ``min_size`` 0, both
    past the model's claims (``logical``, a spec a leaf); the optimizer
    state from stage 1 over the bare shape, ``min_size`` 0.

    ``layer_leaves`` (a flag a leaf: a stacked ``[L, ...]`` layer leaf) is
    the layout of ``overlap_comm`` (the JAX ``layerwise_pspecs``): the
    bucketed schedule slices layer ranges along dim 0, so the params and the
    accumulator never shard a stacked leaf's layer dim, and at stage 3 the
    accumulator takes exactly the params' layout (the threshold too: a leaf
    kept whole keeps a whole accumulator)."""
    plans = []
    for i, shape in enumerate(shapes):
        shape = tuple(int(d) for d in shape)
        claims = list(logical[i]) if logical is not None and logical[i] else []
        claims += [None] * (len(shape) - len(claims))
        if layer_leaves is not None and layer_leaves[i] and shape and claims[0] is None:
            claims[0] = LAYER_DIM
        pdim = _pick(shape, n, 0, claims) if shape else None
        odim = _pick(shape, n, 0, [None] * len(shape)) if shape else None
        param = (stage >= 3 and pdim is not None
                 and _numel(shape) >= max(persistence_threshold, n))
        acc = stage >= 2 and pdim is not None
        if layer_leaves is not None and stage >= 3:
            acc = param
        plans.append(LeafPlan(shape, pdim, odim, n, param,
                              stage >= 1 and odim is not None, acc))
    return plans


def shard_of(full: torch.Tensor, plan: LeafPlan, dim: int, r: int) -> torch.Tensor:
    """Rank ``r``'s slice along ``dim`` of a full leaf, a tensor of its
    own."""
    size = plan.shape[dim] // plan.n
    return full.narrow(dim, r * size, size).clone(
        memory_format=torch.contiguous_format)


def reshard(x: torch.Tensor, src_dim: int, dst_dim: int, axis) -> torch.Tensor:
    """This rank's slice along ``src_dim`` of a leaf into its slice along
    ``dst_dim``: one all-to-all over ``axis``, each rank sending every other
    the block of its slice that the other keeps."""
    from deepspeed_tpu_torch.comm import comm

    return comm.all_to_all_single(x, axis, split_dim=dst_dim, concat_dim=src_dim)
