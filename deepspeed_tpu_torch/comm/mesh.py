"""The device mesh over ``torch.distributed`` ranks (counterpart of
``deepspeed_tpu/comm/mesh.py``).

The JAX package lays its devices out as one ``jax.sharding.Mesh`` with
named axes ``MESH_AXES`` = (pp, dp, fsdp, ep, sp, tp), device ``r`` at the
row-major coordinates of ``r`` in that shape.  The port keeps the sizes'
rules and the order: rank ``r`` sits where device ``r`` sits, so it holds
the batch rows and the shard that device holds.  Each axis, and the data
axes together, is backed by a process group: the ranks that share every
other coordinate, in the order of their coordinate along the axis.  The
groups are made when the mesh is built, by every rank in the same order
(``torch.distributed.new_group`` is collective); a group that spans the
world is the world's own.

Axis meanings are the JAX package's: ``dp`` pure data parallelism,
``fsdp`` the ZeRO axis (optimizer state from stage 1, gradients from 2,
params at 3 are sharded over it), ``pp``, ``ep``, ``sp`` and ``tp`` the
parallel meshes (refused by the port's config for now).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")
# the axis sets whose groups a mesh makes: each axis, and the data axes
GROUP_AXES = tuple((a,) for a in MESH_AXES) + (("dp", "fsdp"), ("dp", "fsdp", "ep"))

_GLOBAL_MESH: Optional["Mesh"] = None


class Mesh:
    """Named axis sizes over ``size`` ranks, this rank's coordinates and
    the process groups of its axes.  ``shape`` maps each axis, in order, to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, sizes: Dict[str, int], order: Sequence[str], rank: int = 0,
                 make_groups: bool = True):
        self.axis_names: Tuple[str, ...] = tuple(order)
        self.shape: Dict[str, int] = {a: int(sizes[a]) for a in self.axis_names}
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(self.axis_names, coords)}
        self._groups: Dict[Tuple[int, ...], object] = {}
        if make_groups:
            self._make_groups()

    def members(self, axes: Union[str, Sequence[str]],
                coords: Optional[Dict[str, int]] = None) -> List[int]:
        """The ranks that share every coordinate but ``axes`` with
        ``coords`` (default: this rank's), in row-major order over
        ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        coords = self.coords if coords is None else coords
        shape = tuple(self.shape.values())
        ranges = [range(self.shape[a]) if a in axes else (coords[a],)
                  for a in self.axis_names]
        return sorted(int(np.ravel_multi_index(c, shape))
                      for c in itertools.product(*ranges))

    def _make_groups(self) -> None:
        """Every group of every axis set in ``GROUP_AXES``, made by all
        ranks in one order (duplicates once), this rank's kept."""
        from deepspeed_tpu_torch.comm import comm

        if not comm.is_initialized() or comm.get_world_size() != self.size:
            return
        world = list(range(self.size))
        seen = set()
        for axes in GROUP_AXES:
            others = [a for a in self.axis_names if a not in axes]
            for combo in itertools.product(*(range(self.shape[a]) for a in others)):
                members = tuple(self.members(axes, dict(zip(others, combo),
                                                        **{a: 0 for a in axes})))
                if members in seen:
                    continue
                seen.add(members)
                group = None if list(members) == world else comm.new_group(members)
                if self.rank in members:
                    self._groups[members] = group

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of ``axes`` that holds this rank (None: the
        world's)."""
        members = tuple(self.members(axes))
        if list(members) == list(range(self.size)):
            return None
        if members not in self._groups:
            raise RuntimeError(f"no process group for mesh axes {axes} (the mesh "
                               "was built before torch.distributed was initialized)")
        return self._groups[members]

    def axis_rank(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's place in its group of ``axes``."""
        return self.members(axes).index(self.rank)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def build_mesh(dp: int = 0, fsdp: int = 0, tp: int = 1, pp: int = 1, sp: int = 1,
               ep: int = 1, world_size: Optional[int] = None,
               axis_order: Optional[Sequence[str]] = None,
               rank: Optional[int] = None, make_groups: bool = True) -> Mesh:
    """A mesh over the world (or ``world_size`` ranks), with the JAX
    function's rules: sizes of 0 are inferred, ``fsdp`` absorbing what the
    explicit axes leave, or ``dp`` when ``fsdp`` is given.  Its process
    groups are made (by every rank: call it on all of them) unless
    ``make_groups`` is false or no process group spans ``world_size``."""
    from deepspeed_tpu_torch.comm import comm

    n = int(world_size) if world_size is not None else comm.get_world_size()
    fixed = {"tp": max(1, tp), "pp": max(1, pp), "sp": max(1, sp), "ep": max(1, ep)}
    known = math.prod(fixed.values())
    if n % known != 0:
        raise ValueError(f"device count {n} not divisible by tp*pp*sp*ep={known}")
    remainder = n // known
    if dp and fsdp:
        if dp * fsdp != remainder:
            raise ValueError(f"dp({dp})*fsdp({fsdp}) != remaining devices {remainder}")
    elif fsdp:
        if remainder % fsdp != 0:
            raise ValueError(f"fsdp={fsdp} does not divide remaining devices {remainder}")
        dp = remainder // fsdp
    else:
        dp = dp or 1
        if remainder % dp != 0:
            raise ValueError(f"dp={dp} does not divide remaining devices {remainder}")
        fsdp = remainder // dp
    sizes = {"pp": fixed["pp"], "dp": dp, "fsdp": fsdp, "ep": fixed["ep"],
             "sp": fixed["sp"], "tp": fixed["tp"]}
    order = tuple(axis_order) if axis_order else MESH_AXES
    order = tuple(a for a in order if a in sizes) + tuple(
        a for a in MESH_AXES if a not in order)
    return Mesh(sizes, order, comm.get_rank() if rank is None else rank,
                make_groups=make_groups)


def mesh_from_config(mesh_cfg, world_size: Optional[int] = None,
                     make_groups: bool = True) -> Mesh:
    return build_mesh(dp=mesh_cfg.dp, fsdp=mesh_cfg.fsdp, tp=mesh_cfg.tp,
                      pp=mesh_cfg.pp, sp=mesh_cfg.sp, ep=mesh_cfg.ep,
                      world_size=world_size, axis_order=mesh_cfg.axis_order,
                      make_groups=make_groups)


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh(create_default: bool = True) -> Optional[Mesh]:
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None and create_default:
        _GLOBAL_MESH = build_mesh()
    return _GLOBAL_MESH


def axis_size(mesh: Mesh, axis: str) -> int:
    return int(mesh.shape.get(axis, 1))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes over which the global batch is split."""
    return tuple(a for a in ("dp", "fsdp", "ep") if axis_size(mesh, a) > 1) or ("dp",)


# ---------------------------------------------------------------------------
# the reference's group queries (deepspeed/utils/groups.py): process groups
# here, where the JAX package answers with axis names
# ---------------------------------------------------------------------------

def get_data_parallel_group(mesh: Optional[Mesh] = None):
    return (mesh or get_global_mesh()).group(("dp", "fsdp", "ep"))


def get_model_parallel_group(mesh: Optional[Mesh] = None):
    return (mesh or get_global_mesh()).group("tp")


def get_expert_parallel_group(mesh: Optional[Mesh] = None):
    return (mesh or get_global_mesh()).group("ep")


def get_sequence_parallel_group(mesh: Optional[Mesh] = None):
    return (mesh or get_global_mesh()).group("sp")


def get_pipeline_parallel_group(mesh: Optional[Mesh] = None):
    return (mesh or get_global_mesh()).group("pp")


def get_data_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    """Batch shards: dp × fsdp × ep."""
    mesh = mesh or get_global_mesh()
    return axis_size(mesh, "dp") * axis_size(mesh, "fsdp") * axis_size(mesh, "ep")


def get_model_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return axis_size(mesh or get_global_mesh(), "tp")


def get_expert_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return axis_size(mesh or get_global_mesh(), "ep")


def get_sequence_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return axis_size(mesh or get_global_mesh(), "sp")


def get_pipeline_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return axis_size(mesh or get_global_mesh(), "pp")
