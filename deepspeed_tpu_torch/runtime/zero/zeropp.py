"""ZeRO++ over ``torch.distributed`` (counterpart of
``deepspeed_tpu/runtime/zero/zeropp.py``): quantized weight gathers (qwZ),
quantized gradient reduce-scatters (qgZ) and the hpZ secondary partition.

State layout (the JAX engine's, which its checkpoints hold): each leaf is
flattened and zero-padded to ``n_pad``, a multiple of ``P * 8``
(:func:`flatten_spec`, ``P`` the fsdp size), and rank ``r`` keeps the fp32
slice ``[r * n_pad / P, (r + 1) * n_pad / P)`` as its primary shard; the
optimizer steps these shards and the accumulator has their shape.  Under
hpZ (``zero_hpz_partition_size`` z > 1) each rank also keeps a secondary
slice of ``n_pad / z`` elements, the one of its place in a contiguous
subgroup of z fsdp ranks (:func:`hpz_groups`, process groups made by every
rank in the same order): int8 codes ``[nb, block]`` and scales ``[nb]``
under qwZ, else bf16 (``jnp.bfloat16`` in the JAX function, whatever the
compute dtype) with a scalar placeholder for the scales.

Each micro-batch gathers the full compute-dtype tree
(:func:`gather_param_tree`): from the secondary over the rank's subgroup
under hpZ, else from the primary over fsdp, int8 under qwZ.  The grads go
back through :func:`reduce_scatter_flat` (int8 under qgZ), times 1 / P,
then averaged over dp.  The boundary clips with this path's own rule, then
refreshes the secondary from the updated primary (:func:`refresh_secondary`:
one fsdp gather, int8 under qwZ, re-sliced and re-quantized).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm import collectives_q as cq
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.runtime.comm.quantized import block_quantize

QUANT_BLOCK = 256


class ZeroPPParams(NamedTuple):
    """The params of a ZeRO++ state as the JAX engine saves them:
    ``primary`` the flat fp32 shards, ``secondary_q`` / ``secondary_s`` the
    hpZ secondary (``()`` without hpZ)."""

    primary: Any
    secondary_q: Any
    secondary_s: Any


class ZeroPPConfig(NamedTuple):
    world: int                # fsdp size P
    hpz: int                  # secondary partition size z (1 = off)
    q_weights: bool
    q_grads: bool
    compute_dtype: torch.dtype
    block: int = QUANT_BLOCK


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def hpz_groups(P: int, z: int) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Contiguous subgroups of ``z`` fsdp positions (position r in group
    r // z); None when z is 1 or P (the whole axis)."""
    if z <= 1 or z == P:
        return None
    return tuple(tuple(range(g * z, (g + 1) * z)) for g in range(P // z))


def make_hpz_group(mesh, z: int):
    """This rank's hpZ subgroup as a process group (every rank makes every
    subgroup of every fsdp group, in one order); the fsdp group when the
    subgroups are the whole axis."""
    P = int(mesh.shape.get("fsdp", 1))
    groups = hpz_groups(P, z)
    if groups is None:
        return mesh.group("fsdp")
    mine, seen = None, set()
    for r in range(mesh.size):
        coords = dict(zip(mesh.axis_names,
                          (int(c) for c in np.unravel_index(r, tuple(mesh.shape.values())))))
        members = tuple(mesh.members("fsdp", coords))
        if members in seen:
            continue
        seen.add(members)
        for pos in groups:
            ranks = [members[i] for i in pos]
            group = comm.new_group(ranks)
            if mesh.rank in ranks:
                mine = group
    return mine


def flatten_spec(shapes: Sequence[Tuple[int, ...]], P: int) -> List[int]:
    """Each leaf's padded flat length."""
    return [pad_to(int(np.prod(s)) if len(s) else 1, P * 8) for s in shapes]


def primary_shard(full: torch.Tensor, n_pad: int, P: int, rank: int) -> torch.Tensor:
    """This rank's fp32 slice of a leaf flattened and padded to ``n_pad``."""
    flat = full.reshape(-1).float()
    if n_pad != flat.numel():
        flat = torch.nn.functional.pad(flat, (0, n_pad - flat.numel()))
    per = n_pad // P
    return flat[rank * per:(rank + 1) * per].clone()


def flat_grads(grads: Sequence[torch.Tensor], lens: Sequence[int]) -> List[torch.Tensor]:
    """Full grads -> fp32 flat leaves padded to ``n_pad``."""
    out = []
    for g, L in zip(grads, lens):
        flat = g.reshape(-1).float()
        out.append(torch.nn.functional.pad(flat, (0, L - flat.numel()))
                   if L != flat.numel() else flat.contiguous())
    return out


def q_all_gather_flat(local: torch.Tensor, group, block: int = QUANT_BLOCK) -> torch.Tensor:
    """int8 gather of a flat shard over ``group`` -> the fp32
    concatenation, recorded as ZeRO++'s (``zpp_q_all_gather``)."""
    return cq.q_all_gather_flat(local, group, block=block, op="zpp_q_all_gather")


def dense_all_gather_flat(local: torch.Tensor, group) -> torch.Tensor:
    return comm.all_gather(local, group)


def reduce_scatter_flat(full: torch.Tensor, group, quantized: bool,
                        block: int = QUANT_BLOCK) -> torch.Tensor:
    """[n_pad] local gradient -> this rank's summed [n_pad / P] shard (qgZ:
    each destination's chunk quantized once, summed in fp32)."""
    if quantized:
        return cq.q_reduce_scatter_flat(full, group, block=block)
    return comm.reduce_scatter(full, group)


def gather_param_tree(primary: Sequence[torch.Tensor], sec_q: Sequence[Any],
                      sec_s: Sequence[Any], cfg: ZeroPPConfig,
                      shapes: Sequence[Tuple[int, ...]], fsdp_group, hpz_group
                      ) -> List[torch.Tensor]:
    """The full compute-dtype leaves: from the secondary over this rank's
    subgroup under hpZ (int8 under qwZ, each member's quant-block padding
    stripped before the concatenation), else from the primary over fsdp."""
    out = []
    for i, (flat_local, shape) in enumerate(zip(primary, shapes)):
        n = int(np.prod(shape)) if len(shape) else 1
        if cfg.hpz > 1:
            s2 = flat_local.numel() * cfg.world // cfg.hpz
            if cfg.q_weights:
                from deepspeed_tpu_torch.ops.kernels.comm_quant import dequantize_blockwise

                q, s = sec_q[i], sec_s[i]
                comm.record_q("zpp_q_all_gather(hpz)", (q, s),
                              torch.empty((s2,), dtype=cfg.compute_dtype, device="meta"))
                qg = comm.all_gather(q, hpz_group, tiled=False)
                sg = comm.all_gather(s, hpz_group, tiled=False)
                full = dequantize_blockwise(qg, sg, s2)
            else:
                full = comm.all_gather(sec_q[i], hpz_group).float()
        elif cfg.q_weights:
            full = q_all_gather_flat(flat_local.to(cfg.compute_dtype), fsdp_group,
                                     cfg.block)
        else:
            full = dense_all_gather_flat(flat_local.to(cfg.compute_dtype), fsdp_group)
        out.append(full[:n].reshape(shape).to(cfg.compute_dtype))
    return out


def refresh_secondary(primary: Sequence[torch.Tensor], cfg: ZeroPPConfig,
                      fsdp_group, fsdp_rank: int) -> Tuple[List[Any], List[Any]]:
    """The hpZ secondary from the primary: one fsdp gather (int8 under
    qwZ), this rank's subgroup position's slice, re-quantized (scales as
    [nb]) under qwZ, else bf16 with a scalar placeholder."""
    z = cfg.hpz
    if z <= 1:
        return [], []
    qs, ss = [], []
    pos = fsdp_rank % z
    for flat_local in primary:
        n_pad = flat_local.numel() * cfg.world
        s2 = n_pad // z
        if cfg.q_weights:
            full = q_all_gather_flat(flat_local.to(cfg.compute_dtype), fsdp_group,
                                     cfg.block)
        else:
            full = dense_all_gather_flat(flat_local.to(cfg.compute_dtype), fsdp_group)
        mine = full.reshape(-1)[pos * s2:(pos + 1) * s2]
        if cfg.q_weights:
            q, s, _ = block_quantize(mine.float().contiguous(), cfg.block)
            qs.append(q)
            ss.append(s.reshape(-1))
        else:
            qs.append(mine.to(torch.bfloat16).contiguous())
            ss.append(torch.zeros((), dtype=torch.float32, device=flat_local.device))
    return qs, ss
