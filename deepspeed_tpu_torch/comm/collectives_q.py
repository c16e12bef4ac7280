"""Quantized collectives over ``torch.distributed`` (counterpart of
``deepspeed_tpu/comm/collectives_q.py``).

Each collective sends blockwise int8 codes and fp32 block scales (the
codec of :mod:`.quant`: the kernels of ``ops/kernels/comm_quant.py``)
instead of the dense payload, and dequantizes on arrival.  The JAX
functions run inside ``shard_map`` over a named mesh axis; these run
eagerly over that axis's process group (``axis``: a mesh axis name or a
tuple of them, or a process group, as :mod:`.comm`'s collectives take it):

- :func:`q_all_reduce` -- the stage 0-2 gradient sync: each rank's vector
  cut into one chunk a rank, each chunk quantized on its own; an
  all-to-all of the codes; each rank dequantizes and sums its chunk in
  fp32; the chunk is quantized again and all-gathered.  With a
  ``residual`` (error feedback), the input is compensated first, and the
  new residual holds what this rank's quantization dropped plus, in this
  rank's own chunk slice, what the requantization of its reduced chunk
  dropped (the two levels of the 1-bit optimizers' worker and server
  errors).  At one rank it returns its compensated input unquantized;
- :func:`q_all_reduce_tree` -- the same, leaf by leaf;
- :func:`q_all_gather`, :func:`q_all_gather_flat`, :func:`q_all_gather_dim`
  -- each rank's shard quantized, codes and scales all-gathered, each
  source's quant-block padding stripped before the concatenation;
- :func:`q_reduce_scatter`, :func:`q_reduce_scatter_flat`,
  :func:`q_reduce_scatter_dim` -- each destination's chunk quantized on
  its own, the codes exchanged by an all-to-all, each rank dequantizing
  and summing its chunk in fp32 in rank order (one quantization error an
  element);
- :func:`q_all_to_all` -- the tiled all-to-all with int8 payloads
  (``comm.all_to_all_single(quantized=True)``).

Unlike :func:`q_all_reduce`, the gathers and reduce-scatters quantize also
over a group of one, as the JAX functions do.  A division by the group's
size is a product with its fp32 reciprocal: what XLA compiles the JAX
functions' division by that constant to.  Each call records itself
(:func:`~deepspeed_tpu_torch.comm.comm.record_q`: the bytes it sends by
dtype, and the dense twin) unless ``record=False``.

The ring and pipeline carries (``quantize_carry``, ``q_ppermute``,
``q_boundary_ppermute``) and ``q_reshard`` serve the sequence, pipeline
and expert meshes, which the port does not run yet (ROADMAP.md queue 1,
item 2e, the parallel meshes).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.quant import DEFAULT_BLOCK
from deepspeed_tpu_torch.ops.kernels.comm_quant import (dequantize_blockwise,
                                                        dequantize_error,
                                                        quantize_blockwise)

__all__ = ["q_all_reduce", "q_all_reduce_tree", "q_all_gather",
           "q_all_gather_flat", "q_all_gather_dim", "q_reduce_scatter",
           "q_reduce_scatter_flat", "q_reduce_scatter_dim", "q_all_to_all"]


def _recip(n: int, device) -> torch.Tensor:
    """fl32(1 / n) as a tensor (a Python scalar would be rounded elsewhere
    on the card)."""
    return torch.tensor(1.0, dtype=torch.float32, device=device) / n


def _merge_leading(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """[G, ...] stacked pieces -> their concatenation along ``dim``."""
    moved = parts.movedim(0, dim)
    shape = list(moved.shape)
    merged = shape[:dim] + [shape[dim] * shape[dim + 1]] + shape[dim + 2:]
    return moved.reshape(merged)


def _exchange(q: torch.Tensor, s: torch.Tensor, group):
    """Row p of the codes and scales to rank p; the rows received, by
    source (the untiled ``lax.all_to_all``)."""
    return (comm.all_to_all_single(q, group).view(q.shape),
            comm.all_to_all_single(s, group).view(s.shape))


def _gather(q: torch.Tensor, s: torch.Tensor, group):
    """Every rank's codes and scales stacked by source."""
    return (comm.all_gather(q, group, tiled=False),
            comm.all_gather(s, group, tiled=False))


def _chunk_quantize(flat: torch.Tensor, P: int, block: int):
    """``flat`` fp32 cut into ``P`` equal destination chunks of whole
    blocks, each chunk quantized on its own: (q [P, nb, block], scale [P,
    nb, 1], chunk length)."""
    n = flat.numel()
    chunk = -(-n // P)
    chunk = -(-chunk // block) * block
    if P * chunk != n:
        flat = torch.nn.functional.pad(flat, (0, P * chunk - n))
    q, s = quantize_blockwise(flat.contiguous(), block, rows=P)
    return q, s, chunk


# ---------------------------------------------------------------------------
# all-reduce (the gradient sync), with two-level error feedback
# ---------------------------------------------------------------------------

def q_all_reduce(x: torch.Tensor, axis, *, block: int = DEFAULT_BLOCK,
                 residual: Optional[torch.Tensor] = None, mean: bool = True,
                 op: str = "q_all_reduce", record: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out, new_residual)``: the mean (or sum) over ``axis`` of the
    ranks' ``x`` (plus ``residual``) through int8 codes, in ``x.dtype``,
    and the new fp32 residual (None when no residual was passed)."""
    group = comm._group(axis)
    P = comm.get_world_size(group)
    shape, dtype = x.shape, x.dtype
    n = x.numel()
    comp = x.float().reshape(-1)
    if residual is not None:
        comp = comp + residual.float().reshape(-1)
    if P <= 1:
        new_res = (torch.zeros(shape, dtype=torch.float32, device=x.device)
                   if residual is not None else None)
        return comp.reshape(shape).to(dtype), new_res
    q, s, chunk = _chunk_quantize(comp, P, block)
    if residual is not None:
        worker_err = dequantize_error(comp, q, s)
    # phase 1: rank r gathers every source's chunk r and sums it in fp32
    qt, st = _exchange(q, s, group)
    reduced = dequantize_blockwise(qt, st, chunk, sum=True)
    # phase 2: the reduced chunk quantized again and all-gathered
    q2, s2 = quantize_blockwise(reduced, block)
    new_res = None
    if residual is not None:
        # what the requantization dropped re-enters through this rank's own
        # next contribution to its chunk
        server_err = dequantize_error(reduced, q2, s2)
        full = torch.zeros(P * chunk, dtype=torch.float32, device=x.device)
        r = comm.get_rank(group)
        full[r * chunk:(r + 1) * chunk] = server_err
        new_res = (worker_err + full[:n]).reshape(shape)
    if record:
        comm.record_q(op, (q, s, q2, s2), x)
    qg, sg = _gather(q2[0], s2[0], group)
    out = dequantize_blockwise(qg, sg, chunk)[:n]
    if mean:
        out = out * _recip(P, out.device)
    return out.reshape(shape).to(dtype), new_res


def q_all_reduce_tree(tree: Any, axis, *, block: int = DEFAULT_BLOCK,
                      residual_tree: Any = None, mean: bool = True,
                      op: str = "q_all_reduce", record: bool = True
                      ) -> Tuple[Any, Any]:
    """:func:`q_all_reduce` leaf by leaf over nested dicts, lists and
    tuples of tensors; the residual tree mirrors the value tree (None for
    no error feedback)."""
    leaves: List[torch.Tensor] = []

    def flat(t):
        if isinstance(t, dict):
            for k in t:
                flat(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                flat(v)
        else:
            leaves.append(t)

    def build(t, it):
        if isinstance(t, dict):
            return {k: build(v, it) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, it) for v in t)
        return next(it)

    flat(tree)
    values = leaves
    leaves = []
    if residual_tree is not None:
        flat(residual_tree)
    res = leaves if residual_tree is not None else [None] * len(values)
    outs, ress = [], []
    for leaf, r in zip(values, res):
        o, nr = q_all_reduce(leaf, axis, block=block, residual=r, mean=mean,
                             op=op, record=record)
        outs.append(o)
        ress.append(nr)
    out_tree = build(tree, iter(outs))
    return out_tree, (build(tree, iter(ress)) if residual_tree is not None else None)


# ---------------------------------------------------------------------------
# all-gather (the parameter fetch)
# ---------------------------------------------------------------------------

def _q_ag_parts(local: torch.Tensor, group, block: int, op: str, record: bool,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The core int8 gather: ``[G * n_local]`` in ``dtype``, each source's
    padding stripped."""
    q, s = quantize_blockwise(local.contiguous(), block)
    if record:
        comm.record_q(op, (q, s), local)
    qg, sg = _gather(q[0], s[0], group)
    return dequantize_blockwise(qg, sg, local.numel(), dtype=dtype)


def q_all_gather_flat(local: torch.Tensor, axis, block: int = DEFAULT_BLOCK,
                      op: str = "q_all_gather", record: bool = True) -> torch.Tensor:
    """int8 all-gather of a flat local shard over ``axis`` (a subgroup's
    process group for hpZ) -> the flat fp32 concatenation."""
    return _q_ag_parts(local, comm._group(axis), block, op, record)


def q_all_gather(x: torch.Tensor, axis, *, block: int = DEFAULT_BLOCK,
                 op: str = "q_all_gather", record: bool = True) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 through int8 codes, in
    ``x.dtype``."""
    group = comm._group(axis)
    G = comm.get_world_size(group)
    parts = _q_ag_parts(x, group, block, op, record, x.dtype)
    return parts.reshape((G * x.shape[0],) + tuple(x.shape[1:]))


def q_all_gather_dim(leaf: torch.Tensor, axis, dim: int, *,
                     block: int = DEFAULT_BLOCK, op: str = "q_all_gather",
                     record: bool = True) -> torch.Tensor:
    """The ranks' shards concatenated along ``dim`` through int8 codes (the
    overlap schedule's per-leaf bucket gather), in ``leaf.dtype``."""
    group = comm._group(axis)
    G = comm.get_world_size(group)
    parts = _q_ag_parts(leaf, group, block, op, record, leaf.dtype)
    return _merge_leading(parts.reshape((G,) + tuple(leaf.shape)), dim)


# ---------------------------------------------------------------------------
# reduce-scatter (the gradient shard)
# ---------------------------------------------------------------------------

def _q_rs_shards(flat: torch.Tensor, group, P: int, shard_elems: int,
                 block: int, op: str, record: bool, dense_like) -> torch.Tensor:
    """``flat`` [P * shard_elems] fp32, destination r owning elements
    [r * shard_elems, (r + 1) * shard_elems): each destination's chunk
    quantized on its own, the codes exchanged, this rank's chunk
    dequantized and summed in fp32 -> [shard_elems]."""
    q, s = quantize_blockwise(flat, block, rows=P)
    if record:
        comm.record_q(op, (q, s), dense_like)
    qt, st = _exchange(q, s, group)
    return dequantize_blockwise(qt, st, shard_elems, sum=True)


def q_reduce_scatter_flat(full: torch.Tensor, axis, *, block: int = DEFAULT_BLOCK,
                          op: str = "q_reduce_scatter", record: bool = True
                          ) -> torch.Tensor:
    """[n_pad] local tensor (n_pad divisible by the group's size) -> this
    rank's summed [n_pad / P] shard, in ``full.dtype``."""
    group = comm._group(axis)
    P = comm.get_world_size(group)
    shard = full.numel() // P
    reduced = _q_rs_shards(full.float().reshape(-1).contiguous(), group, P, shard,
                           block, op, record, full)
    return reduced.to(full.dtype)


def q_reduce_scatter(x: torch.Tensor, axis, *, block: int = DEFAULT_BLOCK,
                     op: str = "q_reduce_scatter", record: bool = True) -> torch.Tensor:
    """Reduce-scatter along dim 0 (divisible by the group's size) through
    int8 codes: this rank's summed shard in ``x.dtype``."""
    group = comm._group(axis)
    P = comm.get_world_size(group)
    shard = x.shape[0] // P
    shard_elems = x.numel() // P
    reduced = _q_rs_shards(x.float().reshape(-1).contiguous(), group, P,
                           shard_elems, block, op, record, x)
    return reduced.reshape((shard,) + tuple(x.shape[1:])).to(x.dtype)


def q_reduce_scatter_dim(ct: torch.Tensor, axis, dim: int, *,
                         block: int = DEFAULT_BLOCK, op: str = "q_reduce_scatter",
                         record: bool = True) -> torch.Tensor:
    """``reduce_scatter(..., scatter_dim=dim)`` through int8 codes (the
    overlap schedule's per-leaf reduce-scatter)."""
    moved = ct.movedim(dim, 0).contiguous()
    shard = q_reduce_scatter(moved, axis, block=block, op=op, record=record)
    return shard.movedim(0, dim)


# ---------------------------------------------------------------------------
# all-to-all
# ---------------------------------------------------------------------------

def q_all_to_all(x: torch.Tensor, axis, split_dim: int = 0, concat_dim: int = 0,
                 *, block: int = DEFAULT_BLOCK, op: str = "q_all_to_all",
                 record: bool = True) -> torch.Tensor:
    """The tiled all-to-all through int8 codes: ``split_dim`` cut into one
    chunk a rank, each quantized on its own and sent, the chunks received
    dequantized and concatenated along ``concat_dim`` in rank order."""
    group = comm._group(axis)
    P = comm.get_world_size(group)
    if P <= 1:
        return x
    moved = x.movedim(split_dim, 0)
    S = moved.shape[0]
    if S % P:
        raise ValueError(f"q_all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {P} ways")
    chunk_s, rest = S // P, tuple(moved.shape[1:])
    flat = moved.reshape(P, -1).float().contiguous()
    q, s = quantize_blockwise(flat, block, rows=P)
    if record:
        comm.record_q(op, (q, s), x)
    qt, st = _exchange(q, s, group)
    recv = dequantize_blockwise(qt, st, flat.shape[1], dtype=x.dtype)
    recv = recv.reshape((P, chunk_s) + rest).movedim(1, 1 + split_dim)
    return _merge_leading(recv, concat_dim)
