"""Top-k gating and the MoE feed-forward block, PyTorch port.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` at one expert-parallel
rank (ep = 1): GShard top-k gating with a fixed expert capacity
``C = max(min_capacity, ceil(k*N/E * capacity_factor))`` (overflow tokens
get a zero combine weight and pass through the residual), the
load-balancing aux loss ``E * sum_e mean_prob_e * frac_tokens_e`` over the
top-1 choice, and the expert contractions as dense ``[E, C, *]`` batched
matmuls.  Capacity slots are granted in token order; the k-th choice of
every token is placed after all (k-1)-th choices of the expert, and k > 1
renormalises the kept gates per token.

The router's logits are computed in fp32 with TF32 off for that product:
a flipped argmax reroutes a token.  ``torch.argmax`` takes the first
maximum, as ``jnp.argmax`` does.  Random Token Selection (``use_rts``)
grants the slots in the order of a permutation of the tokens.  Given a
threefry key (the model's dropout chain, ``moe_mlp(..., key=)``), the
permutation is ``jax.random.permutation``'s bit for bit
(:func:`deepspeed_tpu_torch.utils.prng.permutation`).  Without one the JAX
package seeds from the bits of the tokens' fp32 sum, whose summation order
the port cannot match bit for bit; the port then draws from a
``torch.Generator`` seeded from that sum, which still varies from batch to
batch and repeats under remat, but is not JAX's stream.  The dispatch quantization of the JAX package (``moe_q_dispatch``)
acts only across an ``ep`` axis, so it is a no-op here, as it is there at
ep = 1.

Under a data-parallel engine (:func:`global_aux_stats`) each rank gates
its rows as the JAX engine's GSPMD program gates the global micro-batch,
whose rows ``[r * mb, (r + 1) * mb)`` rank r holds:

- the aux loss's two means, of the router's probabilities and of the top-1
  choices, are the global batch's (summed over the data-parallel group, the
  probabilities' sum differentiated);
- the capacity ``C`` is the global token count's;
- each expert's slots are numbered in the global order: one all-gather of
  the ranks' ``[k, E]`` choice counts a layer offsets slot ``j`` by every
  rank's counts of the slots before it, then by the lower ranks' counts of
  slot ``j``, so a token is kept iff its global position is below ``C``.

The expert buffers stay each rank's own: its kept tokens, numbered in the
same order, fill the first ``min(C, N_local)`` rows (:func:`buffer_capacity`),
and a dropped token's position is that bound.  Random Token Selection
permutes the global micro-batch, so over more than one rank it is refused
(ROADMAP.md queue 3, F2).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Tuple

import torch

from deepspeed_tpu_torch.models.layers import activation_fn
from deepspeed_tpu_torch.ops.kernels.common import full_fp32
from deepspeed_tpu_torch.utils import prng


def compute_capacity(num_tokens: int, num_experts: int, k: int,
                     capacity_factor: float, min_capacity: int = 4) -> int:
    return max(min_capacity,
               int(math.ceil(k * num_tokens / num_experts * capacity_factor)))


def router_gates(xt: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """Softmax router probabilities [N, E] in fp32 from tokens [N, D]."""
    with full_fp32():
        logits = xt.float() @ gate_w.float()
    return torch.softmax(logits, dim=-1)


def _permutation(n: int, generator, device):
    """A permutation of ``n`` tokens from ``generator``: a threefry key
    pair (``jax.random.permutation``'s) or a ``torch.Generator``."""
    if isinstance(generator, tuple):
        return prng.permutation(generator, n, device)
    return torch.randperm(n, generator=generator,
                          device=generator.device if generator is not None
                          else device).to(device)


_AUX_GROUP: Optional[Tuple[Any, int, int]] = None   # (group, world, rank)


@contextlib.contextmanager
def global_aux_stats(group: Any, world: int, rank: int = 0):
    """Inside: the gating and the aux loss's means are the data-parallel
    group's (the engine's forward runs in it); ``rank`` is this rank's
    place in the group, whose rows of the global micro-batch it holds."""
    global _AUX_GROUP
    prev, _AUX_GROUP = _AUX_GROUP, (group, world, rank)
    try:
        yield
    finally:
        _AUX_GROUP = prev


def _data_world() -> int:
    return 1 if _AUX_GROUP is None else _AUX_GROUP[1]


def global_tokens(n_local: int) -> int:
    """The global micro-batch's token count the capacity is taken from."""
    return n_local * _data_world()


def buffer_capacity(n_local: int, capacity: int) -> int:
    """Rows of this rank's expert buffers: the capacity, or over several
    ranks at most the rank's own tokens (an expert takes a token once)."""
    return capacity if _data_world() == 1 else min(capacity, n_local)


def _slot_offsets(counts: torch.Tensor) -> torch.Tensor:
    """``[k, E]`` offsets of each slot's positions: on one rank every
    earlier slot's counts; over ranks (one all-gather of ``counts``) every
    rank's counts of the earlier slots, then the lower ranks' of this one."""
    before = torch.cumsum(counts, dim=0) - counts
    if _AUX_GROUP is None:
        return before
    from deepspeed_tpu_torch.comm import comm

    group, world, rank = _AUX_GROUP
    every = comm.all_gather(counts[None], group, gather_dim=0)       # [W, k, E]
    total = every.sum(dim=0)
    return (torch.cumsum(total, dim=0) - total) + every[:rank].sum(dim=0)


def _topk_slots(gates: torch.Tensor, k: int, capacity: int):
    """Per slot j < k: (expert [N], position in its buffer [N], kept gate
    [N] fp32), the kept-gate sum [N] and the aux loss.  A token is kept iff
    its position among the expert's slots (over ranks, the global one) is
    below ``capacity``; a dropped token's position is the buffer's size
    (:func:`buffer_capacity`)."""
    N, E = gates.shape
    remaining = gates
    aux = torch.zeros((), dtype=torch.float32, device=gates.device)
    onehots = []
    for slot in range(k):
        idx = torch.argmax(remaining, dim=-1)                       # [N]
        onehot = torch.nn.functional.one_hot(idx, E)                # [N, E]
        if slot == 0:
            me = gates.mean(dim=0)
            ce = onehot.float().mean(dim=0)
            if _AUX_GROUP is not None:
                from deepspeed_tpu_torch.comm import comm

                group, world, _ = _AUX_GROUP
                me = comm.all_reduce_grad(me, group) / world
                ce = comm.all_reduce(ce, group) / world
            aux = E * (me * ce).sum()
        onehots.append((idx, onehot))
        remaining = torch.where(onehot > 0, -torch.inf, remaining)
    counts = torch.stack([oh.sum(dim=0) for _, oh in onehots])      # [k, E]
    local = torch.cumsum(counts, dim=0) - counts
    spread = _data_world() > 1
    offsets = _slot_offsets(counts) if spread else local
    size = buffer_capacity(N, capacity)
    kept_sum = torch.zeros(N, dtype=torch.float32, device=gates.device)
    slots = []
    for slot, (idx, onehot) in enumerate(onehots):
        ahead = torch.cumsum(onehot, dim=0) - onehot
        pos = ((ahead + offsets[slot][None]) * onehot).sum(dim=-1)  # [N]
        keep = pos < capacity
        if spread:
            # the rank's kept tokens of an expert are a prefix of its own
            # order: numbered locally they fill the buffer's first rows
            pos = torch.where(keep, ((ahead + local[slot][None]) * onehot).sum(dim=-1),
                              torch.full_like(pos, size))
        gate_val = gates.gather(1, idx[:, None])[:, 0]
        w = gate_val * keep.float()
        slots.append((idx, pos, w))
        kept_sum = kept_sum + w
    return slots, kept_sum, aux


def topk_assignments(gates: torch.Tensor, k: int, capacity: int,
                     generator: Optional[torch.Generator] = None,
                     use_rts: bool = False):
    """Compact top-k assignment: (expert_idx [N, k], pos [N, k], weight
    [N, k] fp32, aux scalar) for the scatter/gather dispatch.  ``use_rts``
    grants capacity in the order of a random permutation of the tokens
    (drawn from ``generator``, a ``torch.Generator`` or a threefry key
    pair); a no-op when nothing overflows."""
    if use_rts:
        perm = _permutation(gates.shape[0], generator, gates.device)
        inv = torch.argsort(perm)
        e_idx, pos, w, aux = topk_assignments(gates[perm], k, capacity)
        return e_idx[inv], pos[inv], w[inv], aux
    slots, kept_sum, aux = _topk_slots(gates, k, capacity)
    weight = torch.stack([w for _, _, w in slots], dim=1)
    if k > 1:
        weight = weight / torch.clamp_min(kept_sum, 1e-9)[:, None]
    return (torch.stack([i for i, _, _ in slots], dim=1),
            torch.stack([p for _, p, _ in slots], dim=1), weight, aux)


def topk_gating(gates: torch.Tensor, k: int, capacity: int,
                generator: Optional[torch.Generator] = None,
                use_rts: bool = False):
    """GShard top-k gating with fixed capacity: (combine [N, E, C] fp32,
    dispatch [N, E, C] bool, aux scalar) from router probabilities
    ``gates`` [N, E]; over ranks ``C`` is :func:`buffer_capacity`."""
    if use_rts:
        perm = _permutation(gates.shape[0], generator, gates.device)
        inv = torch.argsort(perm)
        combine, dispatch, aux = topk_gating(gates[perm], k, capacity)
        return combine[inv], dispatch[inv], aux
    N, E = gates.shape
    C = buffer_capacity(N, capacity)
    slots, kept_sum, aux = _topk_slots(gates, k, capacity)
    combine = torch.zeros((N, E, C), dtype=torch.float32, device=gates.device)
    for idx, pos, w in slots:
        onehot = torch.nn.functional.one_hot(idx, E).float()
        pos_oh = torch.nn.functional.one_hot(pos.clamp(0, C - 1), C).float()
        combine = combine + (w[:, None, None] * onehot[:, :, None]
                             * pos_oh[:, None, :])
    if k > 1:
        combine = combine / torch.clamp_min(kept_sum, 1e-9)[:, None, None]
    return combine, combine > 0, aux


def _rts_generator(xt: torch.Tensor) -> torch.Generator:
    """A generator seeded from the batch's content (the JAX package folds
    the bits of the fp32 sum into a fixed key), so RTS still varies from
    batch to batch when the caller passes none.  Reads one scalar back."""
    s = xt.float().sum().reshape(1).cpu()
    seed = int(s.view(torch.int32)[0]) & 0x7FFFFFFF
    return torch.Generator(device=xt.device).manual_seed(17 * 2 ** 31 + seed)


def moe_mlp(params, x: torch.Tensor, cfg,
            generator: Optional[torch.Generator] = None, key=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE feed-forward block on [B, S, D] hidden states: (output
    [B, S, D] in x's dtype, aux loss fp32 scalar).

    ``params``: {"gate_w" [D, E], "w_up" [E, D, F], ("w_gate" [E, D, F]),
    "w_down" [E, F, D]}.  ``cfg.moe_drop_tokens=False`` sizes the capacity
    for the worst case (C = N, the global micro-batch's tokens under a
    data-parallel engine): no token is dropped.  ``cfg.moe_dispatch``
    is "scatter" (an index-add into the [E, C, D] buffers and a gather back,
    O(N*k*D)) or "einsum" (the one-hot [N, E, C] contractions); both give
    the same buffers.  Random Token Selection (``cfg.moe_use_rts``) draws
    its permutation from ``key`` (a threefry key pair: JAX's permutation
    for the JAX ``rng``), else from ``generator``, else from a generator
    seeded from the content."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    N = B * S
    xt = x.reshape(N, D)
    gates = router_gates(xt, params["gate_w"])
    use_rts = bool(getattr(cfg, "moe_use_rts", False))
    if use_rts and _data_world() > 1:
        raise NotImplementedError(
            "moe_use_rts over data-parallel ranks: the JAX engine permutes the "
            "global micro-batch, which no rank holds (ROADMAP.md queue 3, F2)")
    if use_rts and key is not None:
        generator = key
    elif use_rts and generator is None:
        generator = _rts_generator(xt)
    Ng = global_tokens(N)
    if getattr(cfg, "moe_drop_tokens", True):
        C = compute_capacity(Ng, E, k, cfg.moe_capacity_factor,
                             getattr(cfg, "moe_min_capacity", 4))
    else:
        C = Ng
    use_scatter = getattr(cfg, "moe_dispatch", "scatter") == "scatter"
    if use_scatter:
        e_idx, pos, weight, aux = topk_assignments(gates, k, C, generator,
                                                   use_rts)
        Cb = buffer_capacity(N, C)
        keep = pos < Cb
        safe_pos = pos.clamp(0, Cb - 1)
        contrib = torch.where(keep.reshape(-1)[:, None],
                              xt.repeat_interleave(k, dim=0),
                              torch.zeros((), dtype=x.dtype, device=x.device))
        expert_in = torch.zeros((E, Cb, D), dtype=x.dtype, device=x.device)
        expert_in.index_put_((e_idx.reshape(-1), safe_pos.reshape(-1)),
                             contrib, accumulate=True)
    else:
        combine, dispatch, aux = topk_gating(gates, k, C, generator, use_rts)
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xt)
    act = activation_fn(cfg.activation)
    up = torch.bmm(expert_in, params["w_up"].to(x.dtype))
    if cfg.glu:
        hidden = act(torch.bmm(expert_in, params["w_gate"].to(x.dtype))) * up
    else:
        hidden = act(up)
    out = torch.bmm(hidden, params["w_down"].to(x.dtype))          # [E, C, D]
    if use_scatter:
        gathered = out[e_idx, safe_pos]                             # [N, k, D]
        y = (gathered * (weight * keep).to(x.dtype)[..., None]).sum(dim=1)
    else:
        y = torch.einsum("ecd,nec->nd", out, combine.to(x.dtype))
    return y.reshape(B, S, D), aux
