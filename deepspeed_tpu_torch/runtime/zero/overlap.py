"""Layer-bucketed compute/collective overlap for ZeRO (``overlap_comm``).

Counterpart of ``deepspeed_tpu/runtime/zero/overlap.py``.  The plain ZeRO
path of the engine gathers every stage-3 leaf before the forward and
reduces every grad after the whole backward.  With
``zero_optimization.overlap_comm`` the engine drives the model through its
per-layer segments (``CausalLM.stream_segments()``) in **buckets**: the
embedding piece, then the stacked layers in chunks of
``zero_optimization.overlap_bucket_layers`` layers (slices of the leading
``[L]`` dim, which the overlap layout never shards:
:func:`layerwise_pspecs`, :func:`~deepspeed_tpu_torch.runtime.zero.
partition.zero_plan` with ``layer_leaves``), then the head piece (final
norm, LM head):

- **stage 3**: each bucket's sharded leaves pass through
  :class:`_GatherReduceScatter`, an ``autograd.Function`` whose forward
  casts the shard to the compute dtype and all-gathers it and whose
  backward reduce-scatters the cotangent (the JAX ``_scoped_all_gather``'s
  custom VJP), so each bucket's reduce-scatters are issued as that
  bucket's grads land.  Bucket i+1's gathers are issued (``async_op``)
  when bucket i starts, its input ready, and waited on when bucket i+1
  runs; bucket 0's with the embedding's.  A leaf's collective is its own,
  as in the JAX schedule, but a bucket's go out together
  (:func:`~deepspeed_tpu_torch.comm.comm.coalescing`: one NCCL group
  launch), which keeps the host's cost a bucket rather than a leaf.  Layer buckets run under ``torch.utils.checkpoint``
  with the gathers inside: the backward re-gathers (ZeRO-3's 2x gather)
  and holds no gathered param;
- **stages 1 and 2**: the params are whole, so nothing is gathered; each
  bucket's leaves pass through :class:`_ReduceOnGrad`, an identity whose
  backward reduces the bucket's grads when they land: a reduce-scatter
  into the sharded accumulator (stage 2) or the data-parallel sum
  (stage 1).  Layer buckets are checkpointed when the model remats.

A reduction issued in the backward completes (its wait, its add into the
accumulator) two buckets later, or after the backward returns
(:meth:`OverlapSchedule.finish`), so the backward's kernels run beside it
and at most two buckets' grads wait for their reductions.  Collectives move the compute
dtype, as the JAX schedule's; a leaf reduce-scattered over ``fsdp`` is
summed over ``dp`` next (the JAX schedule's rest-axis ``pmean``).  The
engine divides the loss by the data-parallel world before the backward, so
these sums are the JAX schedule's means.

Loss semantics are the plain path's: the same segments (each layer under the
model's remat policy, the training forward's own body), the same ``1/gas``,
the same CE weight (``_ce_weight``), an MoE layer gated over the global
micro-batch, its aux losses summed in layer order; only the schedule
differs.  Evaluation and the boundary's ``apply`` stay on the plain path.

:meth:`OverlapSchedule.comm_plan_entries` lists the collectives of one
micro-batch a bucket at a time as the JAX function does.  Where the fsdp
axis has one rank the port still runs its one-rank gathers and
reduce-scatters (nothing short-circuits at world 1: ``comm/comm.py``), and
the entries list them, where the JAX plan, counting only axes of more than
one device, lists none.

``comm_quantization`` (:class:`QCommOpts`, the JAX schedule's int8
branches): ``all_gather`` at stage 3 sends each bucket's shards as int8
codes and fp32 block scales (:func:`~deepspeed_tpu_torch.comm.
collectives_q.q_all_gather_dim`'s codec, the gathers of a bucket still
issued together ahead), ``reduce_scatter`` at stages 2-3 reduce-scatters a
bucket's grads through :func:`~deepspeed_tpu_torch.comm.collectives_q.
q_reduce_scatter_dim` when the bucket's last grad lands.  The JAX
schedule communicates only over axes of more than one device, so it
quantizes nothing where fsdp has one rank; the engine turns both off
there, and the one-rank collectives stay exact.  The int8 entries of
:meth:`OverlapSchedule.comm_plan_entries` are the JAX plan's: ``q_<op>``,
the codes' and scales' bytes, and the dense twin.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.runtime.zero.partition import (LAYER_DIM, LeafPlan,
                                                         choose_pspec,
                                                         params_pspecs)

__all__ = ["BucketInfo", "OverlapSchedule", "QCommOpts", "layerwise_pspecs",
           "plan_buckets", "unpack_lm_batch"]

DATA_AXES = ("dp", "fsdp", "ep")
_HEAD_KEYS = ("final_norm", "lm_head", "lm_head_bias")


def plan_buckets(num_layers: int, bucket_layers: int) -> List[Tuple[int, int]]:
    """Contiguous ``[start, stop)`` layer ranges covering ``num_layers``."""
    bl = max(1, int(bucket_layers))
    return [(i, min(i + bl, num_layers)) for i in range(0, num_layers, bl)]


def unpack_lm_batch(batch):
    """(tokens, labels, loss_mask) for the LM batch forms the built-in
    models accept, or None for forms the segment-driven schedule cannot
    route (the streamed offload path's contract)."""
    if isinstance(batch, (tuple, list)) and len(batch) == 2:
        return batch[0], batch[1], None
    if isinstance(batch, dict) and "tokens" in batch and "labels" in batch:
        return batch["tokens"], batch["labels"], batch.get("loss_mask")
    return None


def layerwise_pspecs(params: Any, mesh, shard: bool, persistence_threshold: int = 0,
                     logical_specs: Any = None) -> Any:
    """:func:`~deepspeed_tpu_torch.runtime.zero.partition.params_pspecs`
    that never shards dim 0 of a stacked ``params["layers"]`` leaf (the JAX
    function's rule: a sentinel claims it during the choice and is dropped
    after).  Other leaves keep the standard choice."""
    specs = params_pspecs(params, mesh, shard=shard,
                          persistence_threshold=persistence_threshold,
                          logical_specs=logical_specs)
    if not shard or not (isinstance(params, dict) and "layers" in params):
        return specs

    def walk(tree, logical):
        if isinstance(tree, dict):
            return {k: walk(v, None if logical is None else logical[k])
                    for k, v in tree.items()}
        shape = tuple(tree.shape)
        base = list(logical) if logical is not None else [None] * len(shape)
        base += [None] * (len(shape) - len(base))
        if base and base[0] is None:
            base[0] = LAYER_DIM
        out = list(choose_pspec(shape, mesh, min_size=persistence_threshold,
                                existing=tuple(base)))
        if out:
            out[0] = None
        return tuple(out)

    lspecs = logical_specs.get("layers") if isinstance(logical_specs, dict) else None
    return dict(specs, layers=walk(params["layers"], lspecs))


def _bucket_key(path: str) -> str:
    """``jax.tree_util.keystr`` of a dotted path below its first key."""
    return "".join(f"[{k!r}]" for k in path.split(".")[1:])


class QCommOpts(NamedTuple):
    """The schedule's int8 switches (``comm_quantization`` -> engine ->
    here): ``all_gather`` quantizes the stage-3 bucket gathers,
    ``reduce_scatter`` the stage 2-3 reduce-scatters."""

    all_gather: bool = False
    reduce_scatter: bool = False
    block: int = 256


class _Done:
    """A result already in hand, waited on like a :class:`~deepspeed_tpu_
    torch.comm.comm.Pending`."""

    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value


class _QGather:
    """A bucket leaf's int8 gather in flight: its codes' and scales'
    gathers; :meth:`wait` dequantizes them (each rank's padding stripped),
    concatenated along the leaf's dim, in the compute dtype."""

    def __init__(self, q_pend, s_pend, shard_shape, dim, dtype):
        self._q, self._s = q_pend, s_pend
        self._shape, self._dim, self._dtype = tuple(shard_shape), dim, dtype

    def wait(self) -> torch.Tensor:
        from deepspeed_tpu_torch.comm.collectives_q import _merge_leading
        from deepspeed_tpu_torch.ops.kernels.comm_quant import dequantize_blockwise

        qg, sg = self._q.wait(), self._s.wait()
        n = 1
        for d in self._shape:
            n *= d
        parts = dequantize_blockwise(qg, sg, n, dtype=self._dtype)
        return _merge_leading(parts.reshape((qg.shape[0],) + self._shape), self._dim)


class BucketInfo(NamedTuple):
    """One schedule bucket."""

    name: str
    kind: str                 # "embed" | "layers" | "head"
    start: int                # layer range (kind == "layers" only)
    stop: int
    gathers_per_micro: int    # 2 = rematerialized (backward re-gathers)


class _Leaf(NamedTuple):
    """One leaf of a bucket: its engine index, whether it is a stacked
    layer leaf (sliced to the bucket's range), and its reduction."""
    index: int
    stacked: bool
    kind: str                 # "gather" | "scatter" | "sum"


class _Ctx:
    """What a bucket's autograd functions share: the schedule and the
    bucket's gathers issued ahead (taken by the first forward; a remat
    recompute gathers again)."""

    def __init__(self, sched: "OverlapSchedule", ahead: Optional[Dict] = None):
        self.sched, self.ahead = sched, ahead or {}


class _GatherReduceScatter(torch.autograd.Function):
    """Stage 3: forward, the compute-dtype all-gather of a shard along its
    ``pdim`` (issued with its bucket's: ahead, or when a remat recompute
    opens the bucket); backward, the cotangent staged for its bucket's
    reduce-scatter (then summed over ``dp``) into the accumulator."""

    @staticmethod
    def forward(ctx, shard, bctx, slot, region):
        ctx.bctx, ctx.slot, ctx.region = bctx, slot, region
        return bctx.ahead.pop(slot).wait()

    @staticmethod
    def backward(ctx, g):
        ctx.bctx.sched._reduce(g, ctx.slot, ctx.region, "gather")
        return None, None, None, None


class _ReduceOnGrad(torch.autograd.Function):
    """Stages 1-2 (and a stage-3 leaf kept whole): the identity, whose
    backward stages the grad for its bucket's reductions."""

    @staticmethod
    def forward(ctx, x, bctx, slot, region, kind):
        ctx.bctx, ctx.slot, ctx.region, ctx.kind = bctx, slot, region, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.bctx.sched._reduce(g, ctx.slot, ctx.region, ctx.kind)
        return None, None, None, None, None


class OverlapSchedule:
    """The bucketed schedule of one engine (built by the engine's
    ``_build_overlap``).  ``paths``, ``plan``: the engine's leaves (dotted
    paths in its order) and their :class:`LeafPlan`; ``groups``: the
    ``fsdp``, ``dp`` and data-parallel process groups, ``sizes``: the
    mesh's axis sizes."""

    def __init__(self, *, segments: Dict[str, Any], paths: Sequence[str],
                 plan: Sequence[LeafPlan], zero_stage: int,
                 compute_dtype: torch.dtype, bucket_layers: int, remat: bool,
                 sizes: Dict[str, int], groups: Dict[str, Any],
                 qcomm: QCommOpts = QCommOpts()):
        self.seg = segments
        self.qcomm = qcomm
        self.L = int(segments["num_layers"])
        self.buckets = plan_buckets(self.L, bucket_layers)
        self.tied = bool(segments["tied"])
        self.moe_coef = float(segments["moe_coef"])
        self.dropout = float(segments["dropout"])
        self.paths = list(paths)
        self.plan = list(plan)
        self.zero_stage = zero_stage
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.sizes = dict(sizes)
        self.groups = groups
        # the training forward's per-layer body under the model's remat
        # policy (bit for bit the plain path's); else the segment's layer
        self.layer_body = segments.get("layer_body")
        self._has = {k: any(p == k or p.startswith(k + ".") for p in self.paths)
                     for k in _HEAD_KEYS}
        self._leaves = {"embed": [], "layers": [], "head": []}
        for i, (path, pl) in enumerate(zip(self.paths, self.plan)):
            top = path.split(".")[0]
            where = "head" if top in _HEAD_KEYS else top
            if where not in self._leaves:
                raise ValueError(f"overlap_comm: leaf {path} is outside the "
                                 "embed / layers / head layout")
            kind = ("gather" if pl.param else
                    "scatter" if pl.acc else "sum")
            self._leaves[where].append(_Leaf(i, where == "layers", kind))
        self._pending: List[Tuple[Any, torch.Tensor]] = []
        # a bucket's grads wait here until the last of them lands
        self._staged: Dict[Tuple[str, int, int], List[Tuple]] = {}
        # the comm counters' calls and bytes an op of the engine's last
        # micro-batch (set by the engine), to hold against plan_counts()
        self.last_counts: Dict[str, Dict[str, int]] = {}
        # reductions in flight at most: two buckets' worth (each holds its
        # bucket's grad until it completes)
        self._window = 2 * max(len(v) for v in self._leaves.values())
        self._acc: Optional[List[torch.Tensor]] = None
        self._master: Optional[List[torch.Tensor]] = None

    # -- structure ------------------------------------------------------
    def bucket_infos(self) -> List[BucketInfo]:
        infos = [BucketInfo("embed", "embed", 0, 0, 1)]
        for b0, b1 in self.buckets:
            infos.append(BucketInfo(f"layers[{b0}:{b1}]", "layers", b0, b1,
                                    2 if self.remat else 1))
        infos.append(BucketInfo("head", "head", 0, 0, 1))
        return infos

    def bucket_assignment(self) -> Dict[str, str]:
        """``leaf id -> bucket name``, leaf ids as the JAX function names
        them (a stacked leaf once a layer range)."""
        out = {}
        for where in ("embed", "head"):
            for leaf in self._leaves[where]:
                path = self.paths[leaf.index]
                top = path.split(".")[0]
                out[top + _bucket_key(path)] = where
        for b0, b1 in self.buckets:
            for leaf in self._leaves["layers"]:
                name = f"layers[{b0}:{b1}]"
                out[name + _bucket_key(self.paths[leaf.index])] = name
        return out

    # -- analytic comm plan -------------------------------------------------
    def comm_plan_entries(self) -> List[Tuple[str, int, int, str, int]]:
        """Per bucket, ``(op, calls, bytes, dtype, world)`` of one
        micro-batch's collectives, as the JAX function lists them: the
        gathers (stage 3; twice for a rematerialized layer bucket), the
        reduce-scatters (stage 2-3), the all-reduces (a leaf kept whole;
        the ``dp`` sum after a reduce-scatter).  Bytes are the compute
        dtype's: a gather's and a reduce-scatter's the whole slice's, a
        ``dp`` sum's the shard's.  A layer bucket's bytes are its slice's
        exactly (the JAX plan takes ``int(leaf bytes * layers / L)``, the
        same number when ``L`` divides evenly, as in every layout here)."""
        item = torch.empty((), dtype=self.compute_dtype).element_size()
        cname = str(self.compute_dtype).replace("torch.", "")
        fsdp, dp = self.sizes.get("fsdp", 1), self.sizes.get("dp", 1)
        data = 1
        for a in DATA_AXES:
            data *= self.sizes.get(a, 1)
        micro = []
        for info in self.bucket_infos():
            g_rows, r_rows, ar_rows = [], [], []
            for leaf in self._leaves[info.kind]:
                pl = self.plan[leaf.index]
                numel = 1
                for d in pl.shape:
                    numel *= d
                if leaf.stacked:
                    numel = numel // pl.shape[0] * (info.stop - info.start)
                nbytes = numel * item
                if leaf.kind == "gather":
                    g_rows.append((nbytes, fsdp))
                    r_rows.append((nbytes, fsdp))
                    if dp > 1:
                        ar_rows.append((max(1, nbytes // fsdp), dp))
                elif leaf.kind == "scatter":
                    r_rows.append((nbytes, fsdp))
                    if dp > 1:
                        ar_rows.append((max(1, nbytes // fsdp), dp))
                else:
                    ar_rows.append((nbytes, data))

            qc = self.qcomm

            def add(op, rows, mult=1, quantized=False):
                if not rows:
                    return
                dense = mult * sum(b for b, _ in rows)
                world = max(w for _, w in rows)
                if quantized:
                    # int8 codes and one fp32 scale a block: the wire bytes,
                    # the dense twin beside them
                    micro.append((f"q_{op}", mult * len(rows),
                                  int(dense / item * (1 + 4.0 / qc.block)),
                                  "int8", world, (dense, cname)))
                else:
                    micro.append((op, mult * len(rows), dense, cname, world))

            if self.zero_stage == 3:
                add("all_gather", g_rows, mult=info.gathers_per_micro,
                    quantized=qc.all_gather)
            add("reduce_scatter", r_rows, quantized=qc.reduce_scatter)
            add("all_reduce", ar_rows)
        return micro

    def hideable_comm_fraction(self) -> float:
        """The share of a micro-batch's collective bytes the schedule can
        hide under compute: all but the first gather and the last
        reduction (the embedding bucket's, which ends the backward)."""
        entries = self.comm_plan_entries()
        total = sum(e[2] for e in entries)
        if not total:
            return 0.0
        gathers = [e for e in entries if e[0].endswith("all_gather")]
        reduces = [e for e in entries if not e[0].endswith("all_gather")]
        exposed = (gathers[0][2] if gathers else 0) + (reduces[0][2] if reduces else 0)
        return max(0.0, 1.0 - exposed / total)

    def plan_counts(self) -> Dict[str, Dict[str, int]]:
        """:meth:`comm_plan_entries` summed by op: the ``comm.counters()``
        one micro-batch adds."""
        out: Dict[str, Dict[str, int]] = {}
        for op, calls, nbytes, *_ in self.comm_plan_entries():
            c = out.setdefault(op, {"calls": 0, "bytes": 0})
            c["calls"] += calls
            c["bytes"] += nbytes
        return out

    # -- collectives ----------------------------------------------------
    def _bucket_of(self, slot) -> Tuple[str, int, int]:
        """``(where, start, stop)`` of a leaf slot's bucket."""
        path = self.paths[slot[0]]
        top = path.split(".")[0]
        return ("head" if top in _HEAD_KEYS else top, slot[1], slot[2])

    def _reduce(self, g: torch.Tensor, slot, region, kind: str) -> None:
        """Stage one leaf's bucket grad; once its bucket's last grad has
        landed, issue the bucket's reductions together (one batch a kind:
        the reduce-scatters, then the sums).  Their results are added into
        the accumulator regions two buckets later or by :meth:`finish`."""
        key = self._bucket_of(slot)
        staged = self._staged.setdefault(key, [])
        staged.append((g.to(self.compute_dtype).contiguous(), slot, region, kind))
        if len(staged) == len(self._leaves[key[0]]):
            self._issue_reductions(self._staged.pop(key))

    def _issue_reductions(self, staged) -> None:
        while len(self._pending) >= self._window:
            self._complete(self._pending.pop(0))
        scatter = [x for x in staged if x[3] != "sum"]
        sums = [x for x in staged if x[3] == "sum"]
        if scatter and self.qcomm.reduce_scatter:
            from deepspeed_tpu_torch.comm.collectives_q import q_reduce_scatter_dim

            pends = [_Done(q_reduce_scatter_dim(g, self.groups["fsdp"],
                                                self.plan[slot[0]].pdim,
                                                block=self.qcomm.block, record=False))
                     for g, slot, _, _ in scatter]
        elif scatter:
            with comm.coalescing(self.groups["fsdp"]):
                pends = [comm.reduce_scatter(g, self.groups["fsdp"],
                                             self.plan[slot[0]].pdim, async_op=True)
                         for g, slot, _, _ in scatter]
        if scatter:
            if self.sizes.get("dp", 1) > 1:
                # the rest of the data axes: the shards summed over dp
                shards = [p.wait() for p in pends]
                with comm.coalescing(self.groups["dp"]):
                    pends = [comm.all_reduce(t, self.groups["dp"], async_op=True)
                             for t in shards]
            self._pending.extend((p, x[2]) for p, x in zip(pends, scatter))
        if sums:
            with comm.coalescing(self.groups["data"]):
                # reduced in place: a copy, since autograd may hand the same
                # tensor to another input (an add's two operands)
                pends = [comm.all_reduce(g.clone(), self.groups["data"], async_op=True)
                         for g, _, _, _ in sums]
            self._pending.extend((p, x[2]) for p, x in zip(pends, sums))

    @staticmethod
    def _complete(item) -> None:
        pend, region = item
        with torch.no_grad():
            region.add_(pend.wait())

    def finish(self) -> None:
        """Issue what the backward left staged (a bucket with a leaf that
        took no grad), then wait for every reduction and add each into its
        accumulator region, in issue order (the backward completes the
        oldest as it goes, past two buckets' worth in flight)."""
        staged, self._staged = self._staged, {}
        for item in staged.values():
            self._issue_reductions(item)
        pending, self._pending = self._pending, []
        for item in pending:
            self._complete(item)

    # -- the bucketed forward ---------------------------------------------
    def _inputs(self, where: str, b0: int = 0, b1: int = 0):
        """The grad-carrying inputs of a bucket's leaves (a shard, or the
        whole compute copy; sliced to ``[b0, b1)`` for a stacked leaf) and
        the accumulator regions their reductions land in."""
        ins, regions = [], []
        for leaf in self._leaves[where]:
            i = leaf.index
            src = self._master[i] if leaf.kind == "gather" else self._compute[i]
            acc = self._acc[i]
            if leaf.stacked:
                src, acc = src[b0:b1], acc[b0:b1]
            ins.append(src.detach().requires_grad_())
            regions.append(acc)
        return ins, regions

    def _ahead(self, where: str, b0: int = 0, b1: int = 0) -> Dict:
        """Issue the gathers of a bucket together (the compute-dtype casts of
        its shards): ``slot -> Pending``."""
        leaves = [leaf for leaf in self._leaves[where] if leaf.kind == "gather"]
        if not leaves:
            return {}
        out = {}
        srcs = []
        for leaf in leaves:
            src = self._master[leaf.index]
            src = src[b0:b1] if leaf.stacked else src
            srcs.append(src.detach().to(self.compute_dtype))
        if self.qcomm.all_gather:
            from deepspeed_tpu_torch.ops.kernels.comm_quant import quantize_blockwise

            codes = [quantize_blockwise(x.contiguous(), self.qcomm.block) for x in srcs]
            with comm.coalescing(self.groups["fsdp"]):
                qp = [comm.all_gather(q[0], self.groups["fsdp"], tiled=False,
                                      async_op=True) for q, _ in codes]
            with comm.coalescing(self.groups["fsdp"]):
                sp = [comm.all_gather(sc[0], self.groups["fsdp"], tiled=False,
                                      async_op=True) for _, sc in codes]
            for leaf, x, qpend, spend in zip(leaves, srcs, qp, sp):
                out[(leaf.index, b0, b1)] = _QGather(
                    qpend, spend, x.shape, self.plan[leaf.index].pdim, self.compute_dtype)
            return out
        with comm.coalescing(self.groups["fsdp"]):
            for leaf, x in zip(leaves, srcs):
                out[(leaf.index, b0, b1)] = comm.all_gather(
                    x, self.groups["fsdp"], gather_dim=self.plan[leaf.index].pdim,
                    async_op=True)
        return out

    def _open(self, bctx: _Ctx, where: str, ins, regions, b0=0, b1=0):
        """The bucket's full compute tensors, through its autograd
        functions, as ``path -> tensor``.  Its gathers were issued ahead,
        except in a remat recompute, which issues them here."""
        if not bctx.ahead:
            bctx.ahead = self._ahead(where, b0, b1)
        out = {}
        for leaf, x, region in zip(self._leaves[where], ins, regions):
            slot = (leaf.index, b0, b1)
            if leaf.kind == "gather":
                full = _GatherReduceScatter.apply(x, bctx, slot, region)
            else:
                full = _ReduceOnGrad.apply(x, bctx, slot, region, leaf.kind)
            out[self.paths[leaf.index]] = full
        return out

    @staticmethod
    def _nest(flat: Dict[str, torch.Tensor], strip: str = ""):
        tree: Dict[str, Any] = {}
        for path, t in flat.items():
            keys = path.split(".")
            if strip:
                keys = keys[1:]
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t
        return tree

    def loss(self, master: List[torch.Tensor], compute: List[Any],
             grad_acc: List[torch.Tensor], tokens, labels, mask, rng,
             ce_weight=None) -> torch.Tensor:
        """The micro-batch's loss through the buckets, its graph built so
        that the backward reduces a bucket at a time (call :meth:`finish`
        after the backward).  ``master``: the engine's masters (shards at
        stage 3), ``compute``: its whole compute-dtype copies (None for a
        sharded leaf), ``grad_acc``: its accumulators."""
        from deepspeed_tpu_torch.utils import prng

        self._master, self._compute, self._acc = master, compute, grad_acc
        seg = self.seg
        S = int(tokens.shape[1])
        keys = (prng.split(rng, self.L) if self.dropout > 0 and rng is not None
                else [None] * self.L)
        body = (self.layer_body(tokens.device) if self.layer_body is not None
                else (lambda lp, x, cos, sin, key: seg["layer_fwd"](lp, x, key, cos, sin)))

        embed_ctx = _Ctx(self, self._ahead("embed"))
        ahead = self._ahead("layers", *self.buckets[0]) if self.buckets else {}
        ins, regions = self._inputs("embed")
        embed_full = self._nest(self._open(embed_ctx, "embed", ins, regions), "embed")
        x = seg["embed_fwd"](embed_full, tokens)
        cos, sin = seg["rope"](S, x.dtype, x.device)
        aux_total = None
        layer_paths = [self.paths[leaf.index] for leaf in self._leaves["layers"]]
        for bi, (b0, b1) in enumerate(self.buckets):
            bctx = _Ctx(self, ahead)
            # the next bucket's gathers, issued once this bucket's input is
            # ready (its work queued), waited on when that bucket runs
            if bi + 1 < len(self.buckets):
                ahead = self._ahead("layers", *self.buckets[bi + 1])
            else:
                ahead = self._ahead("head")
            ins, regions = self._inputs("layers", b0, b1)

            def run(x_in, *shards, _b0=b0, _b1=b1, _ctx=bctx, _regions=regions,
                    _aux=aux_total):
                full = self._open(_ctx, "layers", shards, _regions, _b0, _b1)
                aux = _aux
                y = x_in
                for j in range(_b1 - _b0):
                    lp = self._nest({p: full[p][j] for p in layer_paths}, "layers")
                    y, a = body(lp, y, cos, sin, keys[_b0 + j])
                    if a is not None:
                        aux = a if aux is None else aux + a
                return y if aux is None else (y, aux)

            if self.remat:
                out = checkpoint(run, x, *ins, use_reentrant=False)
            else:
                out = run(x, *ins)
            x, aux_total = (out, aux_total) if torch.is_tensor(out) else out
        head_ctx = _Ctx(self, ahead)
        ins, regions = self._inputs("head")
        head_full = self._open(head_ctx, "head", ins, regions)
        head_tree = {"final_norm": self._nest({p: t for p, t in head_full.items()
                                               if p.startswith("final_norm")},
                                              "final_norm"),
                     "head": embed_full["tok"] if self.tied else head_full["lm_head"]}
        if "lm_head_bias" in head_full:
            head_tree["head_bias"] = head_full["lm_head_bias"]
        loss = seg["head_loss"](head_tree, x, labels, mask)
        if ce_weight is not None:
            loss = loss * ce_weight
        if self.moe_coef and aux_total is not None:
            loss = loss + self.moe_coef * aux_total
        return loss
