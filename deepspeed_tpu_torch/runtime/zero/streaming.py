"""Host-to-card parameter streaming for ZeRO-Infinity (``offload_param``).

Counterpart of ``deepspeed_tpu/runtime/zero/streaming.py``.  The params
live in host memory in the compute dtype, one block a stacked ``[L, ...]``
leaf; :class:`ParamStreamer` moves one layer at a time to the card for the
streamed forward and backward (:mod:`.stream_grad`):

- **Persistent staging slots.** ``staging_slots`` device buffers of one
  layer's size, allocated once.  A layer's H2D is a copy into a free slot,
  each leaf of the layer one contiguous slice of its host block.
- **Prefetch.** :meth:`prefetch` starts layer ``i``'s copy now, so that it
  runs while the layer before computes; :meth:`take` finding it in flight
  counts a hit, else it starts the copy itself and counts a miss.  The
  transport never changes the numbers: prefetch on and off give the same
  bits.
- **Events.** On the card every copy runs on a side stream and records an
  event; :meth:`take` makes the compute stream wait for it (the host never
  blocks).  :meth:`release` records an event on the compute stream once
  every segment that reads the slot has been issued; the slot is handed out
  again only to a copy that waits for that event (``reuse_log`` keeps one
  entry a reuse, with the two events, so that :meth:`reuse_gaps_ms` can
  show each copy started after its slot's readers finished).
- **int8.** With ``int8`` each layer and the embed / head trees cross as
  the blockwise int8 codes and fp32 scales of :mod:`~deepspeed_tpu_torch.
  comm.quant` (``quantize_tree_np``'s layout: one ``[nb, block]`` code
  array and one ``[nb, 1]`` scale array a leaf), quantized on the host once
  a binding (:meth:`refresh`), and :meth:`materialize` dequantizes them on
  the card in plain torch (``q.float() * scale``, cut to the leaf's size,
  cast to its dtype), as the JAX package's plain-jnp stage does.

The counters are plain attributes, under the JAX metric names' meaning:
``h2d_bytes`` and ``d2h_bytes`` (``ds_offload_relay_bytes_total{dir}``),
``prefetch_hits`` / ``prefetch_misses`` (``ds_offload_prefetch_*``) and
the stall of each :meth:`take` (``ds_offload_relay_seconds``): on the card
the time the compute stream waited for the copy, read from timing events
by :meth:`stall_seconds` after a synchronize; 0 on the CPU.  On the card
:meth:`copy_seconds` reads the layer copies' own device time too.

On the CPU every copy is a plain copy into the same slots, in order, and
the numbers are the card's.  The host blocks themselves belong to the
engine, which page-locks them on the card (``runtime/zero/relay.py``'s
``PinnedBlock``) and must call :meth:`quiesce` before it rewrites them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm.quant import DEFAULT_BLOCK, quantize_blockwise_np

_ALIGN = 256


def tree_leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs of a nested dict, keys sorted (the JAX tree's
    order)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(tree_leaves(tree[k], prefix + (k,)))
    return out


def tree_nest(pairs) -> Dict[str, Any]:
    """The inverse of :func:`tree_leaves`."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


class _Layout:
    """Where each leaf of one payload lies in a flat byte buffer: a list of
    ``(path, shape, dtype, offset)`` and the total bytes."""

    def __init__(self, specs):
        self.items = []
        off = 0
        for path, shape, dtype in specs:
            self.items.append((path, tuple(shape), dtype, off))
            off += _aligned(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize)
        self.nbytes = off

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for _, shape, dtype, off in self.items:
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            out.append(buf[off:off + n].view(dtype).view(shape))
        return out

    def payload_bytes(self) -> int:
        return sum(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                   for _, shape, dtype, _ in self.items)


def _quantize(t: torch.Tensor, block: int):
    """One leaf's (q int8 [nb, block], scale fp32 [nb, 1]) as CPU tensors,
    from its values in fp32 (the JAX ``quantize_tree_np``)."""
    q, s = quantize_blockwise_np(t.detach().to("cpu", torch.float32).numpy(), block)
    return torch.from_numpy(q), torch.from_numpy(s)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    n = int(np.prod(shape, dtype=np.int64))
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(shape).to(dtype)


class ParamStreamer:
    """Per-layer H2D transport over a stacked host tree (each leaf
    ``[L, ...]`` in host memory).  :meth:`refresh` (re)binds the source:
    once when the engine is built and after every change of the host copy
    (the int8 mode requantizes there)."""

    def __init__(self, device, *, int8: bool = False,
                 quant_block: int = DEFAULT_BLOCK, prefetch: bool = True,
                 staging_slots: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.int8 = bool(int8)
        self.quant_block = int(quant_block)
        self.prefetch_enabled = bool(prefetch)
        self.staging_slots = max(1, int(staging_slots))
        self.num_layers = 0
        # counters (the JAX metric names' meaning)
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.takes = 0
        self._stall_marks: List[Tuple[Any, Any]] = []
        self._copy_marks: List[Tuple[Any, Any]] = []    # each layer copy's span
        # one entry a reuse of a slot: (slot, layer it served, layer it now
        # takes, its readers' event, the copy's start event); events on the
        # card only
        self.reuse_log: List[tuple] = []
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._leaves: List[torch.Tensor] = []         # stacked host leaves
        self._paths: List[Tuple[str, ...]] = []
        self._layout: Optional[_Layout] = None
        self._q: Optional[List[List[torch.Tensor]]] = None   # int8: per layer
        self._slots: Optional[List[torch.Tensor]] = None
        self._state: List[Any] = []       # None (free), ("inflight", i), ("held", i)
        self._free_event: List[Any] = []
        self._served: List[int] = []
        self._ready: Dict[int, Any] = {}  # layer -> its copy's event
        self._slot_of: Dict[int, int] = {}
        self._next = 0
        self._aux: Dict[str, Tuple[Any, List, List]] = {}

    # ------------------------------------------------------------------
    # the host source
    # ------------------------------------------------------------------
    def refresh(self, layers: Dict[str, Any]) -> None:
        """(Re)bind the stacked host tree ``layers``.  Under int8 each layer
        is quantized here, host work paid once a binding (an optimizer step
        or a load), not once a micro-batch.  Nothing may be in flight."""
        self.quiesce()
        pairs = tree_leaves(layers)
        self._paths = [p for p, _ in pairs]
        self._leaves = [t for _, t in pairs]
        self.num_layers = int(self._leaves[0].shape[0])
        if self.int8:
            nb = [-(-int(np.prod(t.shape[1:], dtype=np.int64)) // self.quant_block)
                  for t in self._leaves]
            specs = []
            for path, n in zip(self._paths, nb):
                specs.append((path + ("q",), (n, self.quant_block), torch.int8))
                specs.append((path + ("scale",), (n, 1), torch.float32))
            layout = _Layout(specs)
            self._q = []
            for i in range(self.num_layers):
                layer = []
                for t in self._leaves:
                    layer.extend(_quantize(t[i], self.quant_block))
                self._q.append(layer)
        else:
            layout = _Layout([(p, t.shape[1:], t.dtype)
                              for p, t in zip(self._paths, self._leaves)])
        if self._layout is None or layout.nbytes != self._layout.nbytes:
            self._slots = None
        self._state = [None] * len(self._state)
        self._layout = layout
        self._ready.clear()
        self._slot_of.clear()

    def layer_payload_bytes(self) -> int:
        """The bytes one layer's H2D moves."""
        return self._layout.payload_bytes()

    def slot_bytes(self) -> int:
        """Device bytes the staging slots hold."""
        return 0 if self._layout is None else self.staging_slots * self._layout.nbytes

    def _alloc_slots(self) -> None:
        if self._slots is not None:
            return
        n = self.staging_slots
        self._slots = [torch.empty(self._layout.nbytes, dtype=torch.uint8,
                                   device=self.device) for _ in range(n)]
        self._state = [None] * n
        self._free_event = [None] * n
        self._served = [-1] * n
        self._next = 0

    def _host_parts(self, i: int) -> List[torch.Tensor]:
        if self.int8:
            return self._q[i]
        return [t[i] for t in self._leaves]

    # ------------------------------------------------------------------
    # transport
    # ------------------------------------------------------------------
    def _acquire(self) -> Optional[int]:
        """The next free slot in turn, or None."""
        self._alloc_slots()
        n = len(self._slots)
        for k in range(n):
            s = (self._next + k) % n
            if self._state[s] is None:
                self._next = (s + 1) % n
                return s
        return None

    def _dispatch(self, i: int, slot: int) -> None:
        views = self._layout.views(self._slots[slot])
        parts = self._host_parts(i)
        start = None
        if self.cuda:
            side = self._stream
            with torch.cuda.stream(side):
                if self._free_event[slot] is not None:
                    side.wait_event(self._free_event[slot])
                start = torch.cuda.Event(enable_timing=True)
                start.record(side)
                for dst, src in zip(views, parts):
                    dst.copy_(src, non_blocking=True)
                ready = torch.cuda.Event(enable_timing=True)
                ready.record(side)
            self._ready[i] = ready
            self._copy_marks.append((start, ready))
        else:
            for dst, src in zip(views, parts):
                dst.copy_(src)
        if self._served[slot] >= 0:
            self.reuse_log.append((slot, self._served[slot], i,
                                   self._free_event[slot], start))
        self._served[slot] = i
        self._state[slot] = ("inflight", i)
        self._slot_of[i] = slot
        self.h2d_bytes += self._layout.payload_bytes()

    def prefetch(self, i: int) -> None:
        """Start layer ``i``'s H2D now (nothing when it is in flight, when
        prefetch is off, or when no slot is free)."""
        if not self.prefetch_enabled or i in self._slot_of:
            return
        slot = self._acquire()
        if slot is not None:
            self._dispatch(i, slot)

    def take(self, i: int) -> Dict[str, Any]:
        """Layer ``i``'s payload on the card (a tree of views into its
        slot), the compute stream ordered after its copy; a hit when it was
        already in flight.  The slot is held until :meth:`release`."""
        hit = i in self._slot_of
        if not hit:
            slot = self._acquire()
            if slot is None:
                raise RuntimeError(
                    f"offload_param: no free staging slot for layer {i} "
                    f"({self.staging_slots} slots, all held)")
            self._dispatch(i, slot)
        slot = self._slot_of.pop(i)
        self._state[slot] = ("held", i)
        self.takes += 1
        if hit:
            self.prefetch_hits += 1
        else:
            self.prefetch_misses += 1
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            before.record(cur)
            cur.wait_event(self._ready.pop(i))
            after.record(cur)
            self._stall_marks.append((before, after))
        views = self._layout.views(self._slots[slot])
        payload = tree_nest(zip([it[0] for it in self._layout.items], views))
        payload["_slot"] = slot
        return payload

    def release(self, payload: Dict[str, Any]) -> None:
        """Every segment that reads ``payload`` has been issued: its slot is
        free once the compute stream reaches this point."""
        slot = payload["_slot"]
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self._free_event[slot] = ev
        self._state[slot] = None

    def drop_inflight(self) -> None:
        """Forget queued prefetches (the backward walks the layers in
        reverse: a forward prefetch nobody takes would hold a slot).  A
        later copy into such a slot runs after the dropped one on the same
        stream."""
        for i, slot in list(self._slot_of.items()):
            self._state[slot] = None
            self._ready.pop(i, None)
        self._slot_of.clear()

    def quiesce(self) -> None:
        """Wait until no H2D reads the host copy (before it is rewritten):
        the slots' copies on the side stream and the embed / head copies on
        the compute stream."""
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # the embed and head trees
    # ------------------------------------------------------------------
    def put_aux(self, name: str, tree: Dict[str, Any], src_key=None) -> Dict[str, Any]:
        """A non-layer tree (embed, head) on the card through the same
        codec: dense, a copy of each leaf; int8, its codes and scales,
        quantized once a ``src_key`` (the binding's generation)."""
        pairs = tree_leaves(tree)
        if not self.int8:
            out = [(p, t.to(self.device, non_blocking=True)) for p, t in pairs]
            self.h2d_bytes += sum(t.numel() * t.element_size() for _, t in pairs)
            return tree_nest(out)
        cached = self._aux.get(name)
        if cached is None or cached[0] != src_key:
            codes = [_quantize(t, self.quant_block) for _, t in pairs]
            spec = [(p, tuple(t.shape), t.dtype) for p, t in pairs]
            self._aux[name] = cached = (src_key, codes, spec)
        _, codes, spec = cached
        self.h2d_bytes += sum(q.numel() + 4 * s.numel() for q, s in codes)
        return {"codes": [(q.to(self.device, non_blocking=True),
                           s.to(self.device, non_blocking=True)) for q, s in codes],
                "spec": spec}

    def materialize_aux(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """A :meth:`put_aux` payload as its compute tree (the int8 dequant;
        a dense payload is the tree itself)."""
        if not self.int8:
            return payload
        return tree_nest((p, _dequantize(q, s, shape, dtype))
                         for (q, s), (p, shape, dtype) in zip(payload["codes"],
                                                              payload["spec"]))

    def materialize(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """A layer payload as its compute tree: the int8 dequant on the card
        (each leaf in its host dtype), or the slot's views themselves."""
        tree = {k: v for k, v in payload.items() if k != "_slot"}
        if not self.int8:
            return tree
        out = []
        for path, t in zip(self._paths, self._leaves):
            node = tree
            for k in path:
                node = node[k]
            out.append((path, _dequantize(node["q"], node["scale"], t.shape[1:],
                                          t.dtype)))
        return tree_nest(out)

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def record_d2h(self, nbytes: int) -> None:
        self.d2h_bytes += int(nbytes)

    def stall_seconds(self) -> float:
        """The compute stream's total wait for copies over every take so
        far (synchronizes the card)."""
        if not self._stall_marks:
            return 0.0
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in self._stall_marks) / 1e3

    def copy_seconds(self) -> float:
        """The device time of the layer copies so far, each from its start
        on the side stream to its landing (synchronizes the card)."""
        if not self._copy_marks:
            return 0.0
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in self._copy_marks) / 1e3

    def reuse_gaps_ms(self) -> List[float]:
        """For each slot reuse on the card, the ms from its readers' event
        to the start of the copy that reused it: never negative, since the
        copy waits for the event (synchronizes the card)."""
        torch.cuda.synchronize(self.device)
        return [free.elapsed_time(start) for _, _, _, free, start in self.reuse_log
                if free is not None and start is not None]

    def reset_counters(self) -> None:
        self.h2d_bytes = self.d2h_bytes = 0
        self.prefetch_hits = self.prefetch_misses = self.takes = 0
        self._stall_marks = []
        self._copy_marks = []
        self.reuse_log = []
