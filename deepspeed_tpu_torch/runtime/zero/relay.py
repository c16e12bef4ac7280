"""The offload relay: the staging between the card and the host stepper.

One optimizer step of the offload path moves every gradient leaf D2H and
every updated param leaf H2D.  :class:`OffloadRelay` owns the host side of
both moves:

- **D2H.** :meth:`grads_to_host` puts every leaf's copy in flight at once,
  into one staging buffer a leaf, on a side stream that first waits for
  the compute stream, with one event a leaf.  :meth:`grad` waits for leaf
  ``i``'s event alone, so the host steps leaf ``i`` while ``i+1`` is still
  in flight.
- **H2D.** :meth:`out_buffer` hands out the buffers of a small rotating
  pool (sized to the largest leaf); :meth:`params_to_device` copies one
  into the card's param leaf without blocking, on the compute stream, and
  records an event on the buffer.  A buffer is handed out again only after
  its event has fired, so a later leaf never overwrites bytes still in
  flight.

On the card the staging is page-locked (so the copies are asynchronous
DMA): one exact-size host block for the grads and one for the H2D pool,
registered with ``cudaHostRegister`` and released with the relay (PyTorch's
caching host allocator would round each buffer up to a power of two and
keep it after the relay is gone).  Pinning happens only there, since a
CPU-only torch cannot pin.  On the CPU there is nothing to move:
:meth:`grad` is the gradient itself and :meth:`params_to_device` a plain
copy.  Only the staging is pinned, never the masters.

Timing: ``last`` holds the host seconds of the last step's parts (the
wait for the D2H, the H2D issue) and, on the card, events that
:meth:`device_ms` reads after a synchronize.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch


_ALIGN = 256


def _offsets(sizes: List[int], itemsize: int) -> List[int]:
    """Byte offsets of consecutive buffers, each aligned to 256 bytes."""
    out, off = [], 0
    for n in sizes:
        out.append(off)
        off += -(-n * itemsize // _ALIGN) * _ALIGN
    return out + [off]


class PinnedBlock:
    """One exact-size block of page-locked host memory: a plain CPU
    allocation registered with ``cudaHostRegister``, unregistered when the
    block goes away."""

    def __init__(self, nbytes: int):
        # zeroed first: the pages are touched by all of torch's threads, so
        # that registering them does not fault each one in alone
        self.buf = torch.zeros(max(nbytes, 1), dtype=torch.uint8)
        self._cudart = torch.cuda.cudart()
        torch.cuda.check_error(self._cudart.cudaHostRegister(
            self.buf.data_ptr(), self.buf.numel(), 0))
        self._registered = True

    def view(self, offset: int, n: int, dtype: torch.dtype) -> torch.Tensor:
        return self.buf[offset:offset + n * dtype.itemsize].view(dtype)

    def __del__(self):
        if getattr(self, "_registered", False):
            self._cudart.cudaHostUnregister(self.buf.data_ptr())
            self._registered = False


class OffloadRelay:
    def __init__(self, sizes: List[int], grad_dtype: torch.dtype,
                 out_dtype: torch.dtype, device: torch.device, n_out: int = 2):
        self.device = device
        self.cuda = device.type == "cuda"
        self.sizes = list(sizes)
        self.grad_dtype = grad_dtype
        self.out_dtype = out_dtype
        self._blocks: List[PinnedBlock] = []
        self._stage: Optional[List[torch.Tensor]] = None
        self._out: List[torch.Tensor] = []
        self._n_out = n_out
        self._out_events: List[Optional[torch.cuda.Event]] = [None] * n_out
        self._next = 0
        self._grad_events: List[torch.cuda.Event] = []
        self._inflight: List[torch.Tensor] = []
        self._stream = torch.cuda.Stream(device) if self.cuda else None
        # one entry a reuse of a pool buffer: (slot, leaf it served last,
        # whether its event had fired before the wait, and after it)
        self.reuse_log: List[tuple] = []
        self._served: List[int] = [-1] * n_out
        self._slot_of = 0
        self.last: Dict[str, float] = {}
        self._marks: Dict[str, torch.cuda.Event] = {}

    def pinned_bytes(self) -> int:
        """Host bytes of the staging (pinned on the card)."""
        top = max(self.sizes, default=0)
        return (_offsets(self.sizes, self.grad_dtype.itemsize)[-1]
                + _offsets([top] * self._n_out, self.out_dtype.itemsize)[-1])

    def _alloc(self) -> None:
        if self._stage is not None or not self.cuda:
            return
        offs = _offsets(self.sizes, self.grad_dtype.itemsize)
        self._blocks = [PinnedBlock(offs[-1])]
        self._stage = [self._blocks[0].view(o, n, self.grad_dtype)
                       for o, n in zip(offs, self.sizes)]
        top = max(self.sizes, default=0)
        offs = _offsets([top] * self._n_out, self.out_dtype.itemsize)
        self._blocks.append(PinnedBlock(offs[-1]))
        self._out = [self._blocks[1].view(o, top, self.out_dtype)
                     for o in offs[:-1]]

    def _mark(self, name: str, stream=None) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream or torch.cuda.current_stream(self.device))
        self._marks[name] = ev

    # -- D2H -------------------------------------------------------------
    def grads_to_host(self, grads: List[torch.Tensor]) -> None:
        """Start every leaf's D2H copy (``grads`` are the final, flat-able
        gradients in leaf order)."""
        self.last = {"d2h_wait_s": 0.0, "h2d_issue_s": 0.0}
        if not self.cuda:
            self._inflight = [g.reshape(-1) for g in grads]
            return
        self._alloc()
        self._marks = {}
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._grad_events = []
        self._inflight = list(grads)
        with torch.cuda.stream(self._stream):
            self._mark("d2h_start", self._stream)
            for g, st in zip(grads, self._stage):
                st.copy_(g.reshape(-1), non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._stream)
                self._grad_events.append(ev)
            self._mark("d2h_end", self._stream)

    def grad(self, i: int) -> torch.Tensor:
        """Leaf ``i``'s gradient on the host, once its copy has landed."""
        if not self.cuda:
            return self._inflight[i]
        t = time.perf_counter()
        self._grad_events[i].synchronize()
        self.last["d2h_wait_s"] += time.perf_counter() - t
        return self._stage[i]

    # -- H2D -------------------------------------------------------------
    def out_buffer(self, i: int) -> torch.Tensor:
        """A host buffer for leaf ``i``'s new params: the next of the pool,
        waited on until the copy that last read it has finished."""
        n = self.sizes[i]
        if not self.cuda:
            return torch.empty(n, dtype=self.out_dtype)
        slot = self._next
        self._next = (slot + 1) % self._n_out
        ev = self._out_events[slot]
        if ev is not None:
            fired = ev.query()
            t = time.perf_counter()
            ev.synchronize()
            self.last["h2d_wait_s"] = (self.last.get("h2d_wait_s", 0.0)
                                       + time.perf_counter() - t)
            self.reuse_log.append((slot, self._served[slot], fired, ev.query()))
        self._served[slot] = i
        self._slot_of = slot
        return self._out[slot][:n]

    def params_to_device(self, i: int, out: torch.Tensor,
                         dst: torch.Tensor) -> None:
        """Copy leaf ``i``'s new params (``out``, from :meth:`out_buffer`)
        into the card's leaf ``dst`` without blocking."""
        if not self.cuda:
            dst.view(-1).copy_(out)
            return
        t = time.perf_counter()
        if "h2d_start" not in self._marks:
            self._mark("h2d_start")
        dst.view(-1).copy_(out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._out_events[self._slot_of] = ev
        self.last["h2d_issue_s"] += time.perf_counter() - t

    def finish(self) -> None:
        """End of the step: the compute stream waits for the D2H stream
        (the accumulator it read is zeroed next), and the grads held for
        the copies are let go."""
        if self.cuda:
            self._mark("h2d_end")
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        self._inflight = []

    def device_ms(self) -> Dict[str, float]:
        """The last step's device spans in ms (D2H: first copy issued to
        last landed; H2D: first to last), after a synchronize."""
        m = self._marks
        if not self.cuda or "h2d_end" not in m:
            return {}
        torch.cuda.synchronize(self.device)
        out = {"d2h_ms": m["d2h_start"].elapsed_time(m["d2h_end"])}
        if "h2d_start" in m:
            out["h2d_ms"] = m["h2d_start"].elapsed_time(m["h2d_end"])
        return out
