"""Pipelined NVMe swapper for optimizer states (counterpart of
``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``).

- One state file per leaf, ``state_{i}.bin``: [master, *aux] fp32
  concatenated, the JAX package's bytes in its layout, so either package
  reads the other's files.
- Over data-parallel ranks each rank swaps in a directory of its own,
  ``rank{r}`` under the path (:func:`rank_swap_dir`).
- Read-ahead of leaf ``i+1`` while ``i`` is being stepped, and
  asynchronous write-back, over a rotating pool of 3 host buffers: one
  being stepped, one holding the read in flight, one that may still be
  draining a write.  Reads and writes run on separate aio handles, so
  waiting for the read does not also drain the write-backs.

A failed read or write raises (``RuntimeError`` naming the file); a swap
directory that cannot be created raises ``OSError``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.ops.aio import aio_handle


def rank_swap_dir(swap_dir: str, rank: Optional[int]) -> str:
    """A data-parallel rank's own directory under ``swap_dir`` (``rank{r}``),
    so that the ranks' ``state_{i}.bin`` never collide; ``swap_dir`` itself
    for a process without a group."""
    return swap_dir if rank is None else os.path.join(swap_dir, f"rank{rank}")


class OptimizerStateSwapper:
    def __init__(self, swap_dir: str, sizes: List[int], aio_config=None,
                 n_buffers: int = 3, n_slots: int = 3, rank: Optional[int] = None):
        swap_dir = rank_swap_dir(swap_dir, rank)
        os.makedirs(swap_dir, exist_ok=True)
        self.dir = swap_dir
        self.sizes = list(sizes)
        self.STATES = n_slots  # master + aux slots (adam: m, v)
        kw = {}
        if aio_config is not None:
            kw = dict(block_size=aio_config.block_size,
                      queue_depth=aio_config.queue_depth,
                      num_threads=aio_config.thread_count,
                      single_submit=aio_config.single_submit,
                      overlap_events=aio_config.overlap_events)
        self._read_h = aio_handle(**kw)
        self._write_h = aio_handle(**kw)
        max_elems = max(self.sizes) * self.STATES if self.sizes else 0
        self._buffers = [torch.empty(max_elems, dtype=torch.float32)
                         for _ in range(n_buffers)]
        self._buf_of: Dict[int, int] = {}   # leaf index -> buffer slot
        self._pending_read: Optional[int] = None
        self._writes_since_drain = 0
        # bytes moved and seconds waited, for the rate a caller reports
        self.read_bytes = 0
        self.write_bytes = 0

    def _path(self, i: int) -> str:
        return os.path.join(self.dir, f"state_{i}.bin")

    def _check(self, rc: int, op: str, i: Optional[int] = None) -> None:
        if rc != 0:
            where = self._path(i) if i is not None else self.dir
            raise RuntimeError(f"nvme {op} failed ({rc} requests) for {where}")

    def _claim_slot(self, i: int) -> int:
        slot = i % len(self._buffers)
        # the slot may still back an in-flight write of an earlier leaf:
        # drain the writes before reuse (at most every n_buffers leaves)
        if self._writes_since_drain:
            self._check(self._write_h.wait(), "write-back")
            self._writes_since_drain = 0
        self._buf_of[i] = slot
        return slot

    def _view(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        return buf[:self.sizes[i] * self.STATES]

    # -- init / sync paths --------------------------------------------------
    def initialize(self, i: int, master_flat: torch.Tensor) -> None:
        """Create the state file: master = given, moments = 0."""
        buf = torch.zeros(self.sizes[i] * self.STATES, dtype=torch.float32)
        buf[:self.sizes[i]] = master_flat.reshape(-1)
        self._check(self._write_h.sync_pwrite(buf, self._path(i)), "write", i)
        self.write_bytes += buf.numel() * 4

    def read_sync(self, i: int) -> torch.Tensor:
        buf = torch.empty(self.sizes[i] * self.STATES, dtype=torch.float32)
        self._check(self._read_h.sync_pread(buf, self._path(i)), "read", i)
        self.read_bytes += buf.numel() * 4
        return buf

    def write_sync(self, i: int, buf: torch.Tensor) -> None:
        view = buf.reshape(-1)[:self.sizes[i] * self.STATES].contiguous()
        self._check(self._write_h.sync_pwrite(view, self._path(i)), "write", i)
        self.write_bytes += view.numel() * 4

    # -- pipelined path ------------------------------------------------------
    def prefetch(self, i: int) -> None:
        """Submit the async read for leaf i (at most one in flight)."""
        if self._pending_read is not None:
            raise RuntimeError("one read-ahead at a time")
        slot = self._claim_slot(i)
        self._read_h.async_pread(self._view(self._buffers[slot], i), self._path(i))
        self._pending_read = i

    def wait_fetch(self, i: int) -> torch.Tensor:
        if self._pending_read != i:
            raise RuntimeError(f"leaf {i} was not prefetched")
        self._check(self._read_h.wait(), "read", i)
        self._pending_read = None
        self.read_bytes += self.sizes[i] * self.STATES * 4
        return self._view(self._buffers[self._buf_of[i]], i)

    def writeback(self, i: int, buf: torch.Tensor) -> None:
        """Async write-back of a stepped buffer (drained lazily)."""
        self._write_h.async_pwrite(self._view(buf, i), self._path(i))
        self._writes_since_drain += 1
        self.write_bytes += self.sizes[i] * self.STATES * 4

    def drain(self) -> None:
        rc = self._write_h.wait()
        self._writes_since_drain = 0
        self._check(rc, "write-back")
