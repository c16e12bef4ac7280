"""Async file I/O over ``csrc/ds_aio.cpp`` (counterpart of
``deepspeed_tpu/ops/aio``).

:class:`aio_handle` mirrors the reference handle API: ``async_pread`` /
``async_pwrite`` submit (split into ``block_size`` requests for the worker
threads), ``wait()`` drains and returns the number of failed requests
(0 = all done).  Buffers are contiguous CPU tensors, passed by
``data_ptr()``; the handle keeps each one alive until the ``wait()`` that
covers it.  The library builds at the first handle; a failed build raises.
"""

from __future__ import annotations

from typing import List

import torch

from deepspeed_tpu_torch.ops.op_builder import AsyncIOBuilder


def _host_buffer(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"aio buffers are contiguous CPU tensors, got "
                         f"{'a strided view' if t.device.type == 'cpu' else t.device}")
    return t


class aio_handle:
    """Handle over the native thread-pool async I/O engine."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 8,
                 single_submit: bool = False, overlap_events: bool = True,
                 num_threads: int = 4, use_direct: bool = False):
        self._lib = AsyncIOBuilder().load()
        self._h = self._lib.ds_aio_handle_new(
            block_size, queue_depth, int(single_submit), int(overlap_events),
            num_threads, int(use_direct))
        if not self._h:
            raise RuntimeError("failed to create aio handle")
        self._pending: List[torch.Tensor] = []

    def async_pwrite(self, buffer: torch.Tensor, path: str, offset: int = 0) -> None:
        buffer = _host_buffer(buffer)
        self._pending.append(buffer)
        self._lib.ds_aio_pwrite_async(self._h, path.encode(), buffer.data_ptr(),
                                      buffer.numel() * buffer.element_size(),
                                      offset)

    def async_pread(self, buffer: torch.Tensor, path: str, offset: int = 0) -> None:
        buffer = _host_buffer(buffer)
        self._pending.append(buffer)
        self._lib.ds_aio_pread_async(self._h, path.encode(), buffer.data_ptr(),
                                     buffer.numel() * buffer.element_size(),
                                     offset)

    def wait(self) -> int:
        rc = int(self._lib.ds_aio_wait(self._h))
        self._pending.clear()
        return rc

    def sync_pwrite(self, buffer: torch.Tensor, path: str, offset: int = 0) -> int:
        self.async_pwrite(buffer, path, offset)
        return self.wait()

    def sync_pread(self, buffer: torch.Tensor, path: str, offset: int = 0) -> int:
        self.async_pread(buffer, path, offset)
        return self.wait()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ds_aio_handle_free(h)
            self._h = None


__all__ = ["aio_handle", "AsyncIOBuilder"]
