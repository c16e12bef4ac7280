"""Request queue + iteration-level scheduler (Orca / DeepSpeed-FastGen
dynamic-batching role), PyTorch port.

A trimmed copy of ``deepspeed_tpu/serving/scheduler.py`` — pure host
bookkeeping, no tensors.  It owns the FIFO wait queue and the slot table;
the :class:`~deepspeed_tpu_torch.serving.engine.ServingEngine` drives it
one iteration at a time (admit -> prefill chunk -> decode block), so
requests join and leave the running batch at token granularity.  The
metrics, flight-recorder and tracer hooks of the JAX copy are not ported
yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

# process-global request ids: FIFO order per scheduler, unique across engines
_REQUEST_IDS = itertools.count()

QUEUED = "queued"          # waiting for a slot
PREFILLING = "prefilling"  # owns a slot; prompt partially in the KV cache
RUNNING = "running"        # decoding
FINISHED = "finished"


class QueueFull(RuntimeError):
    """Admission-control shed: the bounded wait queue is at its watermark,
    so this submit is refused instead of queued."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


@dataclass
class Request:
    """One generation request and its lifecycle bookkeeping."""

    prompt: np.ndarray                  # 1-D int token ids
    max_new_tokens: int
    request_id: int = -1
    eos_token_id: int = -1              # -1 = no EOS stop
    state: str = QUEUED
    slot: int = -1
    prefill_pos: int = 0                # prefix tokens already in the cache
    output_tokens: List[int] = field(default_factory=list)
    # deferred-output refs [(block_idx, n_tokens) | ("tok", device scalar)]:
    # no-EOS requests fetch their sampled tokens only at finish
    pending_blocks: List = field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    deadline: float = 0.0               # perf_counter deadline; 0 = none
    finish_reason: str = ""             # "eos" | "length" | "cache_budget" | ...
    limit_reason: str = ""              # which bound set the position limit
    preemptions: int = 0                # times preempted and requeued
    prefix_hit_tokens: int = 0          # prefill tokens served from the cache

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefix(self) -> np.ndarray:
        """Tokens that must be cache-resident before decoding (re)starts:
        the prompt, plus every output token already produced after a
        preempt-resume (re-prefilling them rebuilds the same KV state)."""
        if not self.output_tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.output_tokens, np.int32)])

    @property
    def prefix_len(self) -> int:
        return self.prompt_len + len(self.output_tokens)

    @property
    def done(self) -> bool:
        return self.state == FINISHED


class IterationScheduler:
    """FIFO admission over a fixed pool of KV-cache slots.

    ``submit`` enqueues; ``admit`` assigns every free slot to the oldest
    queued requests (once per engine iteration); ``finish`` frees the slot
    immediately so the next ``admit`` can reuse it.  Completion order is
    recorded in ``finished``.
    """

    def __init__(self, num_slots: int, max_queue_depth: int = 0,
                 shed_retry_after_s: float = 1.0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.max_queue_depth = int(max_queue_depth)
        self.shed_retry_after_s = float(shed_retry_after_s)
        self._queue: Deque[Request] = deque()
        self._slots: List[Optional[Request]] = [None] * num_slots
        self.finished: List[Request] = []

    # -- admission -----------------------------------------------------
    def submit(self, req: Request) -> Request:
        if self.max_queue_depth > 0 \
                and len(self._queue) >= self.max_queue_depth:
            raise QueueFull(
                f"admission queue full ({len(self._queue)} >= "
                f"max_queue_depth={self.max_queue_depth}); shedding",
                retry_after_s=self.shed_retry_after_s)
        if req.request_id < 0:
            req.request_id = next(_REQUEST_IDS)
        req.state = QUEUED
        req.t_submit = time.perf_counter()
        self._queue.append(req)
        return req

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def expire_deadlines(self, now: Optional[float] = None) -> List[Request]:
        """Cancel every QUEUED request whose deadline has passed (reason
        ``deadline``)."""
        now = time.perf_counter() if now is None else now
        out = []
        for req in [r for r in list(self._queue) if 0 < r.deadline < now]:
            try:
                self._queue.remove(req)
            except ValueError:
                continue
            req.state = FINISHED
            req.finish_reason = "deadline"
            req.t_finish = now
            out.append(req)
        return out

    def admit(self) -> List[Request]:
        """Assign free slots to the oldest queued requests (FIFO); returns
        the newly-admitted requests, now PREFILLING."""
        self.expire_deadlines()
        admitted = []
        for slot in self.free_slots():
            try:
                req = self._queue.popleft()
            except IndexError:
                break
            req.slot = slot
            req.state = PREFILLING
            req.prefill_pos = 0
            req.t_admit = time.perf_counter()
            self._slots[slot] = req
            admitted.append(req)
        return admitted

    # -- lifecycle -----------------------------------------------------
    def request_in(self, slot: int) -> Optional[Request]:
        return self._slots[slot]

    def prefilling(self) -> List[Request]:
        """Prefilling requests in admission (request id) order."""
        return sorted((r for r in self._slots
                       if r is not None and r.state == PREFILLING),
                      key=lambda r: r.request_id)

    def running(self) -> List[Request]:
        return [r for r in self._slots if r is not None and r.state == RUNNING]

    def finish(self, req: Request) -> None:
        """Mark finished and free the slot now."""
        if req.state == FINISHED:
            return
        req.state = FINISHED
        req.t_finish = time.perf_counter()
        if req.slot >= 0 and self._slots[req.slot] is req:
            self._slots[req.slot] = None
        self.finished.append(req)

    def cancel(self, req: Request) -> bool:
        """Withdraw a still-QUEUED request; False if it already left the
        queue."""
        if req.state != QUEUED:
            return False
        try:
            self._queue.remove(req)
        except ValueError:
            return False
        req.state = FINISHED
        req.finish_reason = "cancelled"
        req.t_finish = time.perf_counter()
        return True

    def requeue_front(self, req: Request) -> None:
        """Preempt-and-requeue: the request loses its slot and goes back to
        the HEAD of the wait queue."""
        if req.slot >= 0 and self._slots[req.slot] is req:
            self._slots[req.slot] = None
        req.slot = -1
        req.state = QUEUED
        req.prefill_pos = 0
        self._queue.appendleft(req)

    def drain_finished(self) -> List[Request]:
        """Return-and-clear the finished list (long-lived loops must call
        it, or ``finished`` grows without bound)."""
        out = self.finished
        self.finished = []
        return out

    # -- introspection -------------------------------------------------
    @property
    def num_queued(self) -> int:
        return len(self._queue)

    @property
    def num_occupied(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or self.num_occupied > 0
