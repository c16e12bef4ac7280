"""Continuous-batching serving layer, PyTorch port.

- :mod:`.scheduler` — request queue + iteration-level scheduler;
- :mod:`.paged_kv` — :class:`PagedKVPool`, the block allocator over one
  shared pool of KV token pages;
- :mod:`.prefix_cache` — :class:`PrefixCache`, copy-on-write prefix caching
  over the page pool;
- :mod:`.engine` — :class:`ServingEngine`, chunked prefill interleaved with
  per-row-position decode blocks.
"""

from deepspeed_tpu_torch.serving.scheduler import (FINISHED, PREFILLING, QUEUED,
                                                   RUNNING, IterationScheduler,
                                                   QueueFull, Request)
from deepspeed_tpu_torch.serving.paged_kv import PagedKVPool, init_paged_kv_cache
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.engine import ServingEngine

__all__ = ["Request", "IterationScheduler", "QueueFull", "ServingEngine",
           "PagedKVPool", "init_paged_kv_cache", "PrefixCache", "QUEUED",
           "PREFILLING", "RUNNING", "FINISHED"]
