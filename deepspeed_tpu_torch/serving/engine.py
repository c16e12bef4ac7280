"""Continuous-batching serving engine, PyTorch port.

Counterpart of ``deepspeed_tpu/serving/engine.py`` ``ServingEngine``:

- the KV layout (``paged_kv_cache``): by default a paged KV pool shared by
  ``num_slots`` slots (``serving/paged_kv.py``), alloc-on-append,
  free-on-finish, LIFO preempt-and-requeue under pool pressure, and
  copy-on-write prefix caching (``serving/prefix_cache.py``); or the
  fixed-slot layout, one contiguous ``[L, num_slots, Hkv, cache_len, Dh]``
  cache (``cache_len`` the budget rounded up to a flash-decode block
  multiple), a slot's row reserved whole from admission to finish, with no
  pool, no preemption and no prefix cache (the JAX knob is paged-only);
- the KV cache in bf16/fp32 or, with ``quantize_kv_cache``, int8 with an
  fp32 scale per position and head, on either layout (decoded on the
  unfused loop, as in the JAX engine);
- per-row decode positions: every slot sits at its own depth;
- iteration-level scheduling: each :meth:`step` admits queued requests into
  freed slots, advances at most ``max_prefill_chunks`` prompt chunks, then
  decodes ``decode_block_tokens`` tokens for every slot;
- decode on the kernel-injected (fused) path by default: every decode
  micro-step runs :func:`~deepspeed_tpu_torch.models.fused_decode.
  decode_step` over the engine's ``_dparams`` (four fused kernel calls per
  layer); ``use_fused_decode=False``, or a model the fused path does not
  support, decodes with ``forward_with_cache`` on the plain tree.  Prefill
  always runs ``forward_with_cache`` on the plain tree: over a gathered
  view of the slot's pages (paged) or straight on the slot's row of the
  contiguous cache (fixed-slot);
- sync-free decode: the per-slot last token, position and active mask live
  on the device and are carried from block to block, with EOS folded into
  the step (a row stops the step its EOS is sampled).  The host keeps an
  upper-bound view of the positions for scheduling and learns of EOS from
  a deferred drain one block behind the dispatch; no-EOS requests fetch
  their tokens only when they finish.

The JAX engine runs a compiled program per prefill bucket and one per
decode block; the port runs the same steps eagerly, on PyTorch's current
stream, and mutates the cache in place where the JAX programs donate it.

Not ported yet (ROADMAP.md queue 1): the KV host tier, HTTP, metrics,
drain, the background serve loop, disaggregated handoff, profiling and
goodput.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine, pow2_bucket
from deepspeed_tpu_torch.models.decoding import (cache_planes,
                                                 forward_with_cache,
                                                 init_kv_cache, sample_token)
from deepspeed_tpu_torch.models.fused_decode import decode_step
from deepspeed_tpu_torch.serving.paged_kv import PagedKVPool, init_paged_kv_cache
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.scheduler import (PREFILLING, RUNNING,
                                                   IterationScheduler, Request)

logger = logging.getLogger(__name__)


class ServingEngine:
    """Continuous-batching serving over an :class:`InferenceEngine`'s
    weights.

    ``model``/``config``/``params``/``device`` as for the inference engine
    (``device=None`` is the CUDA card; it raises when there is none).
    ``num_slots``, ``prefill_chunk`` and ``decode_block_tokens`` default to
    the config's values.
    """

    def __init__(self, model, config=None, *, num_slots: int = 0,
                 prefill_chunk: int = 0, decode_block_tokens: int = 0,
                 params: Any = None, device: DeviceLike = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0):
        if not isinstance(config, DeepSpeedInferenceConfig):
            config = DeepSpeedInferenceConfig(**(config or {}))
        engine = InferenceEngine(model, config, params=params, device=device)
        self.engine = engine
        self.module = engine.module
        self.device = engine.device
        self._config = engine.config
        self.num_slots = int(num_slots or self._config.num_slots)
        self.prefill_chunk = int(prefill_chunk or self._config.prefill_chunk)
        self._K = int(decode_block_tokens or self._config.decode_block_tokens
                      or max(1, self._config.decode_unroll))
        self.max_prefill_chunks = max(1, int(self._config.max_prefill_chunks))
        self._sample = dict(do_sample=bool(do_sample),
                            temperature=float(temperature), top_k=int(top_k),
                            top_p=float(top_p))
        if int(self._config.kv_host_tier_pages) > 0:
            raise NotImplementedError(
                "the KV host tier (kv_host_tier_pages > 0) is not ported yet "
                "(ROADMAP.md queue 1: serving features deferred from the "
                "first slice)")
        self.scheduler = IterationScheduler(
            self.num_slots, max_queue_depth=int(self._config.max_queue_depth),
            shed_retry_after_s=float(self._config.shed_retry_after_s))
        self.paged = bool(self._config.paged_kv_cache)
        quant_kv = bool(self._config.quantize_kv_cache)
        if self.paged:
            self.pool = PagedKVPool(self.num_slots,
                                    self._config.max_out_tokens,
                                    page_tokens=self._config.kv_page_tokens,
                                    pool_tokens=self._config.kv_pool_tokens)
            self._cache = init_paged_kv_cache(
                self.module.config, self.pool.num_pages, self.pool.page,
                dtype=engine.dtype, device=self.device, quantized=quant_kv)
            # the per-slot LOGICAL window (page-table depth x page)
            self.cache_len = self.pool.cache_len
        else:
            self.pool = None
            self._cache = init_kv_cache(
                self.module.config, self.num_slots,
                self._config.max_out_tokens, dtype=engine.dtype,
                device=self.device, quantized=quant_kv)
            # the PHYSICAL depth (rounded up to a flash-decode block multiple)
            self.cache_len = int(self._cache["k"].shape[-2])
        # copy-on-write prefix caching shares pages: paged only
        self.prefix_cache = (PrefixCache(self.pool)
                             if self.paged and self._config.prefix_caching
                             else None)
        # generation bounds use the LOGICAL budget, not the page-rounded one
        self.max_out = int(self._config.max_out_tokens)
        mcfg = self.module.config
        if mcfg.position == "learned":
            # learned positions bound the context: no token is generated at a
            # position the table does not hold (a KV window larger than the
            # table is served, as the JAX engine serves it; the rows a padded
            # chunk or a parked slot reads past the table are clamped in
            # forward_with_cache / decode_step and attended by no query)
            self.max_out = min(self.max_out, int(mcfg.max_seq_len))
        # host SCHEDULE view of per-slot state; for EOS rows an upper bound
        # of the device carries (the device may stop a row early)
        self._pos = np.zeros(self.num_slots, np.int64)
        self._active = np.zeros(self.num_slots, bool)
        self._limit = np.zeros(self.num_slots, np.int64)
        self._eos = np.full(self.num_slots, -1, np.int64)
        self._drained_pos = np.zeros(self.num_slots, np.int64)
        # device decode state, carried from block to block
        self._last_dev = torch.zeros(self.num_slots, dtype=torch.long,
                                     device=self.device)
        self._pos_dev = torch.zeros(self.num_slots, dtype=torch.long,
                                    device=self.device)
        self._act_dev = torch.zeros(self.num_slots, dtype=torch.bool,
                                    device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(self._config.seed) + 1)
        # deferred token blocks: device [K, B] tensors kept un-fetched until
        # scheduling needs their values (refcounted per consumer)
        self._blocks: Dict[int, torch.Tensor] = {}
        self._block_valid: Dict[int, torch.Tensor] = {}
        self._block_np: Dict[int, tuple] = {}
        self._block_refs: Dict[int, int] = {}
        self._outstanding = deque()   # [(idx, [EOS Request, ...])]
        self._drain_lag = 1
        self._next_block = 0
        self.steps = 0
        # cumulative counters (what the JAX engine exports as metrics)
        self.stats = {"prefill_chunks": 0, "prefill_tokens": 0,
                      "decode_blocks": 0, "decode_tokens": 0,
                      "prefix_hit_tokens": 0, "prefix_miss_tokens": 0,
                      "preempted": 0, "cow_copies": 0}
        layout = (f"paged pool: {self.pool.num_pages - 1} x {self.pool.page}"
                  f"-token pages, {self.num_slots} slots x {self.cache_len} "
                  f"window" if self.paged
                  else f"{self.num_slots} slots x {self.cache_len} tokens")
        logger.info("serving engine: %s%s, prefill_chunk=%d, decode_block=%d, "
                    "%s decode", layout, ", int8 KV" if quant_kv else "",
                    self.prefill_chunk, self._K,
                    "fused" if engine._dparams is not None else "unfused")

    # ------------------------------------------------------------------
    def set_params(self, params: Any) -> None:
        self.engine.set_params(params)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device: a
        copy through pinned memory, so later edits of ``a`` never reach it."""
        t = torch.from_numpy(np.array(a, dtype=np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 128,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request; returns the live Request handle (its
        ``output_tokens`` fill in as the scheduler serves it)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size > self.max_out:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the per-slot cache "
                f"budget max_out_tokens={self.max_out}")
        if deadline_s is None:
            cfg_dl = float(self._config.request_deadline_s)
            deadline_s = cfg_dl if cfg_dl > 0 else None
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_token_id=(-1 if eos_token_id is None
                                    else int(eos_token_id)))
        if deadline_s is not None:
            req.deadline = time.perf_counter() + float(deadline_s)
        return self.scheduler.submit(req)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[Request]:
        """One scheduler iteration: admit -> prefill chunk(s) -> decode
        block -> drain deferred finish events.  Returns the requests that
        finished during this iteration."""
        if self.engine._params is None:
            raise RuntimeError("no weights: set_params() first")
        done_before = len(self.scheduler.finished)
        for req in self.scheduler.admit():
            self._pos[req.slot] = 0
            self._active[req.slot] = False
            self._limit[req.slot] = 0
            if self.prefix_cache is not None:
                self._admit_prefix(req)
        for req in self.scheduler.prefilling()[: self.max_prefill_chunks]:
            self._prefill_one_chunk(req)
        if self._active.any():
            self._decode_block()
        elif self._outstanding:
            self._flush_outstanding()
        self.steps += 1
        return self.scheduler.finished[done_before:]

    def run(self) -> List[Request]:
        """Serve to empty; returns finished requests in completion order."""
        while self.scheduler.has_work:
            self.step()
        return self.scheduler.finished

    # ------------------------------------------------------------------
    def _admit_prefix(self, req: Request) -> None:
        """Adopt the longest cached prefix of the request's prefix into its
        page table (read-only, refcounted) and move the prefill frontier
        past it.  A partially matched boundary page — the page the request
        writes its first computed token into — is copied to a private page
        (copy-on-write).  At least one prefix token is always left to
        compute: the final chunk's logits feed first-token sampling."""
        prefix = req.prefix
        n = req.prefix_len
        page = self.pool.page
        nodes = self.prefix_cache.match_nodes(prefix)
        cap = n - 1
        want_full = min(len(nodes), cap // page)
        for node in nodes[:want_full]:
            self.pool.append_shared(req.slot, node.page)
        matched = want_full * page
        r = cap - matched if want_full < len(nodes) else 0
        if r:
            # allocate the private copy (evicting LRU cached pages under
            # light pressure); with nothing evictable, recompute the
            # boundary page instead of preempting anyone at admission
            boundary = nodes[want_full]
            ok = True
            while not self.pool.ensure(req.slot, matched + 1):
                if not self.prefix_cache.evict_lru():
                    ok = False
                    break
            if ok:
                # an eviction above may have freed the boundary's page and
                # handed it back as dst: a freed page's KV is intact until
                # rewritten, and dst == src needs no copy
                dst = int(self.pool.page_table[req.slot, want_full])
                self._cow_copy(dst, boundary.page)
                matched += r
        if matched <= 0:
            self.stats["prefix_miss_tokens"] += n
            return
        req.prefill_pos = matched
        req.prefix_hit_tokens += matched
        self.stats["prefix_hit_tokens"] += matched
        self.stats["prefix_miss_tokens"] += n - matched
        # the decode block's parked junk write for this row must land AT
        # the frontier (junk page or the private COW page), never inside a
        # shared page
        self._pos[req.slot] = matched
        self._pos_dev[req.slot] = matched

    def _cow_copy(self, dst: int, src: int) -> None:
        """Device-side page copy: physical page ``src`` over ``dst`` in
        every layer of every plane (K, V and an int8 cache's scales)."""
        self.stats["cow_copies"] += 1
        if dst != src:
            for v in cache_planes(self._cache).values():
                v[:, dst] = v[:, src]

    # ------------------------------------------------------------------
    def _ensure_pages(self, req: Request, tokens: int) -> bool:
        """Allocate pages so ``req``'s slot covers ``tokens`` tokens.  Under
        pool pressure: drain deferred finish events, then evict refcount-0
        cached pages (LRU), then preempt the YOUNGEST-admitted occupant
        (possibly ``req`` itself: then False, and the caller skips this
        dispatch).  The oldest request always keeps its pages."""
        while not self.pool.ensure(req.slot, tokens):
            if self._outstanding:
                self._flush_outstanding()
                continue
            if self.prefix_cache is not None and self.prefix_cache.evict_lru():
                continue
            victim = self._youngest_victim()
            if victim is None:
                raise RuntimeError(
                    f"KV page pool exhausted with no preemptible slot "
                    f"(slot {req.slot} needs {tokens} tokens)")
            self._preempt(victim)
            if victim is req:
                return False
        return True

    def _youngest_victim(self) -> Optional[Request]:
        cands = self.scheduler.running() + self.scheduler.prefilling()
        return max(cands, key=lambda r: r.t_admit, default=None)

    def _park(self, b: int) -> None:
        self._active[b] = False
        self._pos[b] = 0
        self._pos_dev[b] = 0
        self._act_dev[b] = False

    def _preempt(self, victim: Request) -> None:
        """Reclaim every page the victim holds and send it back to the queue
        head; its produced tokens become part of the resume prefix."""
        self._flush_outstanding()
        if victim.state == RUNNING:
            self._materialize(victim)
        b = victim.slot
        self._park(b)
        self._limit[b] = 0
        self._eos[b] = -1
        if self.prefix_cache is not None:
            # cache the already-computed prompt pages before release, so the
            # resume (and anyone sharing the prompt) re-prefills through them
            full = min(victim.prefill_pos, victim.prompt_len) // self.pool.page
            if full:
                self.prefix_cache.insert(victim.prompt,
                                         self.pool.owned(b)[:full])
        self.pool.release(b)
        victim.preemptions += 1
        self.scheduler.requeue_front(victim)
        self.stats["preempted"] += 1

    # ------------------------------------------------------------------
    def _prefill_one_chunk(self, req: Request) -> None:
        if req.state != PREFILLING:      # preempted mid-iteration
            return
        slot, off = req.slot, req.prefill_pos
        prefix = req.prefix              # prompt (+ outputs after a resume)
        n_prefix = req.prefix_len
        c = min(self.prefill_chunk, n_prefix - off)
        if self.paged and not self._ensure_pages(req, off + c):
            return                       # self-preempted: resumes later
        cb = pow2_bucket(c, lo=8, cap=self.cache_len - off)
        chunk = np.zeros((1, cb), np.int64)
        chunk[0, :c] = prefix[off:off + c]
        tok_dev = self._prefill(slot, chunk, off, c - 1)
        req.prefill_pos += c
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += c
        # parked rows write junk at their own pos: keeping pos at the
        # frontier means the next chunk overwrites that row first
        self._pos[slot] = req.prefill_pos
        if req.prefill_pos < n_prefix:
            self._pos_dev[slot] = req.prefill_pos
            return
        if not req.t_first_token:
            req.t_first_token = time.perf_counter()
        S = n_prefix
        # the position bound is ABSOLUTE (invariant across preempt-resume)
        # and uses the LOGICAL max_out_tokens, as generate() does
        req_bound = req.prompt_len + req.max_new_tokens - 1
        limit = min(req_bound, self.max_out - 1)
        req.limit_reason = "length" if limit == req_bound else "cache_budget"
        if (req.eos_token_id >= 0
                or len(req.output_tokens) + 1 >= req.max_new_tokens
                or limit <= S):
            first = int(tok_dev)         # the once-per-request sync
            req.output_tokens.append(first)
            if req.eos_token_id >= 0 and first == req.eos_token_id:
                self._release(req, "eos")
                return
            if len(req.output_tokens) >= req.max_new_tokens:
                self._release(req, "length")
                return
            if limit <= S:
                self._release(req, req.limit_reason)
                return
        else:
            req.pending_blocks.append(("tok", tok_dev))
        req.state = RUNNING
        self._last_dev[slot] = tok_dev
        self._pos_dev[slot] = S
        self._act_dev[slot] = True
        self._pos[slot] = S
        self._drained_pos[slot] = S
        self._limit[slot] = limit
        self._eos[slot] = req.eos_token_id
        self._active[slot] = True

    def _prefill(self, slot: int, chunk: np.ndarray, start: int,
                 last_idx: int) -> torch.Tensor:
        """Per-slot chunked prefill: the batch-1 forward at the chunk's
        absolute offset over the slot's cache.  Paged: the slot's pages are
        GATHERED into a contiguous logical view and scattered back after;
        fixed-slot: the forward writes straight into the slot's row of the
        contiguous cache (a view of it, no copy).  Pad rows [start+c,
        start+cb) hold junk K/V that is overwritten before any query
        attends it; paged junk past the allocated pages lands on the junk
        page.  Returns the next token as a device scalar."""
        planes = cache_planes(self._cache)
        if not self.paged:
            sub = dict(self._cache, **{k: v[:, slot:slot + 1]
                                       for k, v in planes.items()})
            logits, _ = forward_with_cache(self.module, self.engine._params,
                                           self._to_device(chunk), sub, start)
            return sample_token(logits[:, last_idx], self._gen,
                                **self._sample)[0]
        pt = self._to_device(self.pool.page_table[slot])
        maxp, page = self.pool.slot_pages, self.pool.page
        sub = dict(self._cache)
        for k, v in planes.items():
            g = v[:, pt]                               # [L, maxp, Hkv, page, D]
            L, mp, Hkv, pg, D = g.shape
            sub[k] = g.permute(0, 2, 1, 3, 4).reshape(L, 1, Hkv, mp * pg, D)
        logits, sub = forward_with_cache(self.module, self.engine._params,
                                         self._to_device(chunk), sub, start)
        for k, v in planes.items():
            L, _, Hkv, _, D = sub[k].shape
            v[:, pt] = sub[k].reshape(L, Hkv, maxp, page, D).permute(
                0, 2, 1, 3, 4)
        last = logits[:, last_idx]
        return sample_token(last, self._gen, **self._sample)[0]

    # ------------------------------------------------------------------
    def _decode_block(self) -> None:
        """Dispatch one decode block and schedule its outputs: no-EOS rows
        emit exactly min(K, limit - pos) tokens and are released by position
        arithmetic (tokens fetched at finish); EOS rows are drain
        participants of this block, fetched one block later."""
        running = self.scheduler.running()
        if self.paged:
            for req in running:
                if req.state != RUNNING:     # preempted by an earlier ensure
                    continue
                b = req.slot
                n = int(min(self._K, self._limit[b] - self._pos[b]))
                if n > 0:
                    # rows [pos, pos+n); a False return means req itself
                    # was the youngest and self-preempted (filtered below)
                    self._ensure_pages(req, int(self._pos[b]) + n)
            running = [r for r in running if r.state == RUNNING]
            if not self._active.any():
                return
        toks, valid = self._block()
        idx = self._next_block
        self._next_block += 1
        self.stats["decode_blocks"] += 1
        refs = 0
        drainers: List[Request] = []
        for req in running:
            b = req.slot
            n = int(min(self._K, self._limit[b] - self._pos[b]))
            self._pos[b] += n
            self.stats["decode_tokens"] += n
            refs += 1
            if req.eos_token_id < 0:
                req.pending_blocks.append((idx, n))
            else:
                drainers.append(req)
            if self._pos[b] >= self._limit[b]:
                self._active[b] = False
        if refs:
            self._blocks[idx] = toks
            self._block_refs[idx] = refs
            if drainers:
                self._block_valid[idx] = valid
        if drainers:
            self._outstanding.append((idx, drainers))
            while len(self._outstanding) > self._drain_lag:
                self._drain_one()
        for req in running:              # finish AFTER refs registered
            if (req.eos_token_id < 0 and not self._active[req.slot]
                    and req.state == RUNNING):
                self._materialize(req)
                self._release(req, req.limit_reason)

    def _step(self, last, pos, page_table, max_pos):
        """One decode micro-step at per-row positions -> logits [B, V]: the
        fused ``decode_step`` over the injected view when the engine built
        one, else ``forward_with_cache`` on the plain tree."""
        dparams = self.engine._dparams
        if dparams is not None:
            logits, _ = decode_step(self.module.config, dparams, last[:, None],
                                    self._cache, pos, page_table=page_table)
            return logits
        logits, _ = forward_with_cache(self.module, self.engine._params,
                                       last[:, None], self._cache, pos,
                                       page_table, max_pos=max_pos)
        return logits[:, -1]

    def _block(self):
        """K decode micro-steps for all slots at their own positions, with
        the active mask and positions as device carries: a row goes inactive
        the step its EOS is sampled; parked rows still run (their writes
        land at their frozen position).  Returns device (toks, valid)
        [K, num_slots]."""
        limit = self._to_device(self._limit)
        eos = self._to_device(self._eos)
        page_table = (self._to_device(self.pool.page_table) if self.paged
                      else None)
        # host upper bound on every query position in this block: sizes the
        # flash-decode loop without reading positions back from the device
        max_pos = min(self.cache_len - 1, int(self._pos.max()) + self._K)
        last, pos, act = self._last_dev, self._pos_dev, self._act_dev
        toks, valids = [], []
        for _ in range(self._K):
            valid = act & (pos < limit)
            logits = self._step(last, pos, page_table, max_pos)
            nxt = sample_token(logits, self._gen, **self._sample)
            nxt = torch.where(valid, nxt, last)
            hit = valid & (eos >= 0) & (nxt == eos)
            act = act & ~hit
            pos = pos + valid.long()
            last = nxt
            toks.append(nxt)
            valids.append(valid)
        self._last_dev, self._pos_dev, self._act_dev = last, pos, act
        return torch.stack(toks), torch.stack(valids)

    # -- deferred finish-event drain -----------------------------------
    def _fetch_block(self, idx: int):
        """Device -> host fetch of one block's (toks, valid), memoized: all
        deferred output flows through here."""
        entry = self._block_np.get(idx)
        if entry is None:
            toks = self._blocks[idx].cpu().numpy()
            valid = (self._block_valid[idx].cpu().numpy()
                     if idx in self._block_valid else None)
            entry = self._block_np[idx] = (toks, valid)
        return entry

    def _unref(self, idx: int) -> None:
        self._block_refs[idx] -= 1
        if self._block_refs[idx] == 0:
            for d in (self._blocks, self._block_valid, self._block_np,
                      self._block_refs):
                d.pop(idx, None)

    def _drain_one(self) -> None:
        """Retire the oldest outstanding block: append each EOS
        participant's valid prefix and release rows whose finish the host
        could not predict."""
        idx, drainers = self._outstanding.popleft()
        toks, valid = self._fetch_block(idx)
        for req in drainers:
            b = req.slot
            if req.state != RUNNING:     # released at an earlier drain
                self._unref(idx)
                continue
            n = int(valid[:, b].sum())   # valid is monotone within a block
            req.output_tokens.extend(int(t) for t in toks[:n, b])
            self._drained_pos[b] += n
            self._unref(idx)
            if (n and req.eos_token_id >= 0
                    and req.output_tokens[-1] == req.eos_token_id):
                self._release(req, "eos")
            elif len(req.output_tokens) >= req.max_new_tokens:
                self._release(req, "length")
            elif self._drained_pos[b] >= self._limit[b]:
                self._release(req, req.limit_reason)

    def _flush_outstanding(self) -> None:
        while self._outstanding:
            self._drain_one()

    def _release(self, req: Request, reason: str) -> None:
        """Finish the request, park its slot at depth 0 and, paged, cache its
        full prompt pages and return its pages to the pool."""
        b = req.slot
        self._park(b)
        if self.prefix_cache is not None:
            # full PROMPT pages only (the boundary page mixes in generated
            # tokens), bounded by the prefill frontier
            full = min(req.prefill_pos, req.prompt_len) // self.pool.page
            if full:
                self.prefix_cache.insert(req.prompt,
                                         self.pool.owned(b)[:full])
        if self.paged:
            self.pool.release(b)
        req.finish_reason = reason
        self.scheduler.finish(req)

    def _materialize(self, req: Request) -> None:
        """Fetch this request's deferred tokens (the prefill-sampled first
        token, then its block refs) into ``output_tokens``, in order."""
        for entry in req.pending_blocks:
            if entry[0] == "tok":
                req.output_tokens.append(int(entry[1]))
                continue
            idx, n = entry
            toks, _ = self._fetch_block(idx)
            req.output_tokens.extend(int(t) for t in toks[:n, req.slot])
            self._unref(idx)
        req.pending_blocks.clear()

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Drop the device state (cache, carries, deferred blocks)."""
        self._cache = {}
        for d in (self._blocks, self._block_valid, self._block_np,
                  self._block_refs):
            d.clear()
        self._outstanding.clear()

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config
