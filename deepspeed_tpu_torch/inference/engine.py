"""Inference engine, PyTorch port.

Counterpart of ``deepspeed_tpu/inference/engine.py``: ``init_inference(model,
config)`` -> :class:`InferenceEngine` with ``generate()``.

- weights: the parameter tree cast to the serving dtype on the engine's
  device; ``dtype: "int8"`` quantizes the layer matmul weights and the head
  to int8 with per-column scales (``models/quant.py``) from their bf16
  values, one layer slice at a time, each slice moved to the device, cast
  and quantized before the next (the device never holds a bf16 copy of a
  quantized leaf); activations stay bf16.  The kernel-injected view
  (``_dparams``, QKV concatenated per layer) is built when the model
  supports the fused decode path, as in the JAX engine.
- the KV cache: one contiguous ``[L, B, Hkv, Smax, Dh]`` allocation whose
  batch and length are power-of-two buckets that never shrink, so mixed
  request sizes reuse it; a growth reallocation counts a rebind
  (``cache_rebinds``).  One spare row past the request's ``max_len`` keeps
  the JAX engine's cache sizing.  ``quantize_kv_cache`` makes it the int8
  cache (``models/decoding.py``): int8 K/V with an fp32 scale a position
  and head, decoded on the unfused loop as in the JAX engine.
- prefill on the plain tree over the prompt right-padded to its bucket,
  the head computed at the last true position only;
- the generation loop: a Python loop of decode steps on the device, with
  on-device sampling (an explicit ``torch.Generator``), EOS padding of
  finished rows, and batch-padding rows that start finished.  The JAX
  engine runs one compiled ``lax.while_loop``; here the host enqueues the
  steps and reads the device at most once every ``decode_unroll`` tokens
  (only with an EOS id, to stop once every row has finished) and once at
  the end.  Each step is the fused ``decode_step`` when ``_dparams`` is set,
  else ``forward_with_cache``.

- weights from ``config.checkpoint`` when no ``params`` are given
  (:meth:`InferenceEngine.load_checkpoint`): a training save dir or tag in
  the sharded layout either package writes, or a HuggingFace checkpoint
  directory through ``module_inject``.

Not ported yet (ROADMAP.md): tensor-parallel meshes and the legacy msgpack
checkpoint layout; a config asking for them is refused here instead of
being served another way than the JAX engine would.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models.decoding import (forward_with_cache,
                                                 init_kv_cache, sample_token)
from deepspeed_tpu_torch.models.fused_decode import (decode_step,
                                                     inject_decode_params,
                                                     supports_fused_decode)
from deepspeed_tpu_torch.models.quant import (QTensor, dequantize_tree,
                                              is_qtensor, quantize_layer_params)

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16}
_INT8 = ("int8", "qint8")


def pow2_bucket(n: int, lo: int = 1, cap: Optional[int] = None) -> int:
    """Next power-of-two >= n, floored at ``lo`` and capped at ``cap``."""
    b = lo
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class InferenceEngine:
    """Holds the serving copy of the weights on ``device`` in the serving
    dtype, and generates.  ``params`` is the nested parameter dict (JAX tree
    layout, int8 leaves as :class:`QTensor`); when omitted, the model
    module's own parameters are used."""

    def __init__(self, model, config: DeepSpeedInferenceConfig,
                 params: Any = None, *, device: DeviceLike = None):
        self.module = model
        self._config = config
        self.device = resolve_device(device)
        tp = config.tensor_parallel.tp_size if config.tensor_parallel else 1
        if tp > 1:
            raise NotImplementedError(
                "tensor-parallel inference is not ported yet (ROADMAP.md "
                "queue 1)")
        if getattr(model, "config", None) is None:
            raise TypeError("model must carry a ModelConfig as .config "
                            "(use deepspeed_tpu_torch.models.causal_lm)")
        # int8 = quantized WEIGHTS; activations stay bf16 (the KV cache too,
        # unless quantize_kv_cache)
        self._int8_weights = config.dtype in _INT8
        self.dtype = (torch.bfloat16 if self._int8_weights
                      else _DTYPES.get(config.dtype, torch.float32))
        self._params = None
        self._dparams = None
        self._cache = None
        self.cache_rebinds = 0        # growth reallocations of the KV cache
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(config.seed))
        # generate() is not reentrant: the cache is handed to the running
        # loop; test-and-set under a lock so a second caller raises
        self._generating = False
        self._gen_lock = threading.Lock()
        if params is None and config.checkpoint:
            self.load_checkpoint(config.checkpoint)
        elif params is not None or hasattr(model, "params"):
            self.set_params(params if params is not None else model.params())

    # ------------------------------------------------------------------
    def set_params(self, params: Any) -> None:
        """Move the parameter tree to the engine's device and cast floating
        leaves to the serving dtype (a leaf already there is used as is).
        With int8 weights the layer matmul weights and the head are
        quantized from their serving-dtype values one layer slice at a
        time, so the device holds one bf16 slice and its fp32 temporaries
        beside the codes, never a bf16 copy of a whole leaf (leaves given as
        QTensors keep their codes and scales).  Rebuilds the
        kernel-injected view."""
        def cast(t):
            if is_qtensor(t):
                return QTensor(t.q.to(self.device),
                               t.scale.to(self.device, torch.float32))
            t = torch.as_tensor(t)
            if t.is_floating_point():
                return t.to(device=self.device, dtype=self.dtype)
            return t.to(device=self.device)

        with torch.no_grad():
            self._params = None
            self._dparams = None
            tree = params
            if self._int8_weights:
                tree = quantize_layer_params(
                    _tree_map(lambda t: t if is_qtensor(t)
                              else torch.as_tensor(t), tree),
                    self.module.config, place=cast)
            self._params = _tree_map(cast, tree)
            self._build_injected_view()
        n = sum(t.numel() for t in _leaves(self._params))
        logger.info("inference engine ready: %.2fM params, dtype %s%s, on %s%s",
                    n / 1e6, "int8-weights/" if self._int8_weights else "",
                    self.dtype, self.device,
                    ", kernel-injected decode" if self._dparams is not None
                    else "")

    def load_checkpoint(self, path: str) -> None:
        """Serve the weights of ``path``: a HuggingFace checkpoint
        directory (through ``module_inject``), a training save dir (the tag
        its ``latest`` names) or one tag, in the sharded layout either
        package writes.  Any other path is the JAX package's legacy msgpack
        layout, which is refused."""
        from deepspeed_tpu_torch.module_inject.containers import (
            hf_to_params, is_hf_checkpoint, load_hf_state_dict)
        from deepspeed_tpu_torch.runtime.checkpoint_engine import (
            ShardedCheckpointEngine, is_sharded_checkpoint, nest_keystrs)

        if is_hf_checkpoint(path):
            self.set_params(hf_to_params(load_hf_state_dict(path),
                                         self.module.config))
            return
        f = path
        if os.path.isdir(path):
            latest = os.path.join(path, "latest")
            if os.path.exists(latest):
                with open(latest) as fh:
                    f = os.path.join(path, fh.read().strip(), "model_states")
            else:
                f = os.path.join(path, "model_states")
            if is_sharded_checkpoint(f):
                self.set_params(nest_keystrs(ShardedCheckpointEngine().load(f)))
                return
        raise NotImplementedError(
            f"checkpoint {path!r} is neither a HuggingFace directory nor in "
            "the sharded layout: the legacy msgpack layout is not ported "
            "(ROADMAP.md queue 1: the legacy msgpack layout)")

    def _build_injected_view(self) -> None:
        """Kernel injection (reference ``replace_with_kernel_inject``): lay
        the weights out for the fused decode kernels.  The JAX policy: on
        when supported (int8 weights included); ``use_fused_decode=False``
        opts out, even over ``replace_with_kernel_inject``."""
        self._dparams = None
        if self._config.use_fused_decode is False:
            return
        cfg = self.module.config
        tp = (self._config.tensor_parallel.tp_size
              if self._config.tensor_parallel else 1)
        if not supports_fused_decode(
                cfg, quantized_kv=self._config.quantize_kv_cache, tp=tp):
            if (self._config.replace_with_kernel_inject
                    or self._config.use_fused_decode):
                logger.info("kernel injection requested but unsupported for "
                            "this model/config (MoE, int8 KV cache, or "
                            "tp>1): using the unfused decode path")
            return
        self._dparams = inject_decode_params(self._params, cfg)

    # ------------------------------------------------------------------
    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Next power-of-two >= n (min 16), capped: the prompt and output
        buckets."""
        return pow2_bucket(n, lo=16, cap=cap)

    def _bucket_batch(self, batch: int) -> int:
        """Next power-of-two >= batch (capped at max_batch_size when set):
        a batch-3 call after a batch-8 call reuses the batch-8 cache, its
        extra rows padded and finished from the start."""
        b = pow2_bucket(batch, lo=1, cap=self._config.max_batch_size or None)
        return max(b, batch)

    def _ensure_compiled(self, batch: int, max_len: int) -> int:
        """Make the KV cache cover ``batch`` rows of ``max_len`` positions
        and return its (bucketed) batch.  The JAX name: there programs are
        compiled per cache shape; here only the allocation is keyed to the
        buckets.  Batch rounds up to a power of two, length to a
        power-of-two bucket capped at ``max_out_tokens + 1``; neither ever
        shrinks, and a growth reallocation counts a rebind."""
        cfg = self.module.config
        need_b = self._bucket_batch(batch)
        need_len = self._bucket(max_len, self._config.max_out_tokens + 1)
        cur = self._cache
        if cur is None or cur["k"].shape[1] < need_b or \
                cur["k"].shape[3] < need_len:
            if cur is not None:
                need_b = max(need_b, cur["k"].shape[1])
                need_len = max(need_len, cur["k"].shape[3])
                self.cache_rebinds += 1
                self._cache = cur = None     # free before reallocating
            self._cache = init_kv_cache(
                cfg, need_b, need_len, dtype=self.dtype, device=self.device,
                quantized=self._config.quantize_kv_cache)
        return self._cache["k"].shape[1]

    def _prefill(self, params, cache, tokens, pos, last_idx):
        """(logits [B, V] fp32 at query position ``last_idx`` — the true
        prompt length - 1 —, cache); the head runs on that position only."""
        logits, cache = forward_with_cache(self.module, params, tokens, cache,
                                           pos, logits_at=last_idx)
        return logits[:, 0], cache

    def _step(self, tokens, cache, pos):
        """One decode step at scalar position ``pos`` -> logits [B, V]."""
        if self._dparams is not None:
            logits, _ = decode_step(self.module.config, self._dparams, tokens,
                                    cache, pos)
            return logits
        logits, _ = forward_with_cache(self.module, self._params, tokens,
                                       cache, pos, max_pos=pos)
        return logits[:, -1]

    def _gen_loop(self, cache, logits, S, n_max, nrows, eos, sample, gen):
        """The decode loop: returns (new tokens [B, n_max] on the device,
        the number of leading columns that count).

        Step i samples from the current logits, pads finished rows with
        EOS, and writes column i; then, unless it is the last, runs the
        forward at position S + i.  Rows >= ``nrows`` are batch padding and
        start finished, so only the true rows govern the EOS stop.  With an
        EOS id the host reads whether every row has finished once every
        ``decode_unroll`` steps and stops there; the steps taken past the
        step that finished the last row are the loop's masked tail: they
        emit EOS everywhere and their columns are cut off, since the count
        of steps taken while some row was unfinished is kept on the device
        (the JAX loop's ``step``).  Without an EOS id nothing is read until
        the end."""
        B = logits.shape[0]
        unroll = max(1, int(self._config.decode_unroll))
        finished = torch.arange(B, device=self.device) >= nrows
        n_done = torch.zeros((), dtype=torch.long, device=self.device)
        cols = []
        with torch.no_grad():
            for i in range(n_max):
                nxt = sample_token(logits, gen, **sample)
                if eos >= 0:
                    n_done += (~finished.all()).long()
                    nxt = torch.where(finished, eos, nxt)
                    finished = finished | (nxt == eos)
                cols.append(nxt)
                if i + 1 == n_max:
                    break
                if eos >= 0 and (i + 1) % unroll == 0 and bool(finished.all()):
                    break
                logits = self._step(nxt[:, None], cache, S + i)
        out = (torch.stack(cols, dim=1) if cols
               else torch.zeros((B, 0), dtype=torch.long, device=self.device))
        return out, (int(n_done) if eos >= 0 else len(cols))

    # ------------------------------------------------------------------
    def generate(self, input_ids, max_new_tokens: int = 128,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Autoregressive generation; returns [B, S + n] token ids on the
        engine's device, n <= max_new_tokens (rows that hit EOS early hold
        EOS padding).  Sampling draws from ``rng`` (a ``torch.Generator`` on
        the engine's device) or the engine's own generator, seeded from
        ``config.seed``; it does not reproduce the JAX package's random
        stream.

        Not reentrant: the KV cache belongs to the running call, and a
        second concurrent call raises ``RuntimeError``.  For concurrent
        requests use :class:`~deepspeed_tpu_torch.serving.ServingEngine`."""
        if self._params is None:
            raise RuntimeError("no weights: pass params= or set_params()")
        with self._gen_lock:
            if self._generating:
                raise RuntimeError(
                    "InferenceEngine.generate() is not reentrant: the KV "
                    "cache belongs to the running call. Serialize calls, or "
                    "use deepspeed_tpu_torch.serving.ServingEngine for "
                    "concurrent requests.")
            self._generating = True
        try:
            tokens = torch.as_tensor(np.asarray(input_ids) if not isinstance(
                input_ids, torch.Tensor) else input_ids)
            tokens = tokens.to(device=self.device, dtype=torch.long)
            if tokens.dim() == 1:
                tokens = tokens[None]
            B, S = tokens.shape
            max_len = min(self._config.max_out_tokens, S + max_new_tokens)
            if self._config.max_batch_size and B > self._config.max_batch_size:
                raise ValueError(
                    f"batch {B} exceeds max_batch_size "
                    f"{self._config.max_batch_size}")
            if S + max(1, self._config.min_out_tokens) > \
                    self._config.max_out_tokens:
                raise ValueError(
                    f"cache budget max_out_tokens="
                    f"{self._config.max_out_tokens} cannot cover "
                    f"min_out_tokens={self._config.min_out_tokens} after a "
                    f"{S}-token prompt")
            return self._generate(tokens, B, S, max_len, max_new_tokens,
                                  do_sample, temperature, top_k, top_p,
                                  eos_token_id, rng)
        finally:
            with self._gen_lock:
                self._generating = False

    @torch.no_grad()
    def _generate(self, tokens, B, S, max_len, max_new_tokens, do_sample,
                  temperature, top_k, top_p, eos_token_id, rng):
        # +1: the JAX engine's spare cache row past max_len
        run_b = self._ensure_compiled(B, max_len + 1)
        if run_b > B:                 # pad rows up to the cache's batch
            tokens = torch.cat([tokens, tokens.new_zeros(run_b - B, S)])
        cache = self._cache
        Sb = self._bucket(S, cache["k"].shape[3])
        padded = (torch.cat([tokens, tokens.new_zeros(run_b, Sb - S)], dim=1)
                  if Sb > S else tokens)
        logits, cache = self._prefill(self._params, cache, padded, 0, S - 1)
        sample = dict(do_sample=bool(do_sample), temperature=float(temperature),
                      top_k=int(top_k), top_p=float(top_p))
        # the JAX loop's exact stop: max_new_tokens, or the cache budget
        n_max = max(0, min(max_new_tokens, max_len - S))
        new, n_done = self._gen_loop(
            cache, logits, S, n_max, B,
            -1 if eos_token_id is None else int(eos_token_id), sample,
            rng if rng is not None else self._gen)
        return torch.cat([tokens[:B], new[:B, :n_done]], dim=1)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def __call__(self, tokens):
        """Plain forward (logits [B, S, V]) through ``CausalLM.apply``; int8
        weights are dequantized to the serving dtype first."""
        params = self._params
        if self._int8_weights:
            params = dequantize_tree(params, self.dtype)
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).to(self.device, torch.long)
        return self.module.apply(params, tokens)

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config
