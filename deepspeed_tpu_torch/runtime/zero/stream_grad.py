"""ZeRO-Infinity's streamed forward and backward: the params and the grads
of one layer at a time on the card.

Counterpart of ``deepspeed_tpu/runtime/zero/stream_grad.py``
(``StreamedFwdBwd.run``).  The whole-program training step would hold the
whole param tree and the whole grad tree on the card; this module runs the
model's segments (``CausalLM.stream_segments()``) instead, step by step as
the JAX function:

  embed_fwd   (embed, tokens) -> x0
  layer_fwd   (lp_i, x_i) -> (x_{i+1}, aux_i)        the forward loop, no
                                                     grads, keeping only
                                                     the boundary x_i
  head        (head, x_L, labels) -> loss / gas in fp32, the head tree's
                                     grads and d(x_L), in the compute dtype
  layer_bwd   (lp_i, x_i, ct) -> (d lp_i, ct')      the backward loop in
                                                     reverse: each layer's
                                                     forward recomputed
                                                     under autograd
  embed_bwd   (embed, tokens, ct) -> d embed

Each layer's weights come through :class:`~deepspeed_tpu_torch.runtime.
zero.streaming.ParamStreamer` (layer i+1's copy in flight while layer i
computes; layer L-1's forward copy kept for the backward, not fetched
again).  Each layer's grads go D2H on a side stream into a page-locked
ring of two layer-sized buffers, and the host adds layer i+1's into the
fp32 accumulators while layer i's backward runs on the card.  The
accumulation order is the JAX function's, which fp32 bit-equality with it
needs: the head first (into ``embed.tok`` when the embeddings are tied),
then layers L-1 ... 0, then the embedding.  An MoE model's loss is ``loss
+ moe_coef * sum(aux)`` and each layer's aux cotangent ``moe_coef / gas``.
Dropout keys are ``prng.split(rng, L)`` (only with dropout > 0), the JAX
key chain, so the recomputed forward draws the forward's masks.

On the CPU the grads are on the host already and are added in place.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.zero.relay import PinnedBlock
from deepspeed_tpu_torch.runtime.zero.streaming import (ParamStreamer, _Layout,
                                                        tree_leaves, tree_nest)
from deepspeed_tpu_torch.utils import prng


_CHUNK = 1 << 20


def host_add_(acc: torch.Tensor, g: torch.Tensor) -> None:
    """``acc += g`` on the host, ``g`` in its dtype widened to fp32 first
    (exact), in chunks that stay in cache: a mixed-dtype ``add_`` over a
    whole leaf runs several times slower."""
    if g.dtype == acc.dtype:
        acc.add_(g)
        return
    a, b = acc.view(-1), g.reshape(-1)
    for k in range(0, a.numel(), _CHUNK):
        a[k:k + _CHUNK].add_(b[k:k + _CHUNK].to(acc.dtype))


def host_sumsq(t: torch.Tensor) -> float:
    """The float64 sum of the squares of a host tensor's elements (fp32
    values squared and summed in float64), in chunks that stay in cache."""
    flat = t.reshape(-1)
    total = 0.0
    for k in range(0, flat.numel(), _CHUNK):
        c = flat[k:k + _CHUNK].to(torch.float64)
        total += float(torch.dot(c, c))
    return total


def _requires_grad(tree: Dict[str, Any]):
    """``(paths, leaves)`` of ``tree``, each leaf a fresh autograd leaf over
    the same memory."""
    pairs = tree_leaves(tree)
    return ([p for p, _ in pairs],
            [t.detach().requires_grad_() for _, t in pairs])


def _node(tree: Dict[str, Any], path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


class StreamedFwdBwd:
    """Drives the per-layer streamed forward and backward of a segmented
    model.  ``segments`` is ``model.stream_segments()``; ``prefetch``,
    ``int8``, ``staging_slots`` and ``quant_block`` are the streamer's
    (config ``offload_param.{prefetch, int8_stream, staging_slots}`` and
    ``offload_optimizer.quant_block``)."""

    def __init__(self, segments: Dict[str, Any], *, gas: int, device,
                 use_dropout: bool = True, prefetch: bool = True,
                 int8: bool = False, staging_slots: int = 2,
                 quant_block: int = 256):
        self.seg = segments
        self.gas = int(gas)
        self.L = int(segments["num_layers"])
        self.moe_coef = float(segments["moe_coef"])
        self.tied = bool(segments["tied"])
        self.use_drop = bool(use_dropout) and segments["dropout"] > 0
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.streamer = ParamStreamer(self.device, int8=int8,
                                      quant_block=quant_block,
                                      prefetch=prefetch,
                                      staging_slots=staging_slots)
        self._gen = None                  # the bound host copy's generation
        self._rope_cache: Dict[Any, Any] = {}
        self._grad_layout: Optional[_Layout] = None
        self._ring: Optional[PinnedBlock] = None
        self._ring_views: List[List[torch.Tensor]] = []
        self._ring_next = 0
        self._d2h = torch.cuda.Stream(self.device) if self.cuda else None
        self._d2h_marks: List[Tuple[Any, Any]] = []   # each layer's grads D2H
        # host seconds of the last run: the forward stream (embed, layers,
        # head, head grads on the host) and the backward stream with the
        # accumulation
        self.last: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def bind(self, params: Dict[str, Any], generation) -> None:
        """Bind the host copy ``params`` (the model's nested tree of host
        tensors); ``generation`` names its values, so the int8 codes of the
        embed and head trees are made once for each."""
        self.streamer.refresh(params["layers"])
        self._gen = generation
        self._grad_layout = _Layout([(p, t.shape[1:], t.dtype)
                                     for p, t in tree_leaves(params["layers"])])

    def d2h_seconds(self) -> float:
        """The device time of the layer grads' copies since the last call,
        each from its start to its landing (synchronizes the card)."""
        marks, self._d2h_marks = self._d2h_marks, []
        if not marks:
            return 0.0
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in marks) / 1e3

    def _rope(self, S: int, dtype: torch.dtype):
        key = (S, dtype)
        if key not in self._rope_cache:
            self._rope_cache[key] = self.seg["rope"](S, dtype, self.device)
        return self._rope_cache[key]

    def _head_tree(self, params: Dict[str, Any]) -> Dict[str, Any]:
        ht = {"final_norm": params["final_norm"],
              "head": params["embed"]["tok"] if self.tied else params["lm_head"]}
        if "lm_head_bias" in params:
            ht["head_bias"] = params["lm_head_bias"]
        return ht

    def _keys(self, rng) -> list:
        return prng.split(rng, self.L) if self.use_drop else [None] * self.L

    # -- the host side of the grads -------------------------------------
    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return t
        self.streamer.record_d2h(t.numel() * t.element_size())
        return t.to("cpu")

    def _grads_down(self, grads: List[torch.Tensor]):
        """Start layer grads' D2H into the next ring buffer: ``(views,
        event)``; on the CPU the grads themselves."""
        if not self.cuda:
            return grads, None
        if self._ring is None:
            self._ring = PinnedBlock(2 * self._grad_layout.nbytes)
            half = self._grad_layout.nbytes
            self._ring_views = [self._grad_layout.views(self._ring.buf[k * half:(k + 1) * half])
                                for k in range(2)]
        views = self._ring_views[self._ring_next]
        self._ring_next ^= 1
        cur = torch.cuda.current_stream(self.device)
        self._d2h.wait_stream(cur)
        with torch.cuda.stream(self._d2h):
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._d2h)
            for dst, g in zip(views, grads):
                dst.copy_(g, non_blocking=True)
                g.record_stream(self._d2h)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._d2h)
        self._d2h_marks.append((start, ev))
        self.streamer.record_d2h(self._grad_layout.payload_bytes())
        return views, ev

    def _acc_layer(self, acc_layers: Dict[str, Any], i: int, handle) -> None:
        grads, ev = handle
        if ev is not None:
            ev.synchronize()
        for (path, _, _, _), g in zip(self._grad_layout.items, grads):
            host_add_(_node(acc_layers, path)[i], g)

    # -- segments -------------------------------------------------------
    def _embed(self, params, tokens):
        st = self.streamer
        embed = st.materialize_aux(st.put_aux("embed", params["embed"], self._gen))
        with torch.no_grad():
            return self.seg["embed_fwd"](embed, tokens)

    def _forward_layers(self, x, keys, cos, sin, keep_last: bool):
        """The forward loop under no_grad: the boundary activations, the
        auxes and (``keep_last``) layer L-1's payload, still held."""
        st = self.streamer
        xs, auxes, lp_last = [x], [], None
        st.prefetch(0)
        with torch.no_grad():
            for i in range(self.L):
                if i + 1 < self.L:   # overlap the next layer's H2D with this one
                    st.prefetch(i + 1)
                lp = st.take(i)
                x, aux = self.seg["layer_fwd"](st.materialize(lp), x, keys[i], cos, sin)
                xs.append(x)
                auxes.append(aux)
                if keep_last and i == self.L - 1:
                    lp_last = lp
                else:
                    st.release(lp)
        return xs, auxes, lp_last

    def _with_aux(self, loss, auxes):
        if self.moe_coef:
            loss = loss + self.moe_coef * torch.stack(auxes).sum()
        return loss

    def _layer_bwd(self, lp, x, key, cos, sin, ct, ct_aux):
        """Layer i's forward again under autograd on the slot's weights (or
        their dequantized values: the codes are a transport, not part of
        the differentiated function) and on ``x``: ``(ct_x, grads)``."""
        paths, leaves = _requires_grad(self.streamer.materialize(lp))
        x_ = x.detach().requires_grad_()
        with torch.enable_grad():
            y, aux = self.seg["layer_fwd"](tree_nest(zip(paths, leaves)), x_,
                                           key, cos, sin)
            outs, cts = [y], [ct]
            if aux is not None:
                outs.append(aux)
                cts.append(ct_aux)
            gs = torch.autograd.grad(outs, [x_] + leaves, cts, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(gs[1:], leaves)]
        return gs[0], grads

    # ------------------------------------------------------------------
    def run(self, params: Dict[str, Any], tokens: torch.Tensor,
            labels: torch.Tensor, loss_mask: Optional[torch.Tensor], rng,
            acc: Dict[str, Any]) -> torch.Tensor:
        """One micro-batch's forward and backward.  The grads, scaled by
        1/gas, are added in fp32 into ``acc`` (host tensors mirroring the
        params tree).  Returns the loss (a scalar on the card)."""
        t0 = time.perf_counter()
        st = self.streamer
        L = self.L
        dtype = tree_leaves(params["layers"])[0][1].dtype
        cos, sin = self._rope(int(tokens.shape[1]), dtype)
        keys = self._keys(rng)
        x = self._embed(params, tokens)
        xs, auxes, lp_last = self._forward_layers(x, keys, cos, sin, keep_last=True)

        # the head: loss and the first cotangent
        head = st.materialize_aux(st.put_aux("head", self._head_tree(params), self._gen))
        paths, leaves = _requires_grad(head)
        x_l = xs[-1].detach().requires_grad_()
        with torch.enable_grad():
            l = self.seg["head_loss"](tree_nest(zip(paths, leaves)), x_l, labels,
                                      loss_mask).float() / self.gas
            gs = torch.autograd.grad(l, leaves + [x_l])
        loss = l.detach() * self.gas
        ct = gs[-1]
        g_head = dict(zip(paths, gs[:-1]))
        del head, leaves, gs
        for path, g in g_head.items():
            if path[0] == "final_norm":
                dst = _node(acc["final_norm"], path[1:])
            elif path[0] == "head":
                dst = acc["embed"]["tok"] if self.tied else acc["lm_head"]
            else:
                dst = acc["lm_head_bias"]
            host_add_(dst, self._to_host(g))
        del g_head
        loss = self._with_aux(loss, auxes)
        ct_aux = torch.tensor(self.moe_coef / self.gas, dtype=torch.float32,
                              device=self.device)
        t1 = time.perf_counter()

        # the backward: the layers in reverse, layer L-1 from its forward copy
        st.drop_inflight()
        prev, prev_idx = None, -1
        for i in range(L - 1, -1, -1):
            if i - 1 >= 0:
                st.prefetch(i - 1)
            lp = lp_last if i == L - 1 else st.take(i)
            lp_last = None
            ct, grads = self._layer_bwd(lp, xs[i], keys[i], cos, sin, ct, ct_aux)
            st.release(lp)
            del lp
            xs[i + 1] = None       # this boundary activation is done with
            handle = self._grads_down(grads)
            del grads
            if prev is not None:   # add layer i+1's while layer i's runs
                self._acc_layer(acc["layers"], prev_idx, prev)
            prev, prev_idx = handle, i
        if prev is not None:
            self._acc_layer(acc["layers"], prev_idx, prev)

        embed = st.materialize_aux(st.put_aux("embed", params["embed"], self._gen))
        paths, leaves = _requires_grad(embed)
        with torch.enable_grad():
            x0 = self.seg["embed_fwd"](tree_nest(zip(paths, leaves)), tokens)
            gs = torch.autograd.grad(x0, leaves, ct, allow_unused=True)
        for path, g, t in zip(paths, gs, leaves):
            host_add_(_node(acc["embed"], path),
                      self._to_host(torch.zeros_like(t) if g is None else g))
        self.last = {"fwd_s": t1 - t0, "bwd_s": time.perf_counter() - t1}
        return loss

    @torch.no_grad()
    def forward(self, params: Dict[str, Any], tokens: torch.Tensor,
                labels: torch.Tensor, loss_mask: Optional[torch.Tensor],
                rng) -> torch.Tensor:
        """The streamed forward alone: the loss of one batch, no grads (the
        engine's evaluation)."""
        st = self.streamer
        dtype = tree_leaves(params["layers"])[0][1].dtype
        cos, sin = self._rope(int(tokens.shape[1]), dtype)
        keys = self._keys(rng)
        x = self._embed(params, tokens)
        xs, auxes, _ = self._forward_layers(x, keys, cos, sin, keep_last=False)
        st.drop_inflight()
        head = st.materialize_aux(st.put_aux("head", self._head_tree(params), self._gen))
        loss = self.seg["head_loss"](head, xs[-1], labels, loss_mask).float()
        return self._with_aux(loss, auxes)
