"""The port's serving layer against the JAX package, on the CPU.

- the scheduler, ``PagedKVPool`` and ``PrefixCache`` copies driven on the
  same operation trace as the JAX copies: same slot assignments, page
  tables, refcounts, free lists, pins, matches and evictions;
- the slice as a whole: the JAX ``ServingEngine`` (fp32) and the port's
  engine on converted weights serve the same mixed waves — chunked
  prefill, a preemption and resume, a copy-on-write prefix-cache hit
  across a partial page, an EOS stop — token for token, with the same
  finish reasons and no leaked pages, on the unfused decode path and on the
  default kernel-injected (fused) one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh, set_global_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.serving import IterationScheduler as JScheduler
from deepspeed_tpu.serving import PagedKVPool as JPool
from deepspeed_tpu.serving import PrefixCache as JCache
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.serving import IterationScheduler as TScheduler
from deepspeed_tpu_torch.serving import PagedKVPool as TPool
from deepspeed_tpu_torch.serving import PrefixCache as TCache
from deepspeed_tpu_torch.serving import Request as TRequest
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


# ---------------------------------------------------------------------------
# host bookkeeping on one operation trace
# ---------------------------------------------------------------------------

def test_scheduler_same_trace_same_slots():
    rng = np.random.default_rng(0)
    js, ts = JScheduler(3), TScheduler(3)
    jr, tr = [], []

    def ix(reqs, r):
        return next(i for i, x in enumerate(reqs) if x is r)

    def view(s, reqs):
        slots = [ix(reqs, s.request_in(i)) if s.request_in(i) else -1
                 for i in range(s.num_slots)]
        return (slots, [ix(reqs, r) for r in s._queue],
                [ix(reqs, r) for r in s.finished],
                [ix(reqs, r) for r in s.prefilling()],
                [ix(reqs, r) for r in s.running()])

    for step in range(60):
        op = rng.integers(0, 5)
        if op == 0 or not jr:
            p = np.arange(int(rng.integers(1, 9)), dtype=np.int32)
            jr.append(js.submit(JRequest(prompt=p, max_new_tokens=4)))
            tr.append(ts.submit(TRequest(prompt=p, max_new_tokens=4)))
        elif op == 1:
            got = ([ix(jr, r) for r in js.admit()],
                   [ix(tr, r) for r in ts.admit()])
            assert got[0] == got[1]
        elif op in (2, 3, 4):
            live = [i for i, r in enumerate(jr) if r.slot >= 0
                    and js.request_in(r.slot) is r]
            if not live:
                continue
            i = live[int(rng.integers(0, len(live)))]
            if op == 2:
                js.finish(jr[i])
                ts.finish(tr[i])
            elif op == 3:
                js.requeue_front(jr[i])
                ts.requeue_front(tr[i])
            else:          # a request starts decoding
                jr[i].state = tr[i].state = "running"
        assert view(js, jr) == view(ts, tr), step
    q = [i for i, r in enumerate(jr) if r.state == "queued"]
    if q:
        assert js.cancel(jr[q[-1]]) == ts.cancel(tr[q[-1]]) is True
    assert view(js, jr) == view(ts, tr)


def _pool_view(pool, cache):
    return (pool.page_table.tolist(), pool._ref.tolist(), list(pool._free),
            sorted(pool._cached), [pool.owned(s) for s in range(pool.num_slots)],
            len(cache), pool.pages_used, pool.pages_free)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_prefix_cache_same_trace(seed):
    """Random admissions (match -> adopt -> grow), finishes (insert ->
    release), evictions and over-asks on a small pool: the two copies must
    agree on every page table, refcount, free list, pin and match."""
    rng = np.random.default_rng(seed)
    pools = [JPool(3, 64, page_tokens=8, pool_tokens=96),
             TPool(3, 64, page_tokens=8, pool_tokens=96)]
    caches = [JCache(pools[0]), TCache(pools[1])]
    base = rng.integers(0, 50, 64)
    prompts = {}
    for step in range(150):
        op = int(rng.integers(0, 4))
        slot = int(rng.integers(0, 3))
        empty = not pools[0].owned(slot)
        if op == 0 and empty:
            n = int(rng.integers(4, 48))
            cut = int(rng.integers(0, n))     # shared prefix, then diverge
            prompt = np.concatenate([base[:cut], rng.integers(50, 99, n - cut)])
            prompts[slot] = prompt
            matched = [c.match(prompt) for c in caches]
            assert matched[0] == matched[1], step
            for p, m in zip(pools, matched):
                p.adopt(slot, m[: (n - 1) // p.page])
            grown = [p.ensure(slot, n) for p in pools]
            assert grown[0] == grown[1], step
        elif op == 1 and not empty:
            full = min(len(prompts[slot]), 48) // pools[0].page
            added = [c.insert(prompts[slot], p.owned(slot)[:full])
                     for c, p in zip(caches, pools)]
            assert added[0] == added[1], step
            freed = [p.release(slot) for p in pools]
            assert freed[0] == freed[1], step
        elif op == 2:
            ev = [c.evict_lru() for c in caches]
            assert ev[0] == ev[1], step
        elif not empty:
            want = int(rng.integers(1, 65))
            grown = [p.ensure(slot, want) for p in pools]
            assert grown[0] == grown[1], step
        assert _pool_view(pools[0], caches[0]) == _pool_view(pools[1],
                                                              caches[1]), step
        for p, c in zip(pools, caches):
            p.check_no_leak()
            c.check_no_leak()
    for s in range(3):
        for p in pools:
            p.release(s)
    while all(c.evict_lru() for c in caches):
        pass
    assert _pool_view(pools[0], caches[0]) == _pool_view(pools[1], caches[1])
    assert pools[1].pages_free == pools[1].num_pages - 1


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256)
# 5 usable 16-token pages for two 64-token slots: the pool must preempt
SERVE_CFG = {"dtype": "float32", "use_fused_decode": False,
             "max_out_tokens": 64, "kv_page_tokens": 16, "kv_pool_tokens": 80}


@pytest.fixture(scope="module")
def weights(devices):
    # a module-scoped fixture runs before the per-test guard that restores
    # the global mesh: put the previous one back here, so that this 8-way
    # fsdp mesh does not reach later files of the same worker
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev_mesh = mesh_mod._GLOBAL_MESH
    mesh = build_mesh(fsdp=8, devices=devices)
    try:
        set_global_mesh(mesh)
        jm = j_causal_lm("llama-tiny", mesh=mesh, remat=False, **TINY)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    # a wider embedding spreads the logits: greedy picks sit far from ties,
    # so token identity tests the algorithm rather than fp32 rounding
    params["embed"]["tok"] = params["embed"]["tok"] * 40.0
    tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    return mesh, jm, params, tm, tp


def _waves(eos):
    """Wave 1: a chunked 37-token prompt and an 18-token prompt that
    together overrun the pool (preemption).  Wave 2: an exact 32-token
    re-ask of the shared prefix (31 tokens adopted: page 0 shared, page 1
    copy-on-written) and an EOS request."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, 32)
    return [
        [(rng.integers(0, 256, 18), 30, None),
         (np.concatenate([shared, rng.integers(0, 256, 5)]), 12, None)],
        [(shared.copy(), 10, None), (rng.integers(0, 256, 21), 12, eos)],
    ]


def _serve(engine, waves):
    out = []
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=n, eos_token_id=e)
                for p, n, e in wave]
        engine.run()
        out += [(list(map(int, r.output_tokens)), r.finish_reason,
                 r.preemptions, r.prefix_hit_tokens) for r in reqs]
    engine.pool.check_no_leak()
    engine.prefix_cache.check_no_leak()
    return out


def _port_engine(tm, tp):
    return deepspeed_tpu_torch.init_serving(tm, SERVE_CFG, params=tp,
                                            device="cpu", num_slots=2,
                                            prefill_chunk=16)


def test_serving_engine_token_identical_to_jax(weights):
    mesh, jm, params, tm, tp = weights
    # pick an EOS id the EOS request really emits: its 4th token on a
    # run without EOS (if the two engines disagree, the comparison below
    # fails anyway)
    probe = _serve(_port_engine(tm, tp), _waves(None))
    eos = probe[3][0][3]
    port = _port_engine(tm, tp)
    got = _serve(port, _waves(eos))
    set_global_mesh(mesh)
    ref = deepspeed_tpu.init_serving(jm, config=SERVE_CFG, num_slots=2,
                                     prefill_chunk=16)
    ref.set_params(params)
    try:
        want = _serve(ref, _waves(eos))
    finally:
        ref.close()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {i}: port {g} != jax {w}"
    # the run covered what it claims to
    assert got[1][2] >= 1, "wave 1 must preempt"
    assert got[2][3] == 31 and port.stats["cow_copies"] >= 1, \
        "the exact re-ask must adopt 31 tokens through a COW page"
    assert got[3][1] == "eos" and len(got[3][0]) < 12
    assert port.stats["prefill_chunks"] > len(got), "prefill must be chunked"
    assert [r[1] for r in got[:3]] == ["length"] * 3
    assert len(set(got[0][0])) > 3, "outputs should not be degenerate"


# the default config: no use_fused_decode key, so both engines decode fused
FUSED_CFG = {k: v for k, v in SERVE_CFG.items() if k != "use_fused_decode"}


def test_serving_engine_fused_token_identical_to_jax(weights, monkeypatch):
    """The default (kernel-injected) decode path of both engines on the
    same waves: both must really take it (``_dparams`` built, the port's
    ``decode_step`` called every micro-step) and agree token for token."""
    import deepspeed_tpu_torch.serving.engine as tse

    mesh, jm, params, tm, tp = weights

    def port_engine():
        return deepspeed_tpu_torch.init_serving(tm, FUSED_CFG, params=tp,
                                                device="cpu", num_slots=2,
                                                prefill_chunk=16)

    probe = _serve(port_engine(), _waves(None))
    eos = probe[3][0][3]
    port = port_engine()
    assert port.engine._dparams is not None
    calls = []
    real = tse.decode_step
    monkeypatch.setattr(tse, "decode_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _serve(port, _waves(eos))
    monkeypatch.undo()
    assert len(calls) == port.stats["decode_blocks"] * port._K > 0
    set_global_mesh(mesh)
    ref = deepspeed_tpu.init_serving(jm, config=FUSED_CFG, num_slots=2,
                                     prefill_chunk=16)
    ref.set_params(params)
    try:
        assert ref.engine._dparams is not None
        want = _serve(ref, _waves(eos))
    finally:
        ref.close()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {i}: port {g} != jax {w}"
    assert got[1][2] >= 1, "wave 1 must preempt"
    assert got[2][3] == 31 and port.stats["cow_copies"] >= 1
    assert got[3][1] == "eos" and len(got[3][0]) < 12
    assert port.stats["prefill_chunks"] > len(got), "prefill must be chunked"
    assert len(set(got[0][0])) > 3, "outputs should not be degenerate"


def test_inference_config_fields_and_defaults_match_jax():
    from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as J
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig as T

    assert list(T.model_fields) == list(J.model_fields)
    assert T().model_dump() == J().model_dump()
    over = {"max_out_tokens": "auto", "mp_size": 2, "num_slots": 3}
    assert T(**over).model_dump() == J(**over).model_dump()


# ---------------------------------------------------------------------------
# the fixed-slot layout (paged_kv_cache=False)
# ---------------------------------------------------------------------------

GPT2 = dict(num_layers=2, hidden_size=64, intermediate_size=256, num_heads=4,
            vocab_size=256, max_seq_len=128)


@pytest.fixture(scope="module")
def gpt2_weights(devices):
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev_mesh = mesh_mod._GLOBAL_MESH
    mesh = build_mesh(fsdp=8, devices=devices)
    try:
        set_global_mesh(mesh)
        jm = j_causal_lm("gpt2-small", mesh=mesh, remat=False, **GPT2)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    # through gpt2's tied head a wide token table alone repeats its input:
    # the position table is widened further
    params["embed"]["tok"] = params["embed"]["tok"] * 16.0
    params["embed"]["pos"] = params["embed"]["pos"] * 80.0
    tm = t_causal_lm("gpt2-small", device="cpu", **GPT2)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    return mesh, jm, params, tm, tp


def _fixed_waves(eos):
    """Wave 1: a 37-token prompt in three chunks beside an 18-token one;
    wave 2: an exact repeat and an EOS request, in the slots the first wave
    left (their rows reused from depth 0)."""
    rng = np.random.default_rng(2)
    first = rng.integers(0, 256, 37)
    return [[(rng.integers(0, 256, 18), 30, None), (first, 12, None)],
            [(first.copy(), 12, None), (rng.integers(0, 256, 21), 12, eos)]]


def _serve_fixed(engine, waves):
    out = []
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=n, eos_token_id=e)
                for p, n, e in wave]
        engine.run()
        out += [(list(map(int, r.output_tokens)), r.finish_reason,
                 r.preemptions, r.prefix_hit_tokens) for r in reqs]
    return out


FIXED_CASES = [(m, f) for m in ("llama", "gpt2") for f in (True, False)]


@pytest.mark.parametrize("model,fused", FIXED_CASES)
def test_fixed_slot_serving_token_identical_to_jax(weights, gpt2_weights,
                                                   model, fused):
    """``paged_kv_cache: false``: one contiguous cache row a slot, the
    prefill written straight into the slot's row, decode at per-row
    positions through ``decode_step``'s contiguous branch (fused) or
    ``forward_with_cache`` (unfused); token for token, with the same finish
    reasons, as the JAX engine's fixed-slot layout."""
    import deepspeed_tpu_torch.serving.engine as tse

    mesh, jm, params, tm, tp = weights if model == "llama" else gpt2_weights
    cfg = {"dtype": "float32", "max_out_tokens": 64, "paged_kv_cache": False}
    if not fused:
        cfg["use_fused_decode"] = False

    def port_engine():
        return deepspeed_tpu_torch.init_serving(tm, cfg, params=tp,
                                                device="cpu", num_slots=2,
                                                prefill_chunk=16)

    probe = _serve_fixed(port_engine(), _fixed_waves(None))
    eos = probe[3][0][3]
    port = port_engine()
    assert port.pool is None and port.prefix_cache is None
    assert port._cache["k"].shape[1] == 2 and port.cache_len == 64
    assert (port.engine._dparams is not None) is fused
    calls = []
    real = tse.decode_step
    tse.decode_step = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        got = _serve_fixed(port, _fixed_waves(eos))
    finally:
        tse.decode_step = real
    if fused:
        assert len(calls) == port.stats["decode_blocks"] * port._K > 0
        assert all(k["page_table"] is None for k in calls)
    else:
        assert not calls
    set_global_mesh(mesh)
    ref = deepspeed_tpu.init_serving(jm, config=cfg, num_slots=2,
                                     prefill_chunk=16)
    ref.set_params(params)
    try:
        assert not ref.paged
        want = _serve_fixed(ref, _fixed_waves(eos))
    finally:
        ref.close()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {i}: port {g} != jax {w}"
    assert got[2][0] == got[1][0], "the exact repeat diverged"
    assert got[3][1] == "eos" and len(got[3][0]) < 12
    assert [r[1] for r in got[:3]] == ["length"] * 3
    assert port.stats["prefill_chunks"] > len(got), "prefill must be chunked"
    assert len(set(got[0][0])) > 3, "outputs should not be degenerate"
