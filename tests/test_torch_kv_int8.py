"""The port's int8 KV cache against the JAX package, on the CPU.

- ``_quantize_kv_rows``: codes equal and scales within one fp32 ulp of the
  JAX function as its engines run it (under ``jit``, where XLA folds
  ``absmax / 127.0`` into a product with the reciprocal);
- ``init_kv_cache(quantized=True)`` and ``init_paged_kv_cache(quantized=
  True)``: the same planes, shapes and dtypes;
- ``forward_with_cache`` over the quantized contiguous cache (one shared
  start position, and per-row positions) and the paged pool: fp32 logits
  within 1e-4, codes equal and scales within 1e-6 relative (the K/V rows
  they quantize come out of fp32 sums in another order);
- the engines: int8-KV ``generate()``, paged serving with a prefix-cache
  hit (the scale planes gathered, scattered and copied on write with the
  codes) and fixed-slot serving token-identical to the JAX engines, with
  the embedding widened x40 as the other parity tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh, set_global_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.serving import paged_kv as jpkv
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import decoding as tdec
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.serving import paged_kv as tpkv
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_matches_jax(dtype):
    """[3, 2, 17, 16] rows (one all-zero row, one of a single value):
    codes equal, scales within one ulp of the jitted JAX function's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 17, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[1, 1, 4] = -2.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, js = jax.jit(jdec._quantize_kv_rows)(jnp.asarray(x).astype(jdt))
    tq, ts = tdec._quantize_kv_rows(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (3, 2, 17, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    ulp = np.spacing(np.abs(np.asarray(js)))
    assert (np.abs(ts.numpy() - np.asarray(js)) <= ulp).all()
    assert float(ts[0, 0, 0, 0]) == 1.0 and int(tq[0, 0, 0].abs().sum()) == 0
    assert int(tq.abs().max()) == 127


def test_quantized_cache_planes_match_jax():
    cfg = t_causal_lm("llama-tiny", device="cpu", **TINY).config
    jc = jdec.init_kv_cache(cfg, 3, 300, dtype=jnp.bfloat16, quantized=True)
    tc = tdec.init_kv_cache(cfg, 3, 300, torch.bfloat16, device="cpu",
                            quantized=True)
    jp = jpkv.init_paged_kv_cache(cfg, 5, 16, dtype=jnp.bfloat16,
                                  quantized=True)
    tp = tpkv.init_paged_kv_cache(cfg, 5, 16, torch.bfloat16, device="cpu",
                                  quantized=True)
    for j, t in ((jc, tc), (jp, tp)):
        assert sorted(j) == sorted(t)
        for k in j:
            assert tuple(t[k].shape) == tuple(j[k].shape), k
            assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype), k
    assert tc["k"].shape[-2] == 512          # rounded up to a block multiple
    assert tdec.activation_dtype(tc) == torch.bfloat16
    assert set(tdec.cache_planes(tc)) == {"k", "v", "k_scale", "v_scale"}


@pytest.fixture(scope="module")
def llama(devices):
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev = mesh_mod._GLOBAL_MESH
    mesh = build_mesh(fsdp=8, devices=devices)
    try:
        set_global_mesh(mesh)
        jm = j_causal_lm("llama-tiny", mesh=mesh, remat=False, **TINY)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    finally:
        mesh_mod._GLOBAL_MESH = prev
    params["embed"]["tok"] = params["embed"]["tok"] * 40.0
    tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    return mesh, jm, params, tm, tp


def _compare_cache(jc, tc):
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("layout", ["shared", "per_row", "paged"])
def test_forward_with_cache_over_int8_cache_matches_jax(llama, layout):
    """A prefill (contiguous: a 12-token chunk at position 0; paged: one
    decode token at a time through a scrambled page table), then decode
    steps; logits within 1e-4, the cache's codes equal and scales within
    1e-6 relative."""
    mesh, jm, params, tm, tp = llama
    cfg = jm.config
    set_global_mesh(mesh)
    toks = np.random.default_rng(2).integers(0, 256, (2, 12))
    if layout == "paged":
        jc = jpkv.init_paged_kv_cache(cfg, 7, 4, dtype=jnp.float32,
                                      quantized=True)
        tc = tpkv.init_paged_kv_cache(tm.config, 7, 4, torch.float32,
                                      device="cpu", quantized=True)
        table = np.array([[3, 1, 5, 0], [2, 6, 4, 0]])
        steps = [(toks[:, i:i + 1], np.array([i, i])) for i in range(12)]
    else:
        jc = jdec.init_kv_cache(cfg, 2, 32, dtype=jnp.float32, quantized=True)
        tc = tdec.init_kv_cache(tm.config, 2, 32, torch.float32,
                                device="cpu", quantized=True)
        table = None
        jl, jc = jdec.forward_with_cache(jm, params,
                                         jnp.asarray(toks, jnp.int32), jc, 0)
        tl, tc = tdec.forward_with_cache(tm, tp, torch.from_numpy(toks), tc, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        _compare_cache(jc, tc)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
        if layout == "shared":
            steps = [(nxt, 12 + i) for i in range(3)]
        else:
            steps = [(nxt, np.array([12 + i, 12 + i])) for i in range(3)]
    for i, (tok, pos) in enumerate(steps):
        if layout != "paged" and i:
            tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        kw = {} if table is None else {"page_table": jnp.asarray(table)}
        tkw = {} if table is None else {"page_table": torch.from_numpy(table)}
        jl, jc = jdec.forward_with_cache(jm, params, jnp.asarray(tok, jnp.int32),
                                         jc, jpos, **kw)
        tl, tc = tdec.forward_with_cache(tm, tp, torch.from_numpy(tok), tc,
                                         tpos, **tkw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    _compare_cache(jc, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kv_generate_token_identical_to_jax(llama, dtype):
    """generate() over the quantized contiguous cache, on the unfused loop
    in both engines: 20 greedy tokens for 3 prompts, then with an EOS id."""
    mesh, jm, params, tm, tp = llama
    cfg = {"dtype": dtype, "max_out_tokens": 64, "quantize_kv_cache": True}
    set_global_mesh(mesh)
    jeng = deepspeed_tpu.init_inference(jm, dict(cfg), params=params)
    teng = deepspeed_tpu_torch.init_inference(tm, dict(cfg), params=tp,
                                              device="cpu")
    assert teng._dparams is None and jeng._dparams is None
    toks = np.random.default_rng(0).integers(0, 256, (3, 11))
    want = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=20))
    got = teng.generate(toks, max_new_tokens=20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert teng._cache["k"].dtype == torch.int8 and "k_scale" in teng._cache
    assert len(set(want[:, 11:].ravel().tolist())) > 3, "degenerate output"
    eos = int(want[1, 16])
    want = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=20,
                                    eos_token_id=eos))
    got = teng.generate(toks, max_new_tokens=20, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    # a longer request grows the cache: the rebind keeps the scale planes
    long = np.random.default_rng(5).integers(0, 256, (2, 40))
    want = np.asarray(jeng.generate(jnp.asarray(long), max_new_tokens=10))
    got = teng.generate(long, max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert teng.cache_rebinds == 1 and "v_scale" in teng._cache


def _waves():
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, 32)
    return [[(rng.integers(0, 256, 18), 30),
             (np.concatenate([shared, rng.integers(0, 256, 5)]), 12)],
            [(shared.copy(), 10), (rng.integers(0, 256, 21), 12)]]


def _serve(engine, waves):
    out = []
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=n) for p, n in wave]
        engine.run()
        out += [(list(map(int, r.output_tokens)), r.finish_reason,
                 r.preemptions, r.prefix_hit_tokens) for r in reqs]
    if engine.pool is not None:
        engine.pool.check_no_leak()
    return out


@pytest.mark.parametrize("paged", [True, False])
def test_int8_kv_serving_token_identical_to_jax(llama, paged):
    """Serving over the int8 cache, two slots: paged (a preemption, and the
    exact re-ask of a shared prefix adopting 31 tokens through a
    copy-on-write page, which must carry the scale planes too) and
    fixed-slot; the same tokens, finish reasons, preemptions and prefix
    hits as the JAX engine."""
    mesh, jm, params, tm, tp = llama
    cfg = {"dtype": "float32", "max_out_tokens": 64, "quantize_kv_cache": True}
    if paged:
        cfg.update(kv_page_tokens=16, kv_pool_tokens=80)
    else:
        cfg["paged_kv_cache"] = False
    port = deepspeed_tpu_torch.init_serving(tm, cfg, params=tp, device="cpu",
                                            num_slots=2, prefill_chunk=16)
    assert port.engine._dparams is None and port.paged is paged
    assert port._cache["k"].dtype == torch.int8
    got = _serve(port, _waves())
    set_global_mesh(mesh)
    ref = deepspeed_tpu.init_serving(jm, config=cfg, num_slots=2,
                                     prefill_chunk=16)
    ref.set_params(params)
    try:
        want = _serve(ref, _waves())
    finally:
        ref.close()
    assert got == want
    assert len(set(got[0][0])) > 3, "outputs should not be degenerate"
    if paged:
        assert got[1][2] >= 1, "wave 1 must preempt"
        assert got[2][3] == 31 and port.stats["cow_copies"] >= 1
    else:
        assert all(r[2] == 0 and r[3] == 0 for r in got)
