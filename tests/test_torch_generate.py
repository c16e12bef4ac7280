"""``init_inference(...).generate()`` of the port against the JAX package, on
the CPU.

- the slice as a whole: the JAX ``InferenceEngine`` and the port's engine on
  converted weights generate the same greedy tokens, for a llama-shaped, a
  gpt2-shaped and an ALiBi model, fp32 and bf16, on the fused
  (kernel-injected) and the unfused decode path, and stop at the same step
  with the same output shape when an EOS id is hit;
- the engine's own contract: the bucketed prefill gives the exact prefill's
  logits, a batch-3 call after a batch-8 call reuses the cache (no rebind),
  the ``ValueError``s for the batch and the cache budget and the
  re-entrancy ``RuntimeError``, sampling reproducible from one seed and
  inside the support the JAX logits give;
- ``decode_step``'s two contiguous-cache branches (one scalar position, per
  row positions) against the JAX ``decode_step``: fp32 logits within 1e-5
  (the same fp32 ops, sums in another order) and the same cache.

Token identity is the test of the algorithm: the embedding is widened so
that greedy picks sit far from ties (ROADMAP.md queue 3, near-tied logits),
as in the serving parity tests.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh, set_global_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.models import fused_decode as jfd
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import fused_decode as tfd
from deepspeed_tpu_torch.models import jax_params_to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256)
MODELS = {
    "llama": ("llama-tiny", TINY),
    "gpt2": ("gpt2-small", dict(num_layers=2, hidden_size=64,
                                intermediate_size=256, num_heads=4,
                                vocab_size=256, max_seq_len=128)),
    "alibi": ("llama-tiny", dict(TINY, position="alibi")),
}


def _build(name, mesh):
    preset, over = MODELS[name]
    jm = j_causal_lm(preset, mesh=mesh, remat=False, **over)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    if jm.config.position == "learned":
        # through gpt2's tied head a wide token table alone repeats its
        # input: the position table is widened further
        params["embed"]["tok"] = params["embed"]["tok"] * 16.0
        params["embed"]["pos"] = params["embed"]["pos"] * 80.0
    else:
        params["embed"]["tok"] = params["embed"]["tok"] * 40.0
    tm = t_causal_lm(preset, device="cpu", **over)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    return jm, params, tm, tp


@pytest.fixture(scope="module")
def models(devices):
    # a module-scoped fixture runs before the per-test guard that restores
    # the global mesh: put the previous one back here
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev = mesh_mod._GLOBAL_MESH
    mesh = build_mesh(fsdp=8, devices=devices)
    try:
        set_global_mesh(mesh)
        built = {name: _build(name, mesh) for name in MODELS}
    finally:
        mesh_mod._GLOBAL_MESH = prev
    return mesh, built


def _prompts(seed=0, batch=3, length=11):
    return np.random.default_rng(seed).integers(0, 256, (batch, length))


def _engines(models, name, cfg):
    mesh, built = models
    jm, params, tm, tp = built[name]
    set_global_mesh(mesh)
    jeng = deepspeed_tpu.init_inference(jm, dict(cfg), params=params)
    teng = deepspeed_tpu_torch.init_inference(tm, dict(cfg), params=tp,
                                              device="cpu")
    return jeng, teng


CASES = [(m, d, f) for m in ("llama", "gpt2", "alibi")
         for d in ("float32", "bfloat16") for f in (True, False)]


@pytest.mark.parametrize("name,dtype,fused", CASES)
def test_generate_token_identical_to_jax(models, name, dtype, fused):
    """20 greedy tokens for 3 prompts; then an EOS id the middle row emits
    at its 6th new token, for the 3 rows (the middle row padded with EOS
    once it has finished) and for the middle row alone (the loop stops
    early): both engines give the same [B, S + n] output."""
    cfg = {"dtype": dtype, "max_out_tokens": 64}
    if not fused:
        cfg["use_fused_decode"] = False
    jeng, teng = _engines(models, name, cfg)
    assert (teng._dparams is not None) is fused
    assert (jeng._dparams is not None) is fused
    toks = _prompts()
    want = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=20))
    got = teng.generate(toks, max_new_tokens=20)
    assert got.device.type == "cpu" and got.shape == want.shape == (3, 31)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[:, 11:].ravel().tolist())) > 3, "degenerate output"
    eos = int(want[1, 16])
    first = 11 + int(np.argmax(want[1, 11:] == eos))
    for rows in (toks, toks[1:2]):
        want = np.asarray(jeng.generate(jnp.asarray(rows), max_new_tokens=20,
                                        eos_token_id=eos))
        got = teng.generate(rows, max_new_tokens=20, eos_token_id=eos)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        row = want[1] if len(rows) == 3 else want[0]
        assert (row[first:] == eos).all()
    assert want.shape == (1, first + 1), "the lone row must stop at its EOS"


def test_bucketed_prefill_equals_the_exact_one(models):
    """An 11-token prompt prefilled in its 16-token bucket (right-padded)
    gives the exact prefill's last-position logits (fp32, 1e-5: the same
    ops on more rows) and the same cache rows."""
    _, built = models
    _, _, tm, tp = built["llama"]
    eng = deepspeed_tpu_torch.init_inference(tm, {"dtype": "float32",
                                                  "max_out_tokens": 64},
                                             params=tp, device="cpu")
    toks = torch.from_numpy(_prompts(batch=4))
    assert eng._ensure_compiled(4, 32) == 4
    padded = torch.cat([toks, torch.zeros(4, 5, dtype=torch.long)], dim=1)
    got, cache = eng._prefill(eng._params, eng._cache, padded, 0, 10)
    k_bucket = cache["k"][:, :, :, :11].clone()
    eng._cache = None
    eng._ensure_compiled(4, 32)
    want, cache = eng._prefill(eng._params, eng._cache, toks, 0, 10)
    assert got.shape == want.shape == (4, 256)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k_bucket, cache["k"][:, :, :, :11], rtol=1e-5,
                               atol=1e-5)


def test_batch_3_after_batch_8_reuses_the_cache(models):
    """Buckets never shrink: batch 3 after batch 8 runs in the batch-8
    cache (padded rows start finished) with no rebind and gives the tokens
    a fresh engine gives; only a longer request grows the cache."""
    _, built = models
    _, _, tm, tp = built["llama"]
    cfg = {"dtype": "float32", "max_out_tokens": 64}
    eng = deepspeed_tpu_torch.init_inference(tm, cfg, params=tp, device="cpu")
    eng.generate(_prompts(1, batch=8), max_new_tokens=10)
    cache = eng._cache
    assert cache["k"].shape[1] == 8 and eng.cache_rebinds == 0
    three = _prompts(2)
    got = eng.generate(three, max_new_tokens=10, eos_token_id=7)
    assert eng._cache is cache and eng.cache_rebinds == 0
    fresh = deepspeed_tpu_torch.init_inference(tm, cfg, params=tp,
                                               device="cpu")
    want = fresh.generate(three, max_new_tokens=10, eos_token_id=7)
    assert fresh._cache["k"].shape[1] == 4
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    eng.generate(_prompts(3, length=40), max_new_tokens=10)
    assert eng.cache_rebinds == 1 and eng._cache["k"].shape[1] == 8


def test_generate_refusals_match_jax(models):
    """The two ValueErrors (batch over max_batch_size; a prompt the cache
    budget cannot cover) on both engines, and re-entry raising
    RuntimeError."""
    cfg = {"dtype": "float32", "max_out_tokens": 32, "max_batch_size": 2}
    jeng, teng = _engines(models, "llama", cfg)
    for eng, conv in ((jeng, jnp.asarray), (teng, lambda a: a)):
        with pytest.raises(ValueError, match="max_batch_size"):
            eng.generate(conv(_prompts(batch=3)), max_new_tokens=4)
        with pytest.raises(ValueError, match="cache budget"):
            eng.generate(conv(_prompts(batch=1, length=32)), max_new_tokens=4)
    seen = []
    real = teng._generate

    def reenter(*a, **k):
        with pytest.raises(RuntimeError, match="reentrant"):
            teng.generate(_prompts(batch=1), max_new_tokens=2)
        seen.append(1)
        return real(*a, **k)

    teng._generate = reenter
    out = teng.generate(_prompts(batch=1), max_new_tokens=2)
    assert seen == [1] and out.shape == (1, 13)
    del teng._generate
    # the flag is released: a second thread may generate afterwards
    t = threading.Thread(target=teng.generate, args=(_prompts(batch=1),),
                         kwargs={"max_new_tokens": 2})
    t.start()
    t.join()
    assert not teng._generating


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6)])
def test_sampling_reproducible_and_in_jax_support(models, top_k, top_p):
    """Sampling draws from a torch.Generator: the same seed gives the same
    tokens, another seed others.  The random streams of the two packages
    differ, so only the support is held to JAX: every first sampled token
    lies in the top-k (or nucleus) set of the JAX engine's logits."""
    jeng, teng = _engines(models, "llama", {"dtype": "float32",
                                            "max_out_tokens": 64})
    toks = _prompts(4, batch=4)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.0, top_k=top_k,
              top_p=top_p)
    runs = [teng.generate(toks, rng=torch.Generator().manual_seed(s), **kw)
            for s in (11, 11, 12)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    logits = np.asarray(jeng(jnp.asarray(toks)))[:, -1].astype(np.float64)
    order = np.argsort(-logits, axis=-1)
    if top_k:
        support = [set(o[:top_k].tolist()) for o in order]
    else:
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        cum = np.cumsum(np.take_along_axis(p, order, -1), -1)
        support = [set(o[: int((c < top_p).sum()) + 1].tolist())
                   for o, c in zip(order, cum)]
    seeds = range(20, 36)
    firsts = [teng.generate(toks, rng=torch.Generator().manual_seed(s),
                            **dict(kw, max_new_tokens=1))[:, -1]
              for s in seeds]
    for row in range(4):
        drawn = {int(f[row]) for f in firsts}
        assert drawn <= support[row], (row, drawn, support[row])
    jout = np.asarray(jeng.generate(jnp.asarray(toks), rng=jax.random.PRNGKey(3),
                                    **kw))
    assert all(int(jout[r, 11]) in support[r] for r in range(4))


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_contiguous_branches_match_jax(models, per_row):
    """Three decode steps over a random contiguous [L, B, Hkv, Smax, Dh]
    cache at one scalar position (generate()'s loop) or per-row positions
    (the fixed-slot layout): fp32 logits within 1e-5, the cache rows each
    side writes within 1e-5 and every other row bit for bit."""
    mesh, built = models
    jm, params, tm, tp = built["llama"]
    cfg = jm.config
    jd = jfd.inject_decode_params(params, cfg)
    td = tfd.inject_decode_params(tp, tm.config)
    rng = np.random.default_rng(3)
    L, B, Hkv, Smax, Dh = cfg.num_layers, 3, cfg.num_kv_heads, 48, cfg.head_dim
    k = rng.standard_normal((L, B, Hkv, Smax, Dh)).astype(np.float32)
    v = rng.standard_normal((L, B, Hkv, Smax, Dh)).astype(np.float32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    pos = np.array([20, 5, 33]) if per_row else np.array(17)
    tok = np.array([[3], [99], [0]])
    for _ in range(3):
        jl, jc = jfd.decode_step(cfg, jd, jnp.asarray(tok), jc,
                                 jnp.asarray(pos, jnp.int32))
        tpos = torch.from_numpy(pos.copy()) if per_row else int(pos)
        tl, tc = tfd.decode_step(tm.config, td, torch.from_numpy(tok), tc,
                                 tpos)
        assert tl.dtype == torch.float32 and tl.shape == (B, 256)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-5,
                                   atol=1e-5)
        tok = np.array(jnp.argmax(jl, -1))[:, None]
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc[name]), tc[name].numpy(),
                                   rtol=1e-5, atol=1e-5)
        keep = np.ones(Smax, bool)
        keep[int(np.min(pos)) - 3: int(np.max(pos))] = False
        np.testing.assert_array_equal(np.asarray(jc[name])[..., keep, :],
                                      tc[name].numpy()[..., keep, :])
