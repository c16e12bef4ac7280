"""The port's MoE MLP and the Mixtral family against the JAX package, on the
CPU.

- ``compute_capacity``, ``topk_assignments`` and ``topk_gating`` on the same
  router probabilities: expert indices, buffer positions and combine
  weights equal (the same fp32 operations), the aux loss within 1e-6 (a
  mean in another order), for k = 1 and 2, with ample and with overflowing
  capacity;
- ``moe_mlp`` on the same weights and input, for both dispatch forms, with
  and without dropping, GLU and plain: fp32 within 1e-5; bf16 with the same
  routing (indices and positions equal) and the output within 2e-2;
- Random Token Selection, held by the two properties the JAX tests check:
  a no-op when the capacity is ample, different victims for different
  generators under overflow;
- ``MoE.apply`` with ``use_residual`` (1e-5) and the expert mask of
  ``split_params_into_moe_groups`` (equal);
- mixtral-tiny: ``CausalLM.apply`` and ``forward_with_cache`` logits (1e-4,
  fp32 over two layers), ``init_inference(...).generate()`` and paged
  ``init_serving`` token-identical to the JAX engines (the embedding
  widened x40, as the other parity tests do), and the HF Mixtral import's
  logits against the JAX model (1e-4) and, without dropping, against HF
  itself (2e-3).
"""

import dataclasses
from types import SimpleNamespace

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
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import decoding as tdec
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

D, F, E = 32, 48, 8


def _gates(rng, N, E=E):
    logits = rng.standard_normal((N, E)).astype(np.float32) * 2.0
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("n,e,k,f,m", [(1, 8, 2, 1.25, 4), (64, 8, 2, 1.25, 4),
                                       (10, 3, 1, 1.0, 1), (2048, 8, 2, 1.25, 4),
                                       (7, 4, 2, 0.25, 2)])
def test_compute_capacity_matches_jax(n, e, k, f, m):
    assert tmoe.compute_capacity(n, e, k, f, m) == jmoe.compute_capacity(n, e, k, f, m)


GATING = [(k, cap) for k in (1, 2) for cap in (64, 5)]


@pytest.mark.parametrize("k,capacity", GATING)
def test_topk_assignments_match_jax(k, capacity):
    """Ample capacity (64) and overflow (5 slots an expert for 48 tokens):
    indices, positions and weights equal, aux within 1e-6."""
    g = _gates(np.random.default_rng(k * 100 + capacity), 48)
    je, jp, jw, ja = jmoe.topk_assignments(jnp.asarray(g), k, capacity)
    te, tp, tw, ta = tmoe.topk_assignments(torch.from_numpy(g), k, capacity)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert abs(float(ta) - float(ja)) <= 1e-6
    dropped = int((tp >= capacity).sum())
    assert (dropped > 0) == (capacity == 5)
    if k == 2:      # every second choice sits after all first choices
        first = torch.bincount(te[:, 0], minlength=E)
        assert bool((tp[:, 1] >= first[te[:, 1]]).all())


@pytest.mark.parametrize("k,capacity", GATING)
def test_topk_gating_matches_jax(k, capacity):
    g = _gates(np.random.default_rng(7 + k + capacity), 48)
    jc, jd, ja = jmoe.topk_gating(jnp.asarray(g), k, capacity)
    tc, td, ta = tmoe.topk_gating(torch.from_numpy(g), k, capacity)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert abs(float(ta) - float(ja)) <= 1e-6


def _moe_cfg(**over):
    base = dict(num_experts=E, num_experts_per_tok=2, moe_capacity_factor=1.25,
                moe_drop_tokens=True, moe_use_rts=False, moe_dispatch="scatter",
                activation="silu", glu=True)
    base.update(over)
    return SimpleNamespace(**base)


def _moe_params(seed, glu=True):
    rng = np.random.default_rng(seed)
    p = {"gate_w": rng.uniform(-D ** -0.5, D ** -0.5, (D, E)),
         "w_up": rng.uniform(-D ** -0.5, D ** -0.5, (E, D, F)),
         "w_down": rng.uniform(-F ** -0.5, F ** -0.5, (E, F, D))}
    if glu:
        p["w_gate"] = rng.uniform(-D ** -0.5, D ** -0.5, (E, D, F))
    return {k: v.astype(np.float32) for k, v in p.items()}


MLP_CASES = [(disp, drop, glu, dt) for disp in ("scatter", "einsum")
             for drop in (True, False) for glu in (True, False)
             for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("dispatch,drop,glu,dtype", MLP_CASES)
def test_moe_mlp_matches_jax(dispatch, drop, glu, dtype):
    """[2, 24, D] tokens (C = 15 of 48 under dropping: tokens are dropped):
    fp32 within 1e-5; bf16: the same routing, the output within 2e-2."""
    cfg = _moe_cfg(moe_dispatch=dispatch, moe_drop_tokens=drop, glu=glu,
                   activation="silu" if glu else "gelu")
    p = _moe_params(3, glu)
    x = np.random.default_rng(4).standard_normal((2, 24, D)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p.items()}
    tx = torch.from_numpy(x).to(tdt)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    jy, jaux = jmoe.moe_mlp(jp, jx, cfg)
    ty, taux = tmoe.moe_mlp(tp, tx, cfg)
    assert ty.dtype == tdt and ty.shape == (2, 24, D)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    # the routing each package computes from the same input
    N = 48
    C = tmoe.compute_capacity(N, E, 2, 1.25) if drop else N
    jg = jax.nn.softmax(jx.reshape(N, D).astype(jnp.float32)
                        @ jp["gate_w"].astype(jnp.float32), axis=-1)
    tg = tmoe.router_gates(tx.reshape(N, D), tp["gate_w"])
    je, jpos, _, _ = jmoe.topk_assignments(jg, 2, C)
    te, tpos, _, _ = tmoe.topk_assignments(tg, 2, C)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert (int((tpos >= C).sum()) > 0) == drop


def test_scatter_and_einsum_dispatch_agree():
    cfg = _moe_cfg()
    p = {k: torch.from_numpy(v) for k, v in _moe_params(5).items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 40, D)).astype(np.float32))
    ys, auxs = tmoe.moe_mlp(p, x, cfg)
    ye, auxe = tmoe.moe_mlp(p, x, _moe_cfg(moe_dispatch="einsum"))
    torch.testing.assert_close(ys, ye, rtol=1e-5, atol=1e-6)
    assert float(auxs) == float(auxe)


def test_rts_noop_when_capacity_ample():
    """With room for every token the permutation changes nothing: the same
    output as sequential selection, and as the JAX function's."""
    cfg = _moe_cfg(moe_capacity_factor=100.0)
    p = _moe_params(8)
    x = np.random.default_rng(9).standard_normal((2, 16, D)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y0, aux0 = tmoe.moe_mlp(tp, torch.from_numpy(x), cfg)
    cfg.moe_use_rts = True
    y1, aux1 = tmoe.moe_mlp(tp, torch.from_numpy(x), cfg,
                            generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(y0, y1, rtol=1e-5, atol=1e-6)
    assert abs(float(aux0) - float(aux1)) <= 1e-6
    jy, _ = jmoe.moe_mlp({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg, rng=jax.random.PRNGKey(5))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_rts_randomizes_overflow_victims():
    """Under a tight capacity RTS decides the victims: two generators drop
    different tokens, and the late tokens stop being the only ones
    dropped; with no generator the content-derived one still runs."""
    cfg = _moe_cfg(moe_capacity_factor=0.25, moe_use_rts=True)
    p = {k: torch.from_numpy(v) for k, v in _moe_params(10).items()}
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 32, D)).astype(np.float32))
    gates = tmoe.router_gates(x.reshape(32, D), p["gate_w"])
    C = tmoe.compute_capacity(32, E, 2, 0.25)

    def kept(seed, rts=True):
        gen = torch.Generator().manual_seed(seed)
        _, _, w, _ = tmoe.topk_assignments(gates, 2, C, gen, rts)
        return (w > 0).any(-1).numpy()

    m1, m2 = kept(0), kept(9)
    assert m1.shape == (32,) and not np.array_equal(m1, m2)
    seq = kept(0, rts=False)
    assert not np.array_equal(m1, seq)
    y, _ = tmoe.moe_mlp(p, x, cfg)
    assert torch.isfinite(y).all()


def test_moe_layer_with_residual_matches_jax():
    """The standalone layer (top-2, use_residual, eval capacity) on carried
    weights: output within 1e-5, aux within 1e-6."""
    kw = dict(hidden_size=D, num_experts=4, k=2, intermediate_size=F,
              use_residual=True, capacity_factor=1.0, eval_capacity_factor=2.0)
    jl, tl = jlayer.MoE(**kw), tlayer.MoE(**kw)
    jp = jl.init(jax.random.PRNGKey(0))
    jp["res_coef"] = jax.random.normal(jax.random.PRNGKey(1), (D, 2)) * 0.3
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ours = tl.init(seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert float(ours["res_coef"].abs().sum()) == 0.0
    x = np.random.default_rng(2).standard_normal((2, 12, D)).astype(np.float32)
    for training in (True, False):
        jy, ja = jl.apply(jp, jnp.asarray(x), training=training)
        ty, ta = tl.apply(tp, torch.from_numpy(x), training=training)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        assert abs(float(ta) - float(ja)) <= 1e-6


def test_split_params_into_moe_groups_matches_jax():
    """The expert mask of a mixtral-tiny tree and of a dense llama tree,
    leaf for leaf as the JAX helper marks them."""
    for preset in ("mixtral-tiny", "llama-tiny"):
        tm = t_causal_lm(preset, device="cpu", num_layers=1, hidden_size=32,
                         intermediate_size=48, num_heads=4, num_kv_heads=2,
                         vocab_size=64)
        tree = tm.params()
        got = tlayer.split_params_into_moe_groups(tree)
        want = jlayer.split_params_into_moe_groups(
            jax.tree.map(lambda t: np.zeros(1), tree))
        assert got == jax.tree.map(bool, want)
        assert tlayer.is_moe_param(tree) == got
        flat = jax.tree.leaves(got)
        assert any(flat) == (preset == "mixtral-tiny")
        if preset == "mixtral-tiny":
            mlp = got["layers"]["mlp"]
            assert mlp == {"gate_w": False, "w_up": True, "w_down": True,
                           "w_gate": True}


# ---------------------------------------------------------------------------
# mixtral-tiny end to end
# ---------------------------------------------------------------------------

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256)


@pytest.fixture(scope="module")
def mixtral(devices):
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev = mesh_mod._GLOBAL_MESH
    mesh = build_mesh(fsdp=8, devices=devices)
    try:
        set_global_mesh(mesh)
        jm = j_causal_lm("mixtral-tiny", mesh=mesh, remat=False, **TINY)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    finally:
        mesh_mod._GLOBAL_MESH = prev
    # a wider embedding spreads the logits away from ties
    params["embed"]["tok"] = params["embed"]["tok"] * 40.0
    tm = t_causal_lm("mixtral-tiny", device="cpu", **TINY)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    return mesh, jm, params, tm, tp


def test_mixtral_param_tree_matches_jax(mixtral):
    _, jm, params, tm, tp = mixtral
    want = jax.tree.map(lambda a: tuple(a.shape), params)
    assert jax.tree.map(lambda t: tuple(t.shape), tm.params()) == want
    assert tp["layers"]["mlp"]["w_up"].shape == (2, 8, 64, 128)
    assert tp["layers"]["mlp"]["gate_w"].shape == (2, 64, 8)


def test_mixtral_apply_logits_match_jax(mixtral):
    """CausalLM.apply (the InferenceEngine's plain forward) on [2, 12]
    tokens: fp32 within 1e-4; with labels the loss and its aux term within
    1e-4 of the JAX loss, and ``initialize`` trains the model (a fresh
    module, so the fixture's weights stay as they are)."""
    mesh, jm, params, tm, tp = mixtral
    toks = np.random.default_rng(0).integers(0, 256, (2, 12))
    set_global_mesh(mesh)
    want = np.asarray(jm.apply(params, jnp.asarray(toks, jnp.int32)))
    got = tm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    eng = deepspeed_tpu_torch.init_inference(tm, {"dtype": "float32"},
                                             params=tp, device="cpu")
    np.testing.assert_allclose(eng(toks).numpy(), want, rtol=1e-4, atol=1e-4)
    want = float(jm.apply(params, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(toks, jnp.int32)))
    got = float(tm.apply(tp, torch.from_numpy(toks), labels=torch.from_numpy(toks)))
    assert got == pytest.approx(want, rel=1e-4)
    fresh = t_causal_lm("mixtral-tiny", device="cpu", **TINY)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=fresh, model_parameters=tp, config={
            "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3}}},
        device="cpu")
    losses = [float(engine.train_step((toks, toks))) for _ in range(2)]
    assert losses[0] == pytest.approx(want, rel=1e-4) and losses[1] < losses[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixtral_forward_with_cache_matches_jax(mixtral, dtype):
    """A 13-token prefill into a contiguous cache, then three decode steps
    at per-row positions: logits within 1e-4 (fp32) / 5e-2 (bf16, two
    layers of bf16 sums in another order)."""
    mesh, jm, params, tm, tp = mixtral
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jpar = jax.tree.map(lambda a: a.astype(jdt), params)
    tpar = jax.tree.map(lambda t: t.to(tdt), tp)
    toks = np.random.default_rng(1).integers(0, 256, (2, 13))
    set_global_mesh(mesh)
    jc = jdec.init_kv_cache(jm.config, 2, 32, dtype=jdt)
    tc = tdec.init_kv_cache(tm.config, 2, 32, tdt, device="cpu")
    tol = 1e-4 if dtype == "float32" else 5e-2
    jl, jc = jdec.forward_with_cache(jm, jpar, jnp.asarray(toks, jnp.int32),
                                     jc, 0)
    tl, tc = tdec.forward_with_cache(tm, tpar, torch.from_numpy(toks), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    pos = np.array([13, 13])
    nxt = np.argmax(np.asarray(jl)[:, -1], -1)
    for _ in range(3):
        jl, jc = jdec.forward_with_cache(jm, jpar,
                                         jnp.asarray(nxt[:, None], jnp.int32),
                                         jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tdec.forward_with_cache(tm, tpar, torch.from_numpy(nxt[:, None]),
                                         tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)
        pos = pos + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixtral_generate_token_identical_to_jax(mixtral, dtype):
    """20 greedy tokens for 3 prompts (batch padded to 4: the pad row takes
    expert capacity in both engines), then with an EOS id; both engines on
    the unfused loop."""
    mesh, jm, params, tm, tp = mixtral
    cfg = {"dtype": dtype, "max_out_tokens": 64}
    set_global_mesh(mesh)
    jeng = deepspeed_tpu.init_inference(jm, dict(cfg), params=params)
    teng = deepspeed_tpu_torch.init_inference(tm, dict(cfg), params=tp,
                                              device="cpu")
    assert teng._dparams is None and jeng._dparams is None
    toks = np.random.default_rng(0).integers(0, 256, (3, 11))
    want = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=20))
    got = teng.generate(toks, max_new_tokens=20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[:, 11:].ravel().tolist())) > 3, "degenerate output"
    eos = int(want[1, 16])
    want = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=20,
                                    eos_token_id=eos))
    got = teng.generate(toks, max_new_tokens=20, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


SERVE_CFG = {"dtype": "float32", "max_out_tokens": 64, "kv_page_tokens": 16,
             "kv_pool_tokens": 80}


def _serve(engine, waves):
    out = []
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=n) for p, n in wave]
        engine.run()
        out += [(list(map(int, r.output_tokens)), r.finish_reason,
                 r.preemptions, r.prefix_hit_tokens) for r in reqs]
    engine.pool.check_no_leak()
    return out


def test_mixtral_serving_token_identical_to_jax(mixtral):
    """Paged serving, two slots, chunked prefill, a preemption and a
    prefix-cache hit: the same tokens, finish reasons, preemptions and
    prefix hits as the JAX engine."""
    mesh, jm, params, tm, tp = mixtral
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, 32)
    waves = [[(rng.integers(0, 256, 18), 30),
              (np.concatenate([shared, rng.integers(0, 256, 5)]), 12)],
             [(shared.copy(), 10), (rng.integers(0, 256, 21), 12)]]
    port = deepspeed_tpu_torch.init_serving(tm, SERVE_CFG, params=tp,
                                            device="cpu", num_slots=2,
                                            prefill_chunk=16)
    assert port.engine._dparams is None
    got = _serve(port, waves)
    set_global_mesh(mesh)
    ref = deepspeed_tpu.init_serving(jm, config=SERVE_CFG, num_slots=2,
                                     prefill_chunk=16)
    ref.set_params(params)
    try:
        want = _serve(ref, waves)
    finally:
        ref.close()
    assert got == want
    assert got[1][2] >= 1 and got[2][3] > 0
    assert len(set(got[0][0])) > 3, "outputs should not be degenerate"


def _save_mixtral(tmp_path):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, tie_word_embeddings=False)
    model = transformers.MixtralForCausalLM(cfg).eval()
    out = str(tmp_path / "mixtral")
    model.save_pretrained(out, safe_serialization=True)
    return out, model


def test_hf_mixtral_logits_match_jax_and_hf(tmp_path):
    """The imported checkpoint's logits against the JAX import (1e-4, the
    same capacity and drops) and, with dropping off (HF routes every token
    to its top 2), against HF's own forward (2e-3)."""
    from deepspeed_tpu.module_inject import containers as jct
    from deepspeed_tpu_torch.module_inject import containers as tct

    path, hf = _save_mixtral(tmp_path)
    toks = np.random.default_rng(3).integers(0, 128, (2, 9))
    model = tct.causal_lm_from_hf(path, device="cpu")
    assert model.config.is_moe and model.config.num_experts == 4
    got = model.apply(model.params(), torch.from_numpy(toks)).numpy()
    jm, jparams = jct.causal_lm_from_hf(path)
    jm.config.remat = False
    assert dataclasses.asdict(jm.config) == dataclasses.asdict(model.config) | \
        {"remat": False}
    want = np.asarray(jm.apply(jparams, jnp.asarray(toks, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    model.config.moe_drop_tokens = False
    nodrop = model.apply(model.params(), torch.from_numpy(toks)).numpy()
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(nodrop, ref, rtol=2e-3, atol=2e-3)
