"""The GPT-2 family of the port against the JAX package, on the CPU.

A 2-layer narrow gpt2-shaped model (learned positions, LayerNorm, tanh-GeLU,
a plain MLP, tied embeddings), once as the repo's presets are
(``use_bias=False``) and once with every projection bias
(``use_bias=True``), in fp32.  Weights are drawn by the JAX init; the leaves
it fills with constants (norm scales and biases, projection biases) are
redrawn from numpy with a seed so that each takes part, and the tree
crosses over with ``jax_params_to_torch``.

Covered: the parameter tree and its conversion, ``forward_with_cache``
(prefill at a scalar offset, per-row decode), ``decode_step`` against the
JAX one with its Pallas kernels in interpret mode, token-identical serving
on the fused and the unfused decode path against the JAX engine, the
training forward (loss, gradients, logits) against ``jax.value_and_grad``,
and the port's engine against ``deepspeed_tpu.initialize`` over three fp32
steps with remat on and off.

Tolerances, as the llama tests of the same paths hold: logits 1e-4
(fp32 matmuls in another order) and 2e-4 through ``decode_step``
(attention: an online softmax against a dense one); loss 1e-5, gradients
1e-4; engine loss and grad norm rtol 1e-5, lr 1e-7, weights atol 1e-4
after Adam steps (a gradient element near Adam's eps turns a 1e-7 relative
difference into a visible step difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.comm.mesh import build_mesh, set_global_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.models import fused_decode as jfd
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import decoding as tdec
from deepspeed_tpu_torch.models import fused_decode as tfd
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.models.convert import torch_params_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

GPT2_TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128,
                 num_heads=4, vocab_size=256, max_seq_len=512)
ATOL = 1e-4


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _build(use_bias, mesh=None, remat=False, **over):
    """(JAX model, JAX params, port model, numpy params): the JAX init with
    its constant leaves (ones and zeros: norm scales, every bias) redrawn
    from a seed."""
    cfg = dict(GPT2_TINY, use_bias=use_bias, remat=remat, **over)
    kw = {} if mesh is None else {"mesh": mesh}
    jm = j_causal_lm("gpt2-small", **kw, **cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(11)
    flat = _flat(jax.tree.map(np.asarray, params))
    for path, a in flat.items():
        if np.all(a == 1.0):
            flat[path] = (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif np.all(a == 0.0):
            flat[path] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    np_params = _unflat(flat)
    tm = t_causal_lm("gpt2-small", device="cpu", **cfg)
    return jm, jax.tree.map(jnp.asarray, np_params), tm, np_params


@pytest.fixture(scope="module", params=[False, True], ids=["nobias", "bias"])
def gpt2(request):
    jm, params, tm, np_params = _build(request.param)
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    return jm, params, tm, tp, np_params


# ---------------------------------------------------------------------------
# parameter tree
# ---------------------------------------------------------------------------

def test_gpt2_param_tree_round_trip(gpt2):
    jm, params, tm, tp, np_params = gpt2
    jflat = _flat(np_params)
    sd = tm.state_dict()
    assert sorted(sd) == sorted(jflat)          # module names ARE tree paths
    for name, arr in jflat.items():
        assert tuple(sd[name].shape) == arr.shape, name
    assert "embed.pos" in jflat and "final_norm.bias" in jflat
    assert jflat["layers.attn_norm.bias"].shape == (2, 64)
    assert ("layers.attn.bo" in jflat) == tm.config.use_bias
    assert ("layers.mlp.b_up" in jflat) == tm.config.use_bias
    assert len(jflat) == (20 if tm.config.use_bias else 14)
    tflat = _flat(tp)
    for name, arr in jflat.items():             # numpy -> torch is exact
        np.testing.assert_array_equal(tflat[name].numpy(), arr)
    back = _flat(torch_params_to_numpy(tp))     # and back
    for name, arr in jflat.items():
        np.testing.assert_array_equal(back[name], arr)
    bad = _unflat(dict(jflat))
    del bad["embed"]["pos"]
    with pytest.raises(ValueError):
        jax_params_to_torch(bad, tm.config, device="cpu")


def test_gpt2_preset_leaves_and_size():
    """gpt2-xl as the port builds it: 14 leaves, 1.5569 B parameters."""
    from deepspeed_tpu_torch.models.config import get_model_config
    from deepspeed_tpu_torch.models.transformer import param_shapes

    flat = _flat(param_shapes(get_model_config("gpt2-xl")))
    assert len(flat) == 14
    n = sum(int(np.prod(shape)) for shape, _, _ in flat.values())
    assert n == 1_556_920_000
    assert flat["embed.pos"][0] == (1024, 1600)
    assert flat["layers.mlp_norm.bias"][0] == (48, 1600)


# ---------------------------------------------------------------------------
# serving forward
# ---------------------------------------------------------------------------

def test_gpt2_prefill_and_per_row_decode_match_jax(gpt2):
    jm, params, tm, tp, _ = gpt2
    toks = np.random.default_rng(4).integers(0, 256, (2, 24))
    jc = jdec.init_kv_cache(jm.config, 2, 64, dtype=jnp.float32)
    tc = tdec.init_kv_cache(tm.config, 2, 64, torch.float32, device="cpu")
    for lo, hi in ((0, 16), (16, 24)):          # the second at an offset
        jl, jc = jdec.forward_with_cache(jm, params, jnp.asarray(toks[:, lo:hi]),
                                         jc, lo)
        tl, tc = tdec.forward_with_cache(tm, tp, torch.from_numpy(toks[:, lo:hi]),
                                         tc, lo)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=0)
    pos = np.array([24, 9], np.int32)           # every row at its own depth
    tok = np.array([[7], [201]])
    for _ in range(3):
        jl, jc = jdec.forward_with_cache(jm, params, jnp.asarray(tok), jc,
                                         jnp.asarray(pos))
        tl, tc = tdec.forward_with_cache(tm, tp, torch.from_numpy(tok), tc,
                                         torch.from_numpy(pos).long())
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=0)
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc[name]), tc[name].numpy(),
                                   atol=ATOL, rtol=0)


def test_gpt2_decode_step_matches_jax_interpret(gpt2):
    """Three paged decode steps (page 128, shuffled table, a parked row on
    the junk page): the four fused calls per layer take kind=layernorm with
    norm biases, GeLU and no gate; learned positions are added at each
    row's own depth and nothing is rotated."""
    jm, params, tm, tp, _ = gpt2
    cfg = jm.config
    jd = jfd.inject_decode_params(params, cfg)
    td = tfd.inject_decode_params(tp, tm.config)
    for jl, tl in zip(jd["layers"], td["layers"]):
        assert sorted(jl) == sorted(tl) and "n1_bias" in tl and "w_gate" not in tl
    rng = np.random.default_rng(7)
    L, Hkv, Dh, page, maxp = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 128, 3
    table = np.zeros((3, maxp), np.int64)
    table[0] = [3, 1, 5]
    table[1, :2] = [6, 2]                       # row 2 parked on the junk page
    k = (rng.standard_normal((L, 7, Hkv, page, Dh)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, 7, Hkv, page, Dh)) * 0.5).astype(np.float32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    pos = np.array([254, 127, 0])
    tok = np.array([[3], [99], [0]])
    for _ in range(3):
        jl, jc = jfd.decode_step(cfg, jd, jnp.asarray(tok), jc,
                                 jnp.asarray(pos, jnp.int32),
                                 page_table=jnp.asarray(table, jnp.int32),
                                 impl="interpret")
        tl, tc = tfd.decode_step(tm.config, td, torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos),
                                 page_table=torch.from_numpy(table))
        np.testing.assert_allclose(np.asarray(jl)[:2], tl[:2].numpy(),
                                   rtol=2e-4, atol=2e-4)
        tok = np.array(jnp.argmax(jl, -1))[:, None]
        tok[2] = 0
        pos[:2] += 1
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc[name])[:, 1:],
                                   tc[name][:, 1:].numpy(), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# serving, the slice as a whole
# ---------------------------------------------------------------------------

# 5 usable 16-token pages for two 64-token slots: the pool must preempt
SERVE_CFG = {"dtype": "float32", "max_out_tokens": 64, "kv_page_tokens": 16,
             "kv_pool_tokens": 80}


def _waves():
    """Wave 1: an 18-token prompt and a chunked 37-token one that together
    overrun the pool (preemption).  Wave 2: an exact re-ask of the shared
    32-token prefix (a copy-on-write prefix hit) and a fresh prompt."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, 32)
    return [[(rng.integers(0, 256, 18), 30),
             (np.concatenate([shared, rng.integers(0, 256, 5)]), 12)],
            [(shared.copy(), 10), (rng.integers(0, 256, 21), 12)]]


def _serve(engine):
    out = []
    for wave in _waves():
        reqs = [engine.submit(p, max_new_tokens=n) for p, n in wave]
        engine.run()
        out += [(list(map(int, r.output_tokens)), r.finish_reason,
                 r.preemptions, r.prefix_hit_tokens) for r in reqs]
    engine.pool.check_no_leak()
    engine.prefix_cache.check_no_leak()
    return out


@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_gpt2_serving_token_identical_to_jax(devices, fused, use_bias):
    mesh = build_mesh(fsdp=8, devices=devices)
    set_global_mesh(mesh)
    jm, params, tm, np_params = _build(use_bias, mesh=mesh)
    # a wider embedding (and with it the tied head) spreads the logits:
    # greedy picks sit far from ties (top-two gaps of ~1e-2 against fp32
    # differences of ~1e-5), so token identity tests the algorithm rather
    # than rounding.  Through the tied head a wide token embedding alone
    # makes every step repeat its input; a position table wider still keeps
    # the outputs varied
    np_params["embed"]["tok"] = np_params["embed"]["tok"] * 16.0
    np_params["embed"]["pos"] = np_params["embed"]["pos"] * 80.0
    params = jax.tree.map(jnp.asarray, np_params)
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    cfg = dict(SERVE_CFG) if fused else dict(SERVE_CFG, use_fused_decode=False)
    port = deepspeed_tpu_torch.init_serving(tm, cfg, params=tp, device="cpu",
                                            num_slots=2, prefill_chunk=16)
    assert (port.engine._dparams is not None) is fused
    got = _serve(port)
    ref = deepspeed_tpu.init_serving(jm, config=cfg, num_slots=2,
                                     prefill_chunk=16)
    ref.set_params(params)
    try:
        assert (ref.engine._dparams is not None) is fused
        want = _serve(ref)
    finally:
        ref.close()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {i}: port {g} != jax {w}"
    assert got[1][2] >= 1, "wave 1 must preempt"
    assert got[2][3] == 31 and port.stats["cow_copies"] >= 1
    assert port.stats["prefill_chunks"] > len(got), "prefill must be chunked"
    assert len(set(got[0][0])) > 3, "outputs should not be degenerate"


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_learned_positions_bound_the_serving_window(devices, fused):
    """A KV window larger than the position table (``max_out_tokens`` above
    ``max_seq_len``) is served as the JAX engine serves it: token-identical
    wherever the table holds the position.  A 35-token prompt's last padded
    chunk reads rows 40..47 of a 40-row table (junk no query attends); a
    20-token prompt asked for 30 tokens runs into the table's end, where the
    JAX engine goes on with NaN position rows (argmax 0) and the port stops
    with ``cache_budget``."""
    mesh = build_mesh(fsdp=8, devices=devices)
    set_global_mesh(mesh)
    jm, params, tm, np_params = _build(False, mesh=mesh, max_seq_len=40)
    np_params["embed"]["tok"] = np_params["embed"]["tok"] * 16.0
    np_params["embed"]["pos"] = np_params["embed"]["pos"] * 80.0
    params = jax.tree.map(jnp.asarray, np_params)
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    cfg = {"dtype": "float32", "max_out_tokens": 64, "kv_page_tokens": 16}
    if not fused:
        cfg["use_fused_decode"] = False
    rng = np.random.default_rng(1)
    asks = [(rng.integers(0, 256, 35), 3), (rng.integers(0, 256, 20), 30)]

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=n) for p, n in asks]
        engine.run()
        return [(list(map(int, r.output_tokens)), r.finish_reason) for r in reqs]

    port = deepspeed_tpu_torch.init_serving(tm, cfg, params=tp, device="cpu",
                                            num_slots=2, prefill_chunk=16)
    assert port.cache_len == 64 and port.max_out == 40
    got = serve(port)
    ref = deepspeed_tpu.init_serving(jm, config=cfg, num_slots=2,
                                     prefill_chunk=16)
    ref.set_params(params)
    try:
        want = serve(ref)
    finally:
        ref.close()
    assert got[0] == want[0] == (want[0][0], "length")
    assert got[1][1] == "cache_budget" and len(got[1][0]) == 20
    assert got[1][0] == want[1][0][:20]
    assert len(set(got[1][0])) > 3, "outputs should not be degenerate"
    assert want[1][0][21:] == [0] * 9          # past the table: NaN rows
    with pytest.raises(ValueError, match="max_out_tokens=40"):
        port.submit(np.arange(41), max_new_tokens=1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
def test_gpt2_loss_and_grads_match_jax(gpt2, remat):
    jm, params, tm, _, np_params = gpt2
    jm.config.remat = tm.config.remat = remat
    tok = _tokens(2, 32, 0)
    mask = (np.random.default_rng(1).random(tok.shape) > 0.2).astype(np.int32)
    try:
        jloss, jgrads = jax.value_and_grad(
            lambda p: jm.apply(p, tok, tok, loss_mask=mask))(params)
        tp = jax_params_to_torch(np_params, tm.config, device="cpu")
        for t in _flat(tp).values():
            t.requires_grad_()
        tloss = tm.apply(tp, torch.from_numpy(tok), torch.from_numpy(tok),
                         torch.from_numpy(mask))
        tloss.backward()
        logits_j = jm.apply(params, tok)
        with torch.no_grad():
            logits_t = tm.apply(tp, torch.from_numpy(tok))
    finally:
        jm.config.remat = tm.config.remat = False
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    tflat = _flat(tp)
    assert set(jflat) == set(tflat)
    for path, t in tflat.items():
        np.testing.assert_allclose(t.grad.numpy(), jflat[path], rtol=1e-4,
                                   atol=1e-4, err_msg=path)
    if tm.config.use_bias:
        # the key bias has no gradient in exact arithmetic (a shift of every
        # key by one vector moves all of a query's scores alike, and softmax
        # ignores it): in both packages what is left is rounding noise
        for bk, bq in ((tflat["layers.attn.bk"].grad.numpy(),
                        tflat["layers.attn.bq"].grad.numpy()),
                       (jflat["layers.attn.bk"], jflat["layers.attn.bq"])):
            assert np.linalg.norm(bk) < 1e-6 * np.linalg.norm(bq)
    assert float(tflat["embed.pos"].grad[:32].abs().max()) > 0
    assert float(tflat["embed.pos"].grad[32:].abs().max()) == 0   # S = 32
    np.testing.assert_allclose(np.asarray(logits_j), logits_t.numpy(),
                               atol=ATOL, rtol=0)


def test_embed_norm_trains_like_jax():
    """The LayerNorm after the embedding (bloom's
    ``word_embeddings_layernorm``) in the training forward: loss and the
    gradients of its scale and bias against JAX."""
    jm, params, tm, np_params = _build(False, embed_norm=True)
    tok = _tokens(2, 24, 3)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(p, tok, tok))(params)
    tp = jax_params_to_torch(np_params, tm.config, device="cpu")
    for t in _flat(tp).values():
        t.requires_grad_()
    tloss = tm.apply(tp, torch.from_numpy(tok), torch.from_numpy(tok))
    tloss.backward()
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    for path in ("embed.norm.scale", "embed.norm.bias", "embed.tok", "embed.pos"):
        np.testing.assert_allclose(_flat(tp)[path].grad.numpy(), jflat[path],
                                   rtol=1e-4, atol=1e-4, err_msg=path)


DS_CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
             "optimizer": {"type": "FusedAdam", "params": {
                 "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
             "scheduler": {"type": "WarmupLR", "params": {
                 "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
             "gradient_clipping": 1.0, "steps_per_print": 10**9}


@pytest.fixture(scope="module", params=[(False, False), (True, False),
                                        (True, True)],
                ids=["noremat-nobias", "remat-nobias", "remat-bias"])
def gpt2_engines(request):
    """Both engines from the same weights, three train_steps on one repeated
    stacked [gas, micro, S] batch; ``remat=True`` is the gpt2-xl preset's
    setting (policy "full": the whole layer is recomputed)."""
    remat, use_bias = request.param
    jm, params, tm, np_params = _build(use_bias, remat=remat)
    assert jm.config.remat is remat and tm.config.remat_policy == "full"
    # the JAX engine makes its one-device mesh the process-global one; a
    # module-scoped fixture runs before the per-test guard that restores the
    # global mesh, so this fixture puts the previous one back itself
    prev_mesh = mesh_mod._GLOBAL_MESH
    try:
        mesh = build_mesh(devices=jax.devices()[:1])
        jeng, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                            config=DS_CONFIG, mesh=mesh)
        teng, *_ = deepspeed_tpu_torch.initialize(
            model=tm, model_parameters=np_params, config=DS_CONFIG,
            device="cpu")
        tok = _tokens(4, 32, 10).reshape(2, 2, 32)
        rec = {"j": [], "t": []}
        for _ in range(3):
            for key, eng in (("j", jeng), ("t", teng)):
                loss = eng.train_step((tok, tok))
                rec[key].append((float(loss), eng.get_global_grad_norm(),
                                 eng.get_lr()[0]))
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    return jeng, teng, rec, np_params


def test_gpt2_engine_matches_jax_engine_per_step(gpt2_engines):
    _, teng, rec, _ = gpt2_engines
    assert teng.global_steps == 3
    for (jl, jn, jlr), (tl, tn, tlr) in zip(rec["j"], rec["t"]):
        assert tl == pytest.approx(jl, rel=1e-5)
        assert tn == pytest.approx(jn, rel=1e-5)
        assert tlr == pytest.approx(jlr, rel=1e-7)
    assert rec["t"][2][0] < rec["t"][0][0]            # it learns


def test_gpt2_engine_final_params_match_jax(gpt2_engines):
    """Every leaf, the vectors too: the JAX optimizer decays norm scales,
    biases and the position table like any weight (no mask), and so does
    the port."""
    jeng, teng, _, np_params = gpt2_engines
    jflat = _flat(jax.tree.map(np.asarray, jeng.state.params))
    tflat = _flat(torch_params_to_numpy(teng.params()))
    assert set(jflat) == set(tflat)
    start = _flat(np_params)
    for path in jflat:
        if path == "layers.attn.bk":
            # a zero-gradient leaf (test_gpt2_loss_and_grads_match_jax holds
            # its gradient to 1e-6 of the query bias's in both packages):
            # Adam normalises that rounding noise into steps of up to lr
            # each, so the two engines' values are not comparable; each stays
            # within the 3 steps of lr 3e-3 (and their weight decay) that
            # Adam can move it
            for flat in (tflat, jflat):
                assert float(np.abs(flat[path] - start[path]).max()) <= 1e-2
            continue
        np.testing.assert_allclose(tflat[path], jflat[path], atol=1e-4, rtol=0,
                                   err_msg=path)
    for path in ("final_norm.scale", "layers.attn_norm.bias", "embed.pos"):
        assert float(np.abs(tflat[path] - start[path]).max()) > 1e-4, path


def test_gpt2_engine_hands_out_per_layer_leaf_views(gpt2_engines):
    """The stacked [L, D] norm leaves are handed to autograd as L leaf
    tensors of size [D] (so a layer's gradient has that layer's size), the
    unstacked vectors and tables as one leaf each."""
    _, teng, _, _ = gpt2_engines
    tree = teng._compute_params()
    scale = tree["layers"]["attn_norm"]["scale"]
    assert isinstance(scale, list) and len(scale) == 2
    assert all(t.shape == (64,) and t.is_leaf and t.requires_grad for t in scale)
    assert tree["final_norm"]["bias"].shape == (64,)
    assert tree["embed"]["pos"].shape == (512, 64)
    assert len(teng.master) == (20 if teng.module.config.use_bias else 14)
