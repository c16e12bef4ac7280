"""int8 weights of the port against the JAX package, on the CPU.

- ``quantize_weight`` against the JAX quantizer jitted as the JAX engine
  runs it (XLA turns ``absmax / 127`` into a product with the fp32
  reciprocal): at most one code and one ulp of scale apart (measured: equal);
- ``quantize_layer_params`` quantizes the same leaves (stacked layer
  matmuls and the head; embeddings, norms, biases and an MoE MLP stay
  dense), ``dequantize_tree`` gives JAX's dense tree, and a JAX int8 tree
  carried across keeps its codes, scales and bytes;
- the int8 engine with JAX's codes carried across: ``engine(tokens)``
  logits within 2e-2 (bf16: a few roundings of activations of order 1, on
  logits up to ~4), ``generate()`` tokens identical to the JAX int8
  engine's on the fused and the unfused path, and to the JAX
  ``init_serving(dtype="int8")`` wave on the paged engine;
- the port's own int8 engine keeps >= 75 % of the bf16 engine's greedy
  tokens, the bound ``tests/unit/test_inference_int8.py`` holds JAX to.
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
from deepspeed_tpu.models import quant as jquant
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.models import quant as tquant
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, tie_embeddings=False)
INT8 = {"dtype": "int8", "max_out_tokens": 64}


def _np_tree(tree):
    """A JAX tree -> numpy leaves, int8 leaves as {"q", "scale"} pairs."""
    return jax.tree.map(
        lambda x: ({"q": np.asarray(x.q), "scale": np.asarray(x.scale)}
                   if jquant.is_qtensor(x) else np.asarray(x)),
        tree, is_leaf=jquant.is_qtensor)


@pytest.mark.parametrize("shape", [(256, 96), (3, 64, 48), (2, 128, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_matches_jitted_jax(shape, dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 5] = 0.0                                  # an all-zero column: scale 1
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    want = jax.jit(jquant.quantize_weight)(jw)
    got = tquant.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tuple(got.scale.shape) == tuple(want.scale.shape) \
        == shape[:-2] + (1, shape[-1])
    codes = np.abs(np.asarray(want.q).astype(np.int32) - got.q.numpy())
    assert codes.max() <= 1
    ulps = np.abs(np.asarray(want.scale).view(np.int32)
                  - got.scale.numpy().view(np.int32))
    assert ulps.max() <= 1
    assert float(got.scale[..., 5].max()) == 1.0
    # the per-column bound of a symmetric quantizer
    err = np.abs(got.astype(torch.float32).numpy() - np.asarray(
        jw.astype(jnp.float32)))
    assert np.all(err <= got.scale.numpy() / 2 + 1e-7)


@pytest.mark.parametrize("preset,over", [
    ("llama-tiny", TINY),
    ("gpt2-small", dict(num_layers=2, hidden_size=64, intermediate_size=256,
                        num_heads=4, vocab_size=256, max_seq_len=64))])
def test_quantize_layer_params_takes_the_same_leaves(preset, over):
    """The same leaves become int8 on both sides, with equal codes and
    scales (one code, one ulp), and dequantize_tree gives JAX's dense
    tree; the bytes of the quantized tree match."""
    jm = j_causal_lm(preset, remat=False, **over)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    jq = jax.jit(lambda p: jquant.quantize_layer_params(p, jm.config))(params)
    tm = t_causal_lm(preset, device="cpu", **over)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu", dtype=torch.bfloat16)
    tq = tquant.quantize_layer_params(tp, tm.config)
    jflat = jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=jquant.is_qtensor)[0]
    n_q = 0
    for path, jleaf in jflat:
        tleaf = tq
        for p in path:
            tleaf = tleaf[p.key]
        assert jquant.is_qtensor(jleaf) == tquant.is_qtensor(tleaf), path
        if tquant.is_qtensor(tleaf):
            n_q += 1
            assert np.abs(np.asarray(jleaf.q).astype(np.int32)
                          - tleaf.q.numpy()).max() <= 1
            assert tleaf.nbytes == jleaf.nbytes
    assert n_q > 0
    assert not tquant.is_qtensor(tq["embed"]["tok"])
    carried = jax_params_to_torch(_np_tree(jq), tm.config, device="cpu",
                                  dtype=torch.bfloat16)
    want = jquant.dequantize_tree(jq, jnp.bfloat16)
    got = tquant.dequantize_tree(carried, torch.bfloat16)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(
                                jax.tree.map(lambda t: t.float().numpy(),
                                             got))):
        np.testing.assert_array_equal(np.asarray(w.astype(jnp.float32)), g,
                                      err_msg=str(path))


def test_moe_mlp_stays_dense():
    """A mixtral-tiny tree (the JAX init carried across): its MLP leaves
    (the router and the experts) stay dense on both sides, its attention
    leaves and head are quantized to the same codes."""
    jm = j_causal_lm("mixtral-tiny", remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = t_causal_lm("mixtral-tiny", device="cpu", **TINY)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    jq = jquant.quantize_layer_params(params, jm.config)
    tq = tquant.quantize_layer_params(tp, tm.config)
    for got, want in ((tq["layers"]["attn"]["wq"], jq["layers"]["attn"]["wq"]),
                      (tq["lm_head"], jq["lm_head"])):
        assert tquant.is_qtensor(got) and jquant.is_qtensor(want)
    assert set(tq["layers"]["mlp"]) == {"gate_w", "w_up", "w_gate", "w_down"}
    for name, leaf in tq["layers"]["mlp"].items():
        assert not tquant.is_qtensor(leaf), name
        assert not jquant.is_qtensor(jq["layers"]["mlp"][name]), name
        assert leaf is tp["layers"]["mlp"][name]
    assert not tquant.is_qtensor(tq["layers"]["attn_norm"]["scale"])
    eng = deepspeed_tpu_torch.init_inference(tm, INT8, params=tp, device="cpu")
    assert not tquant.is_qtensor(eng._params["layers"]["mlp"]["w_up"])
    assert eng._params["layers"]["mlp"]["w_up"].dtype == torch.bfloat16


def test_set_params_quantizes_one_layer_slice_at_a_time():
    """The int8 engine moves and quantizes a stacked leaf one [D, F] layer
    slice at a time: no floating tensor it makes is larger than one slice
    (a bf16 copy of a whole [L, D, F] leaf was the peak before), and the
    codes and scales are those of quantizing the bf16 tree whole."""
    from torch.utils._python_dispatch import TorchDispatchMode

    over = dict(TINY, num_layers=3, hidden_size=64, intermediate_size=160,
                vocab_size=128)
    tm = t_causal_lm("llama-tiny", device="cpu", **over)
    D, F = 64, 160
    sizes = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in jax.tree.leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    sizes.append((t.numel(), str(func)))
            return out

    with Record():
        eng = deepspeed_tpu_torch.init_inference(tm, INT8, params=tm.params(),
                                                 device="cpu")
    assert sizes and max(sizes)[0] <= D * F, max(sizes)
    whole = tquant.quantize_layer_params(
        jax.tree.map(lambda t: t.to(torch.bfloat16), tm.params()), tm.config)
    got, want = eng._params, whole
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(
            want, is_leaf=tquant.is_qtensor)[0],
            jax.tree.leaves(got, is_leaf=tquant.is_qtensor)):
        if tquant.is_qtensor(w):
            assert tquant.is_qtensor(g), path
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale), path
        else:
            assert torch.equal(g, w), path
    assert tquant.is_qtensor(got["layers"]["mlp"]["w_up"])


def test_carried_int8_leaves_keep_codes_and_refuse_misfits():
    jm = j_causal_lm("llama-tiny", remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    jq = jquant.quantize_layer_params(params, jm.config)
    tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
    tree = _np_tree(jq)
    got = jax_params_to_torch(tree, tm.config, device="cpu")
    wq = got["layers"]["attn"]["wq"]
    assert tquant.is_qtensor(wq) and wq.q.dtype == torch.int8
    np.testing.assert_array_equal(wq.q.numpy(), tree["layers"]["attn"]["wq"]["q"])
    np.testing.assert_array_equal(wq.scale.numpy(),
                                  tree["layers"]["attn"]["wq"]["scale"])
    assert tquant.is_qtensor(wq[1]) and tuple(wq[1].shape) == (64, 64)
    bad = dict(tree["layers"]["attn"]["wq"],
               scale=tree["layers"]["attn"]["wq"]["scale"][..., :32])
    tree["layers"]["attn"]["wq"] = bad
    with pytest.raises(ValueError, match="int8 leaf"):
        jax_params_to_torch(tree, tm.config, device="cpu")


@pytest.fixture(scope="module")
def int8_models(devices):
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
    return mesh, jm, params, tm


def _int8_pair(int8_models, cfg):
    """The JAX int8 engine, and the port's engine on JAX's codes and
    scales (so that the kernels, not the quantizers, are compared)."""
    mesh, jm, params, tm = int8_models
    set_global_mesh(mesh)
    jeng = deepspeed_tpu.init_inference(jm, dict(cfg), params=params)
    carried = jax_params_to_torch(_np_tree(jeng._params), tm.config,
                                  device="cpu", dtype=torch.bfloat16)
    teng = deepspeed_tpu_torch.init_inference(tm, dict(cfg), params=carried,
                                              device="cpu")
    return jeng, teng


@pytest.mark.parametrize("fused", [True, False])
def test_int8_engine_matches_jax(int8_models, fused):
    cfg = dict(INT8) if fused else dict(INT8, use_fused_decode=False)
    jeng, teng = _int8_pair(int8_models, cfg)
    assert (teng._dparams is not None) is fused
    assert teng.dtype == torch.bfloat16
    wqkv = teng._dparams["layers"][0]["wqkv"] if fused else None
    if fused:   # the injected QKV concatenates codes and scales
        assert tquant.is_qtensor(wqkv) and tuple(wqkv.scale.shape) == (1, 128)
    toks = np.random.default_rng(0).integers(0, 256, (3, 11))
    want = np.asarray(jeng(jnp.asarray(toks)).astype(jnp.float32))
    got = teng(toks)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    want = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=16))
    got = teng.generate(toks, max_new_tokens=16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[:, 11:].ravel().tolist())) > 3


def test_int8_greedy_tokens_stay_close_to_bf16(int8_models):
    """The port's own quantizer on the same weights: at least 75 % of the
    bf16 engine's greedy tokens (tests/unit/test_inference_int8.py)."""
    _, jm, params, tm = int8_models
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    toks = np.random.default_rng(5).integers(0, 256, (2, 16))
    outs = {}
    for dtype in ("bfloat16", "int8"):
        eng = deepspeed_tpu_torch.init_inference(
            tm, {"dtype": dtype, "max_out_tokens": 64}, params=tp,
            device="cpu")
        outs[dtype] = eng.generate(toks, max_new_tokens=12).numpy()
    match = (outs["int8"][:, -12:] == outs["bfloat16"][:, -12:]).mean()
    assert match >= 0.75, match
    held = sum(t.nbytes if tquant.is_qtensor(t) else t.numel() * t.element_size()
               for t in jax.tree_util.tree_leaves(
                   eng._params, is_leaf=tquant.is_qtensor))
    dense = sum(t.numel() * 2 for t in jax.tree_util.tree_leaves(tp))
    assert held < 0.7 * dense


def test_int8_serving_matches_jax(int8_models):
    """init_serving(dtype="int8"): the paged engine on the fused path
    (paged flash_decode beside the int8 GEMVs) serves the JAX engine's
    tokens, with JAX's codes carried across."""
    mesh, jm, params, tm = int8_models
    cfg = {"dtype": "int8", "max_out_tokens": 64, "kv_page_tokens": 16}
    set_global_mesh(mesh)
    ref = deepspeed_tpu.init_serving(jm, config=dict(cfg), num_slots=2,
                                     prefill_chunk=16)
    ref.set_params(params)
    carried = jax_params_to_torch(_np_tree(ref.engine._params), tm.config,
                                  device="cpu", dtype=torch.bfloat16)
    port = deepspeed_tpu_torch.init_serving(tm, cfg, params=carried,
                                            device="cpu", num_slots=2,
                                            prefill_chunk=16)
    assert port.engine._dparams is not None
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n) for n in (23, 9, 37)]
    try:
        reqs = [ref.submit(p, max_new_tokens=10) for p in prompts]
        ref.run()
        want = [list(map(int, r.output_tokens)) for r in reqs]
    finally:
        ref.close()
    reqs = [port.submit(p, max_new_tokens=10) for p in prompts]
    port.run()
    port.pool.check_no_leak()
    got = [list(map(int, r.output_tokens)) for r in reqs]
    assert got == want
