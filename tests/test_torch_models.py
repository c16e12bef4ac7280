"""The port's model modules against the JAX package, on the CPU.

Config and preset equality, the weight conversion, and
``forward_with_cache`` logits on a 2-layer GQA llama in fp32 (atol 1e-4:
fp32 matmuls in a different order) in every form the serving path uses:
prefill at a scalar offset, per-row decode, and paged decode — each on a
cache short enough for the dense attention path and one long enough for
the flash-decode path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.models import config as jconfig
from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import config as tconfig
from deepspeed_tpu_torch.models import decoding as tdec
from deepspeed_tpu_torch.models import jax_params_to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=1024)
ATOL = 1e-4


def test_model_config_fields_and_presets_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.ModelConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.ModelConfig)]
    assert tf == jf
    assert tconfig._PRESETS == jconfig._PRESETS
    for name in jconfig._PRESETS:
        assert (dataclasses.asdict(tconfig.get_model_config(name))
                == dataclasses.asdict(jconfig.get_model_config(name)))
    over = dict(TINY, rotary_pct=0.5)
    assert (dataclasses.asdict(tconfig.get_model_config("llama-tiny", **over))
            == dataclasses.asdict(jconfig.get_model_config("llama-tiny",
                                                           **over)))


@pytest.fixture(scope="module")
def models():
    jm = j_causal_lm("llama-tiny", remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    return jm, params, tm, tp


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def test_param_tree_names_and_conversion_round_trip(models):
    jm, params, tm, tp = models
    jflat = _paths(jax.tree.map(np.asarray, params))
    # the module's parameter names ARE the JAX tree paths
    sd = tm.state_dict()
    assert sorted(sd) == sorted(jflat)
    for name, arr in jflat.items():
        assert tuple(sd[name].shape) == arr.shape, name
    # numpy -> torch -> numpy is exact
    tflat = _paths(tp)
    assert sorted(tflat) == sorted(jflat)
    for name, arr in jflat.items():
        np.testing.assert_array_equal(tflat[name].numpy(), arr)
    bad = jax.tree.map(np.asarray, params)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="layers.attn.wq"):
        jax_params_to_torch(bad, tm.config, device="cpu")
    del bad["final_norm"]
    with pytest.raises(ValueError):
        jax_params_to_torch(bad, tm.config, device="cpu")


def _cache_pair(cfg, batch, max_len, seed):
    """The same random cache contents on both sides."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def _close_cache(jc, tc):
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc[name]), tc[name].numpy(),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("max_len", [64, 512])
def test_prefill_at_scalar_offset_matches_jax(models, max_len):
    jm, params, tm, tp = models
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 24))
    jc = jdec.init_kv_cache(jm.config, 2, max_len, dtype=jnp.float32)
    tc = tdec.init_kv_cache(tm.config, 2, max_len, torch.float32, device="cpu")
    assert jc["k"].shape == tuple(tc["k"].shape)
    # two chunks: [0, 16) then [16, 24) at a scalar offset
    for lo, hi in ((0, 16), (16, 24)):
        jl, jc = jdec.forward_with_cache(jm, params, jnp.asarray(toks[:, lo:hi]),
                                         jc, lo)
        tl, tc = tdec.forward_with_cache(tm, tp, torch.from_numpy(toks[:, lo:hi]),
                                         tc, lo)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL,
                                   rtol=0)
    _close_cache(jc, tc)


@pytest.mark.parametrize("max_len", [64, 512])
def test_per_row_decode_matches_jax(models, max_len):
    """Continuous-batching decode: every row at its own depth; at 512 the
    flash-decode branch runs (rows 300 and 17 deep: the shallow row's extra
    block must contribute nothing)."""
    jm, params, tm, tp = models
    jc, tc = _cache_pair(jm.config, 2, max_len, seed=5)
    pos = np.array([300 if max_len > 64 else 40, 17], np.int32)
    tok = np.array([[7], [201]])
    for _ in range(3):
        jl, jc = jdec.forward_with_cache(jm, params, jnp.asarray(tok), jc,
                                         jnp.asarray(pos))
        tl, tc = tdec.forward_with_cache(tm, tp, torch.from_numpy(tok), tc,
                                         torch.from_numpy(pos).long())
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL,
                                   rtol=0)
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
        pos = pos + 1
    _close_cache(jc, tc)


@pytest.mark.parametrize("page,maxp", [(16, 4), (64, 8)])
def test_paged_decode_matches_jax(models, page, maxp):
    """Paged decode through a page table, with unallocated entries on the
    junk page 0 and a parked row writing there; 64 x 8 = 512 tokens takes
    the flash-decode branch.  The host bound ``max_pos`` must not change
    the result."""
    jm, params, tm, tp = models
    cfg = jm.config
    P = 2 * maxp + 1
    rng = np.random.default_rng(6)
    shape = (cfg.num_layers, P, cfg.num_kv_heads, page, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    table = np.zeros((3, maxp), np.int32)
    table[0, :maxp] = np.arange(1, maxp + 1)          # full window
    table[1, :2] = [maxp + 1, maxp + 2]               # two pages
    # row 2 parked: all junk page, position 0
    pos = np.array([page * maxp - 2, page + 3, 0], np.int32)
    tok = np.array([[3], [99], [0]])
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    jl, jc = jdec.forward_with_cache(jm, params, jnp.asarray(tok), jc,
                                     jnp.asarray(pos),
                                     page_table=jnp.asarray(table))
    tl, tc = tdec.forward_with_cache(tm, tp, torch.from_numpy(tok), tc,
                                     torch.from_numpy(pos).long(),
                                     page_table=torch.from_numpy(table).long(),
                                     max_pos=page * maxp - 1)
    np.testing.assert_allclose(np.asarray(jl[:2]), tl[:2].numpy(), atol=ATOL,
                               rtol=0)
    # live pages match; the junk page holds whatever the parked row wrote
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc[name])[:, 1:],
                                   tc[name][:, 1:].numpy(), atol=ATOL, rtol=0)


def test_sample_token_greedy_and_filters():
    ties = torch.tensor([[0.1, 2.0, 2.0, -1.0], [3.0, 0.0, 1.0, 3.0]])
    np.testing.assert_array_equal(      # greedy ties: the first maximum
        tdec.sample_token(ties, do_sample=False).numpy(),
        np.asarray(jdec.sample_token(jnp.asarray(ties.numpy()), None,
                                     do_sample=False)))
    logits = torch.tensor([[0.1, 2.0, 1.9, -1.0], [3.0, 0.0, 1.0, 2.9]])
    g = torch.Generator().manual_seed(0)
    for _ in range(20):      # top_k=1 and a tiny top_p both reduce to argmax
        assert tdec.sample_token(logits, g, top_k=1).tolist() == [1, 0]
        assert tdec.sample_token(logits, g, top_p=0.01).tolist() == [1, 0]
