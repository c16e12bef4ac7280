"""The quantized collectives of the port against the JAX package, on the
CPU: the blockwise int8 codec (``comm/quant.py``), every collective of
``comm/collectives_q.py`` and ``comm.all_to_all_single(quantized=True)``,
and the ``comm_quantization`` config (F3: the contradictions the JAX config
refuses) and gates.

The codec is held bit for bit to ``jax.jit(quantize_blockwise)``: under jit
XLA computes the JAX codec's ``absmax / 127.0`` as ``absmax * fl(1/127)``,
and so does the port (an eager JAX call divides).  Each collective runs on
gloo ranks (``tests/torch_zero_ranks.py``, one group a world size) and in
JAX inside ``shard_map`` on a CPU mesh of the same size, fed the same rows
from a seed; their outputs are bit-equal (the sums run in rank order in
both), the error-feedback residuals of two successive ``q_all_reduce``
calls too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.comm import collectives_q as jcq
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.comm import mesh as jmesh_mod
from deepspeed_tpu.comm.mesh import build_mesh as j_build_mesh
from deepspeed_tpu.comm.quant import dequantize_blockwise as j_dequantize
from deepspeed_tpu.comm.quant import quantize_blockwise as j_quantize
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.runtime.comm import quantized as jrq
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.comm.quant import dequantize_blockwise, quantize_blockwise
from deepspeed_tpu_torch.ops.kernels import comm_quant as kcq
from deepspeed_tpu_torch.runtime.comm import quantized as trq
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from tests.test_torch_zero import TINY, config, init_params
from tests.torch_zero_ranks import RankGroup, zero_scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

BLOCK = 64


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _values(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(2 * rng.standard_normal(n))
    x[rng.integers(0, n, max(1, n // 50))] = 0.0
    return x.astype(dtype)


@pytest.mark.parametrize("n,block", [(1 << 16, 256), (1000, 100), (777, 64),
                                     (5, 256), (4096, 1), (300, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_is_the_jitted_jax_codec(n, block, dtype):
    """Codes and scales bit-equal to ``jax.jit(quantize_blockwise)`` (fp32
    and bf16 input, blocks that are not powers of two, a tail block, a
    block of one), and the dequantized values bit-equal too; a block of
    zeros has scale 0 and codes 0."""
    x = _values(n, n + block)
    x[:block] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    q, s = jax.jit(j_quantize, static_argnums=1)(jx, block)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tq, ts = quantize_blockwise(tx, block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    assert float(ts[0]) == 0.0 and not tq[0].any()
    want = jax.jit(lambda a, b: j_dequantize(a, b, (n,), jnp.float32))(q, s)
    np.testing.assert_array_equal(dequantize_blockwise(tq, ts, (n,)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("shape,dtype", [((7, 300), "float32"), ((5, 64), "bfloat16")])
def test_runtime_block_codec_is_the_jax_one(shape, dtype):
    """``runtime/comm/quantized.py``'s ``block_quantize`` (codes, scales and
    the pad) and ``block_dequantize`` (scales as ``[nb]``) equal the JAX
    functions' under jit."""
    x = _values(int(np.prod(shape)), 3).reshape(shape)
    jq, js, jpad = jax.jit(jrq.block_quantize, static_argnums=1)(
        jnp.asarray(x).astype(dtype), 64)
    tq, ts, tpad = trq.block_quantize(torch.from_numpy(x).to(getattr(torch, dtype)), 64)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tpad == int(jpad)
    want = jax.jit(lambda a, b: jrq.block_dequantize(a, b, jpad, shape))(jq, js.reshape(-1))
    got = trq.block_dequantize(tq, ts.reshape(-1), tpad, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_scale_is_the_product_xla_compiles_not_the_quotient():
    """Blocks whose ``absmax / 127`` and ``absmax * fl(1/127)`` differ: the
    port's scales equal the jitted JAX codec's there, and a codec that
    divides (the numpy host twin's rule, and an eager JAX call's) does
    not."""
    x = _values(1 << 18, 5)
    q, s = jax.jit(j_quantize)(jnp.asarray(x))
    absmax = np.abs(x.reshape(-1, 256)).max(1, keepdims=True)
    divided = (absmax / np.float32(127.0)).astype(np.float32)
    differ = (divided != np.asarray(s)).ravel()
    assert differ.sum() > 0
    tq, ts = quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    assert not np.array_equal(divided, ts.numpy())
    _, s_eager = j_quantize(jnp.asarray(x))
    assert not np.array_equal(np.asarray(s_eager), np.asarray(s))


def test_dequantize_sums_in_rank_order_as_xla():
    """The reduce side: ``sum`` over the sources equals XLA's reduce of the
    same products (sequential, from 0), and the concatenation strips each
    source's padding."""
    P_, n = 4, 1000
    xs = np.stack([_values(n, 30 + p) for p in range(P_)])
    q, s = kcq.quantize_blockwise(torch.from_numpy(xs), 128, rows=P_)
    got = kcq.dequantize_blockwise(q, s, n, sum=True).numpy()
    want = jax.jit(lambda a, b: (a.astype(jnp.float32) * b).reshape(P_, -1)[:, :n]
                   .sum(axis=0))(q.numpy(), s.numpy())
    np.testing.assert_array_equal(got, np.asarray(want))
    cat = kcq.dequantize_blockwise(q, s[..., 0], n, dtype=torch.bfloat16)
    assert cat.shape == (P_ * n,) and cat.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        cat.float().numpy().reshape(P_, n),
        (q.float() * s).reshape(P_, -1)[:, :n].to(torch.bfloat16).float().numpy())


def test_codec_launches_only_for_a_card_tensor():
    """A CPU tensor runs the plain version: no launch is counted."""
    before = (kcq.quantize_blockwise.launches, kcq.dequantize_blockwise.launches)
    q, s = kcq.quantize_blockwise(torch.ones(10), 4)
    kcq.dequantize_blockwise(q, s, 10)
    err = kcq.dequantize_error(torch.ones(10), q, s)
    assert err.shape == (10,) and float(err.abs().max()) < 1e-8
    assert (kcq.quantize_blockwise.launches, kcq.dequantize_blockwise.launches) == before
    with pytest.raises(ValueError):
        kcq.quantize_blockwise(torch.ones(4), 0)


# ---------------------------------------------------------------------------
# the collectives, over gloo ranks against shard_map
# ---------------------------------------------------------------------------

def _inputs(world):
    rng = np.random.default_rng(world)

    def rows(*shape):
        return (rng.standard_normal((world,) + shape)
                * np.exp(rng.standard_normal((world,) + shape))).astype(np.float32)
    return {"ar": rows(1001), "ar2": rows(1001), "ar_bf16": rows(300),
            "ag": rows(6, 7), "agf": rows(333), "agd": rows(5, 9, 4),
            "rsf": rows(world * 200), "rs": rows(world * 3, 70),
            "rsd": rows(5, world * 6, 3), "a2a": rows(3, world * 2, 5)}


def _jax_collectives(world, inputs):
    """The JAX collectives in ``shard_map`` over a ``world``-device axis."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("x",))
    groups = ((0, 1), (2, 3)) if world == 4 else None

    def body(ar, ar2, ar_bf16, ag, agf, agd, rsf, rs, rsd, a2a):
        ar, ar2, ar_bf16, ag, agf, agd, rsf, rs, rsd, a2a = (
            v[0] for v in (ar, ar2, ar_bf16, ag, agf, agd, rsf, rs, rsd, a2a))
        o1, r1 = jcq.q_all_reduce(ar, "x", block=BLOCK, residual=jnp.zeros_like(ar))
        o2, r2 = jcq.q_all_reduce(ar2, "x", block=BLOCK, residual=r1)
        o3, _ = jcq.q_all_reduce(ar_bf16.astype(jnp.bfloat16), "x", block=BLOCK,
                                 mean=False)
        tree, _ = jcq.q_all_reduce_tree({"a": ar, "b": [ar2]}, "x", block=BLOCK)
        out = {"q_all_reduce_ef": [o1, r1, o2, r2],
               "q_all_reduce_sum_bf16": [o3],
               "q_all_reduce_tree": [tree["a"], tree["b"][0]],
               "q_all_gather": [jcq.q_all_gather(ag.astype(jnp.bfloat16), "x",
                                                 block=BLOCK)],
               "q_all_gather_flat": [jcq.q_all_gather_flat(agf, "x", block=BLOCK)],
               "q_all_gather_dim": [jcq.q_all_gather_dim(agd, "x", 1, block=BLOCK)],
               "q_reduce_scatter_flat": [jcq.q_reduce_scatter_flat(rsf, "x",
                                                                   block=BLOCK)],
               "q_reduce_scatter": [jcq.q_reduce_scatter(rs, "x", block=BLOCK)],
               "q_reduce_scatter_dim": [jcq.q_reduce_scatter_dim(rsd, "x", 1,
                                                                 block=BLOCK)],
               "q_all_to_all": [jcq.q_all_to_all(a2a, "x", 1, 0, block=BLOCK)],
               "quantized_all_gather": [jrq.quantized_all_gather(ag, "x", BLOCK)],
               "quantized_reduce_scatter": [jrq.quantized_reduce_scatter(rs, "x", BLOCK)],
               "all_to_all_single_quantized": [jcomm.all_to_all_single(
                   a2a, "x", 1, 2, quantized=True, quant_block=BLOCK)]}
        if groups is not None:
            out["q_all_gather_flat_hpz"] = [jcq.q_all_gather_flat(
                agf, "x", groups=groups, block=BLOCK)]
        return jax.tree.map(lambda v: v.astype(jnp.float32)[None], out)

    names = ("ar", "ar2", "ar_bf16", "ag", "agf", "agd", "rsf", "rs", "rsd", "a2a")
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("x"),) * len(names),
                               out_specs=P("x"), check_vma=False))
    res = fn(*(inputs[k] for k in names))
    return jax.tree.map(np.asarray, res)


@pytest.fixture(scope="module")
def ranks():
    """One group of gloo ranks a world size for the whole module: the
    collectives at world 2 and 4, the engines' gates at world 1 and 2."""
    cases = {1: {}, 2: {}, 4: {}}
    for w in (2, 4):
        cases[w]["c"] = ("collectives", dict(inputs=_inputs(w), block=BLOCK))
    for name, (world, mesh, zero, extra) in GATES.items():
        cfg = dict(config(0), **extra, zero_optimization=dict(
            zero, stage3_param_persistence_threshold=0))
        if mesh:
            cfg["mesh"] = mesh
        cases[world][name] = ("gates", dict(preset="llama-tiny",
                                            model_kw=TINY["llama-tiny"], config=cfg))
    groups = {w: RankGroup(w, zero_scenarios, (c,), timeout=240) for w, c in cases.items()}
    try:
        yield groups
    finally:
        for g in groups.values():
            g.close()


@pytest.fixture(scope="module")
def collectives(ranks):
    out = {}
    for w in (2, 4):
        want = _jax_collectives(w, _inputs(w))
        out[w] = (want, [r["c"] for r in ranks[w].results()])
    return out


OPS = ["q_all_reduce_ef", "q_all_reduce_sum_bf16", "q_all_reduce_tree",
       "q_all_gather", "q_all_gather_flat", "q_all_gather_dim",
       "q_reduce_scatter_flat", "q_reduce_scatter", "q_reduce_scatter_dim",
       "q_all_to_all", "all_to_all_single_quantized", "quantized_all_gather",
       "quantized_reduce_scatter"]


@pytest.mark.parametrize("world,op", [(w, o) for w in (2, 4) for o in OPS]
                         + [(4, "q_all_gather_flat_hpz")])
def test_collective_matches_the_jax_collective(collectives, world, op):
    """Each rank's output (and, for ``q_all_reduce``, the residuals of two
    successive calls) bit-equal to rank r of the JAX collective in
    ``shard_map``; the hpZ case gathers over subgroups of 2 at world 4."""
    want, ranks = collectives[world]
    for r, got in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got[op], want[op])):
            np.testing.assert_array_equal(g, w[r], err_msg=f"{op} rank {r} output {i}")


@pytest.mark.parametrize("world", [2, 4])
def test_q_counters_give_wire_bytes_and_the_dense_twin(collectives, world):
    """``comm.q_counters()``: one call an op, the codes' and scales' bytes
    by dtype and the dense twin's bytes (the JAX ``record_q`` accounting).
    The gathers' are each rank's padded codes and one fp32 scale a block:
    agf 333 elements, ag 6 x 7 in bf16 and (``quantized_all_gather``) in
    fp32, agd 5 x 9 x 4 at block 64."""
    _, ranks = collectives[world]
    qc = ranks[0]["q_counters"]
    hpz = world == 4
    blocks = [6, 1, 3, 1] + ([6] if hpz else [])
    ag = qc["q_all_gather"]
    assert ag["calls"] == len(blocks)
    assert ag["bytes"] == {"int8": 64 * sum(blocks), "float32": 4 * sum(blocks)}
    assert ag["dense_bytes"] == (333 * 4 + 42 * 2 + 180 * 4 + 42 * 4
                                 + (333 * 4 if hpz else 0))
    assert qc["q_all_reduce"]["calls"] == 5
    assert qc["q_reduce_scatter"]["calls"] == 4
    assert qc["q_reduce_scatter"]["dense_bytes"] == 4 * (world * 200 + 2 * world * 3 * 70
                                                        + 5 * world * 6 * 3)
    assert qc["q_all_to_all"]["calls"] == 2


# ---------------------------------------------------------------------------
# the config (F3) and the gates
# ---------------------------------------------------------------------------

F3 = {"train_batch_size": 8,
      "zero_optimization": {"stage": 2, "zero_quantized_weights": True},
      "comm_quantization": {"all_gather": False}}


@pytest.mark.parametrize("d", [
    F3,
    {"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "zero_quantized_gradients": True},
     "comm_quantization": {"enabled": True, "reduce_scatter": False}},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "comm_quantization": {"pipeline": True}},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "comm_quantization": {"enabled": True}},
    {"train_batch_size": 8, "comm_quantization": {"block": 0}}],
    ids=["legacy_weights_vs_all_gather", "legacy_grads_vs_reduce_scatter",
         "pipeline_fp16", "enabled_fp16", "block0"])
def test_contradictions_raise_value_error_as_in_the_jax_config(d):
    """F3: a legacy ZeRO++ flag set true while its site is explicitly false,
    the pipeline site under fp16 and a block <= 0 raise ``ValueError`` in
    the port as in the JAX config (the port accepted the first before)."""
    with pytest.raises(ValueError) as jerr:
        JConfig(d)
    with pytest.raises(ValueError) as terr:
        DeepSpeedConfig(d)
    assert str(terr.value) == str(jerr.value)


def test_sites_follow_enabled_unless_set():
    """The tri-state sites: ``null`` follows ``enabled``, an explicit value
    wins; the agreeing legacy flags and an unset legacy flag are
    accepted."""
    for d in ({"comm_quantization": {"enabled": True, "all_to_all": False}},
              {"comm_quantization": {"grad_all_reduce": True}},
              {"zero_optimization": {"zero_quantized_weights": True},
               "comm_quantization": {"all_gather": True}}):
        d = dict(d, train_batch_size=8)
        j, t = JConfig(d).comm_quantization, DeepSpeedConfig(d).comm_quantization
        for site in ("grad_all_reduce", "all_gather", "reduce_scatter",
                     "all_to_all", "sequence_ring", "pipeline"):
            assert getattr(t, "q_" + site) == getattr(j, "q_" + site), (d, site)
        assert (t.block, t.error_feedback) == (j.block, j.error_feedback)


GATES = {
    # name: (world, mesh, zero section, extra)
    "qgrad_stage1": (2, None, {"stage": 1}, {"comm_quantization": {"grad_all_reduce": True}}),
    "qgrad_stage3": (2, None, {"stage": 3}, {"comm_quantization": {"grad_all_reduce": True}}),
    "qgrad_offload": (2, None, {"stage": 2, "offload_optimizer": {"device": "cpu"}},
                      {"comm_quantization": {"grad_all_reduce": True}}),
    "qgrad_overlap": (2, None, {"stage": 2, "overlap_comm": True},
                      {"comm_quantization": {"grad_all_reduce": True}}),
    "qgrad_fp16": (2, None, {"stage": 1},
                   {"fp16": {"enabled": True}, "comm_quantization": {"grad_all_reduce": True}}),
    "qgrad_world1": (1, None, {"stage": 2}, {"comm_quantization": {"grad_all_reduce": True}}),
    "ag_stage2": (2, None, {"stage": 2}, {"comm_quantization": {"all_gather": True}}),
    "ag_stage3_runs_zeropp": (2, None, {"stage": 3}, {"comm_quantization": {"all_gather": True}}),
    "rs_overlap3": (2, None, {"stage": 3, "overlap_comm": True},
                    {"comm_quantization": {"reduce_scatter": True, "all_gather": True}}),
    "overlap_world1": (1, None, {"stage": 3, "overlap_comm": True},
                       {"comm_quantization": {"enabled": True}}),
    "zeropp_overlap": (2, None, {"stage": 3, "overlap_comm": True,
                                 "zero_quantized_weights": True}, {}),
    "ring_pipe_inert": (2, None, {"stage": 0},
                        {"comm_quantization": {"sequence_ring": True, "pipeline": True},
                         "communication_data_type": "fp16", "sparse_gradients": True}),
    "zeropp_dp_only": (2, {"dp": 2}, {"stage": 3, "zero_quantized_gradients": True}, {}),
}


@pytest.fixture(scope="module")
def gates(ranks):
    return {w: ranks[w].results()[0] for w in (1, 2)}


@pytest.mark.parametrize("name", list(GATES))
def test_gates_and_inert_keys_are_the_jax_engines(gates, name):
    """The three quantized paths' gates on the same mesh as the JAX engine:
    whether each runs, the reasons, and ``_inert_config_keys`` entry for
    entry; the overlap schedule's int8 switches, off where fsdp has one
    rank (the JAX schedule quantizes nothing there)."""
    world, mesh, zero, extra = GATES[name]
    cfg = dict(config(0), **extra, zero_optimization=dict(
        zero, stage3_param_persistence_threshold=0))
    if mesh:
        cfg["mesh"] = mesh
    prev = jmesh_mod._GLOBAL_MESH
    try:
        jmesh = j_build_mesh(devices=jax.devices()[:world], **(mesh or {"fsdp": world}))
        jeng = deepspeed_tpu.initialize(
            model=j_causal_lm("llama-tiny", **TINY["llama-tiny"]),
            model_parameters=init_params("llama-tiny"), config=cfg, mesh=jmesh)[0]
    finally:
        jmesh_mod._GLOBAL_MESH = prev
    got = gates[world][name]
    assert got["inert"] == jeng._inert_config_keys
    assert (got["zeropp"], got["zeropp_reason"]) == (jeng._zeropp, jeng._zeropp_reason)
    assert (got["qcomm"], got["qcomm_reason"]) == (jeng._qcomm_grads,
                                                   jeng._qcomm_grads_reason)
    if got["overlap"]:
        jq = jeng._overlap_sched.qcomm
        want = (jq.all_gather and world > 1, jq.reduce_scatter and world > 1, jq.block)
        assert got["qopts"] == want
