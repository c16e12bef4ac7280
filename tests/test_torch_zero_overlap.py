"""``zero_optimization.overlap_comm`` of the port against the JAX engine's
bucketed schedule (``runtime/zero/overlap.py``), on the CPU.

The port's ranks are gloo processes (``tests/torch_zero_ranks.py``); the
JAX engine runs the same configuration with ``overlap_comm: true`` on
``build_mesh(fsdp=N, devices=jax.devices()[:N])`` at N 2 and 4, fed the
global batch.  Bounds are ``tests/test_torch_zero.py``'s (fp32 losses rtol
2e-5, grad norms 1e-4, masters atol 1e-4).  Beside the training numbers:
the buckets, the leaf assignment, the layer-wise layout and the per-bucket
comm plan against the JAX functions, the counters of a micro-batch against
that plan, tags across ``overlap_comm`` on and off and across world sizes,
and the cases the JAX engine leaves the flag inert in.

The comm plan's bytes follow the JAX convention (the compute dtype; a
layer bucket's the slice's).  The JAX plan takes ``int(leaf bytes * layers
/ L)`` where the port counts the slice's elements: the same numbers for the
layer counts here, which halve and quarter exactly.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import mesh as jmesh_mod
from deepspeed_tpu.comm.mesh import build_mesh as j_build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.runtime.zero import overlap as jovl
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import mesh as tmesh
from deepspeed_tpu_torch.runtime.zero import overlap as tovl
from tests.test_torch_zero import (TINY, _shapes, _spec_tuples, close_params,
                                   close_steps, config, jax_train, masked_batches,
                                   token_batches)
from tests.torch_zero_ranks import RankGroup, flat, rank_rows, zero_scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

GPT2_4L = dict(TINY["gpt2-small"], num_layers=4)


def overlap_config(stage, bucket_layers=1, **over):
    cfg = config(stage, **over)
    cfg["zero_optimization"] = dict(cfg["zero_optimization"], overlap_comm=True,
                                    overlap_bucket_layers=bucket_layers)
    return cfg


def init(preset, model_kw, seed=0):
    jm = j_causal_lm(preset, **model_kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


def _cases(world):
    """name -> (preset, model kw, params, config, batches[, JAX mesh kw])."""
    kw = {p: TINY[p] for p in ("llama-tiny", "gpt2-small")}
    params = {p: init(p, k) for p, k in kw.items()}
    tok = token_batches(world, seed=7)
    cases = {}
    for stage in (1, 2, 3):
        presets = ("llama-tiny", "gpt2-small") if world == 2 else ("llama-tiny",)
        for p in presets:
            cases[f"s{stage}_{p}"] = (p, kw[p], params[p], overlap_config(stage), tok)
    if world == 2:
        cases["masked"] = ("llama-tiny", kw["llama-tiny"], params["llama-tiny"],
                           overlap_config(3), masked_batches(2))
        cases["bl2"] = ("gpt2-small", GPT2_4L, init("gpt2-small", GPT2_4L),
                        overlap_config(3, bucket_layers=2), tok)
        cases["bl2_s2"] = ("gpt2-small", GPT2_4L, init("gpt2-small", GPT2_4L),
                           overlap_config(2, bucket_layers=2), tok)
        # a threshold that keeps the norms whole: a bucket mixes gathered
        # leaves with leaves summed over the data axes
        cfg = overlap_config(3)
        cfg["zero_optimization"]["stage3_param_persistence_threshold"] = 4096
        cases["s3_threshold"] = ("llama-tiny", kw["llama-tiny"], params["llama-tiny"],
                                 cfg, tok)
    else:
        # dp 2 x fsdp 2: a bucket's reduce-scatters over fsdp, then the
        # shards summed over dp
        mesh = {"dp": 2, "fsdp": 2}
        for stage in (2, 3):
            cases[f"dp2fsdp2_s{stage}"] = ("llama-tiny", kw["llama-tiny"],
                                           params["llama-tiny"],
                                           overlap_config(stage, mesh=mesh), tok, mesh)
    return cases


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("overlap_ckpt"))
    out = {}
    for world in (2, 4):
        cases = _cases(world)
        rank_cases = {name: ("train", dict(preset=c[0], model_kw=c[1], np_params=c[2],
                                           config=c[3], batches=c[4]))
                      for name, c in cases.items()}
        if world == 2:
            llama = cases["s3_llama-tiny"]
            rank_cases["ckpt"] = ("overlap_ckpt", dict(
                preset="llama-tiny", model_kw=TINY["llama-tiny"], np_params=llama[2],
                configs={"on": overlap_config(3), "off": config(3)},
                batches=token_batches(2, seed=11), root=root))
        out[world] = (cases, RankGroup(world, zero_scenarios, (rank_cases,),
                                       timeout=420))
    yield out, root
    for _, g in out.values():
        g.close()


@pytest.fixture(scope="module")
def runs(groups):
    """The JAX references while the ranks run, then the ranks' results."""
    out, root = groups
    res = {}
    for world, (cases, g) in out.items():
        refs = {name: jax_train(c[0], c[2], c[3], c[4], world,
                                mesh_kw=c[5] if len(c) > 5 else None, model_kw=c[1])
                for name, c in cases.items()}
        res[world] = (refs, g.results())
    return res, root


W2 = ["s1_llama-tiny", "s1_gpt2-small", "s2_llama-tiny", "s2_gpt2-small",
      "s3_llama-tiny", "s3_gpt2-small", "masked", "bl2", "bl2_s2", "s3_threshold"]
W4 = ["s1_llama-tiny", "s2_llama-tiny", "s3_llama-tiny", "dp2fsdp2_s2",
      "dp2fsdp2_s3"]
CASES = [(2, n) for n in W2] + [(4, n) for n in W4]


@pytest.mark.parametrize("world,name", CASES)
def test_overlap_matches_the_jax_engines_overlap_path(runs, world, name):
    """Losses, grad norms and masters of every rank against the JAX engine
    with ``overlap_comm: true`` on the same mesh; both engines took the
    bucketed schedule."""
    refs, ranks = runs[0][world]
    want = refs[name]
    assert want["engine"]._overlap, want["engine"]._overlap_reason
    for rank in ranks:
        got = rank[name]
        assert got["overlap"] is not None and got["inert"] == []
        close_steps(got["steps"], want["steps"])
        close_params(got["params"], want["params"])


@pytest.mark.parametrize("world,name", CASES)
def test_comm_plan_entries_match_jax_and_the_counters(runs, world, name):
    """The per-bucket plan ``(op, calls, bytes, dtype, world)`` equals the
    JAX schedule's ``comm_plan_entries()`` entry for entry, its hideable
    share too; the collectives one micro-batch ran, counted by
    ``comm.counters()``, are the plan's calls and bytes an op."""
    refs, ranks = runs[0][world]
    jsched = refs[name]["engine"]._overlap_sched
    want = [tuple(e) for e in jsched.comm_plan_entries()]
    for rank in ranks:
        ov = rank[name]["overlap"]
        assert ov["entries"] == want
        assert ov["hideable"] == pytest.approx(jsched.hideable_comm_fraction(), abs=1e-12)
        assert ov["last"] == ov["plan_counts"]


@pytest.mark.parametrize("name", ["s3_llama-tiny", "s3_gpt2-small", "bl2", "s1_llama-tiny"])
def test_buckets_and_leaf_assignment_match_jax(runs, name):
    """``bucket_infos`` (embed, the layer ranges in order, head; a stage-3
    layer bucket gathers twice) and ``bucket_assignment`` (every leaf in
    one bucket a layer range) equal the JAX schedule's."""
    refs, ranks = runs[0][2]
    jsched = refs[name]["engine"]._overlap_sched
    for rank in ranks:
        ov = rank[name]["overlap"]
        assert ov["infos"] == [tuple(i) for i in jsched.bucket_infos()]
        assert ov["assignment"] == jsched.bucket_assignment()


@pytest.mark.parametrize("L,bl", [(6, 2), (5, 2), (4, 1), (3, 99), (2, 0), (1, 1)])
def test_plan_buckets_matches_jax(L, bl):
    assert tovl.plan_buckets(L, bl) == jovl.plan_buckets(L, bl)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("preset", ["llama-tiny", "gpt2-small", "mixtral-tiny"])
def test_layerwise_pspecs_match_jax(preset, n):
    """The layer-wise layout (a stacked leaf's layer dim never sharded)
    against the JAX function, with and without the model's logical specs,
    at thresholds 0 and 100_000; and the engine's plan with
    ``layer_leaves`` against it."""
    from deepspeed_tpu_torch.runtime.zero import partition as tpart

    jm, jshapes, tshapes, tlogical = _shapes(preset)
    jmesh = j_build_mesh(fsdp=n, devices=jax.devices()[:n])
    tm = tmesh.build_mesh(fsdp=n, world_size=n, rank=0, make_groups=False)
    for shard in (False, True):
        for persist in (0, 100_000):
            for logical in (None, "model"):
                want = jovl.layerwise_pspecs(
                    jshapes, jmesh, shard, persistence_threshold=persist,
                    logical_specs=None if logical is None else jm.logical_pspecs())
                got = tovl.layerwise_pspecs(
                    tshapes, tm, shard, persistence_threshold=persist,
                    logical_specs=None if logical is None else tlogical)
                assert got == _spec_tuples(want), (shard, persist, logical)
    want = dict(flat(_spec_tuples(jovl.layerwise_pspecs(
        jshapes, jmesh, True, persistence_threshold=0,
        logical_specs=jm.logical_pspecs()))))
    leaves = list(flat(tshapes))
    plan = tpart.zero_plan([leaf.shape for _, leaf in leaves], 3, n, 0,
                           [dict(flat(tlogical))[p] for p, _ in leaves],
                           layer_leaves=[p.startswith("layers.") for p, _ in leaves])
    for (path, _), pl in zip(leaves, plan):
        dims = [i for i, a in enumerate(want[path]) if a == "fsdp"]
        assert (dims[0] if dims else None) == (pl.pdim if pl.param else None), path
        assert pl.acc == pl.param, path
        if path.startswith("layers."):
            assert pl.pdim != 0, path


def test_world2_ranks_agree(runs):
    """Every rank reads the same global losses and the same full params."""
    _, ranks = runs[0][2]
    for name in W2:
        a, b = ranks[0][name], ranks[1][name]
        assert a["steps"] == b["steps"], name
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


def test_checkpoints_cross_overlap_on_and_off_and_world_sizes(runs):
    """A tag saved with ``overlap_comm`` on loads into an engine with it off
    and the other way round (the masters bit-equal to the saved ones, the
    third step at the fp32 bounds of the run that was not interrupted); the
    ranks' overlap tag also loads into an overlap engine at world 1 (micro
    4: the same global batch)."""
    (_, ranks), root = runs[0][2], runs[1]
    for rank in ranks:
        ck = rank["ckpt"]
        for name in ("on", "off"):
            for k, v in ck[name]["saved"].items():
                np.testing.assert_array_equal(ck[name]["loaded"][k], v, err_msg=k)
            assert ck[name]["loaded_overlap"] == (name == "off")
            close_steps([ck[name]["resumed"]], [ck[name]["run"]])
            close_params(ck[name]["params"], ck[name]["run_params"])
    batches = token_batches(2, seed=11)
    llama = init("llama-tiny", TINY["llama-tiny"])
    try:
        one = deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu",
                                                **TINY["llama-tiny"]),
            model_parameters=llama, device="cpu",
            config=dict(overlap_config(3), train_micro_batch_size_per_gpu=4))[0]
        assert one._overlap
        one.load_checkpoint(f"{root}/on")
        loaded = dict(flat({k: v for k, v in one.params().items()}))
        for k, v in ranks[0]["ckpt"]["on"]["saved"].items():
            np.testing.assert_array_equal(loaded[k].detach().numpy(), v, err_msg=k)
        loss = float(one.train_step(rank_rows(batches[2], 0, 1)))
        close_steps([(loss, one.get_global_grad_norm())], [ranks[0]["ckpt"]["on"]["run"]])
    finally:
        comm.destroy()


# ---------------------------------------------------------------------------
# inert cases: the JAX engine's reasons, and the plain schedule trains
# ---------------------------------------------------------------------------

class _NoSegments:
    """A model without ``stream_segments`` (its attribute lookup fails)."""

    @property
    def stream_segments(self):
        raise AttributeError("stream_segments")


def _inert_case(case):
    """(port model, JAX model, config, loss_fn a side) of an inert case."""
    kw = TINY["llama-tiny"]
    tmodel = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", **kw)
    jmodel = j_causal_lm("llama-tiny", **kw)
    if case == "stage0":
        return tmodel, jmodel, overlap_config(0), None, None
    if case == "offload":
        cfg = overlap_config(2)
        cfg["zero_optimization"]["offload_optimizer"] = {"device": "cpu"}
        return tmodel, jmodel, cfg, None, None
    if case == "no_segments":
        t = type("NoSegCausalLM", (_NoSegments, type(tmodel)), {})
        j = type("NoSegCausalLM", (_NoSegments, type(jmodel)), {})
        tmodel.__class__ = t
        jmodel.__class__ = j
        return tmodel, jmodel, overlap_config(3), None, None
    assert case == "loss_fn"

    def t_loss(params, batch, rng):
        return tmodel.apply(params, *batch)

    def j_loss(params, batch, rng):
        return jmodel.apply(params, *batch)
    return tmodel, jmodel, overlap_config(3), t_loss, j_loss


@pytest.mark.parametrize("case", ["stage0", "offload", "no_segments", "loss_fn"])
def test_inert_cases_warn_as_the_jax_engine_and_train(case, caplog):
    """Where the JAX engine finds ``overlap_comm`` inert the port gives the
    same reason (logged; the config half listed in ``_inert_config_keys``,
    the model half only logged, as the JAX engine's ``_setup_overlap``),
    takes the plain schedule and trains: three steps, the same numbers as
    the same config without the flag."""
    params = init("llama-tiny", TINY["llama-tiny"])
    batches = token_batches(1, seed=3)
    tmodel, jmodel, cfg, t_loss, j_loss = _inert_case(case)
    prev = jmesh_mod._GLOBAL_MESH
    try:
        mesh = j_build_mesh(fsdp=1, devices=jax.devices()[:1])
        jeng = deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                        config=cfg, mesh=mesh, loss_fn=j_loss)[0]
        jeng.train_step(batches[0])
    finally:
        jmesh_mod._GLOBAL_MESH = prev
    assert not jeng._overlap and jeng._overlap_reason
    try:
        with caplog.at_level(logging.WARNING):
            eng = deepspeed_tpu_torch.initialize(
                model=tmodel, model_parameters=params, config=cfg, device="cpu",
                loss_fn=t_loss)[0]
        assert not eng._overlap and eng._overlap_sched is None
        assert eng._overlap_reason == jeng._overlap_reason
        assert eng._inert_config_keys == jeng._inert_config_keys
        assert jeng._overlap_reason in caplog.text
        got = [float(eng.train_step(b)) for b in batches]
        comm.destroy()
        plain_cfg = dict(cfg, zero_optimization={
            k: v for k, v in cfg["zero_optimization"].items() if k != "overlap_comm"})
        tmodel2, *_ = _inert_case(case)
        plain = deepspeed_tpu_torch.initialize(
            model=tmodel2, model_parameters=params, config=plain_cfg, device="cpu",
            loss_fn=(lambda p, b, r: tmodel2.apply(p, *b)) if t_loss else None)[0]
        want = [float(plain.train_step(b)) for b in batches]
        assert got == want and all(np.isfinite(got))
    finally:
        comm.destroy()


def test_unroutable_batch_fails_loudly():
    """The bucketed schedule takes ``(tokens, labels)`` or a dict with both;
    another form raises the JAX engine's ValueError before any work."""
    kw = TINY["llama-tiny"]
    try:
        eng = deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", **kw),
            config=dict(overlap_config(3), gradient_accumulation_steps=1),
            device="cpu")[0]
        toks = np.zeros((2, 16), np.int64)
        with pytest.raises(ValueError, match="overlap_comm"):
            eng.forward((toks, toks, toks))
    finally:
        comm.destroy()


# ---------------------------------------------------------------------------
# ZeRO++ knobs: inert with the JAX engine's reasons, run where it runs
# ---------------------------------------------------------------------------

ZEROPP_CASES = {
    "stage2": ({"stage": 2, "zero_quantized_weights": True}, {}, 2),
    "offload": ({"stage": 3, "zero_quantized_gradients": True,
                 "offload_optimizer": {"device": "cpu"}}, {}, 2),
    "fp16": ({"stage": 3, "zero_quantized_weights": True,
              "zero_quantized_gradients": True}, {"fp16": {"enabled": True}}, 2),
    "fsdp1": ({"stage": 3, "zero_hpz_partition_size": 2}, {}, 1),
    "hpz_3_of_4": ({"stage": 3, "zero_hpz_partition_size": 3}, {}, 4),
    "runs": ({"stage": 3, "zero_quantized_weights": True}, {}, 2),
}


@pytest.mark.parametrize("case", list(ZEROPP_CASES))
def test_zeropp_knobs_follow_the_jax_engines_gate(case, caplog):
    """``zero_quantized_weights``, ``zero_quantized_gradients`` and
    ``zero_hpz_partition_size``: the port's gate (``runtime/config.py``
    ``zeropp_gate``) gives the JAX engine's reason on the same mesh and the
    same inert keys; where the JAX engine runs ZeRO++ the port's config
    takes it too (``runtime/zero/zeropp.py``; the runs themselves are held
    to the JAX engine in ``tests/test_torch_zeropp.py``).  At a world of one
    the port's engine warns and trains."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, zeropp_gate

    zero, over, world = ZEROPP_CASES[case]
    cfg = dict(config(0), **over, zero_optimization=dict(
        zero, stage3_param_persistence_threshold=0))
    prev = jmesh_mod._GLOBAL_MESH
    try:
        mesh = j_build_mesh(fsdp=world, devices=jax.devices()[:world])
        jeng = deepspeed_tpu.initialize(
            model=j_causal_lm("llama-tiny", **TINY["llama-tiny"]),
            model_parameters=init("llama-tiny", TINY["llama-tiny"]), config=cfg,
            mesh=mesh)[0]
    finally:
        jmesh_mod._GLOBAL_MESH = prev
    wanted, why = zeropp_gate(cfg, world)
    assert wanted and why == jeng._zeropp_reason
    if why is None:
        assert jeng._zeropp
        DeepSpeedConfig(cfg, world_size=world)       # accepted: ZeRO++ runs
        return
    jkeys = [k for k in jeng._inert_config_keys if "zero_" in k]
    assert jkeys and all(k.startswith("zero_optimization.zero_") for k in jkeys)
    if world > 1:
        DeepSpeedConfig(cfg, world_size=world)       # accepted: inert
        return
    try:
        with caplog.at_level(logging.WARNING):
            eng = deepspeed_tpu_torch.initialize(
                model=deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu",
                                                    **TINY["llama-tiny"]),
                model_parameters=init("llama-tiny", TINY["llama-tiny"]), config=cfg,
                device="cpu")[0]
        assert eng._inert_config_keys == jkeys
        assert why in caplog.text
        losses = [float(eng.train_step(b)) for b in token_batches(1, seed=5)]
        assert all(np.isfinite(losses))
    finally:
        comm.destroy()
