"""ZeRO stages 0-3 and data parallelism of the port against the JAX engine,
on the CPU.

The port's ranks are spawned processes in one gloo group
(``tests/torch_zero_ranks.py``: a ``FileStore``, no socket; one group a
world size, every case of that world in it, each group and each collective
with a timeout).  The JAX engine runs in this process on a CPU mesh of the
same shape, ``build_mesh(fsdp=N, devices=jax.devices()[:N])`` (or ``dp 2 x
fsdp 2``), fed the global batch; rank r of the port is fed rows ``[r * mb,
(r + 1) * mb)`` of each global micro-batch.  Weights come from the JAX
model's init through ``jax_params_to_torch``'s layout (``model_parameters``),
inputs from numpy with a seed.

Tolerances:

- fp32 losses rtol 2e-5: the JAX suite's own bound for the same math under
  another collective schedule (``tests/unit/test_overlap.py``); grad norms
  rtol 1e-4; masters atol 1e-4 after three Adam steps (a grad element near
  1e-8 turns a 1e-7 relative difference into a step difference of a few
  lr * 1e-2, as ``tests/test_torch_train.py`` explains);
- bf16 compute over fp32 masters at the port's bf16 bounds
  (``tests/test_torch_offload.py``): the two packages round the forward's
  bf16 activations at other places, so losses rtol 1e-3, grad norms 1e-2,
  masters 95 % within 1e-4 and all within 1e-2;
- mixtral-tiny at the fp32 bounds, with ``moe_drop_tokens: false`` and with
  a capacity that drops tokens (``moe_capacity_factor`` 0.5): each port rank
  gates its rows as the JAX engine gates the global micro-batch, the
  capacity from the global token count, each expert's slots numbered in the
  global order and the aux loss's two means taken over the global batch
  (``moe/sharded_moe.py``), so both packages keep and drop the same tokens.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as jmesh_mod
from deepspeed_tpu.comm.mesh import build_mesh as j_build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.runtime.zero import partition as jpart
from deepspeed_tpu_torch.comm import mesh as tmesh
from deepspeed_tpu_torch.models.config import get_model_config
from deepspeed_tpu_torch.models.transformer import CausalLM, param_shapes
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from tests.torch_zero_ranks import RankGroup, flat, zero_scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 1e-4, 1e-4
S = 32
TINY = {"llama-tiny": dict(num_layers=2, hidden_size=64, intermediate_size=128,
                           num_heads=4, num_kv_heads=2, vocab_size=256,
                           max_seq_len=128),
        "gpt2-small": dict(num_layers=2, hidden_size=64, intermediate_size=128,
                           num_heads=4, vocab_size=256, max_seq_len=128),
        "mixtral-tiny": dict(num_layers=2, hidden_size=64, intermediate_size=128,
                             num_heads=4, num_kv_heads=2, vocab_size=256,
                             num_experts=4, moe_drop_tokens=False)}
# mixtral-tiny with a capacity that drops tokens: 128 tokens a global
# micro-batch at world 2, k 2 of 4 experts, C = ceil(2 * 128 / 4 * 0.5) = 32
# slots an expert against 64 on average (16 if each rank gated its own rows)
MIXTRAL_DROP = dict(TINY["mixtral-tiny"], moe_drop_tokens=True,
                    moe_capacity_factor=0.5)
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "FusedAdam", "params": {
            "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
        "gradient_clipping": 1.0, "steps_per_print": 10**9}


def config(stage, threshold=0, **over):
    return dict(BASE, **dict({"zero_optimization": {
        "stage": stage, "stage3_param_persistence_threshold": threshold}}, **over))


def init_params(preset, seed=0):
    jm = j_causal_lm(preset, **TINY[preset])
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


def token_batches(world, steps=3, seed=0, vocab=256):
    """Stacked global batches ``[gas, micro * world, S]`` as (tokens, tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tok = rng.integers(0, vocab, (2, 2 * world, S)).astype(np.int32)
        out.append((tok, tok))
    return out


def masked_batches(world, steps=3, seed=3):
    """The masked, uneven labels of ``tests/unit/test_overlap.py``: one
    rank's rows of the first micro-batch all ignored, the others cut at 20,
    a loss mask over two more rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tok = rng.integers(0, 256, (2, 2 * world, S)).astype(np.int32)
        labels = tok.copy()
        labels[0, :2] = -100
        labels[:, 2:, 20:] = -100
        labels[1, :, 25:] = -100
        mask = np.ones_like(tok)
        mask[1, 1:3] = 0
        out.append({"tokens": tok, "labels": labels, "loss_mask": mask})
    return out


def jax_train(preset, params, cfg, batches, world, mesh_kw=None, model_kw=None):
    """The JAX engine on a ``world``-device CPU mesh: per step (loss, grad
    norm), the final params, and the engine (its specs)."""
    prev = jmesh_mod._GLOBAL_MESH
    try:
        mesh = j_build_mesh(devices=jax.devices()[:world], **(mesh_kw or {"fsdp": world}))
        jm = j_causal_lm(preset, **(model_kw or TINY[preset]))
        eng, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                           config=cfg, mesh=mesh)
        steps = []
        for b in batches:
            loss = eng.train_step(b)
            steps.append((float(loss), eng.get_global_grad_norm()))
        final = dict(flat(jax.tree.map(np.asarray, eng.state.params)))
        return {"steps": steps, "params": final, "engine": eng}
    finally:
        jmesh_mod._GLOBAL_MESH = prev


def close_steps(got, want, loss_rtol=LOSS_RTOL, norm_rtol=NORM_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=loss_rtol)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=norm_rtol)


def close_params(got, want, atol=PARAM_ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   atol=atol, rtol=0, err_msg=k)


def close_params_bf16(got, want):
    for k in want:
        d = np.abs(got[k] - np.asarray(want[k], np.float32))
        assert (d <= 1e-4).mean() >= 0.95 and d.max() <= 1e-2, (k, d.max())


# ---------------------------------------------------------------------------
# partitions and the mesh: the functions against JAX's
# ---------------------------------------------------------------------------

def _shapes(preset):
    """The preset's leaf shapes (full widths) in both packages' trees."""
    cfg = get_model_config(preset)
    jm = j_causal_lm(preset)
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tshapes = jax.tree.map(lambda s: types.SimpleNamespace(shape=tuple(s[0])),
                           param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    tlogical = CausalLM.logical_pspecs(types.SimpleNamespace(config=cfg))
    return jm, jshapes, tshapes, tlogical


def _spec_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("preset", ["llama-tiny", "gpt2-small", "mixtral-tiny"])
def test_partition_specs_match_jax(preset, n):
    """``choose_pspec`` on every leaf, ``params_pspecs`` with and without
    the model's logical specs at thresholds 0, 100_000 and the default, and
    ``opt_state_pspecs`` over FusedAdam's state shapes."""
    jm, jshapes, tshapes, tlogical = _shapes(preset)
    jl = _spec_tuples(jm.logical_pspecs())
    assert jax.tree.map(lambda s: s, tlogical, is_leaf=lambda x: isinstance(x, tuple)) == jl
    jmesh = j_build_mesh(fsdp=n, devices=jax.devices()[:n])
    tm = tmesh.build_mesh(fsdp=n, world_size=n, rank=0, make_groups=False)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes):
        for min_size in (0, 1000, 100_000):
            assert tpart.choose_pspec(tuple(leaf.shape), tm, min_size=min_size) == \
                tuple(jpart.choose_pspec(leaf.shape, jmesh, min_size=min_size)), path
    for shard in (False, True):
        for kw in ({}, {"persistence_threshold": 0},
                   {"persistence_threshold": 100_000}):
            for logical in (None, "model"):
                jspec = jpart.params_pspecs(
                    jshapes, jmesh, shard, logical_specs=None if logical is None
                    else jm.logical_pspecs(), **kw)
                tspec = tpart.params_pspecs(
                    tshapes, tm, shard, logical_specs=None if logical is None
                    else tlogical, **kw)
                assert tspec == _spec_tuples(jspec), (shard, kw, logical)
    from deepspeed_tpu.ops.adam.fused_adam import fused_adam

    jopt = jax.eval_shape(fused_adam(1e-3).init, jshapes)
    for shard in (False, True):
        want = _spec_tuples(jpart.opt_state_pspecs(jopt, jmesh, shard))
        got = tpart.opt_state_pspecs({"m": tshapes, "count": types.SimpleNamespace(shape=())},
                                     tm, shard)
        assert got["m"] == want.m and got["count"] == tuple(want.count)
    report = tpart.describe_partitioning(
        tshapes, tpart.params_pspecs(tshapes, tm, True, logical_specs=tlogical))
    assert report.startswith("partitioning: ")


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("n,threshold", [(2, 0), (4, 100_000), (8, 0), (8, 4096)])
@pytest.mark.parametrize("preset", ["llama-tiny", "gpt2-small", "mixtral-tiny"])
def test_engine_plan_matches_the_jax_engines_specs(preset, n, threshold, stage):
    """The port's plan (``zero_plan``: the param, optimizer-state and
    accumulator dims a leaf shards on) against the specs the JAX engine's
    ``_init_state`` builds for the same stage, mesh and threshold."""
    jm, jshapes, tshapes, tlogical = _shapes(preset)
    jmesh = j_build_mesh(fsdp=n, devices=jax.devices()[:n])
    persist = threshold if stage == 3 else 0
    logical = jm.logical_pspecs()
    jp = jpart.params_pspecs(jshapes, jmesh, shard=stage == 3,
                             persistence_threshold=persist, logical_specs=logical)
    from deepspeed_tpu.ops.adam.fused_adam import fused_adam

    jo = jpart.opt_state_pspecs(jax.eval_shape(fused_adam(1e-3).init, jshapes),
                                jmesh, shard=stage >= 1).m
    ja = jpart.params_pspecs(jshapes, jmesh, shard=stage >= 2,
                             persistence_threshold=0 if stage >= 2 else persist,
                             logical_specs=logical)
    leaves = list(flat(tshapes))
    plan = tpart.zero_plan([leaf.shape for _, leaf in leaves], stage, n, threshold,
                           [dict(flat(tlogical))[p] for p, _ in leaves])

    def fsdp_dim(spec):
        dims = [i for i, a in enumerate(tuple(spec)) if a == "fsdp"]
        return dims[0] if dims else None

    specs = {name: dict(flat(_spec_tuples(t))) for name, t in
             (("p", jp), ("o", jo), ("a", ja))}
    for (path, _), pl in zip(leaves, plan):
        assert fsdp_dim(specs["p"][path]) == (pl.pdim if pl.param else None), path
        assert fsdp_dim(specs["o"][path]) == (pl.odim if pl.opt else None), path
        assert fsdp_dim(specs["a"][path]) == (pl.pdim if pl.acc else None), path


@pytest.mark.parametrize("sizes", [{"fsdp": 8}, {"dp": 2}, {"dp": 2, "fsdp": 4},
                                   {"fsdp": 2}, {"dp": 8}, {"fsdp": 2, "tp": 2},
                                   {"dp": 2, "fsdp": 2, "pp": 2}])
def test_build_mesh_sizes_and_rank_order_match_jax(sizes):
    """Axis sizes (``fsdp`` absorbing the rest, or ``dp`` when ``fsdp`` is
    given) and each rank's coordinates: rank r sits where device r does,
    and its groups are the ranks the JAX mesh puts on its axes."""
    jm = j_build_mesh(devices=jax.devices()[:8], **sizes)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        tm = tmesh.build_mesh(world_size=8, rank=r, make_groups=False, **sizes)
        assert tuple(tm.shape.items()) == tuple(jm.shape.items())
        assert ids[tuple(tm.coords[a] for a in tm.axis_names)] == r
        for axis in ("dp", "fsdp"):
            idx = tuple(slice(None) if a == axis else tm.coords[a]
                        for a in tm.axis_names)
            assert tm.members(axis) == sorted(ids[idx].reshape(-1).tolist())
    tm = tmesh.build_mesh(world_size=8, rank=0, make_groups=False, **sizes)
    assert tmesh.data_axes(tm) == tuple(jmesh_mod.data_axes(jm))
    assert tmesh.get_data_parallel_world_size(tm) == \
        jmesh_mod.get_data_parallel_world_size(jm)


# ---------------------------------------------------------------------------
# world 2 and world 4: the port's ranks against the JAX engine
# ---------------------------------------------------------------------------

def _cases_w2():
    llama, gpt2, mix = (init_params(p) for p in ("llama-tiny", "gpt2-small",
                                                 "mixtral-tiny"))
    tok = token_batches(2)
    cases = {}
    for stage in (0, 1, 2, 3):
        cases[f"stage{stage}"] = ("llama-tiny", llama, config(stage), tok)
    cases["masked"] = ("llama-tiny", llama, config(3), masked_batches(2))
    cases["bf16"] = ("llama-tiny", llama, config(3, bf16={"enabled": True}), tok)
    cases["gpt2"] = ("gpt2-small", gpt2, config(3), tok)
    cases["mixtral"] = ("mixtral-tiny", mix, config(2), tok)
    cases["mixtral_drop"] = ("mixtral-tiny", mix, config(2), tok, MIXTRAL_DROP)
    lamb = dict(BASE["optimizer"], type="FusedLamb")
    cases["lamb"] = ("llama-tiny", llama, config(2, optimizer=lamb), tok[:2])
    return cases


def _model_kw(case):
    """A case's model overrides: its fifth entry, else the preset's."""
    return case[4] if len(case) > 4 else TINY[case[0]]


def _world4_case():
    params = init_params("llama-tiny")
    tok = token_batches(4, seed=5)
    return params, tok


@pytest.fixture(scope="module")
def groups():
    """Both rank groups started at once (world 2, every case; world 4,
    ``dp 2 x fsdp 2``), so that their ranks run beside the JAX references;
    the cases of each."""
    cases = _cases_w2()
    rank_cases = {name: ("train", dict(preset=c[0], model_kw=_model_kw(c), np_params=c[1],
                                       config=c[2], batches=c[3]))
                  for name, c in cases.items()}
    llama = cases["stage3"][1]
    rank_cases["bytes"] = ("bytes", dict(preset="llama-tiny", model_kw=TINY["llama-tiny"],
                                         np_params=llama, config=config(3),
                                         batch=cases["stage3"][3][0]))
    rank_cases["gathered"] = ("gathered", dict(
        preset="llama-tiny", model_kw=TINY["llama-tiny"], np_params=llama,
        config=config(3), batches=cases["stage3"][3][:1]))
    params4, tok4 = _world4_case()
    g2 = RankGroup(2, zero_scenarios, (rank_cases,))
    g4 = RankGroup(4, zero_scenarios, ({"dp2fsdp2": ("train", dict(
        preset="llama-tiny", model_kw=TINY["llama-tiny"], np_params=params4,
        config=config(2, mesh={"dp": 2, "fsdp": 2}), batches=tok4))},))
    yield cases, g2, g4
    g2.close()
    g4.close()


@pytest.fixture(scope="module")
def world2(groups):
    cases, g2, _ = groups
    # the JAX references while the ranks run
    refs = {name: jax_train(*c[:4], 2, model_kw=_model_kw(c))
            for name, c in cases.items()}
    llama = cases["stage3"][1]
    halved = jax.tree.map(lambda x: x, llama)
    halved["embed"] = dict(llama["embed"], tok=llama["embed"]["tok"] * np.float32(0.5))
    refs["gathered"] = jax_train("llama-tiny", halved, config(3),
                                 cases["stage3"][3][:1], 2)
    return refs, g2.results()


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_world2_stage_matches_the_jax_engine(world2, stage):
    refs, ranks = world2
    want = refs[f"stage{stage}"]
    for rank in ranks:
        got = rank[f"stage{stage}"]
        close_steps(got["steps"], want["steps"])
        close_params(got["params"], want["params"])


def test_world2_masked_uneven_labels_stage3_matches_the_jax_engine(world2):
    """One rank's rows of a micro-batch all ignored (CE weight 0 there),
    uneven valid counts elsewhere: the weighted per-rank means give the
    global masked mean."""
    refs, ranks = world2
    for rank in ranks:
        close_steps(rank["masked"]["steps"], refs["masked"]["steps"])
        close_params(rank["masked"]["params"], refs["masked"]["params"])


def test_world2_bf16_stage3_matches_the_jax_engine(world2):
    refs, ranks = world2
    for rank in ranks:
        close_steps(rank["bf16"]["steps"], refs["bf16"]["steps"], 1e-3, 1e-2)
        close_params_bf16(rank["bf16"]["params"], refs["bf16"]["params"])


def test_world2_gpt2_tied_head_stage3_matches_the_jax_engine(world2):
    """The tied token table takes grads from the embedding and the head,
    reduce-scattered once after both."""
    refs, ranks = world2
    for rank in ranks:
        close_steps(rank["gpt2"]["steps"], refs["gpt2"]["steps"])
        close_params(rank["gpt2"]["params"], refs["gpt2"]["params"])


def test_world2_mixtral_stage2_matches_the_jax_engine(world2):
    refs, ranks = world2
    for rank in ranks:
        close_steps(rank["mixtral"]["steps"], refs["mixtral"]["steps"])
        close_params(rank["mixtral"]["params"], refs["mixtral"]["params"])


def test_world2_mixtral_dropping_capacity_stage2_matches_the_jax_engine(world2):
    """A capacity that drops tokens (``moe_drop_tokens: true``, capacity
    factor 0.5): the global capacity and the global slot order keep the
    tokens the JAX engine keeps."""
    refs, ranks = world2
    for rank in ranks:
        close_steps(rank["mixtral_drop"]["steps"], refs["mixtral_drop"]["steps"])
        close_params(rank["mixtral_drop"]["params"], refs["mixtral_drop"]["params"])


def test_world2_fused_lamb_stage2_matches_the_jax_engine(world2):
    """FusedLamb on each rank's slices, its two norms summed over the
    slices before the trust ratio."""
    refs, ranks = world2
    for rank in ranks:
        close_steps(rank["lamb"]["steps"], refs["lamb"]["steps"])
        close_params(rank["lamb"]["params"], refs["lamb"]["params"])


def test_world2_ranks_hold_the_same_full_params(world2):
    """``engine.params()`` gives every rank the full values; the loss and
    the grad norm are the global batch's on every rank."""
    _, ranks = world2
    for name in ("stage0", "stage1", "stage2", "stage3", "masked", "gpt2"):
        a, b = ranks[0][name], ranks[1][name]
        assert a["steps"] == b["steps"], name
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


def test_world2_plans_match_the_jax_engines_specs(world2):
    """The ranks' partitions against the specs the JAX engines held."""
    refs, ranks = world2
    eng = refs["stage3"]["engine"]

    def fsdp_dim(spec):
        dims = [i for i, a in enumerate(tuple(spec)) if a == "fsdp"]
        return dims[0] if dims else None

    jp = dict(flat(_spec_tuples(eng._param_specs)))
    jo = dict(flat(_spec_tuples(eng._opt_specs.m)))
    ja = dict(flat(_spec_tuples(eng._acc_specs)))
    for path, _, _, _, pdim, odim, param, opt, acc in ranks[0]["bytes"]["numels"]:
        assert fsdp_dim(jp[path]) == (pdim if param else None), path
        assert fsdp_dim(jo[path]) == (odim if opt else None), path
        assert fsdp_dim(ja[path]) == (pdim if acc else None), path


def test_world2_state_bytes_are_a_half_of_stage_0s(world2):
    """At stage 3 each rank holds 1/2 of every sharded leaf's master, Adam
    moments and accumulator, and replicated leaves whole."""
    _, ranks = world2
    full = {p: int(np.prod(a.shape)) for p, a in flat(init_params("llama-tiny"))}
    sharded = 0
    for rank in ranks:
        for path, master, moments, acc, _, _, param, opt, acc_sh in rank["bytes"]["numels"]:
            n = full[path]
            assert master == (n // 2 if param else n), path
            assert moments == [n // 2 if opt else n] * 2, path
            assert acc == (n // 2 if acc_sh else n), path
            sharded += param
    assert sharded >= 10


def test_world2_gathered_parameters_change_on_rank0_is_seen_everywhere(world2):
    """``zero.GatheredParameters(engine=..., modifier_rank=0)``: rank 0's
    change (the token table halved) replaces rank 1's own, every rank reads
    it back, and the next step trains from it (as the JAX engine from the
    halved table)."""
    refs, ranks = world2
    want = init_params("llama-tiny")["embed"]["tok"] * np.float32(0.5)
    for rank in ranks:
        np.testing.assert_array_equal(rank["gathered"]["seen"], want)
        close_steps(rank["gathered"]["steps"], refs["gathered"]["steps"])
        close_params(rank["gathered"]["params"], refs["gathered"]["params"])


@pytest.mark.parametrize("stage,ops", [(0, {"all_reduce"}), (1, {"all_reduce", "all_gather"}),
                                       (2, {"all_reduce", "reduce_scatter", "all_gather"}),
                                       (3, {"all_reduce", "reduce_scatter", "all_gather",
                                            "all_to_all"})])
def test_world2_collectives_ran(world2, stage, ops):
    _, ranks = world2
    counts = ranks[0][f"stage{stage}"]["counters"]
    assert ops <= {op for op, c in counts.items() if c["calls"] > 0}, counts
    assert (stage >= 2) == ("reduce_scatter" in counts)


@pytest.fixture(scope="module")
def world4(groups):
    params, tok = _world4_case()
    ref = jax_train("llama-tiny", params, config(2), tok, 4, {"dp": 2, "fsdp": 2})
    return ref, groups[2].results()


def test_world4_dp2_fsdp2_stage2_matches_the_jax_engine(world4):
    """Grads reduce-scattered over ``fsdp`` and all-reduced over ``dp``;
    the batch split four ways."""
    ref, ranks = world4
    assert dict(ref["engine"].mesh.shape)["dp"] == 2
    for rank in ranks:
        got = rank["dp2fsdp2"]
        close_steps(got["steps"], ref["steps"])
        close_params(got["params"], ref["params"])


def test_dataloader_rank_rows_are_the_jax_loaders_global_batch():
    """At a data-parallel world of 2 rank r yields rows ``[r * mb, (r + 1)
    * mb)`` of each global micro-batch of the JAX loader (same shuffle,
    seed and epoch), and both ranks' resume state is the global stream's."""
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JLoader
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader as TLoader

    data = (np.arange(40 * 6).reshape(40, 6).astype(np.int32),
            np.arange(40).astype(np.int32))
    mesh = j_build_mesh(fsdp=2, devices=jax.devices()[:2])
    jl = JLoader(data, batch_size=8, mesh=mesh, shuffle=True, seed=3)
    ranks = [TLoader(data, batch_size=8, shuffle=True, seed=3, data_rank=r,
                     data_world=2) for r in range(2)]
    for epoch in range(2):
        want = [[np.asarray(x) for x in b] for b in jl]
        got = [[[x.numpy() for x in b] for b in t] for t in ranks]
        assert len(want) == len(got[0]) == len(got[1]) == 5
        for j, jb in enumerate(want):
            for i in range(2):
                assert got[0][j][i].shape[0] == 4
                np.testing.assert_array_equal(
                    np.concatenate([got[0][j][i], got[1][j][i]]), jb[i])
        assert all(t.state_dict() == jl.state_dict() for t in ranks)
