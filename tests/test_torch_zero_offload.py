"""ZeRO-Offload of the optimizer state at ZeRO stages 1-3 and across ranks:
the port's gloo ranks against the JAX engine's ``offload_optimizer`` at the
same stage on ``build_mesh(fsdp=N, devices=jax.devices()[:N])``, N 2 and 4,
on the CPU.

Each rank's host optimizer holds and steps its slices of the leaves its
stage shards the optimizer state of (the device path's slices); the grads
reach it reduced (reduce-scattered from stage 2, all-reduced and sliced at
stage 1), clipped by the global norm, and its updated slices are gathered
into the compute copy (stages 1-2) or stay sharded (stage 3).  Bounds are
``tests/test_torch_offload.py``'s for bf16 compute (the two packages round
the forward's bf16 activations at other places): losses rtol 1e-3, grad
norms 1e-2, the host masters 95 % within 1e-4 and all within 1e-2, here
assembled whole from the ranks' slices.  Also: each rank's host state is
1/N of the whole, ``nvme`` swaps in a directory a rank, and a stage-2 tag of
two ranks resumes in a stage-0 engine of one.
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm
from tests.test_torch_zero import TINY, close_steps, config, init_params, jax_train, token_batches
from tests.torch_zero_ranks import RankGroup, rank_rows, zero_scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL, NORM_RTOL = 1e-3, 1e-2
ADAMW = {"type": "AdamW", "params": {"lr": 3e-3, "betas": [0.9, 0.95],
                                     "weight_decay": 0.1}}


def offload_config(stage, device="cpu", **off):
    cfg = config(stage, bf16={"enabled": True}, optimizer=ADAMW)
    cfg["zero_optimization"] = dict(cfg["zero_optimization"], offload_optimizer=dict(
        device=device, **off))
    return cfg


# fp16 with the dynamic scale from 2^19, hysteresis 1: on these tokens the
# first two steps overflow and the third applies (the flag and the norm
# taken over the ranks)
FP16 = {"bf16": {"enabled": False}, "fp16": {"enabled": True, "initial_scale_power": 19,
                                              "hysteresis": 1}}


def _cases(world, root):
    tok = token_batches(world, seed=13)
    cases = {f"s{stage}": offload_config(stage) for stage in (1, 2, 3)}
    if world == 2:
        cases["nvme"] = offload_config(2, "nvme", nvme_path=f"{root}/swap")
        cases["fp16"] = dict(offload_config(2), **FP16)
    return tok, cases


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zero_offload"))
    params = init_params("llama-tiny")
    out = {}
    for world in (2, 4):
        tok, cases = _cases(world, root)
        rank_cases = {name: ("train", dict(preset="llama-tiny", model_kw=TINY["llama-tiny"],
                                           np_params=params, config=cfg, batches=tok))
                      for name, cfg in cases.items()}
        if world == 2:
            rank_cases["ckpt"] = ("train", dict(
                preset="llama-tiny", model_kw=TINY["llama-tiny"], np_params=params,
                config=offload_config(2), batches=tok, save_dir=f"{root}/ckpt",
                save_after=2))
        out[world] = (tok, cases, RankGroup(world, zero_scenarios, (rank_cases,),
                                            timeout=420))
    yield out, root, params
    for *_, g in out.values():
        g.close()


@pytest.fixture(scope="module")
def runs(groups):
    out, root, params = groups
    res = {}
    for world, (tok, cases, g) in out.items():
        refs = {name: jax_train("llama-tiny", params, cfg, tok, world)
                for name, cfg in cases.items() if name != "nvme"}
        res[world] = (refs, g.results())
    return res, root, params


def assemble(ranks, name):
    """The host masters whole, from every rank's slices and regions (a
    leaf held whole taken from rank 0)."""
    first = ranks[0][name]["offload"]
    out = []
    for i, m0 in enumerate(first["masters"]):
        place = first["places"][i] if first["places"] else None
        if place is None:
            out.append(m0)
            continue
        full = np.zeros(place[0], np.float32)
        for rank in ranks:
            off = rank[name]["offload"]
            region = off["places"][i][1]
            full[tuple(slice(a, b) for a, b in region)] = off["masters"][i].reshape(
                [b - a for a, b in region])
        out.append(full.reshape(-1))
    return out


def close_masters(got, want):
    d = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(got, want)])
    assert d.max() <= 1e-2 and (d <= 1e-4).mean() >= 0.95, (d.max(), (d <= 1e-4).mean())


CASES = [(2, "s1"), (2, "s2"), (2, "s3"), (4, "s1"), (4, "s2"), (4, "s3")]


@pytest.mark.parametrize("world,name", CASES)
def test_offload_matches_the_jax_engine(runs, world, name):
    """Losses, grad norms and the host masters (the ranks' slices put
    together) against the JAX engine's offload at the same stage and mesh;
    the card's params are the host masters in bf16."""
    refs, ranks = runs[0][world]
    want = refs[name]
    jopt = want["engine"]._offload_opt
    for rank in ranks:
        close_steps(rank[name]["steps"], want["steps"], LOSS_RTOL, NORM_RTOL)
        assert rank[name]["offload"]["paths"] == list(jopt._paths)
        assert rank[name]["offload"]["step_count"] == jopt.step_count
    masters = assemble(ranks, name)
    close_masters(masters, jopt.masters())
    params = ranks[0][name]["params"]
    order = dict(zip(ranks[0][name]["offload"]["paths"], masters))
    for path, p in params.items():
        key = "".join(f"[{k!r}]" for k in path.split("."))
        np.testing.assert_array_equal(
            p.reshape(-1), order[key].astype(jax.numpy.bfloat16).astype(np.float32),
            err_msg=path)


def test_fp16_stage2_overflow_and_scale_match_the_jax_engine(runs):
    """fp16 over 2 ranks at stage 2 from a loss scale of 2^19: each step's
    overflow flag (all-reduced, max), loss scale and applied-step count
    equal the JAX engine's; losses and norms at the bf16 bounds."""
    from deepspeed_tpu.comm import mesh as jmesh_mod

    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import build_mesh as j_build_mesh
    from deepspeed_tpu.models import causal_lm as j_causal_lm

    (_, ranks), _, params = runs[0][2], runs[1], runs[2]
    cfg = dict(offload_config(2), **FP16)
    prev = jmesh_mod._GLOBAL_MESH
    try:
        eng = deepspeed_tpu.initialize(
            model=j_causal_lm("llama-tiny", **TINY["llama-tiny"]), model_parameters=params,
            config=cfg, mesh=j_build_mesh(fsdp=2, devices=jax.devices()[:2]))[0]
        want, scaler = [], []
        for b in token_batches(2, seed=13):
            loss = float(eng.train_step(b))
            want.append((loss, eng.get_global_grad_norm()))
            scaler.append((bool(eng._last_overflow), float(eng.loss_scale),
                           int(eng.global_steps)))
    finally:
        jmesh_mod._GLOBAL_MESH = prev
    assert [s[0] for s in scaler] == [True, True, False], scaler
    for rank in ranks:
        got = rank["fp16"]
        assert [(bool(a), float(b), int(c)) for a, b, c in got["scaler"]] == scaler
        close_steps(got["steps"], want, LOSS_RTOL, NORM_RTOL)


@pytest.mark.parametrize("world,name", CASES)
def test_each_rank_holds_its_slice_of_the_host_state(runs, world, name):
    """A rank's host state bytes are 1/N of the whole (every leaf of
    llama-tiny has a dim N divides), and the slices tile the leaves."""
    refs, ranks = runs[0][world]
    # the JAX engine's host state, whole: fp32 masters and AdamW's 2 moments
    whole = 3 * 4 * sum(m.size for m in refs[name]["engine"]._offload_opt.masters())
    for rank in ranks:
        assert rank[name]["offload"]["bytes"] * world == whole
    regions = [tuple(map(tuple, r[name]["offload"]["places"][0][1])) for r in ranks]
    assert len(set(regions)) == world


def test_nvme_swaps_in_a_directory_a_rank_and_equals_cpu(runs):
    """``nvme`` at stage 2: each rank's ``state_{i}.bin`` under ``rank{r}``
    of the path; the run bit-equal to the cpu backend's."""
    _, ranks = runs[0][2]
    for rank in ranks:
        assert rank["nvme"]["offload"]["swap_dirs"] == ["rank0", "rank1"]
        assert rank["nvme"]["steps"] == rank["s2"]["steps"]
        for a, b in zip(rank["nvme"]["offload"]["masters"], rank["s2"]["offload"]["masters"]):
            np.testing.assert_array_equal(a, b)


def test_stage2_tag_of_two_ranks_resumes_in_a_stage0_engine_of_one(runs):
    """The ranks' stage-2 tag (their ``offload_states`` slices written into
    whole files) loads into a stage-0 offload engine at world 1 (micro 4:
    the same global batch): its host masters are the slices put together,
    and its third step meets the ranks' at the bf16 bounds."""
    (_, ranks), root, params = runs[0][2], runs[1], runs[2]
    tok = token_batches(2, seed=13)
    cfg = dict(offload_config(0), train_micro_batch_size_per_gpu=4)
    try:
        one = deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu",
                                                **TINY["llama-tiny"]),
            model_parameters=params, config=cfg, device="cpu")[0]
        assert not one._dist
        one.load_checkpoint(f"{root}/ckpt")
        assert one._offload_opt.step_count == 2
        loss = float(one.train_step(rank_rows(tok[2], 0, 1)))
        close_steps([(loss, one.get_global_grad_norm())], [ranks[0]["ckpt"]["steps"][2]],
                    LOSS_RTOL, NORM_RTOL)
        close_masters([m.numpy() for m in one._offload_opt.masters()],
                      assemble(ranks, "ckpt"))
    finally:
        comm.destroy()
