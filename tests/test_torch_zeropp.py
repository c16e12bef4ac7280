"""The three quantized training paths of the port against the JAX engine, on
the CPU: the stage 0-2 gradient sync through ``q_all_reduce``
(``comm_quantization.grad_all_reduce``, error feedback on and off), the
overlap schedule's int8 gathers and reduce-scatters, and ZeRO++ (qwZ, qgZ,
hpZ).

The port's ranks are gloo processes (``tests/torch_zero_ranks.py``, one
group a world size); the JAX engine runs the same configuration on a CPU
mesh of the same shape, fed the global batch, from the same weights
(``model_parameters``).  Bounds: fp32 losses rtol 1e-4 over three steps
and grad norms rtol 1e-4 (what they move by is ~1e-6); masters: all but
1e-3 of the elements within 1e-4 (1e-4, the dense paths' bound in
``tests/test_torch_zero.py``, is the share where no code flips) and every
element within 6 lr (three Adam steps, each at most lr on either side:
beta1^2 <= beta2).  Elements go past 1e-4 (2 to 11 of ~100k here)
because an int8 code whose value sits on a rounding boundary flips to its
neighbour where the two packages' values differ by an ulp (their backward
sums run in another order): a value within a relative ~1e-6 of a
boundary flips, about 2 * 127 * 1e-6 ~ 2.5e-4 of the codes of one
quantization, and each step quantizes every grad once (qgZ) and every
weight twice (qwZ, its gather per micro-batch); one code step is 1/127 of
its block's absmax, more than such an element's own grad, and Adam turns
that into a step of up to lr.  The JAX suite's own int8-against-dense
bounds (rtol 0.05 and 0.15) hold another thing and are not the
yardstick.  MoE is not held to the JAX ZeRO++ path:
its program gates each shard's rows, the port the global micro-batch
(ROADMAP.md queue 3).
"""

import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as jmesh_mod
from deepspeed_tpu.comm.mesh import build_mesh as j_build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu_torch.runtime.checkpoint_engine import ShardedCheckpointEngine
from tests.test_torch_zero import TINY, config, init_params, token_batches
from tests.torch_zero_ranks import RankGroup, flat, zero_scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-4, 1e-4, 1e-4
FLIPPED = 1e-3                # the share of elements past PARAM_ATOL
LR = 3e-3                     # tests/test_torch_zero.py BASE's warmup_max_lr


def qgrad(stage, ef, **over):
    return config(stage, comm_quantization={"grad_all_reduce": True,
                                            "error_feedback": ef, "block": 64}, **over)


def overlap_q(stage, **over):
    cfg = config(stage, comm_quantization={"all_gather": True, "reduce_scatter": True,
                                           "block": 64}, **over)
    cfg["zero_optimization"]["overlap_comm"] = True
    return cfg


def zeropp(qw=False, qg=False, hpz=1, **over):
    cfg = config(3, **over)
    cfg["zero_optimization"].update(zero_quantized_weights=qw,
                                    zero_quantized_gradients=qg,
                                    zero_hpz_partition_size=hpz)
    return cfg


_PARAMS = {}


def params_of(preset):
    """``init_params(preset)``, made once a process."""
    if preset not in _PARAMS:
        _PARAMS[preset] = init_params(preset)
    return _PARAMS[preset]


def jax_engine(preset, cfg, world, mesh_kw, params):
    prev = jmesh_mod._GLOBAL_MESH
    try:
        mesh = j_build_mesh(devices=jax.devices()[:world], **(mesh_kw or {"fsdp": world}))
        return deepspeed_tpu.initialize(model=j_causal_lm(preset, **TINY[preset]),
                                        model_parameters=params,
                                        config=cfg, mesh=mesh)[0]
    finally:
        jmesh_mod._GLOBAL_MESH = prev


def _shape_items(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _shape_items(v, path)
        else:
            yield path, v


def jax_params(eng):
    """The JAX engine's full fp32 masters (under ZeRO++ its flat primary
    shards cut back to the leaves' shapes)."""
    if not eng._zeropp:
        return dict(flat(jax.tree.map(np.asarray, eng.state.params)))
    prim = jax.tree.map(np.asarray, eng.state.params.primary)
    return {path: arr[:int(np.prod(shape or (1,)))].reshape(shape)
            for (path, arr), (_, shape) in zip(flat(prim), _shape_items(eng._zpp_shapes))}


# the JAX references: name -> (world, preset, config, JAX mesh kw or None);
# world 2 is fsdp 2.  The JAX engine's quantized gradient sync is one
# program at stages 0-2 (the stage shards only the state of an elementwise
# optimizer, FusedAdam here), so one run an error-feedback setting holds
# the port's three stages.
REFS = {
    "qgrad_ef": (2, "llama-tiny", qgrad(2, True), None),
    "qgrad_noef": (2, "gpt2-small", qgrad(1, False), None),
    "o2": (2, "llama-tiny", overlap_q(2), None),
    "o3": (2, "gpt2-small", overlap_q(3), None),
    "zpp_qw": (2, "gpt2-small", zeropp(qw=True), None),
    "zpp_qg": (2, "llama-tiny", zeropp(qg=True), None),
    "zpp_qwqg": (2, "llama-tiny", zeropp(qw=True, qg=True), None),
    "zpp_hpz2": (4, "llama-tiny", zeropp(qw=True, qg=True, hpz=2), None),
}
# the port's cases: name -> (its reference, its config)
PORT = {f"q{st}_{ef}": (f"qgrad_{ef}", qgrad(st, ef == "ef"))
        for st in (0, 1, 2) for ef in ("ef", "noef")}
PORT.update({name: (name, REFS[name][2]) for name in REFS if not name.startswith("qgrad")})
# the checkpoint round trip: name -> a config that must refuse its tag
CKPT = {"zpp_qwqg": config(3), "zpp_hpz2": config(3)}


def _batches(world):
    return token_batches(world, seed=20 + world)


def jax_ref(name, params, export_dir=None):
    """The JAX engine's run of reference ``name`` from ``params`` as plain
    data: per step (loss, grad norm), the full masters, its gates, and
    under ZeRO++ its layout and (with ``export_dir``) its
    ``save_16bit_model`` directory."""
    world, preset, cfg, mesh_kw = REFS[name]
    eng = jax_engine(preset, cfg, world, mesh_kw, params)
    steps = []
    for b in _batches(world):
        loss = eng.train_step(b)
        steps.append((float(loss), eng.get_global_grad_norm()))
    sched = eng._overlap_sched
    out = {"steps": steps, "params": jax_params(eng), "zeropp": eng._zeropp,
           "qcomm": eng._qcomm_grads, "overlap": eng._overlap,
           "qopts": tuple(sched.qcomm)[:2] if sched is not None else None,
           "inert": eng._inert_config_keys}
    if eng._zeropp:
        out.update(shapes=dict(_shape_items(eng._zpp_shapes)),
                   lens=dict(_shape_items(eng._zpp_lens)), hpz=eng._zpp_cfg.hpz)
    if export_dir is not None:
        out["export"] = eng.save_16bit_model(export_dir)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs, and the JAX references in this process while the
    ranks run (one at a time: the suite shares the host's cores)."""
    root = str(tmp_path_factory.mktemp("zeropp"))
    groups = {}
    try:
        for world in (2, 4):
            rank_cases = {}
            for name, (ref, cfg) in PORT.items():
                rworld, preset = REFS[ref][0], REFS[ref][1]
                if rworld != world:
                    continue
                kw = dict(preset=preset, model_kw=TINY[preset], np_params=params_of(preset),
                          config=cfg, batches=_batches(world))
                if name in CKPT:
                    kw.update(root=os.path.join(root, name), other=CKPT[name])
                rank_cases[name] = ("zeropp", kw)
            groups[world] = RankGroup(world, zero_scenarios, (rank_cases,), timeout=420)
        refs = {name: jax_ref(name, params_of(REFS[name][1]),
                              os.path.join(root, f"jax_{name}") if name in CKPT else None)
                for name in REFS}
        yield refs, {w: g.results() for w, g in groups.items()}
    finally:
        for g in groups.values():
            g.close()


@pytest.mark.parametrize("name", list(PORT))
def test_path_matches_the_jax_engine(runs, name):
    """Losses, grad norms and full masters of every rank against the JAX
    engine's same path (which both engines took, with no key inert), at the
    bounds above; every rank holds the same masters, bit for bit."""
    refs, ranks = runs
    ref = PORT[name][0]
    want = refs[ref]
    world = REFS[ref][0]
    if ref.startswith("zpp"):
        assert want["zeropp"]
    elif ref.startswith("qgrad"):
        assert want["qcomm"]
    else:
        assert want["overlap"] and any(want["qopts"])
    for rank in ranks[world]:
        got = rank[name]
        assert got["inert"] == [] and want["inert"] == []
        assert got["zeropp"] == want["zeropp"]
        got_s, want_s = np.asarray(got["steps"]), np.asarray(want["steps"])
        np.testing.assert_allclose(got_s[:, 0], want_s[:, 0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got_s[:, 1], want_s[:, 1], rtol=NORM_RTOL)
        assert set(got["params"]) == set(want["params"])
        d = np.concatenate([np.abs(got["params"][k] - v).ravel()
                            for k, v in want["params"].items()])
        assert (d > PARAM_ATOL).mean() <= FLIPPED and d.max() <= 6 * LR, (
            (d > PARAM_ATOL).sum(), d.max())
    first = ranks[world][0][name]["params"]
    for rank in ranks[world][1:]:
        for k, v in first.items():
            np.testing.assert_array_equal(rank[name]["params"][k], v, err_msg=k)


@pytest.mark.parametrize("name", list(CKPT))
def test_zeropp_checkpoint_round_trip(runs, name):
    """A ZeRO++ tag saved after two steps loads into a fresh engine: the
    masters bit-equal to the saved ones, the third step bit-equal to the
    run that was not interrupted.  The tag holds the JAX engine's ZeRO++
    layout (``.primary``, the hpZ secondary); an engine of another layout
    refuses it with a ``ValueError`` naming the mismatch."""
    refs, ranks = runs
    want = refs[name]
    world = REFS[name][0]
    for rank in ranks[world]:
        got = rank[name]
        for k, v in got["saved"].items():
            np.testing.assert_array_equal(got["loaded"][k], v, err_msg=k)
        assert got["resumed"] == tuple(got["steps"][2])
        for k, v in got["params"].items():
            np.testing.assert_array_equal(got["resumed_params"][k], v, err_msg=k)
        assert got["refused"] is not None and "ZeRO++" in got["refused"]
    index = ShardedCheckpointEngine.read_index(os.path.join(
        os.path.dirname(os.path.dirname(ranks[world][0][name]["export"])), "t",
        "model_states"))

    def key(path):
        return "".join(f"['{p}']" for p in path.split("."))
    assert {k for k in index if k.startswith(".primary")} == {
        ".primary" + key(p) for p in want["shapes"]}
    for path, n_pad in want["lens"].items():
        assert index[".primary" + key(path)]["shape"] == [n_pad], path
    assert any(k.startswith(".secondary_q") for k in index) == (want["hpz"] > 1)


@pytest.mark.parametrize("name", list(CKPT))
def test_save_16bit_model_exports_full_shapes(runs, name):
    """``save_16bit_model`` under ZeRO++: every leaf in the model's full
    shape and the compute dtype, the JAX engine's export's keys, shapes and
    dtypes."""
    refs, ranks = runs
    got = ShardedCheckpointEngine.read_index(ranks[REFS[name][0]][0][name]["export"])
    want = ShardedCheckpointEngine.read_index(refs[name]["export"])
    assert set(got) == set(want)
    for k in want:
        assert got[k]["shape"] == want[k]["shape"], k
        assert got[k]["dtype"] == want[k]["dtype"], k
