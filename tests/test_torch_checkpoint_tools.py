"""What surrounds the port's checkpoints, against the JAX package, on the
CPU: verified loads and their walk-back, stage debris, retention, saves
mid-accumulation, a JAX tag from the 8-device mesh at ZeRO stage 3, the
dataloader's resume, ``zero_to_fp32``, the universal layout,
``init_inference(checkpoint=)`` and the refusals.

Tolerances, with their reasons: loaded state and tool outputs bit-equal
(the same bytes read back); losses, grad norms and logits of the two
packages from the same state rtol 1e-5 (``tests/test_torch_train.py``:
the same fp32 formulas summed in another order).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import universal as j_universal
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JLoader
from deepspeed_tpu.utils import zero_to_fp32 as j_z2f
from deepspeed_tpu_torch.checkpoint import universal as t_universal
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.runtime.checkpoint_engine import atomic
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader as TLoader
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
from deepspeed_tpu_torch.utils import zero_to_fp32 as t_z2f
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
CFG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
       "optimizer": {"type": "FusedAdam", "params": {
           "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
       "scheduler": {"type": "WarmupLR", "params": {
           "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
       "gradient_clipping": 1.0, "steps_per_print": 10**9}


def _tokens(seed, B=4, S=32):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S))


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().float() if x.is_floating_point() else x.detach()
        return x.numpy().copy()
    a = np.array(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.update(_flat_np(tree[k], path))
        else:
            out[path] = _np(tree[k])
    return out


@pytest.fixture(scope="module")
def factory():
    """Engine factories over one set of tiny params (the JAX engines on a
    one-device mesh; the previous global mesh is put back at the end)."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    prev_mesh = mesh_mod._GLOBAL_MESH
    jm = j_causal_lm("llama-tiny", **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    np_params = jax.tree.map(np.asarray, params)
    mesh = build_mesh(devices=jax.devices()[:1])

    def jax_engine(cfg=CFG, **kw):
        return deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                        config=cfg, mesh=mesh, **kw)[0]

    def port_engine(cfg=CFG, **kw):
        tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
        return deepspeed_tpu_torch.initialize(
            model=tm, model_parameters=np_params, config=cfg, device="cpu",
            **kw)[0]

    yield {"jax": jax_engine, "port": port_engine, "jm": jm}
    mesh_mod._GLOBAL_MESH = prev_mesh


@pytest.fixture(scope="module")
def tags(factory, tmp_path_factory):
    """One step, then a save, in each package: the tools' inputs."""
    root = tmp_path_factory.mktemp("tools")
    out = {}
    for name in ("jax", "port"):
        eng = factory[name]()
        tok = _tokens(1)
        eng.train_step((tok, tok))
        d = str(root / name)
        eng.save_checkpoint(d)
        out[name] = d
    return out


# ---------------------------------------------------------------------------
# verified load, walk-back, debris, retention
# ---------------------------------------------------------------------------

def _two_tags(factory, d):
    """A port engine that saved global_step1 and global_step2 into ``d``."""
    eng = factory["port"]()
    for i in range(2):
        tok = _tokens(10 + i)
        eng.train_step((tok, tok))
        eng.save_checkpoint(d)
    return eng


def _flip_byte(path, offset=100):
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0x01]))


@pytest.mark.parametrize("damage,want", [
    ("flip_shard_byte", "global_step1"),
    ("drop_listed_file", "global_step1"),
    ("flip_shard_byte_deep_only", "global_step1"),
    ("drop_manifest", "global_step2")])
def test_both_loaders_walk_back_to_the_same_tag(factory, tmp_path, damage, want):
    """A tag its manifest contradicts is skipped for the newest valid one
    (with ``verify_on_load``; or by the chunk hashes alone under
    ``deep_verify_on_load``).  A tag without a manifest is the JAX rule's
    pre-manifest save: both load it unverified."""
    d = str(tmp_path / "ckpt")
    _two_tags(factory, d)
    newest = os.path.join(d, "global_step2")
    cfg = CFG
    if damage.startswith("flip_shard_byte"):
        _flip_byte(os.path.join(newest, "model_states", "shard_p0.bin"))
        if damage.endswith("deep_only"):
            cfg = dict(CFG, checkpoint={"verify_on_load": False,
                                        "deep_verify_on_load": True})
    elif damage == "drop_listed_file":
        os.remove(os.path.join(newest, "client_state.json"))
    else:
        os.remove(os.path.join(newest, atomic.MANIFEST_NAME))
    got = factory["port"](cfg).load_checkpoint(d)[0]
    ref = factory["jax"](cfg).load_checkpoint(d)[0]
    assert got == ref == os.path.join(d, want)


def test_save_streams_one_leaf_at_a_time_and_loads_by_target(factory, tmp_path):
    """The peak host buffer of a save is the largest leaf, not the tree;
    ``load(target=)`` gives the target's structure."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine import ShardedCheckpointEngine

    eng = factory["port"]()
    tok = _tokens(3)
    eng.train_step((tok, tok))
    eng.save_checkpoint(str(tmp_path))
    leaves = [p for p in eng.master] + [p for p in eng.grad_acc]
    assert eng.checkpoint_engine.max_bytes_in_flight == max(
        p.numel() * p.element_size() for p in leaves)
    back = ShardedCheckpointEngine().load(
        str(tmp_path / "global_step1" / "model_states"), target=eng.params())
    for k, v in _flat_np(eng.params()).items():
        np.testing.assert_array_equal(_flat_np(back)[k], v, err_msg=k)
    with pytest.raises(KeyError, match="missing leaf"):
        ShardedCheckpointEngine().load(
            str(tmp_path / "global_step1" / "model_states"), target={"nope": 0})


def test_nothing_to_load_returns_none_in_both(factory, tmp_path):
    d = str(tmp_path / "empty")
    os.makedirs(d)
    assert factory["port"]().load_checkpoint(d) == (None, {})
    assert factory["jax"]().load_checkpoint(d) == (None, {})


def test_stage_debris_is_never_loaded_and_the_next_save_clears_it(factory,
                                                                   tmp_path):
    d = str(tmp_path / "ckpt")
    eng = _two_tags(factory, d)
    # a save killed mid-write leaves tmp.<tag>; a crashed publish .trash.*
    stage = atomic.stage_path(d, "global_step3")
    shutil.copytree(os.path.join(d, "global_step2"), stage)
    _flip_byte(os.path.join(stage, "model_states", "shard_p0.bin"))
    os.makedirs(os.path.join(d, ".trash.global_step1.123"))
    assert atomic.list_tags(d) == ["global_step2", "global_step1"]
    assert factory["port"]().load_checkpoint(d)[0] == os.path.join(d, "global_step2")
    assert factory["jax"]().load_checkpoint(d)[0] == os.path.join(d, "global_step2")
    tok = _tokens(12)
    eng.train_step((tok, tok))
    eng.save_checkpoint(d)
    assert sorted(os.listdir(d)) == ["global_step1", "global_step2",
                                     "global_step3", "latest"]
    assert atomic.verify_dir(os.path.join(d, "global_step3")).ok


def test_keep_last_n_leaves_the_jax_engine_s_tags(factory, tmp_path):
    cfg = dict(CFG, checkpoint={"keep_last_n": 2})
    left = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        eng = factory[name](cfg)
        for tag in ("a", "b", "c", "d"):
            eng.save_checkpoint(d, tag=tag, save_latest=tag != "d")
        left[name] = sorted(os.listdir(d))
    assert left["port"] == left["jax"] == ["c", "d", "latest"]
    assert atomic.read_latest(str(tmp_path / "port")) == "c"


# ---------------------------------------------------------------------------
# saves mid-accumulation, and what a load sets back
# ---------------------------------------------------------------------------

def _micro(eng, tok):
    loss = eng(tok)
    eng.backward(loss)
    eng.step()
    return float(loss)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_save_mid_accumulation_resumes_to_the_same_step(factory, tmp_path, saver):
    """Saved after one of two micro-batches: the accumulator and the
    micro count come back, and the step the next micro-batch closes
    equals the saver's own."""
    loader = "port" if saver == "jax" else "jax"
    d = str(tmp_path / "ckpt")
    a = factory[saver]()
    tok = _tokens(20)
    first, second = (tok[:2], tok[:2]), (tok[2:], tok[2:])
    _micro(a, first)
    a.save_checkpoint(d, tag="mid")
    with open(os.path.join(d, "mid", "client_state.json")) as fh:
        assert json.load(fh)["micro_count"] == 1
    b = factory[loader]()
    b.load_checkpoint(d)
    assert not b.is_gradient_accumulation_boundary() and b.global_steps == 0
    la, lb = _micro(a, second), _micro(b, second)
    assert a.global_steps == b.global_steps == 1
    assert lb == pytest.approx(la, rel=TOL)
    assert b.get_global_grad_norm() == pytest.approx(a.get_global_grad_norm(),
                                                     rel=TOL)


@pytest.mark.parametrize("flags", [
    {"load_module_only": True}, {"load_optimizer_states": False},
    {"load_lr_scheduler_states": False}])
def test_partial_loads_set_back_what_the_jax_engine_sets_back(factory, tags,
                                                              flags):
    t, j = factory["port"](), factory["jax"]()
    t.load_checkpoint(tags["jax"], **flags)
    j.load_checkpoint(tags["jax"], **flags)
    tparams = _flat_np(t.params())
    jparams = _flat_np(jax.tree.map(np.asarray, j.state.params))
    for k in jparams:
        np.testing.assert_array_equal(tparams[k], jparams[k], err_msg=k)
    assert (t.global_steps, t.optimizer.count) == (
        int(j.state.global_steps), int(j.state.opt_state.count))
    assert t.lr_scheduler.state_dict() == j.lr_scheduler.state_dict()


def test_jax_zero3_tag_from_eight_devices_loads_whole(tmp_path):
    """The JAX engine at ZeRO stage 3 on the 8-device mesh writes each
    sharded leaf as many chunks; the port assembles the masters bit-equal
    and rescales gradient accumulation to keep the recorded global batch
    (micro 1 x dp 8 -> micro 1 x gas 8), then steps as the JAX engine."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    cfg = dict(CFG, train_micro_batch_size_per_gpu=1,
               gradient_accumulation_steps=1,
               zero_optimization={"stage": 3,
                                  "stage3_param_persistence_threshold": 0})
    prev_mesh = mesh_mod._GLOBAL_MESH
    try:
        mesh = build_mesh(fsdp=8)
        mesh_mod.set_global_mesh(mesh)
        jm = j_causal_lm("llama-tiny", mesh=mesh, **TINY)
        j, *_ = deepspeed_tpu.initialize(model=jm, config=cfg, mesh=mesh)
        tok = _tokens(30, B=8)
        j.train_step((tok, tok))
        d = str(tmp_path / "z3")
        tag = j.save_checkpoint(d)
        with open(os.path.join(tag, "model_states", "index_p0.json")) as fh:
            index = json.load(fh)
        assert max(len(m["chunks"]) for m in index.values()) == 8
        port_cfg = {k: v for k, v in cfg.items() if k != "zero_optimization"}
        tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
        t, *_ = deepspeed_tpu_torch.initialize(model=tm, config=port_cfg,
                                               device="cpu")
        assert t.load_checkpoint(d)[0] == tag
        jparams = _flat_np(jax.tree.map(np.asarray, j.state.params))
        tparams = _flat_np(t.params())
        for k in jparams:
            np.testing.assert_array_equal(tparams[k], jparams[k], err_msg=k)
        assert t.config.gradient_accumulation_steps == 8
        assert t.config.train_batch_size == 8 and t.optimizer.count == 1
        tok = _tokens(31, B=8)
        lj, lt = float(j.train_step((tok, tok))), float(t.train_step((tok, tok)))
    finally:
        mesh_mod._GLOBAL_MESH = prev_mesh
    assert lt == pytest.approx(lj, rel=TOL)
    assert t.get_global_grad_norm() == pytest.approx(j.get_global_grad_norm(),
                                                     rel=TOL)


@pytest.mark.parametrize("elastic", [True, False])
def test_a_global_batch_the_micro_batch_cannot_divide(factory, tags, elastic):
    """The tag's global batch is 4 (micro 2 x gas 2); at micro 3 it cannot
    be kept: elastic_resume raises, as the JAX engine does, and without it
    the current triad stays (with a warning)."""
    from deepspeed_tpu.elasticity import ElasticityIncompatibleWorldSize as JErr
    from deepspeed_tpu_torch.runtime.engine import ElasticityIncompatibleWorldSize

    cfg = dict(CFG, train_micro_batch_size_per_gpu=3,
               checkpoint={"elastic_resume": elastic})
    t, j = factory["port"](cfg), factory["jax"](cfg)
    if elastic:
        with pytest.raises(ElasticityIncompatibleWorldSize, match="multiple"):
            t.load_checkpoint(tags["jax"])
        with pytest.raises(JErr, match="multiple"):
            j.load_checkpoint(tags["port"])
    else:
        t.load_checkpoint(tags["jax"])
        j.load_checkpoint(tags["port"])
        assert (t.config.gradient_accumulation_steps, t.config.train_batch_size) == (
            j.config.gradient_accumulation_steps, j.config.train_batch_size) == (2, 6)


def test_offload_and_legacy_tags_are_refused(factory, tags, tmp_path):
    d = str(tmp_path / "offload")
    shutil.copytree(tags["port"], d)
    tag = atomic.read_latest(d)
    os.makedirs(os.path.join(d, tag, "offload_states"))
    with pytest.raises(ValueError, match="host offload state"):
        factory["port"](dict(CFG, checkpoint={"verify_on_load": False})
                        ).load_checkpoint(d)
    legacy = str(tmp_path / "legacy")
    os.makedirs(os.path.join(legacy, "old"))
    for name in ("model_states.msgpack", "optim_states.msgpack"):
        with open(os.path.join(legacy, "old", name), "wb") as fh:
            fh.write(b"\x80")
    atomic.write_latest(legacy, "old")
    with pytest.raises(NotImplementedError, match="legacy msgpack"):
        factory["port"]().load_checkpoint(legacy)
    with pytest.raises(NotImplementedError, match="legacy msgpack"):
        t_z2f.get_fp32_state_dict_from_zero_checkpoint(legacy)
    with pytest.raises(NotImplementedError, match="legacy msgpack"):
        t_universal.DeepSpeedCheckpoint(legacy).load_params()
    with pytest.raises(NotImplementedError, match="legacy msgpack"):
        deepspeed_tpu_torch.init_inference(
            t_causal_lm("llama-tiny", device="cpu", **TINY),
            {"dtype": "float32"}, checkpoint=legacy, device="cpu")


@pytest.mark.parametrize("section", [
    {"tag_validation": "Fail", "load_universal": True, "async_save": True,
     "use_node_local_storage": True, "parallel_write": {"pipeline_stage": True}},
    {"preemption_save": True}])
def test_checkpoint_config_section(factory, section):
    """The keys the JAX engine never reads are accepted; the preemption
    save is refused, naming the ROADMAP."""
    cfg = dict(CFG, checkpoint=section)
    if section.get("preemption_save"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            factory["port"](cfg)
    else:
        eng = factory["port"](cfg)
        assert eng.config.checkpoint_config.async_save is True


# ---------------------------------------------------------------------------
# the dataloader
# ---------------------------------------------------------------------------

def _dict_dataset(n=23):
    rng = np.random.default_rng(4)
    return [{"ids": rng.integers(0, 256, (8,)),
             "w": rng.random(3).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("kind", ["arrays", "samples", "collate"])
@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True),
                                               (True, False)])
def test_dataloader_yields_the_jax_loader_s_batches(kind, shuffle, drop_last):
    rng = np.random.default_rng(3)
    collate = None
    if kind == "arrays":
        data = (rng.integers(0, 256, (23, 8)),
                rng.random((23, 2)).astype(np.float32))
    else:
        data = _dict_dataset()
        if kind == "collate":
            collate = lambda s: {"ids": np.stack([x["ids"] for x in s]) * 2}
    mesh = build_mesh(devices=jax.devices()[:1])
    kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last, collate_fn=collate)
    jl, tl = JLoader(data, 4, mesh=mesh, **kw), TLoader(data, 4, **kw)
    assert len(tl) == len(jl)
    for epoch in range(2):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb)
        for a, b in zip(jb, tb):
            ja = jax.tree.map(np.asarray, a)
            if isinstance(ja, dict):
                assert set(b) == set(ja)
                for k in ja:
                    assert b[k].device.type == "cpu"
                    np.testing.assert_array_equal(b[k].numpy(), ja[k])
            else:
                for x, y in zip(ja, b):
                    np.testing.assert_array_equal(y.numpy(), x)
    assert tl.state_dict() == jl.state_dict()


def test_dataloader_resumes_mid_epoch_and_checks_its_identity():
    data = (np.arange(40).reshape(20, 2),)
    a = TLoader(data, 3, shuffle=True, seed=9)
    it = iter(a)
    seen = [next(it) for _ in range(2)]
    sd = a.state_dict()
    assert sd == {"epoch": 0, "samples_consumed": 6, "seed": 9, "shuffle": True,
                  "n": 20}
    rest = list(it)
    b = TLoader(data, 3, shuffle=True, seed=9)
    b.load_state_dict(sd)
    assert [x[0].tolist() for x in b] == [x[0].tolist() for x in rest]
    # another batch size replays the same remaining samples (14 at 2 a
    # batch; the batches of 3 drop the last 2)
    c = TLoader(data, 2, shuffle=True, seed=9)
    c.load_state_dict(sd)
    assert (np.concatenate([x[0].numpy() for x in c])[:12].tolist()
            == np.concatenate([x[0].numpy() for x in rest]).tolist())
    j = JLoader(data, 3, mesh=build_mesh(devices=jax.devices()[:1]),
                shuffle=True, seed=9)
    j.load_state_dict(sd)
    assert [np.asarray(x[0]).tolist() for x in j] == [x[0].tolist() for x in rest]
    for bad in ({**sd, "n": 21}, {**sd, "seed": 8}, {**sd, "shuffle": False}):
        with pytest.raises(ValueError):
            TLoader(data, 3, shuffle=True, seed=9).load_state_dict(bad)
    r = RepeatingLoader(TLoader(data, 3, shuffle=True, seed=9))
    r.load_state_dict(sd)
    assert next(r)[0].tolist() == rest[0][0].tolist()
    assert len(seen) == 2


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_engine_dataloader_resumes_at_the_same_sample(factory, tmp_path, saver):
    """``initialize(training_data=)`` returns the loader; its position
    rides save_checkpoint's client_state, and a load in the other package
    resumes at the same sample."""
    loader = "port" if saver == "jax" else "jax"
    rng = np.random.default_rng(6)
    data = (rng.integers(0, 256, (14, 16)), rng.integers(0, 256, (14, 16)))
    a = factory[saver](training_data=data)
    dl = a.training_dataloader
    assert dl is not None
    it = iter(dl)
    for _ in range(3):
        _micro(a, next(it))
    d = str(tmp_path / "ckpt")
    a.save_checkpoint(d, client_state={"note": 1})
    want = [np.asarray(x[0]) for x in it]
    b = factory[loader](training_data=data)
    _, client = b.load_checkpoint(d)
    assert client["note"] == 1 and client["dataloader"]["samples_consumed"] == 6
    got = [np.asarray(x[0]) for x in b.training_dataloader]
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_initialize_returns_the_dataloader(factory):
    tm = t_causal_lm("llama-tiny", device="cpu", **TINY)
    data = (np.zeros((6, 8), np.int64), np.zeros((6, 8), np.int64))
    eng, opt, dl, sched = deepspeed_tpu_torch.initialize(
        model=tm, config=CFG, training_data=data, device="cpu")
    assert dl is eng.training_dataloader and dl.batch_size == 2 and len(dl) == 3
    assert opt is eng.optimizer and sched is eng.lr_scheduler
    eng2, _, none, _ = deepspeed_tpu_torch.initialize(
        model=t_causal_lm("llama-tiny", device="cpu", **TINY), config=CFG,
        device="cpu")
    assert none is None and eng2.training_dataloader is None


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["jax", "port"])
def test_zero_to_fp32_gives_the_jax_tool_s_arrays(tags, tmp_path, source):
    d = tags[source]
    got = t_z2f.get_fp32_state_dict_from_zero_checkpoint(d)
    want = j_z2f.get_fp32_state_dict_from_zero_checkpoint(d)
    assert set(got) == set(want) and "layers/attn/wq" in got
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    t_z2f.main([d, str(tmp_path / "port"), "-t", atomic.read_latest(d)])
    j_z2f.convert_zero_checkpoint_to_fp32_state_dict(d, str(tmp_path / "jax"))
    with np.load(str(tmp_path / "port.npz")) as a, \
            np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("split_layers", [False, True])
@pytest.mark.parametrize("source", ["jax", "port"])
def test_universal_layout_reads_across_packages(tags, tmp_path, source,
                                                split_layers):
    """Each package converts the same tag; each reads the other's output
    back into the tag's arrays, params and optimizer state."""
    d = tags[source]
    tu, ju = str(tmp_path / "port_u"), str(tmp_path / "jax_u")
    t_universal.ds_to_universal(d, tu, split_layers=split_layers)
    j_universal.ds_to_universal(d, ju, split_layers=split_layers)
    with open(os.path.join(tu, "meta.json")) as fh:
        tmeta = json.load(fh)
    with open(os.path.join(ju, "meta.json")) as fh:
        jmeta = json.load(fh)
    assert tmeta == jmeta
    assert sorted(os.listdir(os.path.join(tu, "optim"))) == sorted(
        os.listdir(os.path.join(ju, "optim")))
    tck, jck = t_universal.DeepSpeedCheckpoint(d), j_universal.DeepSpeedCheckpoint(d)
    assert (tck.zero_stage, tck.world_size) == (0, jck.world_size)
    for section, t_target, j_target in (
            ("params", tck.load_params(), jck.load_params()),
            ("optim", tck.load_optim(), jck.load_optim())):
        load_t = getattr(t_universal, f"load_universal_{section}")
        load_j = getattr(j_universal, f"load_universal_{section}")
        want = _flat_np(j_target)
        for got in (_flat_np(load_t(ju, t_target)), _flat_np(load_t(tu, t_target)),
                    _flat_np(load_j(tu, j_target))):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_universal_layout_keeps_bf16_leaves(factory, tmp_path):
    """A master-free tag's bf16 leaves go out as the JAX package writes
    them (raw 2-byte words, "bfloat16" in meta.json) and come back
    bit-equal."""
    cfg = dict(CFG, bf16={"enabled": True, "master_weights": False},
               data_types={"grad_accum_dtype": "bf16"},
               optimizer={"type": "Adam8bit", "params": {"lr": 1e-3}})
    eng = factory["port"](cfg)
    tok = _tokens(40)
    eng.train_step((tok, tok))
    d, u = str(tmp_path / "ckpt"), str(tmp_path / "u")
    eng.save_checkpoint(d)
    t_universal.ds_to_universal(d, u, split_layers=True)
    with open(os.path.join(u, "meta.json")) as fh:
        meta = json.load(fh)
    assert meta["params"]["layers/attn/wq"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(u, "params", "layers.attn.wq.layer0.npy")).dtype == np.dtype("V2")
    back = t_universal.load_universal_params(u, eng.params())
    for k, v in _flat_np(eng.params()).items():
        np.testing.assert_array_equal(_flat_np(back)[k], v, err_msg=k)
    assert back["layers"]["attn"]["wq"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["jax", "port"])
def test_init_inference_from_a_training_save(factory, tags, source):
    d = tags[source]
    tok = _tokens(50, B=2, S=16)
    t = deepspeed_tpu_torch.init_inference(
        t_causal_lm("llama-tiny", device="cpu", **TINY), {"dtype": "float32"},
        checkpoint=d, device="cpu")
    j = deepspeed_tpu.init_inference(factory["jm"], {"dtype": "float32"},
                                     checkpoint=d)
    np.testing.assert_allclose(t(tok).numpy(), np.asarray(j(tok)), rtol=TOL,
                               atol=TOL)
    # a tag directory itself, with no latest pointer above it
    tag = os.path.join(d, atomic.read_latest(d))
    t2 = deepspeed_tpu_torch.init_inference(
        t_causal_lm("llama-tiny", device="cpu", **TINY), {"dtype": "float32"},
        checkpoint=tag, device="cpu")
    np.testing.assert_array_equal(t2(tok).numpy(), t(tok).numpy())


def test_init_inference_from_a_huggingface_directory(tmp_path):
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu_torch.module_inject import config_from_hf
    from deepspeed_tpu_torch.module_inject.containers import (hf_to_params,
                                                              load_hf_state_dict)
    from deepspeed_tpu_torch.models.transformer import CausalLM

    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False)
    path = str(tmp_path / "hf")
    transformers.LlamaForCausalLM(cfg).save_pretrained(path, safe_serialization=True)
    mcfg = config_from_hf(path)
    model = CausalLM(mcfg, device="cpu", seed=0)
    tok = np.array([[1, 5, 9, 2, 77, 31, 8, 4]])
    got = deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"},
                                             checkpoint=path, device="cpu")(tok)
    want = deepspeed_tpu_torch.init_inference(
        model, {"dtype": "float32"},
        params=hf_to_params(load_hf_state_dict(path), mcfg), device="cpu")(tok)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
