"""Checkpoints of the offloading engine against the JAX package's, on the
CPU: a tag either package saves with ``offload_optimizer`` loads in the
other.

Both engines (the JAX one on a one-device mesh, stage 0) start from the
same params with bf16 compute over fp32 host masters and take two steps;
each saves.  A fresh port engine loads the JAX tag, a fresh JAX engine
loads the port's, and a fresh port engine its own.  Checked, bit for bit:

- the loaded host state (every leaf's master and moments from
  ``offload_states/``, ``step_count``) against the tag's ``.npy`` files, and
  the tag's files against the saving engine's live host state;
- the loaded card params, accumulator, step count and loss scaler against
  the tag's ``model_states`` / ``optim_states``;
- the port's reload takes its next step bit-equal to the uninterrupted run
  (cpu and nvme backends);
- ``offload_states/`` is in the tag's manifest, and both packages write the
  same files with the same ``meta.json``;
- an engine without offload given an offload tag raises, naming host
  offload state, and an offloading engine given a device tag raises too;
  with ``load_module_only`` it takes the params as its host masters.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import build_mesh
from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.runtime.checkpoint_engine import ShardedCheckpointEngine
from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import (keystr,
                                                                   tree_flatten_with_path)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=2, vocab_size=256, max_seq_len=128)
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {
            "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
        "gradient_clipping": 1.0, "steps_per_print": 10**9}
NAMES = ("master", "exp_avg", "exp_avg_sq")


def _cfg(device="cpu", **kw):
    return dict(BASE, zero_optimization={"stage": 0, "offload_optimizer": dict(
        device=device, **kw)})


def _batches(n):
    rng = np.random.default_rng(7)
    return [rng.integers(0, TINY["vocab_size"], (4, 32)) for _ in range(n)]


def _steps(eng, batches):
    return [(float(eng.train_step((t, t))), float(eng.get_global_grad_norm()))
            for t in batches]


def _np32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy().copy()
    a = np.array(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _host_state(opt):
    """Every leaf's [master, *moments] of a host optimizer (either package)."""
    return [[_np32(s) for s in opt._leaf_states(i)] for i in range(len(opt._sizes))]


def _tag_host_state(tag):
    d = os.path.join(tag, "offload_states")
    with open(os.path.join(d, "meta.json")) as fh:
        meta = json.load(fh)
    return meta, [[np.load(os.path.join(d, f"leaf{i}.{n}.npy")) for n in NAMES]
                  for i in range(meta["n"])]


def _assert_states_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        for k, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i} {NAMES[k]}")


@pytest.fixture(scope="module")
def setup():
    jm = j_causal_lm("llama-tiny", **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jm, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def round_trip(setup, tmp_path_factory):
    from deepspeed_tpu.comm import mesh as mesh_mod

    jm, params, np_params = setup
    root = tmp_path_factory.mktemp("offload_ckpt")
    dj, dt = str(root / "jax"), str(root / "port")
    first, then = _batches(2), _batches(4)[2:]
    prev = mesh_mod._GLOBAL_MESH
    try:
        mesh = build_mesh(devices=jax.devices()[:1])

        def jax_engine():
            return deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                            config=_cfg(), mesh=mesh)[0]

        def port_engine(cfg=None):
            return deepspeed_tpu_torch.initialize(
                model=t_causal_lm("llama-tiny", device="cpu", **TINY),
                model_parameters=np_params, config=cfg or _cfg(), device="cpu")[0]

        ja, ta = jax_engine(), port_engine()
        _steps(ja, first)
        _steps(ta, first)
        tags = (ja.save_checkpoint(dj), ta.save_checkpoint(dt))
        live = {"ja": _host_state(ja._offload_opt), "ta": _host_state(ta._offload_opt),
                "ta_params": [_np32(p) for p in ta.master]}
        tb, tc, jb = port_engine(), port_engine(), jax_engine()
        loaded = {"tb": tb.load_checkpoint(dj), "tc": tc.load_checkpoint(dt),
                  "jb": jb.load_checkpoint(dt)}
        after = {"tb": _host_state(tb._offload_opt), "jb": _host_state(jb._offload_opt),
                 "tc": _host_state(tc._offload_opt),
                 "steps": {k: e._offload_opt.step_count
                           for k, e in (("tb", tb), ("tc", tc), ("jb", jb))},
                 "tb_model": {keystr(k): _np32(v) for k, v in
                              tree_flatten_with_path(tb._nest(tb.master))},
                 "tb_optim": {keystr(k): _np32(v) for k, v in
                              tree_flatten_with_path(tb._optim_payload())}}
        runs = {"ta": _steps(ta, then), "tc": _steps(tc, then)}
    finally:
        mesh_mod._GLOBAL_MESH = prev
    return dict(tags=tags, live=live, loaded=loaded, after=after, runs=runs,
                port_engine=port_engine, np_params=np_params)


def test_jax_loads_the_port_offload_tag(round_trip):
    rt = round_trip
    assert rt["loaded"]["jb"][0] == rt["tags"][1]
    meta, files = _tag_host_state(rt["tags"][1])
    _assert_states_equal(files, rt["live"]["ta"], "port tag against the port's live state")
    _assert_states_equal(rt["after"]["jb"], files, "JAX engine after the load")
    assert meta["step_count"] == rt["after"]["steps"]["jb"] == 2


def test_port_loads_the_jax_offload_tag(round_trip):
    rt = round_trip
    assert rt["loaded"]["tb"][0] == rt["tags"][0]
    meta, files = _tag_host_state(rt["tags"][0])
    _assert_states_equal(files, rt["live"]["ja"], "JAX tag against the JAX live state")
    _assert_states_equal(rt["after"]["tb"], files, "port engine after the load")
    assert meta["step_count"] == rt["after"]["steps"]["tb"] == 2
    eng = ShardedCheckpointEngine()
    for sub, got in (("model_states", rt["after"]["tb_model"]),
                     ("optim_states", rt["after"]["tb_optim"])):
        want = {k: _np32(v) for k, v in
                eng.load(os.path.join(rt["tags"][0], sub)).items()}
        assert set(got) == set(want), sub
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{sub} {k}")


def test_port_resumes_its_own_offload_tag_bit_equal(round_trip):
    rt = round_trip
    _assert_states_equal(rt["after"]["tc"], rt["live"]["ta"], "port reload")
    assert rt["runs"]["tc"] == rt["runs"]["ta"]


def test_both_packages_write_the_same_offload_files(round_trip):
    jtag, ttag = round_trip["tags"]
    jd, td = (os.path.join(t, "offload_states") for t in (jtag, ttag))
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    with open(os.path.join(jd, "meta.json")) as fh:
        jmeta = json.load(fh)
    with open(os.path.join(td, "meta.json")) as fh:
        tmeta = json.load(fh)
    assert jmeta == tmeta
    for tag in (jtag, ttag):
        with open(os.path.join(tag, "MANIFEST.json")) as fh:
            files = json.load(fh)["files"]
        assert any(f.startswith("offload_states/") for f in files), tag
        assert "offload_states/meta.json" in files


def test_nvme_engine_reload_takes_its_next_step_bit_equal(round_trip, tmp_path):
    port_engine = round_trip["port_engine"]
    cfg = _cfg("nvme", nvme_path=str(tmp_path / "swap_a"))
    a = port_engine(cfg)
    _steps(a, _batches(2))
    tag = a.save_checkpoint(str(tmp_path / "ckpt"))
    want = _steps(a, _batches(4)[2:3])
    b = port_engine(_cfg("nvme", nvme_path=str(tmp_path / "swap_b")))
    assert b.load_checkpoint(str(tmp_path / "ckpt"))[0] == tag
    assert _steps(b, _batches(4)[2:3]) == want
    _assert_states_equal(_host_state(b._offload_opt), _host_state(a._offload_opt),
                         "nvme reload")


def test_offload_and_device_tags_refuse_the_other_engine(round_trip, tmp_path):
    """The repair: an engine without offload given an offload tag raises
    (it used to load an empty optimizer state), naming host offload state;
    the reverse raises too.  A module-only load into an offloading engine
    makes the tag's params its host masters."""
    rt = round_trip
    port_engine = rt["port_engine"]
    plain = port_engine(dict(BASE))
    with pytest.raises(ValueError, match="host offload state"):
        plain.load_checkpoint(os.path.dirname(rt["tags"][1]))
    dev_dir = str(tmp_path / "device")
    _steps(plain, _batches(1))
    plain.save_checkpoint(dev_dir)
    off = port_engine()
    with pytest.raises(ValueError, match="device optimizer state"):
        off.load_checkpoint(dev_dir)
    off.load_checkpoint(dev_dir, load_module_only=True)
    for m, j in zip(off._offload_opt.masters(), off._offload_order):
        np.testing.assert_array_equal(m.numpy(), _np32(plain.master[j]).reshape(-1))
        assert torch.equal(off.master[j], plain.master[j].to(torch.bfloat16))
